"""HTTP serving front-end: JPEG in, caption out (tpucap's
``tpucap/serve_http.py`` on the port's servers).

A thin stdlib (http.server) layer over :class:`tpucap_torch.serve.CaptionServer`
(``engine="batch"``) or :class:`tpucap_torch.serve.ContinuousCaptionServer`
(``engine="continuous"``). Request handling threads only decode JPEG bytes
(the port's threaded C++ decoder, ``ops/jpeg``) and preprocess on the host
in f32, as tpucap's do; all device work flows through the servers, so
concurrent HTTP clients coalesce into batches (or lanes) on the card.

Endpoints, status codes, ``/stats`` keys and ``/metrics`` series are
tpucap's, so a client or a scrape job written for tpucap reads the port:
- ``POST /caption``            body = JPEG bytes -> {"caption": ...}
- ``POST /caption_features``   body = JSON {"features": [...]} (one row)
- ``POST /caption_batch``      body = JSON {"features": [[...], ...]} or
                               {"images_b64": [...]} -> {"captions": [...]}
- ``POST /caption_stream``     body = JPEG bytes -> ndjson lines
                               {"words": [...]}, then {"done": true,
                               "caption": ...} (continuous engine only)
- ``POST /caption_stream_features``  the same for one feature row
- ``POST /reload``             JSON {"bundle": path} -> hot-swap the weights
                               (403 unless ``allow_reload=True``)
- ``GET  /healthz``            liveness + the pipeline's device type
                               (tpucap reports jax's backend)
- ``GET  /stats``              batcher stats; keyed per model when several
                               are served
- ``GET  /metrics``            the same in Prometheus text format 0.0.4
- ``GET  /`` (or ``/demo``)    stdlib-only browser demo page
413 before the body is read past ``max_body_bytes``, 503 with
``Retry-After`` when a queue is full, 404 for an unknown route, 400 for a bad
body or an unknown model.

Multi-model serving: ``extra_models={name: pipeline}`` serves several models
behind one port (``?model=name`` or a "model" field); each model keeps its
own micro-batcher pair, and each pipeline's work runs under its own
precision flags, so an f32 and a bf16 model can be served together.

Streaming uses connection-close framing (no Content-Length; read lines
until EOF); a span comes at most once a sync group (``ticks_per_sync``
steps). On the batch engine the streaming routes answer tpucap's 400.

The batch engine serves the per-request dials, as query parameters
(``?prefix=a+dog``, ``?include_words=dog,grass``) or JSON fields
(``prefix``, ``include_words``; on ``/caption_batch`` also the per-row
``prefixes`` / ``include_words_rows``): a bad dial answers 400, a batch
that fails on the card 500. The continuous engines have no such dials and
answer tpucap's 400.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tpucap_torch.serve import (
    CaptionServer,
    ContinuousCaptionServer,
    Overloaded,
    reload_together,
)


class _ThreadingHTTPServer(ThreadingHTTPServer):
    # socketserver's listen backlog is 5 (tpucap's server keeps it): past
    # 5 connections waiting to be accepted, a burst of clients is reset or
    # retried by TCP a second later (seen on the card's host with 16 and 64
    # closed-loop clients, one connection a request).
    request_queue_size = 1024


def _prom_escape(value: str) -> str:
    """Escape a Prometheus label value (exposition-format rules)."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


# (metric family, type, help, stats key) for the /metrics renderer.
# Counters are cumulative since server start (reset on restart — the
# normal Prometheus counter contract); gauges are point-in-time.
_PROM_FAMILIES = (
    ("tpucap_requests_total", "counter",
     "Requests admitted to the batcher", "requests"),
    ("tpucap_batches_total", "counter",
     "Device batches dispatched", "batches"),
    ("tpucap_padded_rows_total", "counter",
     "Pad rows dispatched (bucket ladder fill)", "padded_rows"),
    ("tpucap_ticks_total", "counter",
     "Continuous-engine decode ticks", "ticks"),
    ("tpucap_mean_batch_size", "gauge",
     "Mean dispatched batch size", "mean_batch"),
    ("tpucap_mean_occupancy", "gauge",
     "Continuous-engine mean live lanes per tick", "mean_occupancy"),
)


def _prometheus_text(models: dict) -> str:
    """Render every model's batcher stats in the Prometheus text
    exposition format (version 0.0.4) — the standard pull-based
    monitoring surface (``GET /metrics``), so a stock Prometheus
    scrape job can watch throughput/latency without parsing the JSON
    ``/stats`` shape. ``models`` is the {name: (pipe, images_server,
    features_server)} routing table."""
    snaps = []  # (labels, stats)
    for name in sorted(models):
        _, images, features = models[name]
        for endpoint, srv in (("images", images), ("features", features)):
            snaps.append(
                (
                    f'model="{_prom_escape(name)}",endpoint="{endpoint}"',
                    srv.stats(),
                )
            )
    lines = []
    for fam, typ, help_, key in _PROM_FAMILIES:
        rows = [
            (labels, s[key]) for labels, s in snaps if s.get(key) is not None
        ]
        if not rows:
            continue
        lines.append(f"# HELP {fam} {help_}")
        lines.append(f"# TYPE {fam} {typ}")
        for labels, v in rows:
            # Counters must render EXACTLY — %g's 6 significant digits
            # would quantize requests_total past ~1e6, so consecutive
            # scrapes could read identical values while thousands of
            # requests were served (breaking Prometheus rate()).
            # repr() is shortest-exact for floats; ints print as ints.
            out = repr(float(v)) if not float(v).is_integer() else str(int(v))
            lines.append(f"{fam}{{{labels}}} {out}")
    # Request latency percentiles as a summary (absent until the first
    # request — percentiles of an empty window are meaningless).
    lat_rows = [
        (labels, q, s[k])
        for labels, s in snaps
        for q, k in (("0.5", "p50_ms"), ("0.99", "p99_ms"))
        if s.get(k) is not None
    ]
    if lat_rows:
        lines.append(
            "# HELP tpucap_request_latency_ms "
            "Request latency from submit to caption (milliseconds)"
        )
        lines.append("# TYPE tpucap_request_latency_ms summary")
        for labels, q, v in lat_rows:
            lines.append(
                f'tpucap_request_latency_ms{{{labels},quantile="{q}"}} '
                f"{float(v):g}"
            )
    return "\n".join(lines) + "\n"


def _preprocess_jpeg_batch(
    blobs: list[bytes], size: int, mode: str
) -> np.ndarray:
    """Decode+preprocess MANY JPEGs with ONE C++ call -> (N, size, size, 3).

    One ``decode_jpeg_batch`` call is load-bearing: the C++ decoder
    threads ACROSS the batch (csrc/jpeg_decode.cpp), so per-blob
    calls would serialize host decode for exactly the batched serving
    shape (/caption_batch images mode) it exists for.
    ``preprocess_input`` is (..., 3)-broadcasting, so one vectorized
    call normalizes the whole stack."""
    from tpucap_torch.data.preprocess import preprocess_input
    from tpucap_torch.ops import jpeg

    rgb = jpeg.decode_jpeg_batch(blobs, size)  # (N, size, size, 3) uint8
    return preprocess_input(rgb.astype(np.float32), mode)


def _preprocess_jpeg(blob: bytes, size: int, mode: str) -> np.ndarray:
    return _preprocess_jpeg_batch([blob], size, mode)[0]


class CaptionHTTPServer:
    """Owns a CaptionServer pair (images + features) and the HTTP loop."""

    def __init__(
        self,
        pipeline,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 64,
        max_delay_ms: float = 5.0,
        method: str | None = None,
        beam_width: int | None = None,
        parallelism: str | None = None,
        max_queue: int | None = None,
        engine: str = "batch",
        ticks_per_sync: int = 8,
        allow_reload: bool = False,
        extra_models: dict | None = None,
        max_body_bytes: int = 64 << 20,
    ):
        """engine='continuous' serves BOTH endpoints through the
        slot-recycling engine (ContinuousCaptionServer, ``max_batch`` slots,
        ``ticks_per_sync`` steps a sync group): greedy by default, beam
        when method='beam' (each request then occupies a beam_width-lane
        group); other methods raise ValueError before any thread starts.
        The JPEG routes run the encoder in the admission path
        (mode='images'); the feature routes skip it.

        ``extra_models`` ({name: pipeline}) serves several models behind
        one port: requests route with ``?model=name`` (or a "model"
        field on the JSON routes); the positional pipeline serves
        unnamed requests. Each model gets its own micro-batcher pair, so
        batches never mix models; the card interleaves whole batches.
        ``/reload`` takes an optional "model" field.

        ``max_body_bytes`` caps the POST request body (413 over it,
        BEFORE the body is read); 0 disables the ceiling."""
        self._pipe = pipeline
        self._max_body_bytes = int(max_body_bytes)
        if extra_models:
            if engine != "batch":
                raise ValueError(
                    "extra_models needs engine='batch' (continuous "
                    "tick loops would contend for the single device)"
                )
            if "default" in extra_models:
                raise ValueError(
                    "'default' names the positional pipeline — pick "
                    "another name for the extra model"
                )
        kw = dict(
            max_batch=max_batch,
            max_delay_ms=max_delay_ms,
            method=method,
            beam_width=beam_width,
            parallelism=parallelism,
            max_queue=max_queue,
        )
        if engine == "continuous":
            # Validate before any server thread starts (no leaked
            # batcher on a bad flag combination).
            dcfg = pipeline.config.decode
            resolved = method or dcfg.method
            if resolved == "beam":
                bw = beam_width or dcfg.beam_width
            elif resolved == "greedy":
                bw = 1
            else:
                raise ValueError(
                    f"engine='continuous' supports method 'greedy'|'beam'"
                    f", got {resolved!r} — use engine='batch'"
                )
        elif engine != "batch":
            raise ValueError(
                f"engine must be 'batch'|'continuous', got {engine!r}"
            )
        # POST /reload is an ADMIN surface (it reads a bundle path off
        # the request): disabled unless explicitly enabled.
        self._allow_reload = allow_reload
        if allow_reload:
            # Fail at construction, not on the first POST /reload: a
            # model without reload_params (an AOT artifact) can never
            # honor the endpoint this flag enables.
            named = {"default": pipeline, **(extra_models or {})}
            for name, pipe_ in named.items():
                if not hasattr(pipe_, "reload_params"):
                    raise ValueError(
                        f"allow_reload=True but model {name!r} "
                        f"({type(pipe_).__name__}) has no reload_params "
                        "— AOT artifacts are immutable"
                    )
        if engine == "continuous":
            cont = dict(
                slots=max_batch,
                max_queue=max_queue,
                beam_width=bw,
                ticks_per_sync=ticks_per_sync,
            )
            self._images = ContinuousCaptionServer(pipeline, mode="images", **cont)
            self._features = ContinuousCaptionServer(pipeline, **cont)
        else:
            self._images = CaptionServer(pipeline, mode="images", **kw)
            self._features = CaptionServer(pipeline, mode="features", **kw)
        # name -> (pipeline, images server, features server); "default"
        # is the positional pipeline, extra models add their own pairs.
        self._models = {"default": (pipeline, self._images, self._features)}
        for name, extra in (extra_models or {}).items():
            self._models[name] = (
                extra,
                CaptionServer(extra, mode="images", **kw),
                CaptionServer(extra, mode="features", **kw),
            )
        self._httpd = _ThreadingHTTPServer(
            (host, port), self._make_handler()
        )
        self._thread: threading.Thread | None = None
        self._loop_started = False

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    def warmup(self) -> None:
        """Run every backing server's bucket shapes once, so the first
        request pays no first-use cost (cuDNN plans, cuBLAS handles, the
        allocator's pools). An images server is skipped when its model
        has no encoder path."""
        for pipe, images, features in self._models.values():
            if getattr(pipe.encoder, "input_size", None) is not None:
                images.warmup()
            features.warmup()

    def serve_background(self) -> tuple[str, int]:
        """Start serving on a daemon thread; returns (host, port)."""
        self._loop_started = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="tpucap-torch-http",
            daemon=True,
        )
        self._thread.start()
        return self.address

    def serve_forever(self) -> None:
        self._loop_started = True
        self._httpd.serve_forever()

    def close(self) -> None:
        # shutdown() deadlocks if serve_forever never started its loop
        # (it waits on an event only that loop sets).
        if self._loop_started:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=30)
        for _, images, features in self._models.values():
            images.close()
            features.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- handler -----------------------------------------------------------

    def _make_handler(self):
        outer = self

        def _resolve(name):
            """-> (images server, features server, input size,
            preprocess mode) for a model name ('' = default)."""
            try:
                pipe, images, features = outer._models[name or "default"]
            except KeyError:
                raise ValueError(
                    f"unknown model {name!r}; serving "
                    f"{sorted(outer._models)}"
                ) from None
            return (
                images,
                features,
                pipe.encoder.input_size,
                pipe.encoder.preprocess_mode,
            )

        class Handler(BaseHTTPRequestHandler):
            # Tests and production logs both want quiet request lines.
            def log_message(self, *a):  # noqa: N802
                pass

            def _reply(
                self, code: int, payload: dict, headers: dict = {}
            ):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    self._reply(
                        200,
                        {"ok": True, "backend": outer._pipe.device.type},
                    )
                elif self.path == "/stats":
                    if len(outer._models) == 1:
                        self._reply(
                            200,
                            {
                                "images": outer._images.stats(),
                                "features": outer._features.stats(),
                            },
                        )
                    else:
                        self._reply(
                            200,
                            {
                                name: {
                                    "images": im.stats(),
                                    "features": fe.stats(),
                                }
                                for name, (_, im, fe) in sorted(
                                    outer._models.items()
                                )
                            },
                        )
                elif self.path == "/metrics":
                    # Prometheus text exposition (version 0.0.4): the
                    # /stats content reshaped for a stock scrape job.
                    body = _prometheus_text(outer._models).encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path in ("/", "/demo"):
                    # Minimal browser demo: pick a JPEG, see the caption
                    # (pure stdlib on both ends; the fetch posts the raw
                    # bytes exactly like the curl examples).
                    body = _DEMO_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def _stream(self, server, x):
                """Stream a request's decoded words as ndjson lines.
                Bridges the engine thread's on_words callback to this
                handler thread through a queue (the callback must never
                block); the future's done-callback posts the sentinel,
                covering results AND failures."""
                import queue as _q

                spans: _q.Queue = _q.Queue()
                if not hasattr(server, "submit_stream"):
                    # Precise capability check: a broad AttributeError
                    # catch would misreport internal bugs as this 400.
                    self._reply(
                        400,
                        {
                            "error": "streaming needs "
                            "engine='continuous' (batch engine has no "
                            "token-progress surface)"
                        },
                    )
                    return
                try:
                    fut = server.submit_stream(
                        x, on_words=lambda ws: spans.put(ws)
                    )
                except (ValueError, Overloaded) as e:
                    code = 503 if isinstance(e, Overloaded) else 400
                    self._reply(code, {"error": str(e)})
                    return
                fut.add_done_callback(lambda f: spans.put(None))
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                # No Content-Length: connection-close framing.
                self.end_headers()
                while True:
                    try:
                        item = spans.get(timeout=120)
                    except _q.Empty:
                        # Headers are already out: an in-band error line
                        # instead of a second status line.
                        self.wfile.write(
                            (
                                json.dumps(
                                    {
                                        "done": True,
                                        "error": "stream timed out",
                                    }
                                )
                                + "\n"
                            ).encode()
                        )
                        return
                    if item is None:
                        break
                    self.wfile.write(
                        (json.dumps({"words": item}) + "\n").encode()
                    )
                    self.wfile.flush()
                final = {"done": True}
                try:
                    final["caption"] = fut.result(timeout=0)
                except Exception as e:
                    final["error"] = str(e)
                self.wfile.write((json.dumps(final) + "\n").encode())

            def do_POST(self):  # noqa: N802
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n < 0:
                        # read(-n) would block until EOF — reject.
                        raise ValueError
                except (TypeError, ValueError):
                    self._reply(
                        400, {"error": "bad Content-Length header"}
                    )
                    self.close_connection = True
                    return
                limit = outer._max_body_bytes
                if limit and n > limit:
                    # Reject BEFORE reading: the declared size alone
                    # earns the 413 — nothing oversized is ever
                    # buffered on the handler thread.
                    self._reply(
                        413,
                        {
                            "error": f"request body {n} bytes exceeds "
                            f"the server limit {limit} — split the "
                            "request (max_body_bytes / --max-body-mb)"
                        },
                        {"Connection": "close"},
                    )
                    self.close_connection = True
                    return
                body = self.rfile.read(n)
                from urllib.parse import parse_qs, urlsplit

                parts = urlsplit(self.path)
                route, query = parts.path, parts.query
                qs = parse_qs(query) if query else {}
                prefix = qs.get("prefix", [""])[0]
                include_words = [
                    w for w in qs.get("include_words", [""])[0].split(",")
                    if w.strip()
                ]
                model = qs.get("model", [""])[0]

                def _submit(server, x, prefix, include_words=()):
                    """Submit with the request's dials, which the batch
                    server serves; the continuous engines have neither
                    surface -> tpucap's 400."""
                    if not prefix and not include_words:
                        return server.submit(x)
                    if not isinstance(server, CaptionServer):
                        raise ValueError(
                            "prefix/include_words need engine='batch' "
                            "(the continuous engines have no "
                            "forced-prefix/constrained path)"
                        )
                    return server.submit(
                        x, prefix=prefix or None,
                        include_words=include_words or None,
                    )

                try:
                    if route == "/reload":
                        # Zero-downtime weight swap: {"bundle": path,
                        # "model": name?}. A model's batch servers share
                        # one pipeline, so ONE swap serves both endpoints;
                        # it waits until both batchers reach it, so no
                        # request of either (a /caption_batch may span
                        # batches) mixes old and new weights. The
                        # continuous engines each keep their own params
                        # snapshot, so both get the reload and the reply
                        # waits for both.
                        if not outer._allow_reload:
                            self._reply(
                                403,
                                {
                                    "error": "reload is disabled — "
                                    "start the server with "
                                    "allow_reload=True "
                                    "(`tpucap serve --allow-reload`)"
                                },
                            )
                            return
                        payload = json.loads(body)
                        bundle = payload["bundle"]
                        images, features, _, _ = _resolve(
                            payload.get("model", "") or model
                        )
                        if isinstance(images, CaptionServer):
                            futs = reload_together([images, features], bundle)
                        else:
                            futs = [
                                images.reload(bundle),
                                features.reload(bundle),
                            ]
                        for f in futs:
                            f.result(timeout=600)
                        self._reply(200, {"ok": True, "bundle": bundle})
                        return
                    elif route == "/caption":
                        images, _, size, pmode = _resolve(model)
                        x = _preprocess_jpeg(body, size, pmode)
                        fut = _submit(images, x, prefix, include_words)
                    elif route == "/caption_features":
                        payload = json.loads(body)
                        _, features, _, _ = _resolve(
                            payload.get("model", "") or model
                        )
                        feats = np.asarray(
                            payload["features"], np.float32
                        )
                        fut = _submit(
                            features,
                            feats,
                            payload.get("prefix", "") or prefix,
                            payload.get("include_words")
                            or include_words,
                        )
                    elif route == "/caption_batch":
                        # Many rows in ONE request. Rows are EITHER
                        # feature vectors ("features") OR base64 JPEGs
                        # ("images_b64": decoded and preprocessed on the
                        # HTTP thread, the encoder on the card). Rows
                        # are submitted together, so the micro-batcher
                        # coalesces them into one device batch.
                        payload = json.loads(body)
                        imgs_b64 = payload.get("images_b64")
                        if imgs_b64 is not None and (
                            "features" in payload
                        ):
                            raise ValueError(
                                "caption_batch takes features OR "
                                "images_b64, not both"
                            )
                        def _row_cap(srv) -> int:
                            # Per-request row cap: one request must not
                            # be able to fill the whole admission queue
                            # (and an unbounded-queue server still gets
                            # a sane ceiling). ValueError -> 400 via
                            # the handler.
                            cap = getattr(srv, "_max_queue", None)
                            return cap if cap is not None else 4096

                        def _check_cap(n_rows: int, cap: int):
                            if n_rows > cap:
                                raise ValueError(
                                    f"caption_batch got {n_rows} "
                                    f"rows, per-request cap is {cap} "
                                    "— split the request"
                                )

                        # Per-row dials: "prefixes" /
                        # "include_words_rows" give each row its own
                        # opening/constraint; validated length-first so
                        # a malformed request fails before decode work.
                        row_prefixes = payload.get("prefixes")
                        row_iw = payload.get("include_words_rows")

                        def _check_row_dials(n_rows: int):
                            for nm, v in (
                                ("prefixes", row_prefixes),
                                ("include_words_rows", row_iw),
                            ):
                                if v is None:
                                    continue
                                if (
                                    not isinstance(v, list)
                                    or len(v) != n_rows
                                ):
                                    raise ValueError(
                                        f"{nm} must be a list with "
                                        f"one entry per row "
                                        f"({n_rows}), got "
                                        f"{type(v).__name__}"
                                        + (
                                            f" of {len(v)}"
                                            if isinstance(v, list)
                                            else ""
                                        )
                                    )

                        # Dial plumbing resolved UP FRONT so every
                        # admission check (conflict, engine support)
                        # can run before any decode work is spent.
                        bprefix = payload.get("prefix", "") or prefix
                        biw = (
                            payload.get("include_words")
                            or include_words
                        )
                        per_row = (
                            row_prefixes is not None
                            or row_iw is not None
                        )
                        if (bprefix or biw) and per_row:
                            raise ValueError(
                                "caption_batch takes shared dials "
                                "(prefix/include_words) OR per-row "
                                "dials (prefixes/include_words_rows), "
                                "not both"
                            )

                        def _check_engine(srv):
                            if (
                                bprefix or biw or per_row
                            ) and not isinstance(srv, CaptionServer):
                                raise ValueError(
                                    "prefix/include_words need "
                                    "engine='batch' (the continuous "
                                    "engines have no forced-prefix/"
                                    "constrained path)"
                                )

                        if imgs_b64 is not None:
                            import base64

                            srv, _, size, pmode = _resolve(
                                payload.get("model", "") or model
                            )
                            if not isinstance(imgs_b64, list) or not (
                                imgs_b64
                            ):
                                raise ValueError(
                                    "images_b64 wants a non-empty "
                                    "LIST of base64 JPEG strings"
                                )
                            # EVERY admission check BEFORE any base64/
                            # JPEG work: a rejected request must cost
                            # its 400, not a full batch decode.
                            _check_cap(len(imgs_b64), _row_cap(srv))
                            _check_row_dials(len(imgs_b64))
                            _check_engine(srv)
                            blobs = [
                                base64.b64decode(b) for b in imgs_b64
                            ]
                            # ONE threaded C++ decode call for the
                            # whole request (the pool parallelizes
                            # across rows).
                            rows = _preprocess_jpeg_batch(
                                blobs, size, pmode
                            )
                        else:
                            _, srv, _, _ = _resolve(
                                payload.get("model", "") or model
                            )
                            rows = np.asarray(
                                payload["features"], np.float32
                            )
                            if rows.ndim < 2:
                                raise ValueError(
                                    "caption_batch wants a LIST of "
                                    f"feature rows, got shape "
                                    f"{rows.shape} — use "
                                    "/caption_features for one row"
                                )
                            _check_cap(rows.shape[0], _row_cap(srv))
                            _check_row_dials(rows.shape[0])
                            _check_engine(srv)
                        # Atomic admission (submit_many): dials and
                        # shapes validate BEFORE anything enqueues and
                        # the capacity check covers the whole set, so
                        # a failed batch never leaves accepted rows
                        # behind for the batcher to decode after the
                        # client already got its 400/503.
                        if per_row:
                            futs = srv.submit_many(
                                rows,
                                prefixes=row_prefixes,
                                include_words_rows=row_iw,
                            )
                        elif isinstance(srv, CaptionServer):
                            futs = srv.submit_many(
                                rows,
                                prefix=bprefix or None,
                                include_words=biw or None,
                            )
                        else:
                            futs = srv.submit_many(rows)
                        # Resolution failures are server-side (500),
                        # unlike the admission errors mapped to 400
                        # by the enclosing handler — same split as
                        # the single-row tail below.
                        try:
                            caps = [
                                f.result(timeout=120) for f in futs
                            ]
                        except Exception as e:
                            self._reply(500, {"error": str(e)})
                            return
                        self._reply(200, {"captions": caps})
                        return
                    elif route == "/caption_stream":
                        if prefix or include_words:
                            # The streaming path has no forced-prefix /
                            # constrained surface — reject loudly rather
                            # than stream an unmodified caption with 200.
                            raise ValueError(
                                "prefix/include_words are not supported "
                                "on the streaming routes; use /caption"
                            )
                        images, _, size, pmode = _resolve(model)
                        self._stream(
                            images, _preprocess_jpeg(body, size, pmode)
                        )
                        return
                    elif route == "/caption_stream_features":
                        payload = json.loads(body)
                        if (
                            prefix
                            or payload.get("prefix")
                            or include_words
                            or payload.get("include_words")
                        ):
                            raise ValueError(
                                "prefix/include_words are not supported "
                                "on the streaming routes; use "
                                "/caption_features"
                            )
                        _, features, _, _ = _resolve(
                            payload.get("model", "") or model
                        )
                        self._stream(
                            features,
                            np.asarray(payload["features"], np.float32),
                        )
                        return
                    else:
                        self._reply(404, {"error": f"no route {self.path}"})
                        return
                except Overloaded as e:
                    # Backpressure: shed load instead of queueing
                    # unboundedly; clients retry after the batch window.
                    self._reply(
                        503, {"error": str(e)}, {"Retry-After": "1"}
                    )
                    return
                except Exception as e:
                    self._reply(400, {"error": str(e)})
                    return
                try:
                    self._reply(200, {"caption": fut.result(timeout=120)})
                except Exception as e:
                    self._reply(500, {"error": str(e)})

        return Handler


_DEMO_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>tpucap demo</title><style>
body{font-family:system-ui,sans-serif;max-width:640px;margin:3rem auto;
     padding:0 1rem;color:#222}
img{max-width:100%;margin-top:1rem;border-radius:6px}
#cap{margin-top:1rem;font-size:1.2rem;min-height:1.5rem}
.err{color:#b00}
</style></head><body>
<h1>tpucap</h1>
<p>Pick a JPEG; it is POSTed to <code>/caption</code> as raw bytes.
Optional: force a caption opening (batch engine only).</p>
<input type="text" id="p" placeholder="prefix, e.g. 'a dog'" size="28">
<input type="file" id="f" accept="image/jpeg">
<div id="cap"></div><img id="img" hidden>
<script>
document.getElementById('f').addEventListener('change', async (e) => {
  const file = e.target.files[0];
  if (!file) return;
  const img = document.getElementById('img');
  img.src = URL.createObjectURL(file); img.hidden = false;
  const cap = document.getElementById('cap');
  cap.textContent = 'captioning…'; cap.className = '';
  const prefix = document.getElementById('p').value.trim();
  const url = prefix
    ? '/caption?prefix=' + encodeURIComponent(prefix) : '/caption';
  try {
    const r = await fetch(url, {method: 'POST', body: file});
    const d = await r.json();
    if (!r.ok) throw new Error(d.error || r.status);
    cap.textContent = d.caption;
  } catch (err) {
    cap.textContent = 'error: ' + err.message; cap.className = 'err';
  }
});
</script></body></html>
"""
