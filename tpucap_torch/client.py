"""Python client of the HTTP serving layer (tpucap's ``tpucap/client.py``,
the port's own copy): a dependency-free ``CaptionClient`` that speaks every
endpoint of ``tpucap_torch.serve_http`` (and of tpucap's server, which has
the same routes) — caption from JPEG bytes or feature rows, per-request
dials, ndjson streaming, multi-model routing, weight reload, and the
stats / health / metrics surfaces:

    from tpucap_torch.client import CaptionClient
    client = CaptionClient("127.0.0.1", 8000)
    caption = client.caption(open("dog.jpg", "rb").read())

- Standard library only (``http.client`` + ``json``): the module imports
  neither torch nor numpy, so it drops into any client process.
- One connection per request; the server threads requests and its
  micro-batcher coalesces them, so pooling buys nothing and the client is
  trivially thread-safe. :meth:`caption_many` is the intended concurrency
  shape.
- A non-200 status raises :class:`ServerError` carrying the status code and
  the server's ``{"error": ...}`` message verbatim. The dials (``prefix``,
  ``include_words``) need the batch engine and the streaming routes the
  continuous one (``serve --engine continuous``); the other engine answers
  400, as tpucap's does.
"""

from __future__ import annotations

import http.client
import json
from typing import Callable, Iterable, Sequence


class ServerError(RuntimeError):
    """An HTTP endpoint returned a non-200 status.

    ``status`` is the HTTP code (400 bad request, 403 reload disabled,
    404 unknown route, 413 body too large, 500 a failed batch, 503
    overloaded); ``str(e)`` is the server's own error message."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class CaptionClient:
    """Client for one caption server (``python -m tpucap_torch serve``, or
    tpucap's ``tpucap serve``).

    ``model`` picks a non-primary model on a multi-model server
    (``--extra-model``); per-call ``model=`` overrides it. ``timeout``
    is the per-request socket timeout in seconds — captions resolve in
    one micro-batch flush, but the FIRST request after a cold start may
    wait on first-use setup unless the server was started with warmup
    (the CLI default), so the default is generous."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8000,
        *,
        model: str = "",
        timeout: float = 300.0,
    ):
        self.host = host
        self.port = int(port)
        self.model = model
        self.timeout = timeout

    # -- plumbing ----------------------------------------------------------

    def _query(
        self,
        model: str | None,
        prefix: str | None = None,
        include_words: Sequence[str] | None = None,
    ) -> str:
        from urllib.parse import urlencode

        q = {}
        m = self.model if model is None else model
        if m:
            q["model"] = m
        if prefix:
            q["prefix"] = prefix
        if include_words:
            if isinstance(include_words, (str, bytes)):
                raise TypeError(
                    "include_words must be a sequence of words, got a "
                    f"string {include_words!r}"
                )
            q["include_words"] = ",".join(include_words)
        return "?" + urlencode(q) if q else ""

    def _request(
        self, method: str, path: str, body: bytes | None = None
    ) -> dict:
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        try:
            payload = json.loads(raw)
        except ValueError:
            # A 200 whose body is not JSON is a broken server (or a
            # proxy in the path) — raise it as such instead of
            # returning a synthesized dict that fails callers with a
            # bare KeyError('caption') later.
            text = raw.decode("utf-8", "replace")
            raise ServerError(
                resp.status,
                f"non-JSON response body: {text[:500]!r}",
            ) from None
        if resp.status != 200:
            raise ServerError(
                resp.status, str(payload.get("error", payload))
            )
        return payload

    # -- captioning --------------------------------------------------------

    def caption(
        self,
        jpeg: bytes,
        *,
        prefix: str | None = None,
        include_words: Sequence[str] | None = None,
        model: str | None = None,
    ) -> str:
        """Caption one JPEG (raw file bytes -> ``POST /caption``).

        ``prefix`` forces the caption's opening words; ``include_words``
        constrains the caption to contain every listed word (the server
        must run the batch engine with beam decode for either)."""
        q = self._query(model, prefix, include_words)
        return self._request("POST", "/caption" + q, jpeg)["caption"]

    def caption_features(
        self,
        features: Sequence[float],
        *,
        prefix: str | None = None,
        include_words: Sequence[str] | None = None,
        model: str | None = None,
    ) -> str:
        """Caption one precomputed feature row (``POST
        /caption_features`` — the reference's pickled-features serving
        shape). ``features`` is any nested sequence JSON can carry
        (``np.asarray(x).tolist()`` for arrays)."""
        if hasattr(features, "tolist"):
            features = features.tolist()
        body = {"features": features}
        m = self.model if model is None else model
        if m:
            body["model"] = m
        if prefix:
            body["prefix"] = prefix
        if include_words:
            if isinstance(include_words, (str, bytes)):
                raise TypeError(
                    "include_words must be a sequence of words, got a "
                    f"string {include_words!r}"
                )
            body["include_words"] = list(include_words)
        return self._request(
            "POST", "/caption_features", json.dumps(body).encode()
        )["caption"]

    def caption_features_many(
        self,
        rows,
        *,
        prefix: str | None = None,
        include_words: Sequence[str] | None = None,
        prefixes: Sequence[str] | None = None,
        include_words_rows: Sequence[Sequence[str]] | None = None,
        model: str | None = None,
    ) -> list[str]:
        """Caption MANY feature rows in one request (``POST
        /caption_batch``) — the single-connection alternative to
        :meth:`caption_many`'s thread fan-out; the server submits the
        rows together so its micro-batcher coalesces them into one
        device batch. ``prefix``/``include_words`` apply to every row;
        ``prefixes``/``include_words_rows`` give each row its own
        dial (one entry per row; "" / [] = none for that row)."""
        if hasattr(rows, "tolist"):
            rows = rows.tolist()
        body = {"features": list(rows)}
        m = self.model if model is None else model
        if m:
            body["model"] = m
        self._add_batch_dials(
            body, prefix, include_words, prefixes, include_words_rows
        )
        return self._request(
            "POST", "/caption_batch", json.dumps(body).encode()
        )["captions"]

    @staticmethod
    def _add_batch_dials(
        body, prefix, include_words, prefixes, include_words_rows
    ) -> None:
        """Shared /caption_batch dial plumbing (shared XOR per-row —
        the server enforces the same rule; failing here saves a
        round-trip)."""
        per_row = prefixes is not None or include_words_rows is not None
        if per_row and (prefix or include_words):
            raise TypeError(
                "pass shared dials (prefix/include_words) OR per-row "
                "dials (prefixes/include_words_rows), not both"
            )
        if prefix:
            body["prefix"] = prefix
        if include_words:
            if isinstance(include_words, (str, bytes)):
                raise TypeError(
                    "include_words must be a sequence of words, got a "
                    f"string {include_words!r}"
                )
            body["include_words"] = list(include_words)
        if prefixes is not None:
            if isinstance(prefixes, (str, bytes)):
                raise TypeError(
                    "prefixes must be a sequence of per-row strings, "
                    f"got a string {prefixes!r}"
                )
            body["prefixes"] = list(prefixes)
        if include_words_rows is not None:
            rows_out = []
            for i, w in enumerate(include_words_rows):
                if isinstance(w, (str, bytes)):
                    # list("dog") would silently become single letters
                    # — the same trap the shared path guards against.
                    raise TypeError(
                        f"include_words_rows[{i}] must be a sequence "
                        f"of words, got a string {w!r}"
                    )
                rows_out.append(list(w))
            body["include_words_rows"] = rows_out

    def caption_jpegs_many(
        self,
        jpegs: Iterable[bytes],
        *,
        prefix: str | None = None,
        include_words: Sequence[str] | None = None,
        prefixes: Sequence[str] | None = None,
        include_words_rows: Sequence[Sequence[str]] | None = None,
        model: str | None = None,
    ) -> list[str]:
        """Caption MANY JPEGs in one request (``POST /caption_batch``
        with base64 rows) — the single-connection alternative to
        :meth:`caption_many`: the server decodes/preprocesses the rows,
        runs the encoder on the card, and its micro-batcher coalesces
        them into one device batch. ``prefix``/``include_words`` apply to every row;
        ``prefixes``/``include_words_rows`` give each row its own
        dial."""
        import base64

        blobs = list(jpegs)
        if not blobs:
            return []
        body = {
            "images_b64": [
                base64.b64encode(b).decode("ascii") for b in blobs
            ]
        }
        m = self.model if model is None else model
        if m:
            body["model"] = m
        self._add_batch_dials(
            body, prefix, include_words, prefixes, include_words_rows
        )
        return self._request(
            "POST", "/caption_batch", json.dumps(body).encode()
        )["captions"]

    def caption_many(
        self,
        jpegs: Iterable[bytes],
        *,
        model: str | None = None,
        max_workers: int = 32,
    ) -> list[str]:
        """Caption many JPEGs concurrently (one thread per in-flight
        request, order preserved). Concurrent submission is what lets
        the server's micro-batcher coalesce requests into one
        device batch — a serial loop would decode batch-1 each
        time. Raises the first failure after all requests settle."""
        from concurrent.futures import ThreadPoolExecutor

        blobs = list(jpegs)
        if not blobs:
            return []
        with ThreadPoolExecutor(min(max_workers, len(blobs))) as pool:
            futs = [
                pool.submit(self.caption, b, model=model) for b in blobs
            ]
            return [f.result() for f in futs]

    # -- streaming ---------------------------------------------------------

    def caption_stream(
        self,
        jpeg: bytes,
        on_words: Callable[[list[str]], None] | None = None,
        *,
        model: str | None = None,
    ) -> str:
        """Stream a caption as it decodes (``POST /caption_stream``,
        continuous engine required server-side). ``on_words`` receives
        each word span as it lands; the spans concatenate to exactly
        the returned final caption (the server's exact-concatenation
        contract). Returns the final caption."""
        return self._stream("/caption_stream", jpeg, on_words, model)

    def caption_stream_features(
        self,
        features: Sequence[float],
        on_words: Callable[[list[str]], None] | None = None,
        *,
        model: str | None = None,
    ) -> str:
        if hasattr(features, "tolist"):
            features = features.tolist()
        body = json.dumps({"features": features}).encode()
        return self._stream(
            "/caption_stream_features", body, on_words, model
        )

    def _stream(self, route, body, on_words, model) -> str:
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        try:
            conn.request("POST", route + self._query(model), body=body)
            resp = conn.getresponse()
            if resp.status != 200:
                raw = resp.read()
                try:
                    msg = json.loads(raw).get("error", raw.decode())
                except ValueError:
                    msg = raw.decode("utf-8", "replace")
                raise ServerError(resp.status, str(msg))
            # ndjson with connection-close framing: read lines to EOF.
            final = None
            buf = b""
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    event = json.loads(line)
                    if "error" in event:
                        raise ServerError(200, str(event["error"]))
                    if event.get("done"):
                        final = event.get("caption", "")
                    elif on_words is not None and event.get("words"):
                        on_words(list(event["words"]))
            if final is None:
                raise ServerError(
                    200, "stream ended without a done event"
                )
            return final
        finally:
            conn.close()

    # -- admin / monitoring ------------------------------------------------

    def reload(self, bundle: str, *, model: str | None = None) -> dict:
        """Hot-swap the served weights from a ``pipeline.save()``
        bundle directory ON THE SERVER's filesystem (``POST /reload``;
        the server must run ``--allow-reload``)."""
        body = {"bundle": bundle}
        m = self.model if model is None else model
        if m:
            body["model"] = m
        return self._request("POST", "/reload", json.dumps(body).encode())

    def healthz(self) -> dict:
        return self._request("GET", "/healthz")

    def stats(self) -> dict:
        return self._request("GET", "/stats")

    def metrics(self) -> str:
        """The raw Prometheus text exposition (``GET /metrics``)."""
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        try:
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        if resp.status != 200:
            raise ServerError(resp.status, raw.decode("utf-8", "replace"))
        return raw.decode()
