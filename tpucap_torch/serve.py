"""Online serving over a built pipeline (tpucap's ``tpucap/serve.py``): the
micro-batching ``CaptionServer`` (batch engine) and the slot-recycling
``ContinuousCaptionServer`` (continuous engine, token streaming).

- Requests enqueue from any thread; ONE batcher thread owns the pipeline's
  device work for this server.
- The batcher coalesces up to ``max_batch`` requests, waiting at most
  ``max_delay_ms`` after the first arrival (size-or-deadline
  micro-batching).
- Batches are zero-padded UP to the power-of-two bucket ladder, as in
  tpucap, where each bucket is one compiled program. Eager PyTorch compiles
  nothing, but the ladder keeps the served shapes (and the kernels'
  launch shapes) those of tpucap's server, and ``warmup()`` runs each one
  once (cuDNN plans, cuBLAS handles, the allocator's pools).

Several servers may share one pipeline (``serve_http``'s images and
features pair) or one card (several models): each pipeline's device work
runs under its own precision flags (``core.precision_flags``), and a
``reload`` swaps the params between whole batches. ``reload_together``
swaps once for every server of a pipeline, when each of them has reached
the reload in its queue, so that no request of any of them (a multi-row
request may span batches) is decoded partly on the old weights and partly
on the new.

``ContinuousCaptionServer`` retires a request's lanes the moment it ends
and refills them (``decode/continuous.py``, ``decode/continuous_beam.py``),
and streams each request's words as they decode.

The batch engine takes tpucap's per-request dials: ``prefix`` (forced
caption opening, ``pipeline.generate_continuation_submit``) and
``include_words`` (must-include words, ``generate_constrained_submit``),
checked at admission so a bad dial fails its own request. Each queued row
carries its dials; a batch with any constrained row splits those rows into
a dispatch of their own (the 2^C banks must not tax the others), with C
bucketed to 1, 2 or 4. In images mode each route encodes and decodes on one
snapshot of the params. tpucap's continuous engines have no such dials.

A batch server with ``method="sample"`` decodes each batch synchronously
through the pipeline's sampling engine (``decode/sample.py``) at seed 0, as
tpucap's does; it takes neither dial (tpucap's 400 texts). The continuous
server stays greedy and beam, as in tpucap.
"""

from __future__ import annotations

import queue
import threading
import time
import typing
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from tpucap_torch.train.loop import refuse_unported


class Overloaded(RuntimeError):
    """Raised by submit() when the request queue is at max_queue —
    backpressure instead of unbounded latency growth."""


def _fail_futures(futs, exc: BaseException) -> None:
    """Best-effort set_exception on every future that is still pending
    (cancelled/already-resolved ones raise InvalidStateError — skip)."""
    for fut in futs:
        try:
            fut.set_exception(exc)
        except Exception:
            pass


def _resolve(fut: Future, caption) -> None:
    """set_result tolerant of cancelled AND already-failed futures (a
    wedged-then-recovered batcher may retire a request close() already
    timed out — the late result is dropped, not a thread crash)."""
    try:
        fut.set_result(caption)
    except Exception:
        pass


# How long a server that reached a shared swap waits for the others.
SWAP_TIMEOUT_S = 600.0


class _Swap:
    """One weight swap shared by several servers of one pipeline. Each
    batcher reaches its reload item between its batches, retires its
    in-flight batches and waits here; the last to arrive swaps, and then
    every batcher goes on. Everything queued before the reload, in any of
    the servers, is decoded on the old weights; everything after, on the
    new."""

    def __init__(self, pipe, source, n: int):
        self._pipe, self._source = pipe, source
        self._error: Exception | None = None
        self._barrier = threading.Barrier(n, action=self._swap)

    def _swap(self) -> None:
        try:
            self._pipe.reload_params(self._source)
        except Exception as e:  # every server's reload future carries it
            self._error = e

    def abort(self) -> None:
        self._barrier.abort()

    def wait(self) -> None:
        try:
            self._barrier.wait(timeout=SWAP_TIMEOUT_S)
        except threading.BrokenBarrierError:
            raise RuntimeError(
                "reload abandoned: another server of this pipeline did not "
                "reach it (closed, wedged or refused)"
            ) from None
        if self._error is not None:
            raise self._error


class _Reload(typing.NamedTuple):
    """Queue control item for weight hot-reload. A NamedTuple so the
    wedge-path _drain_pending (which finds each item's Future
    positionally by iterating) fails its future like any request's.
    ``swap`` is set when the swap is shared with other servers."""

    source: object
    future: Future
    swap: _Swap | None = None


def _drain_pending(q: queue.Queue) -> list:
    """Pop every queued request and return the futures. Re-puts ONE
    close sentinel afterwards: a wedged worker that eventually recovers
    must still see the shutdown signal, or it would park on the empty
    queue forever. The Future is found positionally."""
    futs = []
    while True:
        try:
            item = q.get_nowait()
        except queue.Empty:
            break
        if item is not None:
            if isinstance(item, _Reload) and item.swap is not None:
                item.swap.abort()  # the other servers stop waiting for it
            futs.append(next(f for f in item if isinstance(f, Future)))
    q.put(None)
    return futs


def _snapshot(fn, attempts: int = 5):
    """Copy a container a slow-but-alive worker thread may still be
    mutating (close()'s join timing out means slow, not stopped):
    retry on the mutated-during-iteration RuntimeError."""
    for _ in range(attempts):
        try:
            return fn()
        except RuntimeError:
            time.sleep(0.01)
    return []


def _buckets(max_batch: int) -> list[int]:
    """Power-of-two ladder 1, 2, 4, ..., max_batch (max_batch included
    even when not a power of two)."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


@dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    padded_rows: int = 0  # wasted decode rows from bucket padding
    # Rolling window of per-request e2e latencies: a long-running server
    # must not grow host memory per request, so percentiles reflect the
    # last N requests (deque maxlen). The lock covers append vs the
    # snapshot() sort — /stats runs on HTTP handler threads while the
    # batcher appends, and iterating a mutating deque raises.
    latencies_ms: deque = field(default_factory=lambda: deque(maxlen=10_000))
    lock: threading.Lock = field(default_factory=threading.Lock)

    def add_latency(self, ms: float) -> None:
        with self.lock:
            self.latencies_ms.append(ms)

    def snapshot(self) -> dict:
        with self.lock:
            lat = sorted(self.latencies_ms)
        p = lambda q: lat[int(q * (len(lat) - 1))] if lat else None
        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_batch": self.requests / self.batches if self.batches else 0,
            "padded_rows": self.padded_rows,
            "p50_ms": p(0.5),
            "p99_ms": p(0.99),
        }


class CaptionServer:
    """Micro-batching front-end for ``CaptioningPipeline``.

    mode='features': ``submit`` takes a feature vector (encoder output,
    the reference's pickled-features serving shape). mode='images':
    ``submit`` takes a preprocessed image array (size, size, 3) and the
    batch runs encoder + decode on the pipeline's device
    (``pipeline.encode_submit``: both on one snapshot of the params).

    decode kwargs (method/beam_width) are fixed at server construction.
    method 'sample' decodes each batch synchronously (``generate``'s
    sampling defaults, seed 0 a batch, as tpucap's server); in images mode
    on one snapshot of the params. ``parallelism`` other than none raises
    NotImplementedError.
    """

    def __init__(
        self,
        pipeline,
        *,
        mode: str = "features",
        max_batch: int = 64,
        max_delay_ms: float = 5.0,
        method: str | None = None,
        beam_width: int | None = None,
        parallelism: str | None = None,
        pipeline_depth: int = 1,
        max_queue: int | None = None,
        max_prefix_tokens: int | None = None,
    ):
        if mode not in ("features", "images"):
            raise ValueError(f"mode must be 'features'|'images', got {mode!r}")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        refuse_unported(parallelism=(parallelism if parallelism != "none" else None, None))
        resolved = method or pipeline.config.decode.method
        if resolved not in ("greedy", "beam", "sample"):
            # tpucap's server runs a plain beam search for any other method
            # name; the port refuses rather than run another method than the
            # one asked for (the offline modes are the pipeline's
            # generate_diverse / generate_mbr / generate_ensemble).
            raise NotImplementedError(
                f"method {resolved!r} is not served by tpucap_torch's server "
                "(greedy|beam|sample; diverse, mbr and ensembles are offline "
                "decode modes of the pipeline)"
            )
        # Per-request forced-prefix token cap, tpucap's admission rule.
        self._max_prefix_tokens = (
            max_prefix_tokens
            if max_prefix_tokens is not None
            else pipeline.config.decode.max_len
        )
        self._pipe = pipeline
        self._mode = mode
        self._max_batch = max_batch
        self._max_delay_s = max_delay_ms / 1e3
        self._decode_kw = dict(method=method, beam_width=beam_width, parallelism=parallelism)
        # pipeline_depth > 1 dispatches up to that many batches before
        # retiring the oldest (its copy back and detokenizing), as tpucap's
        # server does with generate_submit. tpucap measured depth 1 winning
        # under closed-loop load (batches grow while the batcher drains);
        # the port's decode checks on the host every few steps, so less of
        # a batch is left to overlap.
        self._depth = max(1, pipeline_depth)
        self._inflight: deque = deque()
        # Sampling goes through the synchronous generate(), each batch
        # under tpucap's default seed 0, as in tpucap.
        self._async_ok = resolved != "sample"
        self._buckets = _buckets(max_batch)
        self._current_futs: tuple = ()  # batch mid-dispatch (wedge path)
        # Bounded admission: reject (Overloaded) rather than queue without
        # limit — the HTTP layer maps this to 503 + Retry-After.
        self._max_queue = max_queue
        self._queue: queue.Queue = queue.Queue()
        self._stats = ServerStats()
        self._closed = False
        # Serializes submit() against close(): without it a submitter can
        # pass the closed check, lose the CPU, and enqueue after the
        # batcher consumed the close sentinel — a Future nobody resolves.
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._batcher, name="tpucap-torch-serve-batcher", daemon=True
        )
        self._thread.start()

    # -- client surface ----------------------------------------------------

    def submit(self, x, prefix: str | None = None, include_words=None) -> Future:
        """Enqueue one request; resolves to the caption string.

        ``prefix``: a forced caption opening ("a dog"); the caption is the
        prefix plus the model's continuation (greedy or beam).
        ``include_words``: words the caption must contain (beam servers
        only; up to 4). Both are validated here, so a bad dial fails this
        request alone (ValueError), never the batch it would ride in. Where
        full satisfaction is unreachable the caption of the most-satisfied
        bank comes back, as offline."""
        x = np.asarray(x)
        expect = self._expected_shape()
        if x.shape != expect:
            raise ValueError(
                f"request shape {x.shape} != expected {expect} (mode={self._mode!r})"
            )
        iw = self._validate_dials(prefix, include_words)
        return self._enqueue_rows([x], prefix or "", iw)[0]

    def submit_many(
        self,
        xs,
        prefix: str | None = None,
        include_words=None,
        *,
        prefixes=None,
        include_words_rows=None,
    ) -> list[Future]:
        """Enqueue MANY rows in one atomic admission — all rows are
        accepted or none are. The shared dials (``prefix`` /
        ``include_words``) and the per-row ones (``prefixes`` /
        ``include_words_rows``, length-N lists, "" / [] = none for a row)
        are checked as tpucap checks them, every row before anything
        enqueues, and the capacity check covers the whole set under the
        submit lock, so a multi-row request is never half-admitted."""
        xs = np.asarray(xs)
        expect = self._expected_shape()
        if xs.ndim != len(expect) + 1 or xs.shape[1:] != expect:
            raise ValueError(
                f"submit_many wants shape (N, *{expect}), got "
                f"{xs.shape} (mode={self._mode!r})"
            )
        if xs.shape[0] == 0:
            return []
        if prefixes is None and include_words_rows is None:
            iw = self._validate_dials(prefix, include_words)
            return self._enqueue_rows(list(xs), prefix or "", iw)
        if prefix or include_words:
            raise ValueError(
                "submit_many takes shared dials (prefix/include_words) "
                "OR per-row dials (prefixes/include_words_rows), not "
                "both"
            )
        n = xs.shape[0]
        if prefixes is None:
            prefixes = [""] * n
        if include_words_rows is None:
            include_words_rows = [()] * n
        if isinstance(prefixes, (str, bytes)):
            raise ValueError(
                "prefixes must be a LIST of per-row strings (use "
                "prefix= for one shared opening)"
            )
        if len(prefixes) != n or len(include_words_rows) != n:
            raise ValueError(
                f"per-row dials must match the {n} rows: got "
                f"{len(prefixes)} prefixes, "
                f"{len(include_words_rows)} include_words_rows"
            )
        # Validate EVERY row's dial up front (admission atomicity: a bad
        # row-3 dial fails the whole request before row 0 enqueues).
        row_dials = []
        for i, (p, w) in enumerate(zip(prefixes, include_words_rows)):
            p = p or ""
            try:
                iw = self._validate_dials(p, w)
            except ValueError as e:
                raise ValueError(f"row {i}: {e}") from None
            row_dials.append((p, iw))
        return self._enqueue_rows_dials(list(xs), row_dials)

    def _validate_dials(self, prefix, include_words) -> tuple:
        """Admission-time check of one request's dials, tpucap's rules and
        texts -> the include_words tuple. Raises, so a bad dial fails its
        own request, never the batch it lands in."""
        method = self._decode_kw["method"] or self._pipe.config.decode.method
        if prefix:
            if method not in ("greedy", "beam"):
                raise ValueError(f"prefix needs method greedy|beam, server runs {method!r}")
            if self._decode_kw["parallelism"] not in (None, "none"):
                raise ValueError("prefix is not supported with mesh-parallel decode")
            (toks,) = self._pipe.encode_prefixes([prefix])  # OOV -> raise
            n_tok = len(toks)
            if n_tok > self._max_prefix_tokens:
                raise ValueError(
                    f"prefix has {n_tok} tokens, server cap is "
                    f"max_prefix_tokens={self._max_prefix_tokens}"
                )
            max_pos = getattr(self._pipe.decoder, "max_positions", None)
            if max_pos is not None and n_tok:
                padded = 1 << (n_tok - 1).bit_length()
                max_len = self._pipe.config.decode.max_len
                if max(padded, n_tok + max_len) > max_pos:
                    raise ValueError(
                        f"prefix length {n_tok} (padded to {padded}) + "
                        f"max_len {max_len} exceeds decoder."
                        f"max_positions {max_pos}"
                    )
        if include_words:
            if isinstance(include_words, (str, bytes)):
                raise ValueError(
                    "include_words must be a list of words, got a "
                    f"string {include_words!r}"
                )
            if prefix:
                raise ValueError("a request takes prefix OR include_words, not both")
            if method != "beam":
                raise ValueError(f"include_words needs method beam, server runs {method!r}")
            if self._decode_kw["parallelism"] not in (None, "none"):
                raise ValueError("include_words is not supported with mesh-parallel decode")
            if self._pipe.config.decode.no_repeat_ngram_size:
                raise ValueError(
                    "include_words does not compose with "
                    "no_repeat_ngram_size (generate_constrained's "
                    "refusal, surfaced at admission)"
                )
            iw = tuple(str(w) for w in include_words)
            # The whole word check now (OOV, phrase, duplicate, sentinel,
            # num_words cap), so a bad constraint fails its own request.
            self._pipe._constraint_ids([list(iw)], 1)
            return iw
        return ()

    def _enqueue_rows(self, rows: list, prefix: str = "", iw: tuple = ()) -> list[Future]:
        """Capacity-check and enqueue a set of validated rows under ONE
        lock acquisition: admission is atomic for the whole set (and
        against concurrent submitters)."""
        return self._enqueue_rows_dials(rows, [(prefix, iw)] * len(rows))

    def _enqueue_rows_dials(self, rows: list, dials: list) -> list[Future]:
        """Atomic admission with a validated (prefix, include_words) dial
        per row."""
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            if self._max_queue is not None and (
                self._queue.qsize() + len(rows) > self._max_queue
            ):
                raise Overloaded(f"request queue at max_queue={self._max_queue}")
            now = time.perf_counter()
            futs: list[Future] = []
            for x, (prefix, iw) in zip(rows, dials):
                fut: Future = Future()
                self._queue.put((x, prefix, iw, fut, now))
                futs.append(fut)
        return futs

    def caption(self, x, timeout: float | None = 60.0) -> str:
        """Blocking single-request convenience wrapper."""
        return self.submit(x).result(timeout=timeout)

    def reload(self, source) -> Future:
        """Hot-swap model weights with zero downtime: enqueue a reload
        that the batcher applies BETWEEN micro-batches (in-flight
        batches drain first), so requests submitted before this call
        resolve under the old weights and later ones under the new.
        ``source`` as in pipeline.reload_params (a pipeline.save()
        bundle dir or a same-topology params tree). On validation
        failure the returned Future carries the error and the server
        keeps serving the old weights."""
        return self._enqueue_reload(source, None)

    def _enqueue_reload(self, source, swap: _Swap | None) -> Future:
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._queue.put(_Reload(source, fut, swap))
        return fut

    def _apply_reload(self, item: _Reload) -> None:
        """Drain every in-flight batch, then swap. Every batch retired
        before the reload future resolves used the old weights; a batch of
        another server on the same pipeline holds the tree it began with
        (the pipeline's params are read once a batch); ``reload_together``
        makes the others wait for it."""
        while self._inflight:
            self._drain_one()
        try:
            if item.swap is None:
                self._pipe.reload_params(item.source)
            else:
                item.swap.wait()
        except Exception as e:
            _fail_futures([item.future], e)
            return
        _resolve(item.future, True)

    def warmup(self, timeout: float | None = None) -> None:
        """Run every bucket shape once before serving traffic. ``timeout``
        accepted for signature parity with tpucap's (this one runs inline,
        not through the queue)."""
        del timeout
        expect = self._expected_shape()
        for b in self._buckets:
            batch = np.zeros((b,) + expect, np.float32)
            self._run_batch(batch)

    def stats(self) -> dict:
        return self._stats.snapshot()

    def close(self, timeout: float = 30.0) -> None:
        """Drain the queue, stop the batcher. Idempotent. If the batcher
        is wedged past ``timeout``, every pending future is failed with a
        TimeoutError instead of leaving callers blocked forever in
        result()."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # sentinel
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            exc = TimeoutError(
                f"serve batcher did not drain within {timeout}s at "
                f"close (wedged in device dispatch?); request abandoned"
            )
            futs = _drain_pending(self._queue)
            for _, bfuts, _ in _snapshot(lambda: list(self._inflight)):
                futs.extend(bfuts)
            futs.extend(self._current_futs)  # the batch mid-dispatch
            _fail_futures(futs, exc)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- batcher -----------------------------------------------------------

    def _expected_shape(self) -> tuple:
        if self._mode == "images":
            s = self._pipe.encoder.input_size
            return (s, s, 3)
        cfg = self._pipe.config.encoder
        if cfg.features == "spatial":
            # attention serving: flattened (positions, channels) grid, the
            # encoder's own grid.
            return (self._pipe.encoder.spatial_positions, cfg.feature_dim)
        return (cfg.feature_dim,)

    def _run_batch(self, batch: np.ndarray) -> list[str]:
        return self._submit_batch(batch)()

    def _submit_batch(self, batch: np.ndarray, prefixes=None, include_words=None):
        """Dispatch one padded batch; returns a zero-arg finalizer that
        waits for the tokens and yields the captions. ``prefixes`` (per-row
        strings, "" = none) routes the batch through the continuation;
        ``include_words`` (per-row word lists, [] = none) through the
        constrained beam with C bucketed to 1, 2 or 4. In images mode every
        route encodes and decodes on one snapshot of the params."""
        images = self._mode == "images"
        beam_width = self._decode_kw["beam_width"]
        if include_words is not None:
            max_c = max(len(r) for r in include_words)
            c_bucket = 1 if max_c <= 1 else (2 if max_c <= 2 else 4)
            submit = (
                self._pipe.encode_constrained_submit
                if images
                else self._pipe.generate_constrained_submit
            )
            return submit(batch, include_words, beam_width=beam_width, num_slots=c_bucket)
        kw = dict(method=self._decode_kw["method"], beam_width=beam_width)
        if prefixes is not None:
            submit = (
                self._pipe.encode_continuation_submit
                if images
                else self._pipe.generate_continuation_submit
            )
            return submit(batch, prefixes, **kw)
        if not self._async_ok:
            params = self._pipe._inference_params()
            with torch.inference_mode():
                feats = self._pipe._features(params, batch, images=images)
            captions = self._pipe._sample_captions(params["decoder"], feats)
            return lambda: captions
        if images:
            return self._pipe.encode_submit(batch, **kw)
        return self._pipe.generate_submit(batch, **kw)

    def _batcher(self) -> None:
        """Top-level worker guard: _flush/_drain_one contain the
        per-batch dispatch errors, but an unexpected exception anywhere
        else must not silently kill the only dispatch thread and leave
        every pending future unresolved."""
        try:
            self._batcher_inner()
        except Exception as e:
            with self._submit_lock:
                self._closed = True  # subsequent submits raise
            futs = _drain_pending(self._queue)
            for _, bfuts, _ in _snapshot(lambda: list(self._inflight)):
                futs.extend(bfuts)
            futs.extend(self._current_futs)
            _fail_futures(futs, e)

    def _batcher_inner(self) -> None:
        while True:
            try:
                item = self._queue.get(timeout=0.001 if self._inflight else None)
            except queue.Empty:
                # No new traffic while results are in flight: retire the
                # oldest batch instead of holding its latency hostage.
                self._drain_one()
                continue
            if item is None:
                self._drain_on_close()
                return
            if isinstance(item, _Reload):
                self._apply_reload(item)
                continue
            batch = [item]
            deadline = time.perf_counter() + self._max_delay_s
            stop = False
            pending_reload = None
            while len(batch) < self._max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                if isinstance(nxt, _Reload):
                    # Close the collection window here: everything
                    # already collected rides the old weights, the swap
                    # happens right after this batch dispatches.
                    pending_reload = nxt
                    break
                batch.append(nxt)
            self._flush(batch)
            while len(self._inflight) >= self._depth:
                self._drain_one()
            if pending_reload is not None:
                self._apply_reload(pending_reload)
            if stop:
                self._drain_on_close()
                return

    def _drain_on_close(self) -> None:
        """Flush any backlog enqueued before the close sentinel, then
        retire every in-flight batch, so no accepted request is left
        with an unresolved future."""
        batch = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            if isinstance(item, _Reload):
                # Preserve submission order at shutdown too: flush what
                # came before, swap, keep draining.
                if batch:
                    self._flush(batch)
                    batch = []
                self._apply_reload(item)
                continue
            batch.append(item)
            if len(batch) == self._max_batch:
                self._flush(batch)
                batch = []
        if batch:
            self._flush(batch)
        while self._inflight:
            self._drain_one()

    def _flush(self, batch: list) -> None:
        """Split constrained requests into their own dispatch (the 2^C
        bank multiplier must not tax plain and prefixed rows), then pad
        each group to the bucket ladder and dispatch."""
        constrained = [it for it in batch if it[2]]
        if constrained and len(constrained) < len(batch):
            self._flush_group([it for it in batch if not it[2]])
            self._flush_group(constrained)
            return
        self._flush_group(batch)

    def _flush_group(self, batch: list) -> None:
        """Pad to the bucket ladder and dispatch; the batch is retired
        later by _drain_one (pipelined) unless dispatch itself fails."""
        xs, prefs, iws, futs, t0s = zip(*batch)
        # Visible to close()'s wedge path: while dispatch is in flight
        # these futures are in neither the queue nor _inflight.
        self._current_futs = futs
        n = len(xs)
        bucket = next(b for b in self._buckets if b >= n)
        stacked = np.stack(xs)
        if bucket > n:
            pad = np.zeros((bucket - n,) + stacked.shape[1:], stacked.dtype)
            stacked = np.concatenate([stacked, pad])
        try:
            finalize = self._submit_batch(
                stacked,
                list(prefs) + [""] * (bucket - n) if any(prefs) else None,
                # Padding rows get [] (all slots pre-satisfied): such a
                # row is exactly standard beam search.
                [list(w) for w in iws] + [[]] * (bucket - n) if any(iws) else None,
            )
        except Exception as e:  # propagate to every waiter, keep serving
            _fail_futures(futs, e)
            self._current_futs = ()
            return
        self._stats.padded_rows += bucket - n
        self._inflight.append((finalize, futs, t0s))
        self._current_futs = ()

    def _drain_one(self) -> None:
        if not self._inflight:
            return
        finalize, futs, t0s = self._inflight.popleft()
        n = len(futs)
        self._current_futs = futs  # popped — close() can't see them else
        try:
            captions = finalize()[:n]
        except Exception as e:
            _fail_futures(futs, e)
            self._current_futs = ()
            return
        self._current_futs = ()
        now = time.perf_counter()
        self._stats.requests += n
        self._stats.batches += 1
        for cap, fut, t0 in zip(captions, futs, t0s):
            self._stats.add_latency((now - t0) * 1e3)
            _resolve(fut, cap)


def _to_host(*tensors) -> list[np.ndarray]:
    """Device tensors -> numpy arrays."""
    return [t.cpu().numpy() for t in tensors]


class ContinuousCaptionServer:
    """Continuous-batching caption server (slot recycling;
    ``decode/continuous.py`` has the device half and the design).

    Unlike :class:`CaptionServer` (whole batches run to completion), a
    finished request's lanes are retired and refilled the moment it
    finishes, so mixed-length traffic keeps every lane busy. One device;
    greedy by default, beam via ``beam_width > 1`` (each request then
    occupies a beam_width-lane group); ``mode='images'`` adds the encoder to
    the admission path (see __init__).

    ``ticks_per_sync`` trades retirement latency for host round trips: each
    sync group runs that many decode steps, then fetches the (tiny)
    finished / active flags.
    """

    def __init__(
        self,
        pipeline,
        *,
        slots: int = 64,
        ticks_per_sync: int = 8,
        max_queue: int | None = None,
        beam_width: int = 1,
        mode: str = "features",
    ):
        """beam_width > 1 switches the engine to the continuous BEAM engine
        (decode/continuous_beam.py): each request occupies a group of
        beam_width lanes, retired when every beam finishes; results are
        beam_decode's. beam_width=1 (default) is the greedy engine.

        mode='images' puts the ENCODER in the admission path: submit takes
        a preprocessed (size, size, 3) image; each admitted wave is padded
        to the admission bucket, encoded on the device, and its feature rows
        are written into lanes. The wave's encode and its decode use one
        snapshot of the params, the engine's, as ``encode_submit`` does for
        a batch."""
        if mode not in ("features", "images"):
            raise ValueError(f"mode must be 'features'|'images', got {mode!r}")
        self._pipe = pipeline
        self._mode = mode
        self._beam_width = beam_width
        self._slots = slots
        _, end_id = pipeline._token_ids()
        self._end_id = end_id
        self._build_engine()
        self._ticks_per_sync = ticks_per_sync
        self._max_queue = max_queue
        self._queue: queue.Queue = queue.Queue()
        # slot -> [future, t0, on_words|None, words_emitted] (mutable:
        # _stream_progress advances words_emitted in place)
        self._futures: dict[int, list] = {}
        self._free = list(range(slots))
        self._stats = ServerStats()
        self._tick_count = 0
        self._tick_occupancy = 0
        self._closed = False
        self._current_futs: tuple = ()  # batch mid-admission (wedge path)
        self._submit_lock = threading.Lock()  # submit vs close ordering
        self._thread = threading.Thread(
            target=self._loop, name="tpucap-torch-continuous", daemon=True
        )
        self._thread.start()

    def _build_engine(self) -> None:
        """Build the device engine over the pipeline's CURRENT inference
        params and a fresh (all idle) slot state. Called at __init__ and
        again by reload(): the engine keeps its own snapshot of the params,
        as tpucap's jitted methods close over theirs, so a reload of the
        pipeline by another server leaves this one's lanes as they were."""
        from tpucap_torch.decode.continuous import ContinuousDecodeEngine
        from tpucap_torch.decode.continuous_beam import ContinuousBeamEngine

        pipeline = self._pipe
        start_id, end_id = pipeline._token_ids()
        cfg_e = pipeline.config.encoder
        feature_shape = (
            (pipeline.encoder.spatial_positions, cfg_e.feature_dim)
            if cfg_e.features == "spatial"
            else (cfg_e.feature_dim,)
        )
        dcfg = pipeline.config.decode
        params = pipeline._inference_params()
        self._encoder_params = params["encoder"] if self._mode == "images" else None
        engine_kw = dict(
            slots=self._slots,
            start_id=start_id,
            end_id=end_id,
            max_len=dcfg.max_len,
            min_len=dcfg.min_len,
            banned_ids=pipeline._banned_ids(),
            no_repeat_ngram_size=dcfg.no_repeat_ngram_size,
            feature_shape=feature_shape,
            feature_dtype=pipeline._infer_dtype(),
            # The pipeline's step (K2 + K3 on the card for a 1-layer merge
            # decoder) under its own precision flags, as _decode runs it.
            step_fn=pipeline.step_fn(),
            precision=pipeline.config.precision,
        )
        if self._beam_width > 1:
            self._engine = ContinuousBeamEngine(
                pipeline.decoder,
                params["decoder"],
                beam_width=self._beam_width,
                length_normalize=dcfg.length_normalize,
                alpha=dcfg.alpha,
                length_penalty=dcfg.length_penalty,
                approx_topk=dcfg.approx_topk,
                **engine_kw,
            )
        else:
            self._engine = ContinuousDecodeEngine(pipeline.decoder, params["decoder"], **engine_kw)
        self._state = self._engine.init_state()

    # -- client surface ----------------------------------------------------

    @property
    def _input_shape(self) -> tuple:
        if self._mode == "images":
            s = self._pipe.encoder.input_size
            return (s, s, 3)
        return self._engine.feature_shape

    def submit(self, features) -> Future:
        return self._submit(features, None)

    def reload(self, source) -> Future:
        """Hot-swap model weights: admission pauses, active lanes run to
        retirement under the old weights, then the pipeline's params are
        replaced (pipeline.reload_params, same validation) and the engine
        is REBUILT over them; queued and later requests decode under the new
        weights. On a validation failure the Future carries the error and
        the old engine keeps serving."""
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._queue.put(_Reload(source, fut))
        return fut

    def submit_stream(self, features, on_words) -> Future:
        """Streaming submit: ``on_words(words: list[str])`` is called with
        each NEW span of decoded words as the request progresses (one span
        a sync group at most); the returned Future still resolves with the
        full caption, and the spans concatenate to exactly that caption.

        Greedy streams every decoded token as it lands. Beam streams the
        group's STABLE PREFIX, the longest common prefix of its k beams,
        which every later leader extends (ContinuousBeamEngine.progress),
        so no emitted word is ever retracted; what the winning beam adds
        past the last stable span is flushed in one final ``on_words`` call
        at retirement, just before the future resolves.

        ``on_words`` runs on the engine thread: it must be fast and never
        block (hand off to a queue, as the HTTP front end does); exceptions
        it raises are swallowed, so a broken client callback cannot kill the
        shared engine loop."""
        if not callable(on_words):
            raise TypeError("on_words must be callable")
        return self._submit(features, on_words)

    def _submit(self, features, on_words) -> Future:
        x = np.asarray(features)
        if x.shape != self._input_shape:
            raise ValueError(
                f"request shape {x.shape} != expected "
                f"{self._input_shape} (mode={self._mode!r})"
            )
        return self._enqueue_rows([x], on_words)[0]

    def submit_many(self, xs) -> list[Future]:
        """Enqueue MANY rows in one atomic admission: all accepted or none
        (the CaptionServer.submit_many contract; the continuous engines
        have no prefix / include_words surface)."""
        xs = np.asarray(xs)
        if xs.ndim != len(self._input_shape) + 1 or xs.shape[1:] != self._input_shape:
            raise ValueError(
                f"submit_many wants shape (N, *{self._input_shape}), "
                f"got {xs.shape} (mode={self._mode!r})"
            )
        if xs.shape[0] == 0:
            return []
        return self._enqueue_rows(list(xs), None)

    def _enqueue_rows(self, rows: list, on_words) -> list[Future]:
        """Capacity-check and enqueue under ONE lock acquisition, so a
        multi-row request is never half admitted."""
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            if self._max_queue is not None and (
                self._queue.qsize() + len(rows) > self._max_queue
            ):
                raise Overloaded(f"request queue at max_queue={self._max_queue}")
            now = time.perf_counter()
            futs: list[Future] = []
            for x in rows:
                fut: Future = Future()
                self._queue.put((x, fut, now, on_words))
                futs.append(fut)
        return futs

    def caption(self, features, timeout: float | None = 60.0) -> str:
        return self.submit(features).result(timeout=timeout)

    def warmup(self, timeout: float = 600.0) -> None:
        """Run the engine's every shape before serving traffic: admit and
        collect at EVERY bucket of the admission ladder, a tick group, the
        flags and the progress fetch, on a scratch state (images mode runs
        the encoder at each bucket too). It pays the first-use costs:
        cuBLAS and cuDNN plans, the allocator's pools. Then the stats are
        reset. Call it before announcing the server, not with traffic."""
        del timeout  # inline: nothing to wait on
        eng = self._engine
        state = eng.init_state()
        shape = self._input_shape
        for b in eng._admit_buckets:
            n = min(b, eng.slots)
            ids = list(range(n))
            idx, feats = self._admission_arrays(ids, [np.zeros(shape, np.float32)] * n)
            state = eng.admit(state, idx, feats)
            state = eng.tick(state, self._ticks_per_sync)
            _to_host(*eng.flags(state))
            _to_host(*eng.progress(state))
            _, state = eng.collect(state, eng.pad_ids(ids))
        with self._stats.lock:
            self._stats.latencies_ms.clear()
        self._stats.requests = 0
        self._stats.batches = 0
        self._tick_count = 0
        self._tick_occupancy = 0

    def stats(self) -> dict:
        s = self._stats.snapshot()
        s["ticks"] = self._tick_count
        s["mean_occupancy"] = (
            self._tick_occupancy / self._tick_count if self._tick_count else 0.0
        )
        return s

    def close(self, timeout: float = 60.0) -> None:
        """Idempotent. If the engine loop is wedged past ``timeout``,
        pending futures are failed with a TimeoutError rather than leaving
        callers blocked in result() forever."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            exc = TimeoutError(
                f"continuous engine loop did not drain within {timeout}s "
                f"at close (wedged in device dispatch?); request abandoned"
            )
            futs = _drain_pending(self._queue)
            futs.extend(f for f, *_ in _snapshot(lambda: list(self._futures.values())))
            futs.extend(self._current_futs)  # batch mid-admission
            pending = getattr(self, "_pending_reload", None)
            if pending is not None:
                futs.append(pending.future)
            _fail_futures(futs, exc)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- engine loop --------------------------------------------------------

    def _admission_arrays(self, ids: list, payloads: list):
        """(slot_idx, feature rows) for engine.admit, padded to the
        admission bucket ladder. mode='images' runs the encoder here on the
        zero-padded image wave, with the engine's snapshot of the encoder
        params (the pad rows' features are computed, then dropped by
        admission)."""
        if self._mode != "images":
            return self._engine.pad_admission(ids, payloads)
        idx = self._engine.pad_ids(ids)
        imgs = np.zeros(idx.shape + self._input_shape, np.float32)
        for i, x in enumerate(payloads):
            imgs[i] = x
        pipe = self._pipe
        with torch.inference_mode():
            x = torch.as_tensor(imgs).to(pipe.device, pipe._infer_dtype())
            return idx, pipe._apply_encoder(self._encoder_params, x)

    def _admit_waiting(self, block: bool) -> bool:
        """Move queued requests into free lanes. Returns False once the
        close sentinel has arrived. While a reload is pending, admission is
        PAUSED (nothing is consumed) so active lanes drain and the swap can
        apply; requests queued behind the reload stay queued and decode
        under the new weights."""
        if getattr(self, "_pending_reload", None) is not None:
            if block:
                time.sleep(0.005)  # don't spin while lanes drain
            return not getattr(self, "_drain_sentinel", False)
        batch = []
        while len(batch) < len(self._free):
            try:
                item = self._queue.get(timeout=0.05 if (block and not batch) else 0)
            except queue.Empty:
                break
            if item is None:
                self._drain_sentinel = True
                break
            if isinstance(item, _Reload):
                # Stop collecting here: everything admitted so far (and the
                # lanes already active) finishes under the old weights.
                self._pending_reload = item
                break
            batch.append(item)
        if batch:
            # Visible to close()'s wedge path: until registered in _futures
            # these requests are in neither the queue nor the slots.
            self._current_futs = tuple(b[1] for b in batch)
            ids = [self._free.pop() for _ in batch]
            idx, feats = self._admission_arrays(ids, [b[0] for b in batch])
            self._state = self._engine.admit(self._state, idx, feats)
            for slot, (_, fut, t0, cb) in zip(ids, batch):
                # [future, t0, on_words callback, words emitted so far]
                self._futures[slot] = [fut, t0, cb, 0]
            self._current_futs = ()
        return not getattr(self, "_drain_sentinel", False)

    def _retire(self, fin: np.ndarray) -> None:
        from tpucap_torch.decode import ids_to_captions

        ids = [int(i) for i in np.where(fin)[0]]
        if not ids:
            return
        # pad_ids pads with the engine's out-of-range index (dropped), not
        # slot 0, which would clear lane 0's finished bit.
        idx = self._engine.pad_ids(ids)
        (tokens, lengths, _), self._state = self._engine.collect(self._state, idx)
        tokens, lengths = _to_host(tokens, lengths)
        tokens, lengths = tokens[: len(ids)], lengths[: len(ids)]
        captions = ids_to_captions(self._pipe.tokenizer, tokens, lengths, end_id=self._end_id)
        now = time.perf_counter()
        self._stats.requests += len(ids)
        for row, (slot, cap) in enumerate(zip(ids, captions)):
            entry = self._futures.pop(slot)
            if entry[2] is not None:
                # Final streaming flush: what the winning sequence carries
                # past the last emitted span (for beam, the part beyond the
                # stable prefix; for greedy, usually nothing). It runs
                # BEFORE the future resolves, so the spans concatenate to
                # exactly the caption a .result() caller sees.
                self._emit_span(entry, tokens[row], int(lengths[row]))
            fut, t0, _, _ = entry
            self._stats.add_latency((now - t0) * 1e3)
            _resolve(fut, cap)
            self._free.append(slot)

    def _stream_progress(self) -> None:
        """Emit newly decoded words to streaming requests' callbacks: one
        (slots, max_len) fetch a sync group, paid ONLY while a streaming
        request is live. ``progress`` gives the tokens and the streamable
        length: the decoded length for greedy lanes, the stable prefix for
        beam groups (``_retire`` flushes the rest)."""
        live = [e for e in self._futures.values() if e[2] is not None]
        if not live:
            return
        tokens, lengths = _to_host(*self._engine.progress(self._state))
        for slot, entry in self._futures.items():
            if entry[2] is None:
                continue
            self._emit_span(entry, tokens[slot], int(lengths[slot]))

    def _emit_span(self, entry, token_row, n: int) -> None:
        """Deliver tokens [emitted, n) of ``token_row`` to a streaming
        entry's callback and advance its high-water mark."""
        _, _, cb, emitted = entry
        if n <= emitted:
            return
        tok = self._pipe.tokenizer
        words = [
            w
            for t in token_row[emitted:n]
            if int(t) != self._end_id and (w := tok.word_for_id(int(t))) is not None
        ]
        entry[3] = n
        if words:
            try:
                cb(words)
            except Exception:
                # A broken client callback must not kill the shared engine
                # loop; the future still resolves at retirement.
                pass

    def _loop(self) -> None:
        """Top-level worker guard: the engine loop is this server's ONLY
        device dispatcher. If admission (which in images mode runs the
        encoder), a tick or a collect raises (out of memory at a fresh
        bucket, say), every accepted request's future is failed with that
        error and the server closes, instead of a dead thread leaving
        clients blocked in result() forever."""
        try:
            self._loop_inner()
        except Exception as e:
            with self._submit_lock:
                self._closed = True  # later submits raise
            futs = _drain_pending(self._queue)
            futs.extend(f for f, *_ in self._futures.values())
            futs.extend(self._current_futs)
            pending = getattr(self, "_pending_reload", None)
            if pending is not None:
                futs.append(pending.future)
            _fail_futures(futs, e)

    def _loop_inner(self) -> None:
        self._drain_sentinel = False
        self._pending_reload = None
        while True:
            keep = self._admit_waiting(block=not self._futures)
            if self._futures:
                self._state = self._engine.tick(self._state, self._ticks_per_sync)
                fin, act, _ = _to_host(*self._engine.flags(self._state))
                self._tick_count += self._ticks_per_sync
                self._tick_occupancy += (
                    int(act.sum()) + len(np.where(fin)[0])
                ) * self._ticks_per_sync
                self._stats.batches += 1  # one sync group
                self._stream_progress()
                self._retire(fin)
            if self._pending_reload is not None and not self._futures:
                item = self._pending_reload
                try:
                    self._pipe.reload_params(item.source)
                    self._build_engine()  # new params -> new engine
                except Exception as e:
                    _fail_futures([item.future], e)
                else:
                    _resolve(item.future, True)
                self._pending_reload = None
                continue  # resume admission immediately
            if not keep and not self._futures:
                return


def reload_together(servers, source) -> list[Future]:
    """One hot swap for several servers of ONE pipeline (``serve_http``'s
    images and features pair): the params are read and installed once,
    when every server's batcher has reached the reload in its own queue.
    A server's requests are queued whole (``submit_many`` holds the submit
    lock), so each is decoded entirely on the old weights or entirely on
    the new, even when its rows span several batches. -> each server's
    reload future, as ``CaptionServer.reload``'s."""
    pipes = {id(s._pipe) for s in servers}
    if len(pipes) != 1:
        raise ValueError("reload_together swaps the params of one pipeline")
    swap = _Swap(servers[0]._pipe, source, len(servers))
    futs = []
    try:
        for server in servers:
            futs.append(server._enqueue_reload(source, swap))
    except Exception:
        swap.abort()  # the servers already queued give up their wait
        raise
    return futs
