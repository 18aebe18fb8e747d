"""The uint8 batch loader and the streamed training input: counterparts
of ``image_batch_loader``, ``caption_batch_stream`` and
``prefetch_iterator`` in ``tpucap/data/pipeline.py``, without grain.

tpucap's loader is a grain ``DataLoader``, and its device work overlaps the
host decode through JAX's asynchronous dispatch. The port's decode loop
drives the card from Python and waits on it, so the loader decodes ahead in
a background thread instead: the C decoder releases the GIL, and the two
run at once.

``caption_batch_stream`` assembles training batches from a lazy feature
mapping (an ``np.load`` handle of an uncompressed ``.npz``), one batch of
rows at a time, in ``batch_iterator``'s order; ``prefetch_iterator`` runs
it on a background thread a few batches ahead of the training step.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from collections.abc import Callable, Iterable, Iterator, Sequence
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tpucap_torch.ops.jpeg import decode_jpeg_files


def prefetch(items: Iterable, fn: Callable, depth: int) -> Iterator[tuple]:
    """Yield ``(item, fn(item))`` in order, ``fn`` running in one background
    thread up to ``depth`` items ahead. An exception in the thread is raised
    to the caller at the item it failed on. Closing the iterator stops the
    thread."""
    with ThreadPoolExecutor(1, thread_name_prefix="tpucap-loader") as pool:
        pending: deque = deque()
        try:
            for item in items:
                pending.append((item, pool.submit(fn, item)))
                if len(pending) > depth:
                    head, future = pending.popleft()
                    yield head, future.result()
            while pending:
                head, future = pending.popleft()
                yield head, future.result()
        finally:
            for _, future in pending:
                future.cancel()


def image_batch_loader(
    paths: Sequence[str],
    *,
    size: int,
    batch_size: int,
    num_workers: int = 0,
    seed: int = 0,
    shuffle: bool = False,
    num_epochs: int = 1,
    fast_scale: bool = True,
    drop_remainder: bool = False,
) -> Iterator[tuple[list[str], np.ndarray]]:
    """Yield (paths_chunk, uint8 batch (B, size, size, 3)) in path order, the
    tail chunk short unless ``drop_remainder``.

    Decoding runs ahead in a background thread (each batch decoded by the
    C decoder's own thread pool): one batch ahead with ``num_workers`` 0,
    ``num_workers`` batches ahead otherwise. ``seed`` only seeds a shuffle,
    and ``shuffle=True`` raises: grain's sampler order cannot be reproduced
    without grain."""
    if shuffle:
        raise NotImplementedError(
            "shuffle=True is not ported: grain's sampler order cannot be "
            "reproduced without grain (ROADMAP queue 5, \"Also open\")"
        )
    del seed
    paths = tuple(str(p) for p in paths)
    n_chunks = (len(paths) + batch_size - 1) // batch_size
    if drop_remainder and n_chunks and len(paths) % batch_size:
        n_chunks -= 1
    chunks = [
        list(paths[c * batch_size : (c + 1) * batch_size])
        for _ in range(num_epochs)
        for c in range(n_chunks)
    ]
    return prefetch(
        chunks,
        lambda chunk: decode_jpeg_files(chunk, size, fast_scale=fast_scale),
        max(1, num_workers),
    )


def caption_batch_stream(
    row_ids,
    tokens: np.ndarray,
    features,
    batch_size: int,
    *,
    rng=None,
    drop_remainder: bool = True,
    start_batch: int = 0,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """(features, tokens) minibatches, the feature rows read per batch as
    ``features[row_ids[i]]``: with a lazy mapping (an uncompressed
    ``np.load`` handle, a memory map) the host holds one batch of rows, not
    the whole (N, F) stack that ``build_training_batch`` makes. Features
    come back f32.

    ``rng`` (a numpy Generator) shuffles the rows with one
    ``rng.shuffle(np.arange(n))`` a call, as ``batch_iterator`` does, so the
    batches come in the in-memory path's order under the same seed.
    ``start_batch`` consumes the whole permutation but assembles nothing
    before that batch (a mid-epoch resume reads no row it skips)."""
    n = len(row_ids)
    if tokens.shape[0] != n:
        raise ValueError(f"{n} row ids vs {tokens.shape[0]} token rows")
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for s in range(start_batch * batch_size, end, batch_size):
        sel = idx[s : s + batch_size]
        feats = np.stack([np.asarray(features[row_ids[i]]) for i in sel]).astype(np.float32, copy=False)
        yield feats, tokens[sel]


def prefetch_iterator(it: Iterator, *, depth: int = 2, transform=None) -> Iterator:
    """Run ``it`` (and ``transform`` on each item, when given) on one
    daemon thread, at most ``depth`` finished items queued. An exception in
    the thread is raised at the consumer's next pull. Closing or abandoning
    the generator stops the thread: the queue is drained, so a worker
    blocked on a full queue wakes, drops its items and exits."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    stop = threading.Event()
    failure: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if stop.is_set() or not put(transform(item) if transform is not None else item):
                    return
        except BaseException as e:  # noqa: BLE001 - raised at the consumer
            failure.append(e)
        finally:
            # The sentinel must not be dropped on a full queue: the consumer
            # would wait for it forever once it drained the items.
            put(sentinel)

    threading.Thread(target=worker, daemon=True, name="tpucap-torch-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()
        try:  # wake a worker blocked on a full queue
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
