"""The uint8 batch loader: counterpart of ``image_batch_loader`` in
``tpucap/data/pipeline.py``, without grain.

tpucap's loader is a grain ``DataLoader``, and its device work overlaps the
host decode through JAX's asynchronous dispatch. The port's decode loop
drives the card from Python and waits on it, so the loader decodes ahead in
a background thread instead: the C decoder releases the GIL, and the two
run at once.
"""

from __future__ import annotations

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
