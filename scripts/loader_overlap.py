"""What holds back ``caption_dataset`` beside the card: path A's
``caption_batch`` (ResNet-50 with fused blocks, lstm1, beam 3, bf16, batch
256) alone and beside a loop of host work, then ``caption_dataset`` with
the loader's decode threads and depth varied.

    python3 scripts/loader_overlap.py    # from the repo root, on the card

Host work beside ``caption_batch``: the port's decoder on JPEG bytes
already in memory; Python reading the same files (what a loader thread
that reads its files in Python adds); ``decode_jpeg_files``, whose C
workers read the files. Then ``caption_dataset(fast_scale=False)`` on 1024
paths with the decoder at 8 (the default), 7 and 6 threads and one or two
batches in flight, three rounds, captions checked against
``caption_batch``'s. The inputs are ``chip_smoke.py`` phase 6's: the six
baseline fixtures tiled. Prints one line per measurement.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from tpucap_torch import _build  # noqa: E402
from tpucap_torch.data import pipeline as data_pipeline  # noqa: E402
from tpucap_torch.ops import jpeg  # noqa: E402

N, BATCH, SIZE = 1024, 256, 224


def beside(pipe, batches, work, label):
    """caption_batch on each decoded batch while `work` loops in a thread."""
    stop = threading.Event()
    done = [0]

    def loop():
        while not stop.is_set():
            work()
            done[0] += 1

    th = threading.Thread(target=loop)
    th.start()
    time.sleep(0.05)
    t0 = time.perf_counter()
    per = [cs.timed(lambda b=b: pipe.caption_batch(b))[1] for b in batches]
    wall = time.perf_counter() - t0
    stop.set()
    th.join()
    print(f"{label}: caption_batch ms a batch {[round(x * 1e3, 2) for x in per]}; "
          f"{done[0]} rounds of host work beside it in {wall:.4f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("loader_overlap: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    _build.build_host("jpeg_decode")
    fixtures = cs.check_jpeg_fixtures()
    baseline = [fixtures[name] for name in cs.BASELINE_FIXTURES]
    pipe = cs.make_pipeline("bf16")
    pipe.encoder = dataclasses.replace(pipe.encoder, fused_blocks=True)
    paths = [str(baseline[i % len(baseline)]) for i in range(N)]
    batches = [jpeg.decode_jpeg_files(paths[s : s + BATCH], SIZE, fast_scale=False)
               for s in range(0, N, BATCH)]
    blobs = [Path(p).read_bytes() for p in paths[:BATCH]]
    pipe.caption_batch(batches[0])  # warm-up
    want = [c for b in batches for c in pipe.caption_batch(b)]
    print(f"loader_overlap: os.cpu_count() {os.cpu_count()}; {N} paths, batch {BATCH}", flush=True)

    per = [cs.timed(lambda b=b: pipe.caption_batch(b))[1] for b in batches]
    print(f"alone: caption_batch ms a batch {[round(x * 1e3, 2) for x in per]}", flush=True)
    beside(pipe, batches, lambda: jpeg.decode_jpeg_batch(blobs, SIZE, fast_scale=False),
           "beside the decode of bytes in memory, 8 threads")
    beside(pipe, batches, lambda: [Path(p).read_bytes() for p in paths[:BATCH]],
           "beside Python reading the batch's files")
    beside(pipe, batches, lambda: jpeg.decode_jpeg_files(paths[:BATCH], SIZE, fast_scale=False),
           "beside decode_jpeg_files (C reads), 8 threads")

    decode_files = jpeg.decode_jpeg_files
    runs: dict = {}
    try:
        for _ in range(3):
            for threads, depth in [(0, 1), (7, 1), (6, 1), (0, 2)]:
                data_pipeline.decode_jpeg_files = functools.partial(decode_files, n_threads=threads)
                caps, s = cs.timed(lambda: pipe.caption_dataset(
                    paths, batch_size=BATCH, fast_scale=False, num_workers=depth))
                if caps != want:
                    raise AssertionError("caption_dataset disagrees with caption_batch")
                runs.setdefault(f"decode threads {threads or os.cpu_count()}, "
                                f"{depth} batch(es) ahead", []).append(s)
    finally:
        data_pipeline.decode_jpeg_files = decode_files
    for label, secs in runs.items():
        print(f"caption_dataset, {label}: s {[round(x, 4) for x in secs]}; "
              f"median {N / float(np.median(secs)):.2f} captions/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
