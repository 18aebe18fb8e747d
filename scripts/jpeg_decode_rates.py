"""Time the port's JPEG decoder against tpucap's libjpeg-turbo decode on the
same files, on this host.

    JAX_PLATFORMS=cpu python scripts/jpeg_decode_rates.py [--reps 5]

Needs tpucap's decoder (libjpeg-turbo), so it runs on a host that has
libjpeg, not on the card's machine (whose ``chip_smoke.py`` phase 6 times
the port's decoder alone). For each set of committed fixtures
(``tests/data/torch_jpeg/``: the six baseline files, the progressive one,
the arithmetic SOF9 and SOF10 ones), a batch of 256 decoded to 224 x 224
with ``fast_scale`` True (5/8) and False (8/8), at one thread and at one a
CPU: each decoder's images/s (the median of ``--reps`` calls) and the
port's share of libjpeg-turbo's rate; the outputs must be byte-identical.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tpucap.ops import jpeg as jax_jpeg  # noqa: E402
from tpucap_torch.ops import jpeg  # noqa: E402

FIXTURES = ROOT / "tests" / "data" / "torch_jpeg"
SETS = {
    "baseline six": ("a_420.jpg", "b_422.jpg", "c_444.jpg", "d_gray.jpg", "e_restart.jpg",
                     "f_optimized.jpg"),
    "progressive (g)": ("g_progressive.jpg",),
    "arithmetic SOF9 (j)": ("j_arith.jpg",),
    "arithmetic SOF10 (k)": ("k_arith_progressive.jpg",),
}
BATCH, SIZE = 256, 224


def rate(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return BATCH / statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    print(f"os.cpu_count() {os.cpu_count()}; batch {BATCH} -> {SIZE}; median of {args.reps}")
    for label, names in SETS.items():
        blobs = [(FIXTURES / names[i % len(names)]).read_bytes() for i in range(BATCH)]
        for fast in (True, False):
            np.testing.assert_array_equal(
                jpeg.decode_jpeg_batch(blobs, SIZE, fast_scale=fast),
                jax_jpeg.decode_jpeg_batch(blobs, SIZE, fast_scale=fast))
            for threads in (1, 0):
                port = rate(lambda: jpeg.decode_jpeg_batch(
                    blobs, SIZE, n_threads=threads, fast_scale=fast), args.reps)
                ref = rate(lambda: jax_jpeg.decode_jpeg_batch(
                    blobs, SIZE, n_threads=threads, fast_scale=fast), args.reps)
                print(f"{label}: fast_scale={fast} n_threads={threads or os.cpu_count()}: "
                      f"port {port:.2f} images/s, libjpeg-turbo {ref:.2f}, "
                      f"port/libjpeg {port / ref:.3f}")


if __name__ == "__main__":
    main()
