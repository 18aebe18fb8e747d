"""The JPEG decoder's two IDCT builds side by side on this host: the default
(SSE2 intrinsics on x86-64, as libjpeg-turbo's ``jidctint-sse2.asm`` lays
the arithmetic out) and the scalar one (``-DTPUCAP_JPEG_SCALAR``, the same
arithmetic lane by lane), both built here by ``g++`` from
``tpucap_torch/csrc/jpeg_decode.cpp``.

    python3 scripts/jpeg_idct_builds.py    # from the repo root

The input is ``chip_smoke.py`` phase 6's: the six baseline fixtures (500 x 375
and 375 x 500) tiled, decoded at scale 8/8 and resized to 224 x 224. Each
round times calls at one thread (256 images) and at the default thread
count (1024 images), the builds in the order default, scalar, scalar,
default; five rounds after one warm-up call of each. Both builds must give
the same bytes. Prints the host, then each build's images/s (median and
best of its ten calls, every call listed) and the scalar build's time over
the default's (medians).
"""

from __future__ import annotations

import ctypes
import os
import platform
import shutil
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import BASELINE_FIXTURES  # noqa: E402
from tpucap_torch import _build  # noqa: E402

FIXTURES = ROOT / "tests" / "data" / "torch_jpeg"
SIZE, ROUNDS = 224, 5


def scalar_build() -> ctypes.CDLL:
    src = _build.CSRC / "jpeg_decode.cpp"
    flags = (*_build.HOST_FLAGS, "-DTPUCAP_JPEG_SCALAR")
    out = _build.BUILD / f"jpeg_decode_scalar-{_build._digest(src, [], flags)}.so"
    if not out.exists():
        _build._compile([([shutil.which("g++"), *flags, str(src)], out)], src.name)
    return ctypes.CDLL(str(out))


def decode(lib, blobs, n_threads: int) -> tuple[np.ndarray, float]:
    """One C batch call; returns the images and its seconds."""
    data = np.frombuffer(b"".join(blobs), np.uint8)
    sizes = np.array([len(b) for b in blobs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    out = np.empty((len(blobs), SIZE, SIZE, 3), np.uint8)
    status = np.zeros(len(blobs), np.int32)
    ptr = ctypes.c_void_p
    t0 = time.perf_counter()
    lib.tpucap_decode_jpeg_batch(
        ptr(data.ctypes.data), ptr(offsets.ctypes.data), ptr(sizes.ctypes.data),
        len(blobs), SIZE, SIZE, ptr(out.ctypes.data), ptr(status.ctypes.data),
        n_threads, 0,
    )
    seconds = time.perf_counter() - t0
    if status.any():
        raise AssertionError(f"decode failed: status {sorted(set(status.tolist()))}")
    return out, seconds


def main() -> int:
    cpu = next((line.split(":", 1)[1].strip() for line in
                Path("/proc/cpuinfo").read_text().splitlines()
                if line.startswith("model name")), platform.processor())
    print(f"host: {cpu}; os.cpu_count() {os.cpu_count()}; {platform.machine()}", flush=True)
    builds = {"default": _build.build_host("jpeg_decode"), "scalar": scalar_build()}
    files = [FIXTURES / name for name in BASELINE_FIXTURES]
    blobs = [files[i % len(files)].read_bytes() for i in range(1024)]
    cases = {"1 thread, 256 images": (blobs[:256], 1),
             "default threads, 1024 images": (blobs, 0)}
    for batch, n_threads in cases.values():  # warm up: threads, pages
        for lib in builds.values():
            decode(lib, batch, n_threads)
    rates = {(b, c): [] for b in builds for c in cases}
    for _ in range(ROUNDS):
        for case, (batch, n_threads) in cases.items():
            outs = {}
            for build in ("default", "scalar", "scalar", "default"):
                outs[build], seconds = decode(builds[build], batch, n_threads)
                rates[build, case].append(len(batch) / seconds)
            if not np.array_equal(outs["default"], outs["scalar"]):
                raise AssertionError("the two builds decode differently")
    for case in cases:
        med = {b: statistics.median(rates[b, case]) for b in builds}
        for b in builds:
            print(f"{case}: {b} build {med[b]:.2f} images/s, best {max(rates[b, case]):.2f} "
                  f"(median of {len(rates[b, case])}: {[round(r, 2) for r in rates[b, case]]})")
        print(f"{case}: scalar takes {med['default'] / med['scalar']:.3f}x the default's time",
              flush=True)
    print("both builds give the same bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
