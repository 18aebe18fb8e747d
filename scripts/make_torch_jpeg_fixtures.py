"""Write the JPEG fixtures of tpucap_torch's decoder and their reference
digests.

    JAX_PLATFORMS=cpu python scripts/make_torch_jpeg_fixtures.py

Needs PIL (to encode) and tpucap's libjpeg-turbo decoder (the reference),
so it runs on a host that has both, not on the card's machine. It writes
into ``tests/data/torch_jpeg/``:

- six baseline JPEGs, 500x375 and 375x500, of smooth content with some
  texture: 4:2:0, 4:2:2, 4:4:4, gray, one with restart markers, one with
  optimized Huffman tables;
- ``digests.json``: for each, the SHA-256 of tpucap's decode with
  ``fast_scale=False`` at its own size and at 224 x 224 (nearest resize).

``chip_smoke.py`` phase 6 holds the card machine's build of the port's
decoder against these digests (that machine has no libjpeg, and the port
imports no PIL);
``tests/test_torch_jpeg.py`` checks that the port and tpucap both still give
them.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tpucap.ops import jpeg as jpeg_ops  # noqa: E402

OUT = ROOT / "tests" / "data" / "torch_jpeg"
SIZE = 224

# name -> (height, width, PIL mode, save options)
FIXTURES = {
    "a_420.jpg": (375, 500, "RGB", dict(quality=90, subsampling=2)),
    "b_422.jpg": (500, 375, "RGB", dict(quality=85, subsampling=1)),
    "c_444.jpg": (375, 500, "RGB", dict(quality=80, subsampling=0)),
    "d_gray.jpg": (500, 375, "L", dict(quality=90)),
    "e_restart.jpg": (375, 500, "RGB", dict(quality=75, subsampling=2, restart_marker_blocks=7)),
    "f_optimized.jpg": (500, 375, "RGB", dict(quality=95, subsampling=2, optimize=True)),
}


def content(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth color fields with stripes and a little grain."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(0.005, 0.03, (3, 2))
    ph = rng.uniform(0, 2 * np.pi, (3,))
    chans = [
        128 + 90 * np.sin(f[c, 0] * x + f[c, 1] * y + ph[c])
        + 25 * np.sin(0.35 * x + 0.2 * c) * (y > h / 2)
        for c in range(3)
    ]
    img = np.stack(chans, -1) + rng.normal(0, 4, (h, w, 3))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def tpucap_native(blob: bytes, h: int, w: int) -> np.ndarray:
    """tpucap's libjpeg decode at the image's own size (target 0 x 0)."""
    lib = jpeg_ops._load()
    out = np.empty((h, w, 3), np.uint8)
    data = np.frombuffer(blob, np.uint8)
    offsets = np.zeros(1, np.int64)
    sizes = np.array([len(blob)], np.int64)
    status = np.zeros(1, np.int32)
    failures = lib.tpucap_decode_jpeg_batch(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        1, 0, 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        1, 0,
    )
    if failures:
        raise ValueError(f"tpucap's decoder refused the image: status {status[0]}")
    return out


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def reference_digests(blob: bytes) -> dict:
    """The digests.json entry of one JPEG, from tpucap's decoder."""
    with Image.open(io.BytesIO(blob)) as im:
        w, h = im.size
    return {
        "shape": [h, w],
        "native": sha256(tpucap_native(blob, h, w)),
        str(SIZE): sha256(jpeg_ops.decode_jpeg_batch([blob], SIZE, fast_scale=False)[0]),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    digests = {
        "reference": "tpucap.ops.jpeg.decode_jpeg_batch(fast_scale=False) "
        "(libjpeg-turbo); 'native' at the image's own size",
        "size": SIZE,
        "files": {},
    }
    total = 0
    for seed, (name, (h, w, mode, opts)) in enumerate(FIXTURES.items()):
        im = Image.fromarray(content(h, w, seed))
        if mode == "L":
            im = im.convert("L")
        buf = io.BytesIO()
        im.save(buf, "JPEG", **opts)
        blob = buf.getvalue()
        (args.out / name).write_bytes(blob)
        total += len(blob)
        digests["files"][name] = reference_digests(blob)
        print(f"{name}: {w}x{h} {mode} {opts} {len(blob)} bytes")
    (args.out / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    print(f"{len(FIXTURES)} files, {total} bytes")


if __name__ == "__main__":
    main()
