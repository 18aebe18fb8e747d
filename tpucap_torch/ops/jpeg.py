"""Host JPEG decode through the port's own decoder (``csrc/jpeg_decode.cpp``,
built by ``g++`` at first use): the counterpart of
``tpucap/ops/jpeg/__init__.py``.

``decode_jpeg_batch(blobs, size)`` -> (N, size, size, 3) uint8 RGB,
nearest-resized (PIL convention), the same bytes as tpucap's libjpeg-turbo
decode. The decoder covers Huffman- and arithmetic-coded JPEG, sequential
and progressive: 8-bit gray, YCbCr or RGB-coded, any sampling with integral
ratios (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...), restart intervals,
optimized tables, DAC conditioning, and files cut short as libjpeg reads
them. There is no libjpeg, no PIL and no other route: an image outside that
scope raises ``ValueError`` naming it and why (CMYK out as RGB, 12-bit,
lossless and hierarchical JPEGs libjpeg-turbo refuses too).
``decode_files(..., load_image=True)`` gives the bytes of tpucap's
``load_image`` (PIL), the route of ``extract_features``
(``data/preprocess.py``): it also takes CMYK and YCCK files, converted to
RGB as Pillow converts them; it resizes as Pillow's NEAREST does (which
sums its step in double, so that on some sizes it takes another row or
column than tpucap's C resize); and it refuses a file cut short, as PIL
does.

``fast_scale=True`` is tpucap's default: it decodes at the smallest libjpeg
scale N/8 that still covers ``size`` (libjpeg's scaled IDCTs, chroma IDCT'd
at twice luma's size where its sampling allows), then resizes.
``fast_scale=False`` decodes at 8/8 and resizes: PIL's bytes.

The C call releases the GIL, so a loader thread decodes while Python drives
the card. ``decode_jpeg_files`` hands the C call the paths, and its worker
threads read the files: read in Python, file by file, a loader thread would
trade the GIL with the thread driving the card (beside it, path A's
``caption_batch`` went from 57-65 to 136-145 ms a batch of 256 on an H100's
8-core host; ``scripts/loader_overlap.py``).
"""

from __future__ import annotations

import ctypes
import functools
import os
from collections.abc import Sequence

import numpy as np

from tpucap_torch import _build

#: csrc/jpeg_decode.cpp:Status -> why an image was refused.
STATUS = {
    1: "corrupt or truncated JPEG data",
    2: "not a JPEG (no SOI marker)",
    3: "a lossless or hierarchical JPEG, which libjpeg-turbo refuses too",
    4: "sample precision other than 8 bits, which libjpeg-turbo's 8-bit "
    "build refuses too",
    5: "color space other than gray, YCbCr or RGB (CMYK, YCCK, two "
    "components), which libjpeg-turbo does not convert to RGB either (CMYK "
    "and YCCK decode on the load_image route of extract_features)",
    6: "chroma sampling with no integral ratio to the largest sampling "
    "factors, which libjpeg refuses too",
    8: "cannot be read",
    9: "wider or taller than 65500 pixels, libjpeg's limit",
    10: "the host could not allocate its decoded planes",
    11: "truncated: the data ends before the image does, which tpucap's "
    "load_image (PIL) refuses",
}

#: csrc/jpeg_decode.cpp's flags.
FAST_SCALE = 1
LOAD_IMAGE = 2

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_intp = ctypes.POINTER(ctypes.c_int)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.build_host("jpeg_decode")
    lib.tpucap_decode_jpeg_batch.restype = ctypes.c_int
    lib.tpucap_decode_jpeg_batch.argtypes = [
        _u8p, _i64p, _i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _u8p, _intp, ctypes.c_int, ctypes.c_int,
    ]
    lib.tpucap_decode_jpeg_files.restype = ctypes.c_int
    lib.tpucap_decode_jpeg_files.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _u8p, _intp, ctypes.c_int, ctypes.c_int,
    ]
    lib.tpucap_jpeg_dims.restype = ctypes.c_int
    lib.tpucap_jpeg_dims.argtypes = [_u8p, ctypes.c_int64, _intp, _intp]
    return lib


def scale_num(height: int, width: int, size: int) -> int:
    """tpucap's scale search (``tpucap/ops/jpeg/jpeg_decode.cpp:81-92``): the
    smallest num in 1..8 with both sides * num // 8 >= size, else 8."""
    for num in range(1, 9):
        if height * num // 8 >= size and width * num // 8 >= size:
            return num
    return 8


def jpeg_dims(blob: bytes) -> tuple[int, int]:
    """(height, width) from a JPEG's header; ``ValueError`` if unreadable."""
    data = np.frombuffer(blob, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _lib().tpucap_jpeg_dims(
        data.ctypes.data_as(_u8p), len(blob), ctypes.byref(h), ctypes.byref(w)
    )
    if rc:
        raise ValueError(f"JPEG header unreadable: {STATUS.get(rc, rc)}")
    return h.value, w.value


def _raise_for(status, names):
    """ValueError naming the images refused and why."""
    bad = np.nonzero(status)[0].tolist()
    why = "; ".join(f"{names[i]}: {STATUS[int(status[i])]}" for i in bad)
    raise ValueError(f"JPEG decode failed for images {bad}: {why}")


def _decode_blobs(blobs, out, target, n_threads, flags) -> np.ndarray:
    """The C batch call; returns the per-image status."""
    n = len(blobs)
    data = np.frombuffer(b"".join(blobs), np.uint8)
    sizes = np.array([len(b) for b in blobs], np.int64)
    offsets = np.zeros(n, np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    status = np.zeros(n, np.int32)
    _lib().tpucap_decode_jpeg_batch(
        data.ctypes.data_as(_u8p),
        offsets.ctypes.data_as(_i64p),
        sizes.ctypes.data_as(_i64p),
        n,
        target,
        target,
        out.ctypes.data_as(_u8p),
        status.ctypes.data_as(_intp),
        int(n_threads),
        flags,
    )
    return status


def decode_jpeg_batch(
    blobs: Sequence[bytes],
    size: int,
    *,
    n_threads: int = 0,
    fast_scale: bool = True,
) -> np.ndarray:
    """JPEG byte strings -> (N, size, size, 3) uint8 RGB, nearest-resized
    (PIL convention). ``n_threads`` 0 = one worker per hardware thread."""
    n = len(blobs)
    out = np.empty((n, size, size, 3), np.uint8)
    if n == 0:
        return out
    status = _decode_blobs(blobs, out, size, n_threads, FAST_SCALE * bool(fast_scale))
    if status.any():
        _raise_for(status, [f"image {i}" for i in range(n)])
    return out


def decode_jpeg(blob: bytes, *, load_image: bool = False) -> np.ndarray:
    """One JPEG at its own size -> (H, W, 3) uint8 RGB; ``load_image`` as
    in ``decode_files``."""
    h, w = jpeg_dims(blob)
    out = np.empty((h, w, 3), np.uint8)
    status = _decode_blobs([blob], out, 0, 1, LOAD_IMAGE * bool(load_image))
    if status.any():
        _raise_for(status, ["image 0"])
    return out


def decode_files(
    paths, size: int, *, n_threads: int = 0, fast_scale: bool = True, load_image: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Image files -> ((N, size, size, 3) uint8 RGB, per-file status): the
    C call, whose workers read the files; rows whose status is not 0 are
    undefined. ``load_image`` gives tpucap's ``load_image`` bytes: CMYK and
    YCCK files admitted (a status 5 without it), Pillow's NEAREST resize, a
    file cut short refused (status 11)."""
    paths = [os.fsencode(str(p)) for p in paths]
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    status = np.zeros(n, np.int32)
    if n:
        _lib().tpucap_decode_jpeg_files(
            (ctypes.c_char_p * n)(*paths),
            n,
            size,
            size,
            out.ctypes.data_as(_u8p),
            status.ctypes.data_as(_intp),
            int(n_threads),
            FAST_SCALE * bool(fast_scale) | LOAD_IMAGE * bool(load_image),
        )
    return out, status


def decode_jpeg_files(
    paths, size: int, *, n_threads: int = 0, fast_scale: bool = True
) -> np.ndarray:
    """Image files -> (N, size, size, 3) uint8 RGB, as ``decode_jpeg_batch``;
    the C call's workers read the files. Errors name the file."""
    paths = [str(p) for p in paths]
    out, status = decode_files(paths, size, n_threads=n_threads, fast_scale=fast_scale)
    if status.any():
        _raise_for(status, paths)
    return out
