"""Fused uint8 resize + normalize: kernel K1 and its plain version
(port of ``tpucap.ops.preprocess``).

Every preprocessing mode is an affine per-channel map of the (possibly
channel-flipped) uint8 input, y = scale * x' + bias, in f32:

    caffe: BGR(x) - mean_bgr        (flip + bias)
    tf:    x/127.5 - 1              (scale + bias)
    torch: (x/255 - mean)/std       (scale + bias)

with the nearest resize (PIL convention, Keras ``load_img`` parity) as a
gather of rows and columns in front. On the card one CUDA launch
(``csrc/preprocess.cu``) does gather, flip, affine, cast and NHWC store in
one pass: at the same size (the maps are the identity) a kernel that takes
8 whole pixels a thread, at any other size one that stages the source rows
in shared memory and gathers from there; see that file for what bounds it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpucap_torch import _build
from tpucap_torch.data.preprocess import CAFFE_MEAN_BGR, TORCH_MEAN, TORCH_STD


def _mode_scale_bias(mode: str) -> tuple[np.ndarray, np.ndarray, bool]:
    """-> (scale (3,), bias (3,), flip_channels). y = scale * x' + bias where
    x' is the channel-flipped input when flip_channels."""
    if mode == "caffe":
        return (
            np.ones(3, np.float32),
            -CAFFE_MEAN_BGR.astype(np.float32),
            True,
        )
    if mode == "tf":
        return (
            np.full(3, 1 / 127.5, np.float32),
            np.full(3, -1.0, np.float32),
            False,
        )
    if mode == "torch":
        return (
            (1.0 / (255.0 * TORCH_STD)).astype(np.float32),
            (-TORCH_MEAN / TORCH_STD).astype(np.float32),
            False,
        )
    raise ValueError(f"unknown preprocess mode {mode!r}")


def _nearest_indices(dst: int, src: int) -> np.ndarray:
    """PIL-convention nearest map: floor((i + 0.5) * src/dst), clipped."""
    idx = np.floor((np.arange(dst) + 0.5) * (src / dst)).astype(np.int32)
    return np.minimum(idx, src - 1)


@functools.lru_cache(maxsize=32)
def _index_table(dst: int, src: int, device: torch.device) -> torch.Tensor:
    """The nearest map as an int32 tensor, uploaded once per device."""
    return torch.from_numpy(_nearest_indices(dst, src)).to(device)


def preprocess_u8_plain(images, rows, cols, scale, bias, flip, out_dtype):
    """Plain PyTorch version of K1: the same gather, flip and f32 affine.
    ``scale``/``bias`` are (3,) f32 tensors on the images' device. The
    affine is rounded to f32 once, as the fused multiply-add of K1 and of
    XLA: in f64, where the product of a byte and an f32 and the sum with
    an f32 bias are exact, then to f32."""
    x = images[:, rows.long()][:, :, cols.long()]
    if flip:
        x = x.flip(-1)
    y = x.double() * scale.double() + bias.double()
    return y.float().to(out_dtype)


def preprocess_u8(images, size_hw, mode: str, out_dtype=torch.float32):
    """uint8 (B, H, W, 3) -> (B, size_h, size_w, 3) in ``out_dtype``.

    On a CUDA tensor this launches kernel K1 (one launch per call); on a CPU
    tensor it runs ``preprocess_u8_plain``."""
    B, H, W, C = images.shape
    if C != 3 or images.dtype != torch.uint8:
        raise ValueError(
            f"expected a uint8 (B, H, W, 3) batch, got {images.dtype} "
            f"{tuple(images.shape)}"
        )
    S_h, S_w = size_hw
    scale, bias, flip = _mode_scale_bias(mode)
    rows = _index_table(S_h, H, images.device)
    cols = _index_table(S_w, W, images.device)
    if images.device.type == "cpu":
        return preprocess_u8_plain(
            images, rows, cols, torch.from_numpy(scale),
            torch.from_numpy(bias), flip, out_dtype,
        )
    _build.require(images, "images", torch.uint8)
    if out_dtype not in _build.DTYPE_CODES:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    if B > 65535 and (S_h, S_w) != (H, W):
        raise ValueError("preprocess_u8: a resize takes at most 65535 images a call")
    out = torch.empty((B, S_h, S_w, 3), dtype=out_dtype, device=images.device)
    fn = _build.kernel("preprocess", "tpucap_preprocess_u8", _ARGTYPES)
    err = fn(
        images.data_ptr(), rows.data_ptr(), cols.data_ptr(), out.data_ptr(),
        B, H, W, S_h, S_w,
        (ctypes.c_float * 3)(*scale.tolist()),
        (ctypes.c_float * 3)(*bias.tolist()),
        int(flip), _build.DTYPE_CODES[out_dtype],
        _build.stream_ptr(images),
    )
    _build.check("preprocess", "tpucap_preprocess_u8", err)
    preprocess_u8.launches += 1
    return out


preprocess_u8.launches = 0

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def resize_nearest(images, size: int):
    """(B, H, W, C) -> (B, size, size, C) nearest resize (a plain gather)."""
    B, H, W, C = images.shape
    if H == size and W == size:
        return images
    rows = _index_table(size, H, images.device).long()
    cols = _index_table(size, W, images.device).long()
    return images[:, rows][:, :, cols]


def normalize_images(images, mode: str = "caffe", *, out_dtype=None):
    """(B, H, W, 3) uint8 RGB -> (B, H, W, 3) float, mode-normalized."""
    _, H, W, _ = images.shape
    return preprocess_u8(images, (H, W), mode, out_dtype or torch.float32)


def fused_preprocess(images, size: int, mode: str = "caffe", *, out_dtype=None):
    """uint8 (B, H, W, 3) -> normalized float (B, size, size, 3) in one
    pass (the resize gather fused with the normalize)."""
    return preprocess_u8(images, (size, size), mode, out_dtype or torch.float32)
