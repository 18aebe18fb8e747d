"""Token-grid softmax attention: kernel K5 and its plain version (port of
the stock TPU flash attention that ``tpucap.models.encoders.vit._flash_ctx``
calls).

    ctx = softmax(scale * q k^T) v        per image and head, no mask

with the stock kernel's numerics: scores accumulated in f32 and then
scaled, softmax statistics in f32, the unnormalised probabilities cast to
v's dtype for the product with v (f32 accumulation), then divided by their
sum and cast to q's dtype. The TPU path pads the 196 ViT tokens to 256 and
fences the pad off with segment ids; the CUDA kernel
(``csrc/flash_attention.cu``) masks keys past L itself and reads q, k and v
with strides, so the views of the fused qkv projection need no copy.
"""

from __future__ import annotations

import ctypes

import torch

from tpucap_torch import _build

HEAD_DIM = 64  # the CUDA kernel's one head width, ViT-B/16's (768 / 12)


def flash_attention_plain(q, k, v, scale: float):
    """q, k, v (B, L, h, d) -> ctx (B, L, h, d) in q's dtype."""
    s = torch.einsum("blhd,bthd->bhlt", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1).transpose(1, 2)[..., None]  # (B, L, h, 1)
    ctx = torch.einsum("bhlt,bthd->blhd", p.to(v.dtype).float(), v.float())
    return (ctx / denom).to(q.dtype)


def flash_attention(q, k, v, scale: float):
    """q, k, v (B, L, h, 64), f32 or bf16, sharing strides with a unit
    stride on the last axis (e.g. views into one (B, L, 3H) projection)
    -> ctx (B, L, h, 64) contiguous.

    On CUDA tensors this launches kernel K5 (one launch per call); on CPU
    tensors it runs ``flash_attention_plain``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    B, L, h, d = q.shape
    dt = q.dtype
    if dt not in _build.DTYPE_CODES:
        raise ValueError(f"flash_attention takes f32 or bf16, got {dt}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != dt or t.shape != q.shape:
            raise ValueError(f"{name} must match q: {t.device} {t.dtype} {tuple(t.shape)}")
        if t.stride() != q.stride():
            raise ValueError(f"{name} must share q's strides {q.stride()}, has {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if d != HEAD_DIM:
        raise ValueError(f"flash_attention takes head width {HEAD_DIM}, got {d}")
    sb, sl, sh, sd = q.stride()
    if sd != 1 or sb % vec or sl % vec or sh % vec:
        raise ValueError(f"flash_attention needs unit last stride and 16-byte rows, got {q.stride()}")
    out = torch.empty((B, L, h, d), dtype=dt, device=q.device)
    fn = _build.kernel("flash_attention", "tpucap_flash_attention", _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, h,
        sb, sl, sh, float(scale), _build.DTYPE_CODES[dt], _build.stream_ptr(q),
    )
    _build.check("flash_attention", "tpucap_flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

_ARGTYPES = (
    (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (ctypes.c_int64,) * 3
    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
)
