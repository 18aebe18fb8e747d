"""Token-grid softmax attention: kernel K5, its backward kernels K5b, and
their plain versions (port of the stock TPU flash attention that
``tpucap.models.encoders.vit._flash_ctx`` calls, forward and backward).

    ctx = softmax(scale * q k^T) v        per image and head, no mask

with the stock kernel's numerics: scores accumulated in f32 and then
scaled, softmax statistics in f32, the unnormalised probabilities cast to
v's dtype for the product with v (f32 accumulation), then divided by their
sum and cast to q's dtype. The TPU path pads the 196 ViT tokens to 256 and
fences the pad off with segment ids; the CUDA kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``) mask keys
and queries past L themselves and read q, k and v with strides, so the
views of the fused qkv projection need no copy.

Training goes through ``flash_attention_qkv``: when the projection needs a
gradient it runs ``FlashAttentionQKV``, whose forward launches K5 with its
row-statistics output (the f32 log-sum-exp of each row's scaled scores)
and whose backward computes di = sum_d O dO as a plain torch reduction,
then launches the dK/dV and the dQ kernel, which write one (B, L, 3H)
gradient buffer with the projection's strides. Without a gradient (under
``torch.no_grad``, ``inference_mode`` or a frozen encoder) it launches K5
alone, with no statistics, as serving always has.
"""

from __future__ import annotations

import ctypes

import torch

from tpucap_torch import _build

HEAD_DIM = 64  # the CUDA kernels' one head width, ViT-B/16's (768 / 12)


def flash_attention_plain(q, k, v, scale: float, *, with_lse: bool = False):
    """q, k, v (B, L, h, d) -> ctx (B, L, h, d) in q's dtype; with
    ``with_lse`` also the rows' f32 log-sum-exp (B, h, L)."""
    s = torch.einsum("blhd,bthd->bhlt", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    total = p.sum(dim=-1)  # (B, h, L)
    ctx = torch.einsum("bhlt,bthd->blhd", p.to(v.dtype).float(), v.float())
    out = (ctx / total.transpose(1, 2)[..., None]).to(q.dtype)
    if with_lse:
        return out, m[..., 0] + torch.log(total)
    return out


def _scores_p(q, k, lse, scale):
    """p = exp(scale q k^T - lse) in f32, (B, h, L, L)."""
    return torch.exp(torch.einsum("blhd,bthd->bhlt", q.float(), k.float()) * scale - lse[..., None])


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, scale: float):
    """Plain version of the dK/dV kernel, the stock backward's numerics:
    dV = p^T dO with p cast to dO's dtype; ds = (dO v^T - di) p scale;
    dK = ds^T q with ds cast to dO's dtype; f32 sums, cast to k's dtype.
    lse, di (B, h, L) f32. -> (dk, dv) (B, L, h, d)."""
    p = _scores_p(q, k, lse, scale)
    dof = do.float()
    dv = torch.einsum("bhlt,blhd->bthd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("blhd,bthd->bhlt", dof, v.float())
    ds = (dp - di[..., None]) * p * scale
    dk = torch.einsum("bhlt,blhd->bthd", ds.to(do.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, di, scale: float):
    """Plain version of the dQ kernel: dQ = ds k with ds cast to k's dtype,
    f32 sums, cast to q's dtype. -> dq (B, L, h, d)."""
    p = _scores_p(q, k, lse, scale)
    dp = torch.einsum("blhd,bthd->bhlt", do.float(), v.float())
    ds = (dp - di[..., None]) * p * scale
    return torch.einsum("bhlt,bthd->blhd", ds.to(k.dtype).float(), k.float()).to(q.dtype)


def attention_di(o, do):
    """di = sum_d O dO in f32, (B, h, L): the stock backward's first step,
    a plain reduction outside either kernel."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """The whole backward from the forward's output o and row statistics
    lse: -> (dq, dk, dv), each (B, L, h, d)."""
    di = attention_di(o, do)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, scale)
    return flash_attention_bwd_dq_plain(q, k, v, do, lse, di, scale), dk, dv


def _check_qkv(q, k, v, *outs):
    """Kernel-side checks shared by the forward and backward wrappers: q,
    k, v (and the gradient views) alike in device, dtype, shape and
    strides, unit last stride, 16-byte rows; returns the dtype code."""
    dt = q.dtype
    if dt not in _build.DTYPE_CODES:
        raise ValueError(f"flash attention takes f32 or bf16, got {dt}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), *outs):
        if t.device != q.device or t.dtype != dt or t.shape != q.shape:
            raise ValueError(f"{name} must match q: {t.device} {t.dtype} {tuple(t.shape)}")
        if t.stride() != q.stride():
            raise ValueError(f"{name} must share q's strides {q.stride()}, has {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash attention takes head width {HEAD_DIM}, got {q.shape[-1]}")
    sb, sl, sh, sd = q.stride()
    if sd != 1 or sb % vec or sl % vec or sh % vec:
        raise ValueError(f"flash attention needs unit last stride and 16-byte rows, got {q.stride()}")
    return _build.DTYPE_CODES[dt]


def _check_bwd_inputs(q, do, lse, di):
    B, L, h, _ = q.shape
    _build.require(do, "do", q.dtype, q.shape)
    _build.require(lse, "lse", torch.float32, (B, h, L))
    _build.require(di, "di", torch.float32, (B, h, L))


def flash_attention(q, k, v, scale: float, *, with_lse: bool = False):
    """q, k, v (B, L, h, 64), f32 or bf16, sharing strides with a unit
    stride on the last axis (e.g. views into one (B, L, 3H) projection)
    -> ctx (B, L, h, 64) contiguous; with ``with_lse`` also the rows' f32
    log-sum-exp (B, h, L), the backward's residual.

    On CUDA tensors this launches kernel K5 (one launch per call); on CPU
    tensors it runs ``flash_attention_plain``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, with_lse=with_lse)
    code = _check_qkv(q, k, v)
    B, L, h, d = q.shape
    sb, sl, sh, _ = q.stride()
    out = torch.empty((B, L, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, h, L), dtype=torch.float32, device=q.device) if with_lse else None
    fn = _build.kernel("flash_attention", "tpucap_flash_attention", _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, B, L, h, sb, sl, sh, float(scale), code,
        _build.stream_ptr(q),
    )
    _build.check("flash_attention", "tpucap_flash_attention", err)
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, di, scale: float, dk, dv) -> None:
    """dK and dV into ``dk``, ``dv`` (views with q's strides, e.g. into one
    (B, L, 3H) gradient buffer). do (B, L, h, 64) contiguous in q's dtype;
    lse, di (B, h, L) f32. On CUDA tensors this launches the dK/dV kernel
    (one launch per call); on CPU tensors it runs its plain version."""
    if q.device.type == "cpu":
        a, b = flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, scale)
        dk.copy_(a)
        dv.copy_(b)
        return
    code = _check_qkv(q, k, v, ("dk", dk), ("dv", dv))
    _check_bwd_inputs(q, do, lse, di)
    B, L, h, _ = q.shape
    sb, sl, sh, _ = q.stride()
    fn = _build.kernel("flash_attention_bwd", "tpucap_flash_attention_bwd_dkv", _BWD_DKV_ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, L, h, sb, sl, sh, float(scale), code,
        _build.stream_ptr(q),
    )
    _build.check("flash_attention_bwd", "tpucap_flash_attention_bwd_dkv", err)
    flash_attention_bwd_dkv.launches += 1


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, di, scale: float, dq) -> None:
    """dQ into ``dq`` (a view with q's strides). Inputs as for
    ``flash_attention_bwd_dkv``. On CUDA tensors this launches the dQ
    kernel (one launch per call); on CPU tensors it runs its plain
    version."""
    if q.device.type == "cpu":
        dq.copy_(flash_attention_bwd_dq_plain(q, k, v, do, lse, di, scale))
        return
    code = _check_qkv(q, k, v, ("dq", dq))
    _check_bwd_inputs(q, do, lse, di)
    B, L, h, _ = q.shape
    sb, sl, sh, _ = q.stride()
    fn = _build.kernel("flash_attention_bwd", "tpucap_flash_attention_bwd_dq", _BWD_DQ_ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        dq.data_ptr(), B, L, h, sb, sl, sh, float(scale), code, _build.stream_ptr(q),
    )
    _build.check("flash_attention_bwd", "tpucap_flash_attention_bwd_dq", err)
    flash_attention_bwd_dq.launches += 1


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_attributes(dtype) -> dict[str, dict[str, int]]:
    """The compiled backward kernels of ``dtype``'s route, read from the
    CUDA runtime: registers a thread, shared memory a block (static and
    dynamic) and blocks an SM holds at once, by wrapper name."""
    if dtype not in _build.DTYPE_CODES:
        raise ValueError(f"flash attention takes f32 or bf16, got {dtype}")
    fn = _build.kernel("flash_attention_bwd", "tpucap_flash_attention_bwd_attributes", _ATTR_ARGTYPES)
    out = {}
    for which, name in enumerate(("flash_attention_bwd_dkv", "flash_attention_bwd_dq")):
        vals = [ctypes.c_int() for _ in range(3)]
        err = fn(which, _build.DTYPE_CODES[dtype], *(ctypes.byref(x) for x in vals))
        _build.check("flash_attention_bwd", "tpucap_flash_attention_bwd_attributes", err)
        out[name] = dict(zip(("registers", "smem_bytes", "blocks_per_sm"), (x.value for x in vals)))
    return out


def qkv_views(qkv, heads: int):
    """(B, L, 3H) -> q, k, v (B, L, heads, H / heads), views."""
    B, L, H3 = qkv.shape
    H = H3 // 3
    return tuple(qkv[..., i * H : (i + 1) * H].reshape(B, L, heads, H // heads) for i in range(3))


class FlashAttentionQKV(torch.autograd.Function):
    """ctx = attention(q, k, v) over the views of one qkv projection, with
    K5's backward. The Function takes the projection itself, so its
    gradient is one (B, L, 3H) buffer that the two backward kernels fill at
    the projection's strides; taking q, k and v apart would have autograd
    build three zero-filled (B, L, 3H) slice gradients and add them."""

    @staticmethod
    def forward(ctx, qkv, heads: int, scale: float):
        qkv = qkv.contiguous()
        out, lse = flash_attention(*qkv_views(qkv, heads), scale, with_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        q, k, v = qkv_views(qkv, ctx.heads)
        do = dout.contiguous()
        di = attention_di(out, do)
        dqkv = torch.empty_like(qkv)
        dq, dk, dv = qkv_views(dqkv, ctx.heads)
        flash_attention_bwd_dkv(q, k, v, do, lse, di, ctx.scale, dk, dv)
        flash_attention_bwd_dq(q, k, v, do, lse, di, ctx.scale, dq)
        return dqkv, None, None


def flash_attention_qkv(qkv, heads: int, scale: float):
    """Attention over one (B, L, 3H) qkv projection -> ctx (B, L, heads, d):
    through ``FlashAttentionQKV`` when the projection needs a gradient,
    else K5 alone on its views."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return FlashAttentionQKV.apply(qkv, heads, scale)
    return flash_attention(*qkv_views(qkv, heads), scale)


_ARGTYPES = (
    (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (ctypes.c_int64,) * 3
    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
)
_BWD_DKV_ARGTYPES = (
    (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 3 + (ctypes.c_int64,) * 3
    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
)
_BWD_DQ_ARGTYPES = (
    (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 3 + (ctypes.c_int64,) * 3
    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
)
_ATTR_ARGTYPES = (ctypes.c_int, ctypes.c_int) + (ctypes.POINTER(ctypes.c_int),) * 3
