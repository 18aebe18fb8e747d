"""Fused merge-decoder step: kernel K3 and its plain version (port of
``tpucap.ops.pallas.decoder_step``).

One step of a 1-layer ``MergeDecoder`` after the embedding gather, with
the TPU kernel's numerics (``fe + h'`` and ``merged`` stay f32):

    h', c', h'32 = K2(x, h, c)                        (lstm_step.lstm_cell)
    merged       = relu((fe + h'32) @ W_p + b_p)      (merge_head, f32)
    logits       = merged @ W_o + b_o                 (vocab_proj, f32)

Three launches per step on one stream replace the TPU's single sequential
grid; ``csrc/decoder_step.cu`` says why and what bounds each. With bf16
weights both stages run on tensor cores on an exact three-term bf16 split
of their f32 operand (``split3``: of ``fe + h'32`` in the head, of
``merged`` in the projection), reading W_p and W_o K-major: the step that
``make_fused_merge_step`` returns makes those copies once, at its first
call, and keeps each while its weight tensor stays the same. The embedding
lookup stays a plain gather outside the kernels, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from tpucap_torch import _build
from tpucap_torch.models.layers import embed
from tpucap_torch.ops.lstm_step import lstm_cell


def merge_head_plain(fe, h32, wp, bp):
    """relu((fe + h'32) @ W_p + b_p) in f32."""
    pre = torch.matmul(fe.float() + h32, wp.float()) + bp.float()
    return torch.relu(pre)


def merge_head_split_plain(fe, h32, wp, bp):
    """The bf16 merge-head kernel's arithmetic in plain PyTorch: a = fe +
    h'32 in f32, its three bf16 terms' products with the bf16 W_p (each
    exact in f32) summed in f32, then bias and relu."""
    w = wp.float()
    a = fe.float() + h32
    return torch.relu(sum(torch.matmul(t.float(), w) for t in split3(a)) + bp.float())


def vocab_proj_plain(merged, wo, bo):
    """merged (f32) @ W_o + b_o in f32."""
    return torch.matmul(merged, wo.float()) + bo.float()


def split3(m):
    """f32 m -> bf16 (hi, mid, lo) with hi + mid + lo == m exactly in f32:
    each term is the previous remainder rounded to nearest bf16, and the
    remainder of a round-to-nearest is exact in f32. The bf16 kernels
    split their f32 operand so: the projection ``merged`` in shared memory,
    the merge head ``fe + h'32`` in registers."""
    hi = m.to(torch.bfloat16)
    r = m - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def vocab_proj_split_plain(merged, wo, bo):
    """The bf16 kernel's arithmetic in plain PyTorch: the three terms'
    products with the bf16 W_o (each exact in f32), summed in f32."""
    w = wo.float()
    return sum(torch.matmul(t.float(), w) for t in split3(merged)) + bo.float()


def weight_kmajor(w):
    """W (K, N) -> W^T (N, K), contiguous: the B operand of the bf16
    kernels (W_p in the head, W_o in the projection), read by TMA in
    64-deep boxes; every row is 16-byte aligned whatever N is."""
    return w.t().contiguous()


def _linear(fn_name, counter, a_args, w, b, M, N, K, dt, device):
    _build.require(w, "weight", dt, (K, N))
    _build.require(b, "bias", dt, (N,))
    out = torch.empty((M, N), dtype=torch.float32, device=device)
    fn = _build.kernel("decoder_step", fn_name, _ARGTYPES[fn_name])
    err = fn(
        *a_args, w.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
        _build.DTYPE_CODES[dt], torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check("decoder_step", fn_name, err)
    counter.launches += 1
    return out


def _aligned16(**tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def merge_head(fe, h32, wp, bp, wp_t=None):
    """fe (B, U) in the weights' dtype, h32 (B, U) f32, wp (U, U), bp (U,)
    -> merged (B, U) f32. Launches the merge-head stage of K3 on CUDA
    tensors; runs ``merge_head_plain`` on CPU tensors. With bf16 weights and
    U a multiple of 64 up to 256 the kernel runs on tensor cores and reads
    W_p K-major: ``wp_t`` is ``weight_kmajor(wp)``, made here when not
    given. Other widths, and f32, take the SIMT kernel."""
    if fe.device.type == "cpu":
        return merge_head_plain(fe, h32, wp, bp)
    M, K = fe.shape
    _build.require(fe, "fe", wp.dtype, (M, K))
    _build.require(h32, "h32", torch.float32, (M, K))
    N = wp.shape[1]
    if wp.dtype != torch.bfloat16 or K % 64 or K > 256 or N % 32:
        return _linear(
            "tpucap_merge_head", merge_head, (fe.data_ptr(), h32.data_ptr()),
            wp, bp, M, N, K, wp.dtype, fe.device,
        )
    if wp_t is None:
        wp_t = weight_kmajor(wp)
    _build.require(wp, "wp", torch.bfloat16, (K, N))
    _build.require(wp_t, "wp_t", torch.bfloat16, (N, K))
    _build.require(bp, "bp", torch.bfloat16, (N,))
    _aligned16(fe=fe, h32=h32, wp_t=wp_t)
    out = torch.empty((M, N), dtype=torch.float32, device=fe.device)
    fn = _build.kernel("decoder_step", "tpucap_merge_head_t", _ARGTYPES["tpucap_merge_head_t"])
    err = fn(
        fe.data_ptr(), h32.data_ptr(), wp_t.data_ptr(), bp.data_ptr(), out.data_ptr(),
        M, N, K, _build.stream_ptr(fe),
    )
    _build.check("decoder_step", "tpucap_merge_head_t", err)
    merge_head.launches += 1
    return out


merge_head.launches = 0


def vocab_proj(merged, wo, bo, wo_t=None):
    """merged (B, U) f32, wo (U, V), bo (V,) -> logits (B, V) f32. Launches
    the projection stage of K3 on CUDA tensors; runs ``vocab_proj_plain``
    on CPU tensors. With bf16 weights and U a multiple of 64 up to 256 the
    kernel runs on tensor cores and reads W_o K-major: ``wo_t`` is
    ``weight_kmajor(wo)``, made here when not given. Other widths,
    and f32, take the SIMT kernel."""
    if merged.device.type == "cpu":
        return vocab_proj_plain(merged, wo, bo)
    M, K = merged.shape
    _build.require(merged, "merged", torch.float32)
    if wo.dtype != torch.bfloat16 or K % 64 or K > 256:
        return _linear(
            "tpucap_vocab_proj", vocab_proj, (merged.data_ptr(),),
            wo, bo, M, wo.shape[1], K, wo.dtype, merged.device,
        )
    N = wo.shape[1]
    if wo_t is None:
        wo_t = weight_kmajor(wo)
    _build.require(wo, "wo", torch.bfloat16, (K, N))
    _build.require(wo_t, "wo_t", torch.bfloat16, (N, K))
    _build.require(bo, "bo", torch.bfloat16, (N,))
    _aligned16(merged=merged, wo_t=wo_t)
    out = torch.empty((M, N), dtype=torch.float32, device=merged.device)
    fn = _build.kernel("decoder_step", "tpucap_vocab_proj_t", _ARGTYPES["tpucap_vocab_proj_t"])
    err = fn(
        merged.data_ptr(), wo_t.data_ptr(), bo.data_ptr(), out.data_ptr(), M, N, K,
        _build.stream_ptr(merged),
    )
    _build.check("decoder_step", "tpucap_vocab_proj_t", err)
    vocab_proj.launches += 1
    return out


vocab_proj.launches = 0

_ARGTYPES = {
    "tpucap_merge_head": (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4
    + (ctypes.c_void_p,),
    "tpucap_vocab_proj": (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
    + (ctypes.c_void_p,),
    "tpucap_vocab_proj_t": (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3
    + (ctypes.c_void_p,),
    "tpucap_merge_head_t": (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3
    + (ctypes.c_void_p,),
}


def fused_merge_step(params, state, x, wp_t=None, wo_t=None):
    """Fused MergeDecoder (1-layer) step after the embedding lookup.

    params: MergeDecoder params (cells[0], pre_out, out). state: {fe, h, c}
    with h/c shaped (B, 1, U). x: (B, E) embedded last tokens. wp_t, wo_t:
    the K-major copies of bf16 W_p and W_o, if the caller keeps them
    (``merge_head``, ``vocab_proj``). -> (logits (B, V) f32, new_state)."""
    cell = params["cells"][0]
    h = state["h"][:, 0].contiguous()
    c = state["c"][:, 0].contiguous()
    h_new, c_new, h32 = lstm_cell(
        x, h, c, cell["kernel"], cell["recurrent"], cell["bias"]
    )
    merged = merge_head(
        state["fe"], h32, params["pre_out"]["kernel"], params["pre_out"]["bias"], wp_t
    )
    logits = vocab_proj(merged, params["out"]["kernel"], params["out"]["bias"], wo_t)
    new_state = {
        "fe": state["fe"],
        "h": h_new[:, None, :],
        "c": c_new[:, None, :],
    }
    return logits, new_state


def make_fused_merge_step(decoder):
    """Drop-in step_fn for the decode engines (1-layer MergeDecoder only).
    The pipeline makes one per decode; with bf16 weights it keeps the K-major
    copies of W_p and W_o from its first call, each for as long as its
    weight is the same tensor."""
    if decoder.num_layers != 1:
        raise ValueError("fused step supports single-layer MergeDecoder")

    kmajor = {"pre_out": (None, None), "out": (None, None)}  # (W, W^T): one copy per decode

    def copy_of(params, layer):
        w = params[layer]["kernel"]
        if w.dtype == torch.bfloat16 and kmajor[layer][0] is not w:
            kmajor[layer] = (w, weight_kmajor(w))
        return kmajor[layer][1] if kmajor[layer][0] is w else None

    def step(params, state, token):
        wp_t, wo_t = copy_of(params, "pre_out"), copy_of(params, "out")
        x = embed(params["embedding"], token)
        return fused_merge_step(params, state, x, wp_t, wo_t)

    return step
