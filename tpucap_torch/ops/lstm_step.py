"""Fused LSTM cell: kernel K2 and its plain version (port of
``tpucap.ops.pallas.lstm_step``).

One launch computes z = x@W + h@U + b with f32 accumulation, the Keras
gates i, f, g, o, c' = f*c + i*tanh(g) and h' = sigmoid(o)*tanh(c'),
writing h' and c' in the dtype of h and c and, for the merge step, h' in
f32. ``csrc/lstm_step.cu`` holds the kernel and what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from tpucap_torch import _build
from tpucap_torch.models.layers import lstm_gates_f32


def lstm_cell_plain(x, h, c, kernel, recurrent, bias):
    """Plain PyTorch version of K2 -> (h', c', h' in f32)."""
    h32, c32 = lstm_gates_f32(kernel, recurrent, bias, x, h, c)
    return h32.to(h.dtype), c32.to(c.dtype), h32


def lstm_cell(x, h, c, kernel, recurrent, bias):
    """x (B, E), h/c (B, U), kernel (E, 4U), recurrent (U, 4U), bias (4U,),
    all of one dtype (f32 or bf16) -> (h', c', h' in f32).

    On CUDA tensors this launches kernel K2, which copies 16-byte rows:
    E and U must be multiples of 8 and every tensor 16-byte aligned. On
    CPU tensors it runs ``lstm_cell_plain``."""
    if x.device.type == "cpu":
        return lstm_cell_plain(x, h, c, kernel, recurrent, bias)
    B, E = x.shape
    U = h.shape[-1]
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"lstm_cell takes f32 or bf16, got {dt}")
    if E % 8 or U % 8:
        raise ValueError(f"lstm_cell needs E and U multiples of 8 (16-byte rows), got E={E}, U={U}")
    for name, t, shape in (
        ("x", x, (B, E)),
        ("h", h, (B, U)),
        ("c", c, (B, U)),
        ("kernel", kernel, (E, 4 * U)),
        ("recurrent", recurrent, (U, 4 * U)),
        ("bias", bias, (4 * U,)),
    ):
        _build.require(t, name, dt, shape)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    h32 = torch.empty((B, U), dtype=torch.float32, device=x.device)
    fn = _build.kernel("lstm_step", "tpucap_lstm_cell", _ARGTYPES)
    err = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), kernel.data_ptr(),
        recurrent.data_ptr(), bias.data_ptr(), h_out.data_ptr(),
        c_out.data_ptr(), h32.data_ptr(), B, E, U, _build.DTYPE_CODES[dt],
        _build.stream_ptr(x),
    )
    _build.check("lstm_step", "tpucap_lstm_cell", err)
    lstm_cell.launches += 1
    return h_out, c_out, h32


lstm_cell.launches = 0

_ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
