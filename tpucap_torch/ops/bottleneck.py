"""Fused ResNet identity-bottleneck block: kernel K4 and its plain version
(port of ``tpucap.ops.pallas.bottleneck``).

    out = relu(x + c3(relu(c2(relu(c1(x))))))

for BN-folded 1x1 / 3x3 (SAME) / 1x1 convs with biases, stride 1 and no
conv shortcut: the 12 identity blocks of ResNet-50 (each stack's first
block has a conv shortcut, so 16 - 4). Numerics as in the TPU kernel: each
conv accumulates in f32 and is rounded to the activation dtype before its
bias is added in that dtype; the 3x3's nine taps share one f32 sum; the
output is relu((y3 + b3) + x). The unfused ``encoders.common.conv``
rounds the same way.

The TPU kernel sizes whole images into VMEM (``_group_for``); the CUDA
kernel (``csrc/bottleneck.cu``) tiles each image spatially instead, so it
takes no ``group``. That file says what bounds it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpucap_torch import _build


def fused_identity_block_plain(p1, p2, p3, x):
    """Plain PyTorch version of K4. Kernels OIHW, x NHWC. Each conv runs in
    f32 on upcast operands (exact products, one f32 sum) and is then
    rounded to x's dtype, as the TPU kernel's f32 accumulators are."""
    dt = x.dtype

    def conv(p, y, pad):
        z = F.conv2d(y.float(), p["kernel"].float(), padding=pad).to(dt)
        return z + p["bias"].to(dt)[:, None, None]

    xn = x.permute(0, 3, 1, 2)
    y = torch.relu(conv(p1, xn, 0))
    y = torch.relu(conv(p2, y, 1))
    out = torch.relu(conv(p3, y, 0) + xn)
    return out.permute(0, 2, 3, 1)


def fused_identity_block(p1, p2, p3, x):
    """p1/p2/p3: {"kernel", "bias"} with OIHW kernels (M, C, 1, 1),
    (M, M, 3, 3), (C, M, 1, 1); x (B, H, W, C) NHWC, f32 or bf16. C and M
    must be multiples of 64, and C of 128 in bf16 (every ResNet-50 block).

    On CUDA tensors this launches kernel K4 (one launch per call); on CPU
    tensors it runs ``fused_identity_block_plain``."""
    if x.device.type == "cpu":
        return fused_identity_block_plain(p1, p2, p3, x)
    B, H, W, C = x.shape
    M = p1["kernel"].shape[0]
    dt = x.dtype
    if dt not in _build.DTYPE_CODES:
        raise ValueError(f"fused_identity_block takes f32 or bf16, got {dt}")
    if C % 64 or M % 64:
        raise ValueError(f"fused_identity_block needs C and M multiples of 64, got {C}, {M}")
    if dt == torch.bfloat16 and C % 128:
        raise ValueError(f"fused_identity_block's bf16 kernel needs C a multiple of 128, got {C}")
    x = x.contiguous()
    # OIHW kernels on the card are channels_last, i.e. (out, kh, kw, in)
    # bytes: these views are then contiguous and nothing is copied.
    w1 = p1["kernel"].to(dt).reshape(M, C).contiguous()
    w2 = p2["kernel"].to(dt).permute(0, 2, 3, 1).contiguous()
    w3 = p3["kernel"].to(dt).reshape(C, M).contiguous()
    b1, b2, b3 = (p["bias"].to(dt).contiguous() for p in (p1, p2, p3))
    for name, t, shape in (
        ("x", x, (B, H, W, C)), ("w1", w1, (M, C)), ("w2", w2, (M, 3, 3, M)),
        ("w3", w3, (C, M)), ("b1", b1, (M,)), ("b2", b2, (M,)), ("b3", b3, (C,)),
    ):
        _build.require(t, name, dt, shape)
        align = 4 if name.startswith("b") else 16  # 16-byte copies; bf16 pairs of bias
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    out = torch.empty_like(x)
    fn = _build.kernel("bottleneck", "tpucap_identity_block", _ARGTYPES)
    err = fn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), out.data_ptr(), B, H, W, C, M,
        _build.DTYPE_CODES[dt], _build.stream_ptr(x),
    )
    _build.check("bottleneck", "tpucap_identity_block", err)
    fused_identity_block.launches += 1
    return out


fused_identity_block.launches = 0

_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
