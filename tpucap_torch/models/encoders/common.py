"""Conv-net primitives with Keras-equivalent semantics (port of
``tpucap.models.encoders.common``).

Activations are NHWC at every public function, as in the JAX package.
Inside, a convolution views them as NCHW in ``channels_last`` memory format
(the same bytes, so the permute is free) and runs ``F.conv2d`` — cuDNN on
the card, which the JAX package likewise leaves to XLA. Conv kernels are
stored OIHW (``tpucap_torch.convert`` turns the JAX package's HWIO into it).

Inference-mode BatchNorm only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpucap_torch.core import refuse_int8
from tpucap_torch.models.layers import glorot_uniform


def init_conv(gen, kh, kw, cin, cout, use_bias=True):
    p = {
        "kernel": glorot_uniform(
            gen, (cout, cin, kh, kw), kh * kw * cin, kh * kw * cout
        )
    }
    if use_bias:
        p["bias"] = torch.zeros(cout)
    return p


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TF 'SAME' padding (the extra pixel goes after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(p, x, stride=(1, 1), padding="SAME"):
    """x (B, H, W, Cin) -> (B, H', W', Cout); kernel OIHW. The convolution
    comes out in x's dtype and the bias is added after it, in that dtype,
    as in the JAX package and kernel K4. The JAX package's int8 branch is
    not ported: an int8 kernel raises."""
    if p["kernel"].dtype == torch.int8:
        refuse_int8("conv")
    w = p["kernel"].to(x.dtype)
    xn = x.permute(0, 3, 1, 2)
    if padding == "VALID":
        pad = 0
    elif padding == "SAME":
        (t, bt) = _same_pads(x.shape[1], w.shape[2], stride[0])
        (l, r) = _same_pads(x.shape[2], w.shape[3], stride[1])
        if t == bt and l == r:
            pad = (t, l)
        else:
            xn = F.pad(xn, (l, r, t, bt))
            pad = 0
    else:
        raise ValueError(f"unknown padding {padding!r}")
    # No bias inside the call: in a bf16 flow the f32 sum is rounded to
    # bf16 first and the bias added in bf16 after, two roundings as
    # tpucap does them (one, with the bias inside, differs in the last bit).
    y = F.conv2d(xn, w, None, stride=stride, padding=pad).permute(0, 2, 3, 1)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def init_bn(c, scale=True):
    p = {"beta": torch.zeros(c), "mean": torch.zeros(c), "var": torch.ones(c)}
    if scale:
        p["gamma"] = torch.ones(c)
    return p


def batch_norm(p, x, eps=1e-3):
    """Inference BN over the channel (last) axis, in the activation dtype;
    eps defaults to the Keras BatchNormalization default."""
    inv = torch.rsqrt(p["var"].to(x.dtype) + eps)
    if "gamma" in p:
        inv = inv * p["gamma"].to(x.dtype)
    return (x - p["mean"].to(x.dtype)) * inv + p["beta"].to(x.dtype)


def max_pool(x, window, stride, padding="VALID"):
    """VALID only: no encoder of the JAX package pools with SAME."""
    if padding != "VALID":
        raise ValueError(f"max_pool: padding {padding!r}; the encoders pool VALID")
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def avg_pool_same(x, window):
    """Stride-1 SAME average pool dividing by the count of *valid* elements
    per window (TF/Keras: the padding is left out of the mean). In f32 one
    library pool, which sums in its own order (within an ulp of the JAX
    package's). In any other dtype the window is summed in that dtype in
    row-major order, then divided by the counts, also in that dtype, so a
    bf16 flow rounds where the JAX package's ``reduce_window`` rounds."""
    lo = (window - 1) // 2
    hi = window - 1 - lo
    if x.dtype == torch.float32 and lo == hi:
        y = F.avg_pool2d(
            x.permute(0, 3, 1, 2), window, 1, padding=lo, count_include_pad=False
        )
        return y.permute(0, 2, 3, 1)
    H, W = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, lo, hi, lo, hi))
    ones = F.pad(torch.ones_like(x[..., :1]), (0, 0, lo, hi, lo, hi))
    sums = torch.zeros_like(x)
    counts = torch.zeros_like(x[..., :1])
    for dy in range(window):
        for dx in range(window):
            sums = sums + xp[:, dy : dy + H, dx : dx + W]
            counts = counts + ones[:, dy : dy + H, dx : dx + W]
    return sums / counts


def zero_pad(x, pad):
    """ZeroPadding2D: pad ((top, bottom), (left, right))."""
    (t, b), (l, r) = pad
    return F.pad(x, (0, 0, l, r, t, b))


def global_avg_pool(x):
    return x.mean(dim=(1, 2))
