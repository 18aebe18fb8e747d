"""Dense / Embedding / LSTM / GRU / LayerNorm / dropout / attention
primitives with Keras-default initialization (port of
``tpucap.models.layers``).

Params are plain dicts of tensors in the JAX package's layout: a dense
kernel is ``(in, out)``, an LSTM cell holds ``kernel (in, 4U)``,
``recurrent (U, 4U)`` and ``bias (4U,)`` in Keras gate order i, f, g, o, a
GRU cell ``kernel (in, 3U)``, ``recurrent (U, 3U)`` and ``bias (2, 3U)``
in Keras gate order z, r, h.
Init draws from an explicit ``torch.Generator`` (CPU), so a seed fixes the
weights; the numbers differ from ``jax.random``'s for the same seed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tpucap_torch.core import refuse_int8

# ---------------------------------------------------------------------------
# Keras-default initializers


def glorot_uniform(gen, shape, fan_in: int, fan_out: int) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


def orthogonal(gen, rows: int, cols: int) -> torch.Tensor:
    """(rows, cols) with orthonormal rows or columns, the jax/Keras
    orthogonal initializer: QR of a normal matrix, signs fixed by diag(R)."""
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return q if rows >= cols else q.T


# ---------------------------------------------------------------------------
# Dense


def init_dense(gen, in_dim: int, out_dim: int):
    return {
        "kernel": glorot_uniform(gen, (in_dim, out_dim), in_dim, out_dim),
        "bias": torch.zeros(out_dim),
    }


def dense(p, x, activation=None):
    """y = x @ kernel in the activation dtype with f32 accumulation, cast
    to that dtype, then the bias added in that dtype. The JAX package's
    int8 branch is not ported: an int8 kernel raises."""
    if p["kernel"].dtype == torch.int8:
        refuse_int8("dense")
    y = torch.matmul(x, p["kernel"].to(x.dtype)) + p["bias"].to(x.dtype)
    return activation(y) if activation is not None else y


# ---------------------------------------------------------------------------
# Embedding


def init_embedding(gen, vocab_size: int, embed_dim: int):
    table = torch.rand((vocab_size, embed_dim), generator=gen) * 0.1 - 0.05
    return {"table": table}


def embed(p, token_ids):
    """Lookup: (...,) int -> (..., embed_dim)."""
    return p["table"][token_ids]


# ---------------------------------------------------------------------------
# LSTM cell (Keras gate order/equations)


def init_lstm_cell(gen, in_dim: int, units: int):
    kernel = glorot_uniform(gen, (in_dim, 4 * units), in_dim, 4 * units)
    recurrent = orthogonal(gen, units, 4 * units)
    # unit_forget_bias: f-gate bias = 1 (second quarter in i,f,g,o order).
    bias = torch.cat(
        [torch.zeros(units), torch.ones(units), torch.zeros(2 * units)]
    )
    return {"kernel": kernel, "recurrent": recurrent, "bias": bias}


def lstm_gates_f32(kernel, recurrent, bias, x, h, c):
    """The cell update in f32: z = x@W + h@U + b with f32 accumulation
    (operands upcast exactly), gates i, f, g, o, then
    c' = f*c + i*tanh(g), h' = sigmoid(o)*tanh(c'). -> (h' f32, c' f32)."""
    z = (
        torch.matmul(x.float(), kernel.float())
        + torch.matmul(h.float(), recurrent.float())
        + bias.float()
    )
    zi, zf, zg, zo = torch.chunk(z, 4, dim=-1)
    c_new = torch.sigmoid(zf) * c.float() + torch.sigmoid(zi) * torch.tanh(zg)
    h_new = torch.sigmoid(zo) * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell_step(p, x, h, c):
    """One LSTM step. x (B, in), h/c (B, units) -> (h', c') in the dtypes
    of h and c, so a bf16 flow stays bf16 across steps."""
    h_new, c_new = lstm_gates_f32(
        p["kernel"], p["recurrent"], p["bias"], x, h, c
    )
    return h_new.to(h.dtype), c_new.to(c.dtype)


# ---------------------------------------------------------------------------
# GRU cell (Keras GRU-v2, reset_after=True)


def init_gru_cell(gen, in_dim: int, units: int):
    """Keras GRU-v2 defaults: kernel glorot (in, 3U), recurrent orthogonal
    (U, 3U), bias (2, 3U) zeros, row 0 the input bias and row 1 the
    recurrent bias (kept apart: the reset gate multiplies h@U + b_rec)."""
    kernel = glorot_uniform(gen, (in_dim, 3 * units), in_dim, 3 * units)
    recurrent = orthogonal(gen, units, 3 * units)
    return {"kernel": kernel, "recurrent": recurrent, "bias": torch.zeros((2, 3 * units))}


def gru_cell_step(p, x, h):
    """One GRU step, Keras's gate order z, r, hh. x (B, in), h (B, U) -> h'
    in h's dtype:

        mx = x@W + b_in;  mh = h@U + b_rec     (two products, each split in 3)
        z = sigmoid(mx_z + mh_z);  r = sigmoid(mx_r + mh_r)
        hh = tanh(mx_h + r * mh_h)              (reset after the product)
        h' = z*h + (1-z)*hh

    The weights are cast to the operand's dtype and both products taken on
    operands upcast to f32 (exact), so they accumulate in f32 as the JAX
    package's ``preferred_element_type=f32`` dots do; the gate math is f32."""
    mx = torch.matmul(x.float(), p["kernel"].to(x.dtype).float()) + p["bias"][0].float()
    mh = torch.matmul(h.float(), p["recurrent"].to(h.dtype).float()) + p["bias"][1].float()
    mx_z, mx_r, mx_h = torch.chunk(mx, 3, dim=-1)
    mh_z, mh_r, mh_h = torch.chunk(mh, 3, dim=-1)
    z = torch.sigmoid(mx_z + mh_z)
    r = torch.sigmoid(mx_r + mh_r)
    hh = torch.tanh(mx_h + r * mh_h)
    return (z * h.float() + (1.0 - z) * hh).to(h.dtype)


# ---------------------------------------------------------------------------
# LayerNorm and activations (ViT encoder)


def init_layer_norm(dim: int):
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def layer_norm(p, x, eps: float = 1e-5):
    """Normalize the last axis. Statistics in f32 with the population
    variance (``jnp.var``), output cast back to x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation (PyTorch's default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Dropout (inverted, Keras/flax scaling)


def dropout(rng, x, rate: float, deterministic: bool):
    """Keep each element with probability 1 - rate and scale it by
    1 / (1 - rate), in x's dtype. The mask is drawn from ``rng``, a
    ``torch.Generator`` on x's device; its bits are not jax's."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Multi-head attention primitives


def split_heads(x, num_heads: int):
    """(..., H) -> (..., num_heads, head_dim), a view."""
    return x.reshape(*x.shape[:-1], num_heads, x.shape[-1] // num_heads)


def merge_heads(x):
    """(..., num_heads, head_dim) -> (..., H)."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def sdpa(q, k, v, mask, scale: float):
    """Scaled dot-product attention, q (..., Q, h, d) over k/v (..., T, h, d).

    mask (..., Q, T) bool, True = attend, or None for dense attention.
    Scores in the operands' dtype, then f32 for the scale and the softmax;
    the weights are cast to q.dtype for the product with v. Returns
    ``(ctx, w)`` with w (..., h, Q, T) f32. The products stay library
    matmuls, as the JAX package leaves them to XLA."""
    scores = torch.einsum("...qhd,...thd->...hqt", q, k).float() * scale
    if mask is not None:
        scores = torch.where(mask[..., None, :, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("...hqt,...thd->...qhd", w.to(q.dtype), v)
    return ctx, w
