"""tpucap_torch's ViT family and kernel K5's plain version against tpucap.

K5 (token-grid flash attention) is held against the stock TPU kernel's own
reference, ``mha_reference_no_custom_vjp``, fed exactly what
``tpucap.models.encoders.vit._flash_ctx`` feeds the kernel (heads first, L
padded to a multiple of 128, pad tokens in a segment of their own), with
the pad rows sliced off; and against tpucap's ``sdpa``. The stock kernel
itself lowers on a TPU only. The ViT runs ``vit_tiny`` with params bridged
by ``params_from_jax``.

Tolerances: f32 differs only by summation order, 1e-5 absolute at O(1)
values (2e-5 through a whole ViT); bf16 rounds the probabilities and the
output to bf16 on both sides after f32 sums in another order: one bf16 ulp
(1e-2 relative + 1e-2 absolute), and through two transformer layers 5e-2.

K5's backward (``flash_attention_bwd_plain``, the plain version of the two
backward kernels) is held against ``jax.vjp`` of the same stock reference
(padded, with segment ids; the pad rows' cotangent is zero, as slicing
them off makes it) and of tpucap's ``sdpa``, each in f32 (the reference
in bf16 rounds its scores before the scale, which the kernels do not).
Each gradient within a share of its own scale (max |ref|): f32 1e-5
(measured at most 1e-6: sums in another order); bf16 inputs one bf16 ulp,
2**-7 (measured at most 4.2e-3: p and ds are rounded to bf16 before their
products, and the gradients to bf16 at the end).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds,
    mha_reference_no_custom_vjp,
)

from tpucap import config as jcfg
from tpucap.models import layers as jl
from tpucap.models.encoders import PREPROCESS_MODES as JAX_PREPROCESS_MODES
from tpucap.models.encoders import vit_tiny as jax_vit_tiny
from tpucap.models.encoders.fold_bn import fold_batch_norms as jax_fold
from tpucap_torch import config as tcfg
from tpucap_torch import ops
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.core import tree_map
from tpucap_torch.models.encoders import (
    ViT,
    build_encoder,
    fold_batch_norms,
    vit_tiny,
)
from tpucap_torch.ops.attention import (
    FlashAttentionQKV,
    attention_di,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_attributes,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_attention_qkv,
    qkv_views,
)

from ports_init import jit_init

torch.set_num_threads(2)

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=0, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}


def _qkv(dt, B=2, L=40, h=3, d=16, seed=0):
    """q, k, v (B, L, h, d) as views of one (B, L, 3 h d) projection, as
    the ViT makes them, and the same values as jax arrays."""
    jdt, tdt = DT[dt]
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(B, L, 3 * h * d)).astype(np.float32)).to(tdt)
    views = [qkv[..., i * h * d : (i + 1) * h * d].reshape(B, L, h, d) for i in range(3)]
    return views, [jnp.asarray(t.float().numpy(), jdt) for t in views]


def _stock_reference(q, k, v, scale):
    """tpucap's _flash_ctx padding and segment ids around the stock reference."""
    B, L, h, d = q.shape
    Lp = -(-L // 128) * 128
    pad = ((0, 0), (0, 0), (0, Lp - L), (0, 0))
    qT, kT, vT = (jnp.pad(jnp.moveaxis(a, 1, 2), pad) for a in (q, k, v))
    seg = jnp.broadcast_to((jnp.arange(Lp) < L).astype(jnp.int32), (B, Lp))
    out = mha_reference_no_custom_vjp(
        qT, kT, vT, segment_ids=SegmentIds(q=seg, kv=seg), sm_scale=scale
    )
    return jnp.moveaxis(out[:, :, :L, :], 1, 2)


# L -> (heads, head width): ViT-B/16's 196 tokens, and the card check's
# ragged lengths (one partial query and key tile; a last key tile of one).
SHAPES = {40: (3, 16), 196: (3, 64), 49: (4, 64), 257: (4, 64)}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("L", [40, 196, 49, 257])
def test_flash_attention_plain_matches_stock_reference_and_sdpa(dt, L):
    h, d = SHAPES[L]
    (q, k, v), (qj, kj, vj) = _qkv(dt, L=L, h=h, d=d)
    scale = 1.0 / q.shape[-1] ** 0.5
    got = flash_attention_plain(q, k, v, scale)
    assert got.dtype == DT[dt][1] and got.shape == q.shape
    # The stock reference computes in f32 here: its bf16 path rounds the
    # scores before the scale, which the kernel (f32 scores) does not.
    ref = _stock_reference(*(a.astype(jnp.float32) for a in (qj, kj, vj)), scale)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref), **TOL[dt])
    ctx, _ = jl.sdpa(qj, kj, vj, None, scale)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ctx.astype(jnp.float32)), **TOL[dt]
    )


def test_flash_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    (q, k, v), _ = _qkv("f32")
    ops.reset_launch_counts()
    torch.testing.assert_close(
        flash_attention(q, k, v, 0.25), flash_attention_plain(q, k, v, 0.25), rtol=0, atol=0
    )
    assert ops.launch_counts()["flash_attention"] == 0


# -- K5's backward ---------------------------------------------------------

BWD_TOL = {"f32": 1e-5, "bf16": 2.0**-7}


def _cotangent(dt, q, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=tuple(q.shape)).astype(np.float32)).to(DT[dt][1])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("L", [40, 196, 49, 257])
def test_flash_attention_bwd_plain_matches_stock_vjp_and_sdpa_vjp(dt, L):
    h, d = SHAPES[L]
    (q, k, v), (qj, kj, vj) = _qkv(dt, L=L, h=h, d=d)
    scale = 1.0 / d**0.5
    do = _cotangent(dt, q)
    o, lse = flash_attention_plain(q, k, v, scale, with_lse=True)
    got = flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    f32 = [a.astype(jnp.float32) for a in (qj, kj, vj)]
    doj = jnp.asarray(do.float().numpy())
    _, stock_vjp = jax.vjp(lambda a, b, c: _stock_reference(a, b, c, scale), *f32)
    _, sdpa_vjp = jax.vjp(lambda a, b, c: jl.sdpa(a, b, c, None, scale)[0], *f32)
    for ref in (stock_vjp(doj), sdpa_vjp(doj)):
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            assert g.dtype == DT[dt][1] and g.shape == q.shape, name
            r = np.asarray(r)
            np.testing.assert_allclose(
                g.float().numpy(), r, rtol=0, atol=BWD_TOL[dt] * np.abs(r).max(), err_msg=name
            )


def test_flash_attention_plain_lse_is_the_rows_logsumexp():
    (q, k, v), _ = _qkv("f32", L=49, h=4, d=64)
    out, lse = flash_attention_plain(q, k, v, 0.125, with_lse=True)
    s = torch.einsum("blhd,bthd->bhlt", q, k) * 0.125
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), rtol=0, atol=2e-6)
    assert torch.equal(out, flash_attention_plain(q, k, v, 0.125))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_qkv_autograd_on_cpu_runs_plain_and_counts_no_launch(dt):
    """The Function's gradient is one (B, L, 3H) buffer: dq, dk, dv at the
    projection's strides, the plain backward's values; without a gradient
    the forward keeps its no-statistics route."""
    h, d, L = 4, 64, 49
    (q, k, v), _ = _qkv(dt, L=L, h=h, d=d)
    qkv = torch.cat([t.reshape(2, L, h * d) for t in (q, k, v)], dim=-1)
    do = _cotangent(dt, q)
    ops.reset_launch_counts()
    x = qkv.clone().requires_grad_()
    ctx = flash_attention_qkv(x, h, 0.125)
    assert ctx.grad_fn is not None and type(ctx.grad_fn).__name__ == "FlashAttentionQKVBackward"
    ctx.backward(do)
    o, lse = flash_attention_plain(q, k, v, 0.125, with_lse=True)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, 0.125)
    for got, w in zip(qkv_views(x.grad, h), want):
        assert torch.equal(got, w)
    # The wrappers, called on their own, write into views of one buffer.
    buf = torch.zeros_like(qkv)
    dq, dk, dv = qkv_views(buf, h)
    di = attention_di(o, do)
    flash_attention_bwd_dkv(q, k, v, do, lse, di, 0.125, dk, dv)
    flash_attention_bwd_dq(q, k, v, do, lse, di, 0.125, dq)
    assert torch.equal(buf, x.grad)
    with torch.no_grad():
        assert flash_attention_qkv(x, h, 0.125).grad_fn is None
    assert torch.equal(FlashAttentionQKV.apply(qkv, h, 0.125), ctx.detach())
    counts = ops.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention_bwd_dkv"] == counts["flash_attention_bwd_dq"] == 0


def test_flash_attention_bwd_attributes_take_the_kernels_dtypes_only():
    """The query of the backward kernels' registers and shared memory names
    one of their two routes; any other dtype is refused before a build."""
    with pytest.raises(ValueError, match="f32 or bf16"):
        flash_attention_bwd_attributes(torch.float16)


# -- the ViT encoder ---------------------------------------------------------


@pytest.fixture(scope="module")
def vit_params():
    return jax.tree.map(np.asarray, jit_init(jax_vit_tiny(), jax.random.key(5)))


_REFERENCES: dict = {}


def _vit_reference(features, jdt, jp, x):
    """tpucap's jitted ViT apply, compiled once a features kind and dtype
    (the flash and xla cases share it)."""
    key = (features, jdt)
    if key not in _REFERENCES:
        _REFERENCES[key] = jax.jit(jax_vit_tiny(features).apply)
    return _REFERENCES[key](jp, jnp.asarray(x, jdt))


@pytest.mark.parametrize("features", ["pooled", "spatial"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_vit_tiny_matches_jax(vit_params, features, impl, dt):
    jdt, tdt = DT[dt]
    x = np.random.default_rng(6).uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    tp = tree_map(lambda t: t.to(tdt), params_from_jax(vit_params))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), vit_params)
    ref = _vit_reference(features, jdt, jp, x)
    enc = dataclasses.replace(vit_tiny(features), attention_impl=impl)
    with torch.inference_mode():
        got = enc.apply(tp, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    tol = dict(rtol=0, atol=2e-5) if dt == "f32" else dict(rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


def test_params_from_jax_carries_the_vit_tree(vit_params):
    tp = params_from_jax(vit_params)
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 2
    assert sorted(tp["blocks"][0]) == sorted(vit_params["blocks"][0])
    hwio = vit_params["patch_embed"]["kernel"]
    assert tuple(tp["patch_embed"]["kernel"].shape) == (64, 3, 4, 4)
    np.testing.assert_array_equal(tp["patch_embed"]["kernel"].permute(2, 3, 1, 0).numpy(), hwio)
    np.testing.assert_array_equal(tp["pos_embedding"].numpy(), vit_params["pos_embedding"])
    assert tuple(tp["pos_embedding"].shape) == (64, 64)
    # Init gives the same tree, shapes and all.
    assert _shapes(tp) == _shapes(vit_tiny().init(torch.Generator().manual_seed(0)))


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _shapes(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [s for i, v in enumerate(tree) for s in _shapes(v, f"{prefix}/{i}")]
    return [(prefix, tuple(tree.shape))]


def test_fold_batch_norms_leaves_vit_params_alone(vit_params):
    tp = params_from_jax(vit_params)
    assert fold_batch_norms("vit_b16", tp) is tp
    assert jax_fold("vit_b16", vit_params) is vit_params


def test_registry_config_and_validation():
    enc = build_encoder("vit_b16", features="spatial")
    assert isinstance(enc, ViT)
    assert (enc.input_size, enc.preprocess_mode, enc.attention_impl) == (224, "tf", "xla")
    assert (enc.grid, enc.spatial_positions, enc.feature_dim) == (14, 196, 768)
    assert (enc.hidden_dim, enc.num_layers, enc.num_heads, enc.mlp_dim) == (768, 12, 12, 3072)
    for name in ("vit_b16", "vit_tiny"):
        built = build_encoder(name)
        assert JAX_PREPROCESS_MODES[name] == (built.input_size, built.preprocess_mode)
        for kind in ("pooled", "spatial"):
            assert tcfg.encoder_config(name, kind).feature_dim == jcfg.FEATURE_DIMS[name, kind]
    with pytest.raises(ValueError, match="patch_size"):
        ViT(input_size=224, patch_size=15)
    with pytest.raises(ValueError, match="num_heads"):
        ViT(hidden_dim=64, num_heads=5)
    with pytest.raises(ValueError, match="attention_impl"):
        ViT(attention_impl="fused")


def test_vit_tiny_gradients_match_jax(vit_params):
    """ViT.apply is differentiable: the gradient of a scalar of the pooled
    features with respect to every param and the images, the port with
    flash attention (K5's Function, plain versions on the CPU) against jax
    with xla attention, f32: within 1e-5 of each tensor's scale."""
    x = np.random.default_rng(7).uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    w = np.random.default_rng(8).normal(size=(2, 64)).astype(np.float32)
    jenc = jax_vit_tiny()

    def jloss(p, img):
        return jnp.sum(jenc.apply(p, img) * w)

    jg = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, vit_params), jnp.asarray(x))
    enc = dataclasses.replace(vit_tiny(), attention_impl="flash")
    tp = tree_map(lambda t: t.requires_grad_(True), params_from_jax(vit_params))
    img = torch.from_numpy(x).requires_grad_(True)
    loss = (enc.apply(tp, img) * torch.from_numpy(w)).sum()
    loss.backward()
    got = jax.tree.leaves(params_to_numpy(tree_map(lambda t: t.grad, tp))) + [img.grad.numpy()]
    want = jax.tree.leaves(jax.tree.map(np.asarray, jg[0])) + [np.asarray(jg[1])]
    assert len(got) == len(want)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max())
