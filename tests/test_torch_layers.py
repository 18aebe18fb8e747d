"""tpucap_torch.models.layers against tpucap.models.layers on the same
numpy inputs (f32 and bf16).

Tolerances: f32 differs only by summation order (1e-5 absolute at O(1)
values); bf16 outputs are rounded to bf16 by both sides after an f32
accumulation in different orders, so they may differ by one bf16 ulp
(2**-8 relative): 1e-2 relative + 1e-2 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap.models import layers as jl
from tpucap_torch.models import layers as tl

torch.set_num_threads(2)

DTYPES = {
    "f32": (jnp.float32, torch.float32, dict(rtol=0, atol=1e-5)),
    "bf16": (jnp.bfloat16, torch.bfloat16, dict(rtol=1e-2, atol=1e-2)),
}


def _pair(arr, name):
    """numpy f32 -> (jax array, torch tensor) holding identical values in
    the dtype ``name`` (bf16 values are rounded once, by torch)."""
    jdt, tdt, _ = DTYPES[name]
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(tdt)
    return jnp.asarray(t.float().numpy(), jdt), t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("relu", [False, True])
def test_dense_matches_jax(dt, relu):
    rng = np.random.default_rng(0)
    x_j, x_t = _pair(rng.normal(size=(6, 24)), dt)
    k_j, k_t = _pair(rng.normal(size=(24, 20)) * 0.2, dt)
    b_j, b_t = _pair(rng.normal(size=(20,)), dt)
    y_j = jl.dense({"kernel": k_j, "bias": b_j}, x_j, jax.nn.relu if relu else None)
    y_t = tl.dense({"kernel": k_t, "bias": b_t}, x_t, torch.relu if relu else None)
    assert y_t.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(_np(y_t), _np(y_j), **DTYPES[dt][2])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_embed_matches_jax(dt):
    rng = np.random.default_rng(1)
    tab_j, tab_t = _pair(rng.normal(size=(13, 8)), dt)
    ids = rng.integers(0, 13, size=(4, 5))
    y_j = jl.embed({"table": tab_j}, jnp.asarray(ids))
    y_t = tl.embed({"table": tab_t}, torch.from_numpy(ids))
    np.testing.assert_array_equal(_np(y_t), _np(y_j))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lstm_cell_step_matches_jax(dt):
    rng = np.random.default_rng(2)
    B, E, U = 5, 12, 16
    p_j, p_t = {}, {}
    for name, shape, scale in (
        ("kernel", (E, 4 * U), 0.3),
        ("recurrent", (U, 4 * U), 0.3),
        ("bias", (4 * U,), 1.0),
    ):
        p_j[name], p_t[name] = _pair(rng.normal(size=shape) * scale, dt)
    x_j, x_t = _pair(rng.normal(size=(B, E)), dt)
    h_j, h_t = _pair(rng.normal(size=(B, U)), dt)
    c_j, c_t = _pair(rng.normal(size=(B, U)), dt)
    hj, cj = jl.lstm_cell_step(p_j, x_j, h_j, c_j)
    ht, ct = tl.lstm_cell_step(p_t, x_t, h_t, c_t)
    assert ht.dtype == ct.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(_np(ht), _np(hj), **DTYPES[dt][2])
    np.testing.assert_allclose(_np(ct), _np(cj), **DTYPES[dt][2])


def test_inits_follow_keras_defaults():
    """Same shapes as the JAX inits; glorot bound, orthogonal recurrent
    kernel, unit forget bias, embedding range."""
    gen = torch.Generator().manual_seed(0)
    E, U, V = 24, 16, 30
    cell_t = tl.init_lstm_cell(gen, E, U)
    cell_j = jl.init_lstm_cell(jax.random.key(0), E, U)
    for k in cell_j:
        assert tuple(cell_t[k].shape) == cell_j[k].shape
    limit = np.sqrt(6.0 / (E + 4 * U))
    assert float(cell_t["kernel"].abs().max()) <= limit
    rec = cell_t["recurrent"]
    np.testing.assert_allclose((rec @ rec.T).numpy(), np.eye(U), atol=1e-5)
    np.testing.assert_array_equal(
        cell_t["bias"].numpy(), np.asarray(cell_j["bias"])
    )
    emb = tl.init_embedding(gen, V, E)["table"]
    assert emb.shape == (V, E) and float(emb.abs().max()) <= 0.05
    d = tl.init_dense(gen, E, U)
    assert d["kernel"].shape == (E, U) and not d["bias"].any()


# -- ViT primitives ----------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layer_norm_matches_jax(dt):
    """f32 statistics with the population variance on both sides; the
    offset mean makes a sample variance visibly wrong (by 1/(n-1))."""
    rng = np.random.default_rng(3)
    x_j, x_t = _pair(rng.normal(size=(3, 5, 48)) * 2 + 0.5, dt)
    s_j, s_t = _pair(rng.uniform(0.5, 1.5, size=(48,)), dt)
    b_j, b_t = _pair(rng.normal(size=(48,)) * 0.1, dt)
    y_j = jl.layer_norm({"scale": s_j, "bias": b_j}, x_j)
    y_t = tl.layer_norm({"scale": s_t, "bias": b_t}, x_t)
    assert y_t.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(_np(y_t), _np(y_j), **DTYPES[dt][2])
    init = tl.init_layer_norm(7)
    np.testing.assert_array_equal(init["scale"].numpy(), np.asarray(jl.init_layer_norm(7)["scale"]))
    np.testing.assert_array_equal(init["bias"].numpy(), np.asarray(jl.init_layer_norm(7)["bias"]))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gelu_is_jax_tanh_approximation(dt):
    """jax.nn.gelu defaults to the tanh form; the erf form differs by up
    to 4.7e-4 (near |x| = 2.7), far outside the f32 tolerance."""
    x_j, x_t = _pair(np.linspace(-6, 6, 401), dt)
    np.testing.assert_allclose(_np(tl.gelu(x_t)), _np(jax.nn.gelu(x_j)), **DTYPES[dt][2])
    if dt == "f32":
        erf = torch.nn.functional.gelu(x_t)
        assert float((erf - tl.gelu(x_t)).abs().max()) > 1e-4


def test_split_and_merge_heads_match_jax():
    x = np.arange(2 * 3 * 24, dtype=np.float32).reshape(2, 3, 24)
    s_t = tl.split_heads(torch.from_numpy(x), 4)
    s_j = jl.split_heads(jnp.asarray(x), 4)
    assert tuple(s_t.shape) == s_j.shape == (2, 3, 4, 6)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(tl.merge_heads(s_t).numpy(), x)
    # A column slice of a fused projection splits as a view.
    qkv = torch.from_numpy(np.tile(x, (1, 1, 3)))
    assert tl.split_heads(qkv[..., 24:48], 4).data_ptr() == qkv[..., 24:].data_ptr()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_matches_jax(dt, masked):
    rng = np.random.default_rng(4)
    q_j, q_t = _pair(rng.normal(size=(2, 5, 3, 8)), dt)
    k_j, k_t = _pair(rng.normal(size=(2, 7, 3, 8)), dt)
    v_j, v_t = _pair(rng.normal(size=(2, 7, 3, 8)), dt)
    mask = None
    if masked:
        mask = rng.random(size=(2, 5, 7)) > 0.3
        mask[..., 0] = True  # every query sees a key
    ctx_j, w_j = jl.sdpa(q_j, k_j, v_j, None if mask is None else jnp.asarray(mask), 0.35)
    ctx_t, w_t = tl.sdpa(q_t, k_t, v_t, None if mask is None else torch.from_numpy(mask), 0.35)
    assert ctx_t.dtype == DTYPES[dt][1] and w_t.dtype == torch.float32
    np.testing.assert_allclose(_np(ctx_t), _np(ctx_j), **DTYPES[dt][2])
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), **DTYPES[dt][2])
