"""Plain versions of the port's kernels against the JAX package's kernels.

K1 (preprocess) against tpucap.ops.preprocess.fused_preprocess (its XLA
path on the CPU; also at an output of 299) and the host oracle
tpucap.data.preprocess; K2 (LSTM cell) against
fused_lstm_step(interpret=True); K3 (merge step) against
fused_merge_step(interpret=True) with a ragged last vocab tile; the exact
three-term bf16 split behind K3's bf16 merge head and projection. (K4 and K5 are held
against tpucap in test_torch_encoder.py and test_torch_vit.py.)
On CPU tensors every wrapper runs its plain version and counts no launch; the
CUDA kernels themselves are checked against these plain versions on the
card by chip_smoke.py.

Tolerances: K1 is exact in caffe mode (integer + f32 bias) and within
2e-6 absolute in tf/torch mode (a fused multiply-add against a separate
multiply and add); K2/K3 differ by summation order, 1e-5 absolute in f32
at O(1) values; bf16 outputs may differ by one bf16 ulp (1e-2).
"""

import shutil
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap.data.preprocess import preprocess_input
from tpucap.models.layers import lstm_cell_step
from tpucap.ops.pallas.decoder_step import fused_merge_step as jax_merge_step
from tpucap.ops.pallas.lstm_step import fused_lstm_step as jax_lstm_step
from tpucap.ops.preprocess import fused_preprocess as jax_fused_preprocess
from tpucap.ops.preprocess import normalize_images as jax_normalize_images
from tpucap_torch import _build, ops
from tpucap_torch.ops import attention, bottleneck, decoder_step, lstm_step, preprocess

torch.set_num_threads(2)

TOL = {
    "f32": dict(rtol=0, atol=1e-5),
    "bf16": dict(rtol=1e-2, atol=1e-2),
}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(arr, name):
    jdt, tdt = DT[name]
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(tdt)
    return jnp.asarray(t.float().numpy(), jdt), t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- K1 ---------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["caffe", "tf", "torch"])
@pytest.mark.parametrize("src_hw", [(16, 16), (23, 11)])
def test_preprocess_matches_jax_and_host_oracle(mode, src_hw):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(3, *src_hw, 3), dtype=np.uint8)
    size = 16
    atol = 0 if mode == "caffe" else 2e-6
    ref = np.asarray(jax_fused_preprocess(jnp.asarray(imgs), size, mode))
    out = preprocess.fused_preprocess(torch.from_numpy(imgs), size, mode)
    assert out.shape == (3, size, size, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=atol)
    rows = preprocess._nearest_indices(size, src_hw[0])
    cols = preprocess._nearest_indices(size, src_hw[1])
    host = preprocess_input(imgs[:, rows][:, :, cols].astype(np.float32), mode)
    np.testing.assert_allclose(out.numpy(), host, rtol=0, atol=max(atol, 1e-6))


@pytest.mark.parametrize("mode", ["caffe", "torch"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_preprocess_plain_at_299_matches_jax_resize_and_normalize(mode, dt):
    """An output of 299 from 300 x 250: rows of 299 x 3 outputs fill no
    whole 16-byte chunk, the ragged case of the card's gather kernel. The
    plain version, as the card's check runs it, against tpucap's resize
    gather and normalize; bf16 outputs within one bf16 ulp."""
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, size=(2, 300, 250, 3), dtype=np.uint8)
    jdt, tdt = DT[dt]
    ref = jax_fused_preprocess(jnp.asarray(imgs), 299, mode, out_dtype=jdt)
    scale, bias, flip = preprocess._mode_scale_bias(mode)
    cpu = torch.device("cpu")
    out = preprocess.preprocess_u8_plain(
        torch.from_numpy(imgs), preprocess._index_table(299, 300, cpu),
        preprocess._index_table(299, 250, cpu), torch.from_numpy(scale),
        torch.from_numpy(bias), flip, tdt,
    )
    assert out.shape == (2, 299, 299, 3) and out.dtype == tdt
    atol = 0 if mode == "caffe" else 2e-6
    rtol = 0 if dt == "f32" else 2**-7
    np.testing.assert_allclose(_np(out), _np(ref), rtol=rtol, atol=atol)


def test_preprocess_out_dtype_and_normalize_images():
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, size=(2, 9, 7, 3), dtype=np.uint8)
    ref = jax_normalize_images(jnp.asarray(imgs), "caffe", out_dtype=jnp.bfloat16)
    out = preprocess.normalize_images(
        torch.from_numpy(imgs), "caffe", out_dtype=torch.bfloat16
    )
    assert out.shape == (2, 9, 7, 3) and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out), _np(ref))
    np.testing.assert_array_equal(
        preprocess.resize_nearest(torch.from_numpy(imgs), 5).numpy(),
        imgs[:, preprocess._nearest_indices(5, 9)][
            :, :, preprocess._nearest_indices(5, 7)
        ],
    )
    with pytest.raises(ValueError, match="unknown preprocess mode"):
        preprocess.fused_preprocess(torch.from_numpy(imgs), 9, "bgr")


# -- K2 ---------------------------------------------------------------------


def _lstm_inputs(dt, B=8, E=16, U=32, seed=0):
    rng = np.random.default_rng(seed)
    vals = {
        "x": rng.normal(size=(B, E)),
        "h": rng.normal(size=(B, U)),
        "c": rng.normal(size=(B, U)),
        "kernel": rng.normal(size=(E, 4 * U)) * 0.3,
        "recurrent": rng.normal(size=(U, 4 * U)) * 0.3,
        "bias": rng.normal(size=(4 * U,)),
    }
    return {k: _pair(v, dt) for k, v in vals.items()}


# (B, E, U): the small case, and a ragged one like the card's check (a
# batch of 37 rows, no multiple of any row tile, with E != U).
@pytest.mark.parametrize(
    "dt, shape",
    [("f32", (8, 16, 32)), ("bf16", (8, 16, 32)), ("f32", (37, 24, 40)), ("bf16", (37, 24, 40))],
    ids=["f32", "bf16", "f32-B37-E24-U40", "bf16-B37-E24-U40"],
)
def test_lstm_cell_plain_matches_pallas_kernel(dt, shape):
    """f32 against the Pallas kernel; its ref stores refuse bf16, so bf16
    is held against the function it replaces, layers.lstm_cell_step."""
    B, E, U = shape
    v = _lstm_inputs(dt, B=B, E=E, U=U)
    J = {k: a for k, (a, _) in v.items()}
    T = {k: b for k, (_, b) in v.items()}
    p = {k: J[k] for k in ("kernel", "recurrent", "bias")}
    ref_fn = (
        partial(jax_lstm_step, interpret=True) if dt == "f32" else lstm_cell_step
    )
    h_ref, c_ref = ref_fn(p, J["x"], J["h"], J["c"])
    h, c, h32 = lstm_step.lstm_cell_plain(
        T["x"], T["h"], T["c"], T["kernel"], T["recurrent"], T["bias"]
    )
    assert h.dtype == c.dtype == DT[dt][1] and h32.dtype == torch.float32
    np.testing.assert_allclose(_np(h), _np(h_ref), **TOL[dt])
    np.testing.assert_allclose(_np(c), _np(c_ref), **TOL[dt])
    np.testing.assert_allclose(_np(h32), _np(h), **TOL[dt])


def test_lstm_cell_wrapper_rejects_widths_off_16_bytes():
    """The kernel copies 16-byte rows: off the CPU, E and U must be
    multiples of 8 (checked before any device is touched)."""
    B, E, U = 4, 12, 16
    t = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="multiples of 8"):
        lstm_step.lstm_cell(t(B, E), t(B, U), t(B, U), t(E, 4 * U), t(U, 4 * U), t(4 * U))


# -- K3 ---------------------------------------------------------------------


def _merge_inputs(dt, B=8, E=16, U=32, V=80, seed=3):
    rng = np.random.default_rng(seed)
    cell = {
        "kernel": _pair(rng.normal(size=(E, 4 * U)) * 0.3, dt),
        "recurrent": _pair(rng.normal(size=(U, 4 * U)) * 0.3, dt),
        "bias": _pair(rng.normal(size=(4 * U,)), dt),
    }
    dense = lambda i, o: {  # noqa: E731
        "kernel": _pair(rng.normal(size=(i, o)) * 0.2, dt),
        "bias": _pair(rng.normal(size=(o,)), dt),
    }
    tree = {"cells": [cell], "pre_out": dense(U, U), "out": dense(U, V)}
    state = {
        "fe": _pair(np.abs(rng.normal(size=(B, U))), dt),
        "h": _pair(rng.normal(size=(B, 1, U)), dt),
        "c": _pair(rng.normal(size=(B, 1, U)), dt),
    }
    x = _pair(rng.normal(size=(B, E)), dt)
    pick = lambda tree, i: jax.tree.map(  # noqa: E731
        lambda pr: pr[i], tree, is_leaf=lambda n: isinstance(n, tuple)
    )
    return (pick(tree, 0), pick(state, 0), x[0]), (pick(tree, 1), pick(state, 1), x[1])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_merge_step_plain_matches_pallas_kernel_ragged_vocab(dt):
    (pj, sj, xj), (pt, st, xt) = _merge_inputs(dt)
    logits_ref, st_ref = jax_merge_step(pj, sj, xj, tile_v=32, interpret=True)
    logits, new = decoder_step.fused_merge_step(pt, st, xt)
    assert logits.shape == (8, 80) and logits.dtype == torch.float32
    # logits are f32 on both sides; in bf16 only h'/c' are rounded.
    np.testing.assert_allclose(_np(logits), _np(logits_ref), **TOL["f32"])
    for key in ("h", "c"):
        assert new[key].dtype == DT[dt][1]
        np.testing.assert_allclose(_np(new[key]), _np(st_ref[key]), **TOL[dt])
    assert new["fe"] is st["fe"]


def test_split3_is_exact_over_f32_magnitudes():
    """hi + mid + lo == m exactly in f32, at magnitudes 1e-30 to 1e30 of
    both signs: each term is the previous remainder rounded to bf16, and
    a round-to-nearest's remainder is exact in f32."""
    rng = np.random.default_rng(7)
    mag = 10.0 ** rng.uniform(-30, 30, size=(64, 96))
    sign = rng.choice([-1.0, 1.0], size=mag.shape)
    m = torch.from_numpy((sign * mag * rng.uniform(1, 2, size=mag.shape)).astype(np.float32))
    hi, mid, lo = decoder_step.split3(m)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.float() + mid.float() + lo.float(), m)
    assert torch.equal((hi.float() + mid.float()) + lo.float(), m)
    # Two terms would not do: they leave about 2**-17 of each value.
    assert not torch.equal(hi.float() + mid.float(), m)


@pytest.mark.parametrize("shape", [(8, 32, 80), (111, 64, 1001)], ids=["small", "ragged"])
def test_vocab_proj_split_matches_plain(shape):
    """The bf16 kernel's arithmetic (three exact bf16 x bf16 products per
    term, one f32 sum) against the f32 product: summation order only."""
    B, U, V = shape
    rng = np.random.default_rng(8)
    merged = torch.from_numpy(np.abs(rng.normal(size=(B, U))).astype(np.float32))
    wo = torch.from_numpy(rng.normal(size=(U, V)) * U**-0.5).to(torch.bfloat16)
    bo = torch.from_numpy(rng.normal(size=(V,))).to(torch.bfloat16)
    got = decoder_step.vocab_proj_split_plain(merged, wo, bo)
    want = decoder_step.vocab_proj_plain(merged, wo, bo)
    assert got.dtype == torch.float32 and got.shape == (B, V)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def _fused_step_inputs(dt):
    """tpucap's inputs, and the port's with x as the embedding table:
    token i's embedding is x[i]."""
    (pj, sj, xj), (pt, st, xt) = _merge_inputs(dt)
    return pj, sj, xj, dict(pt, embedding={"table": xt}), st


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_step_makes_kmajor_copy_once_and_matches_pallas_kernel(dt, monkeypatch):
    """The step from make_fused_merge_step equals tpucap's fused_merge_step
    on the same inputs at every call, and makes the K-major copies of W_p
    and W_o once each (bf16 weights only), not once per step; a new W_o
    tensor gets its own copy and W_p keeps its."""
    pj, sj, xj, pt, st = _fused_step_inputs(dt)
    copies = []
    real = decoder_step.weight_kmajor
    monkeypatch.setattr(
        decoder_step, "weight_kmajor", lambda w: copies.append(w) or real(w)
    )
    step = decoder_step.make_fused_merge_step(types.SimpleNamespace(num_layers=1))
    token = torch.arange(8)
    logits_ref, _ = jax_merge_step(pj, sj, xj, tile_v=32, interpret=True)
    for _ in range(3):
        logits, new = step(pt, st, token)
        np.testing.assert_allclose(_np(logits), _np(logits_ref), **TOL["f32"])
    want = [pt["pre_out"]["kernel"], pt["out"]["kernel"]] if dt == "bf16" else []
    assert len(copies) == len(want) and all(c is w for c, w in zip(copies, want))
    pt2 = dict(pt, out={"kernel": pt["out"]["kernel"].clone(), "bias": pt["out"]["bias"]})
    step(pt2, st, token)
    step(pt2, st, token)
    want += [pt2["out"]["kernel"]] if dt == "bf16" else []
    assert len(copies) == len(want) and all(c is w for c, w in zip(copies, want))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_merge_head_split_plain_matches_pallas_kernel(dt):
    """The bf16 merge-head kernel's arithmetic (fe + h'32 in f32, split
    into three bf16 terms, exact products summed in f32), followed by the
    projection's, against tpucap's fused_merge_step: f32 logits, summation
    order only. U = 64, the narrowest width the kernel takes."""
    (pj, sj, xj), (pt, st, xt) = _merge_inputs(dt, U=64)
    logits_ref, _ = jax_merge_step(pj, sj, xj, tile_v=32, interpret=True)
    cell = pt["cells"][0]
    _, _, h32 = lstm_step.lstm_cell_plain(
        xt, st["h"][:, 0], st["c"][:, 0], cell["kernel"], cell["recurrent"], cell["bias"]
    )
    merged = decoder_step.merge_head_split_plain(st["fe"], h32, **_wb(pt["pre_out"], "wp", "bp"))
    assert merged.dtype == torch.float32 and merged.shape == (8, 64)
    torch.testing.assert_close(
        merged,
        decoder_step.merge_head_plain(st["fe"], h32, **_wb(pt["pre_out"], "wp", "bp")),
        rtol=0, atol=1e-5,
    )
    logits = decoder_step.vocab_proj_split_plain(merged, **_wb(pt["out"], "wo", "bo"))
    np.testing.assert_allclose(_np(logits), _np(logits_ref), **TOL["f32"])


def test_identity_block_wrapper_rejects_widths_its_bf16_kernel_does_not_take():
    """Checked before any device is touched: K4's bf16 kernel takes C a
    multiple of 128 (its output passes are 128 channels wide)."""
    t = lambda *shape: torch.empty(shape, device="meta", dtype=torch.bfloat16)  # noqa: E731
    conv = lambda o, i, k: {"kernel": t(o, i, k, k), "bias": t(o)}  # noqa: E731
    with pytest.raises(ValueError, match="C a multiple of 128"):
        bottleneck.fused_identity_block(conv(64, 192, 1), conv(64, 64, 3), conv(192, 64, 1), t(1, 4, 4, 192))


def test_wrappers_on_cpu_run_plain_versions_and_count_no_launch():
    ops.reset_launch_counts()
    (_, _, _), (pt, st, xt) = _merge_inputs("f32")
    cell = pt["cells"][0]
    h, c = st["h"][:, 0], st["c"][:, 0]
    got = lstm_step.lstm_cell(xt, h, c, cell["kernel"], cell["recurrent"], cell["bias"])
    want = lstm_step.lstm_cell_plain(
        xt, h, c, cell["kernel"], cell["recurrent"], cell["bias"]
    )
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    merged = decoder_step.merge_head(st["fe"], got[2], **_wb(pt["pre_out"], "wp", "bp"))
    torch.testing.assert_close(
        merged,
        decoder_step.merge_head_plain(st["fe"], got[2], **_wb(pt["pre_out"], "wp", "bp")),
        rtol=0, atol=0,
    )
    logits = decoder_step.vocab_proj(merged, **_wb(pt["out"], "wo", "bo"))
    torch.testing.assert_close(
        logits,
        decoder_step.vocab_proj_plain(merged, **_wb(pt["out"], "wo", "bo")),
        rtol=0, atol=0,
    )
    imgs = torch.randint(0, 256, (2, 6, 6, 3), dtype=torch.uint8)
    preprocess.preprocess_u8(imgs, (4, 4), "tf")
    assert ops.launch_counts() == {
        "preprocess_u8": 0, "lstm_cell": 0, "merge_head": 0, "vocab_proj": 0,
        "identity_block": 0, "flash_attention": 0,
        "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
    }


def test_encoder_kernel_wrappers_on_cpu_run_plain_versions_and_count_no_launch():
    """K4 and K5 on CPU tensors: the plain versions, bit for bit."""
    ops.reset_launch_counts()
    gen = torch.Generator().manual_seed(0)
    C, M = 128, 64

    def conv(o, i, k):
        return {"kernel": torch.randn(o, i, k, k, generator=gen) * (i * k * k) ** -0.5,
                "bias": torch.randn(o, generator=gen) * 0.1}

    p1, p2, p3 = conv(M, C, 1), conv(M, M, 3), conv(C, M, 1)
    x = torch.randn(2, 5, 6, C, generator=gen).relu()
    torch.testing.assert_close(
        bottleneck.fused_identity_block(p1, p2, p3, x),
        bottleneck.fused_identity_block_plain(p1, p2, p3, x), rtol=0, atol=0,
    )
    q, k, v = torch.randn(3, 2, 7, 4, 64, generator=gen)
    torch.testing.assert_close(
        attention.flash_attention(q, k, v, 0.125),
        attention.flash_attention_plain(q, k, v, 0.125), rtol=0, atol=0,
    )
    assert set(ops.launch_counts().values()) == {0}


def _wb(p, wname, bname):
    return {wname: p["kernel"], bname: p["bias"]}


def test_kernel_build_reports_missing_nvcc():
    if shutil.which("nvcc"):
        pytest.skip("nvcc present: the build itself runs in chip_smoke.py")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
