"""tpucap_torch's gradient accumulation (``train/loop.py``:
``accumulated_sum_grads``, ``normalized_accum_grads`` and the steps'
``grad_accum_steps``) against tpucap's, on the CPU, same weights (bridged),
dropout off: lstm1 (embed 16, hidden 32, vocab 50, 24-d features, batch 8,
T = 8, rows of varied pad counts and one all-pad row), the soft-attention
decoder on 3 x 3 grids with ``attention_reg`` 1.0 (the regularizer's
second backward), and the joint step on ``tiny_cnn`` at 32 x 32 with
lstm1 on its 128-d features.

Each package's step runs once under plain SGD at lr 1e6 from the same
params, so the gradient it applied is read back as (params - updated
params) / lr, to about 1e-7 of its scale.
Tolerances: the step's metrics (the accumulated sums, normalized) within
1e-6 relative, the perplexity, their exponential, within 1e-5 (measured
4.7e-7 at A = 4); each accumulated gradient within 1e-5 of its tensor's scale
(max |ref|), as the unaccumulated gradients of
``tests/test_torch_train.py`` (sums in another order; the attention score
bias, whose gradient is zero in theory, is rounding noise on both sides
and is held below 1e-6 of the largest gradient instead). The port's A = 2
against its own A = 1: the sums within 1e-6 relative and the gradients
within 1e-6 of their scale, the reassociation of the f32 sums. A batch
that does not divide raises tpucap's ``ValueError``. (``fit`` with
``TrainConfig.grad_accum_steps`` = 2 against tpucap's, per epoch, is in
``tests/test_torch_preemption.py``; ``fit_finetune``'s through the CLI in
``tests/test_torch_cli_finetune.py``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap.models.encoders import TinyCNN as JaxTinyCNN
from tpucap.train import finetune as jft
from tpucap.train import loop as jloop
from tpucap_torch import config as tcfg
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.models.decoders import build_decoder
from tpucap_torch.models.encoders import TinyCNN
from tpucap_torch.train import (
    TrainState,
    build_optimizer,
    caption_loss_sums,
    make_joint_train_step,
    make_train_step,
)
from tpucap_torch.train.loop import (
    accumulated_sum_grads,
    chain,
    normalized_accum_grads,
    scale_by_learning_rate,
    trainable,
)

from ports_init import jit_init

torch.set_num_threads(2)

V, FD, B, T, GRID = 50, 24, 8, 8, 9


def _decoders(name, feature_dim=FD):
    kw = dict(vocab_size=V, feature_dim=feature_dim, embed_dim=16, hidden_dim=32, dropout_rate=0.0)
    return jax_build_decoder(name, **kw), build_decoder(name, **kw)


def _tokens(rng):
    toks = rng.integers(2, V, size=(B, T + 1)).astype(np.int32)
    toks[:, 0] = 1
    for i, n in enumerate(rng.integers(2, T + 1, size=B)):
        toks[i, n:] = 0
    toks[3, 1:] = 0
    return toks


def _batch(name, seed):
    rng = np.random.default_rng(seed)
    shape = (B, GRID, FD) if name == "attention" else (B, FD)
    return rng.normal(size=shape).astype(np.float32), _tokens(rng)


def _close_to_scale(got, want, share, what=""):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0, atol=share * np.abs(w).max(), err_msg=what)


def _drop_score_bias(tg, jg):
    """The attention score bias: zero in theory, noise on both sides."""
    scale = max(np.abs(np.asarray(g)).max() for g in jax.tree.leaves(jg))
    for g in (tg["att_score"].pop("bias"), jg["att_score"].pop("bias")):
        assert np.abs(np.asarray(g)).max() < 1e-6 * scale


def _port_accum(tdec, tp, feats, toks, steps, reg):
    sums_fn = lambda p, f, t: caption_loss_sums(tdec, p, f, t, attention_reg=reg)  # noqa: E731
    use_reg = reg > 0
    g_nll, g_reg, sums = accumulated_sum_grads(sums_fn, tp, feats, toks, steps=steps, use_reg=use_reg)
    assert (g_reg is not None) == use_reg
    return normalized_accum_grads(g_nll, g_reg, sums, attention_reg=reg), sums


LR = 1e6  # the update dwarfs the params: read back to ~1e-7 of the gradient's scale


def _sgd_steps(jstep_fn, tstep_fn, jp, *batch):
    """One step of each package's step under plain SGD at lr ``LR`` from the
    same params: -> (tpucap's metrics, the port's, tpucap's gradient, the
    port's), each gradient read back as (params - updated params) / LR."""
    jopt, topt = optax.sgd(LR), chain(scale_by_learning_rate(LR))
    jstate, jm = jstep_fn(jopt)(
        jloop.TrainState.create(jax.tree.map(jnp.asarray, jp), jopt, jax.random.key(0)), *map(jnp.asarray, batch)
    )
    tb = [torch.from_numpy(x).long() if x.dtype == np.int32 else torch.from_numpy(x) for x in batch]
    tstate, tm = tstep_fn(topt)(TrainState.create(params_from_jax(jp), topt, None), *tb)
    jg = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / LR, jp, jstate.params)
    tg = jax.tree.map(lambda a, b: (a - b) / LR, params_to_numpy(params_from_jax(jp)), params_to_numpy(tstate.params))
    return jm, tm, jg, tg


def _same_metrics(tm, jm):
    assert sorted(tm) == sorted(jm)
    for k in jm:
        # exp(loss) turns the loss's 1e-6 into |loss| x 1e-6 (losses near 4).
        rtol = 1e-5 if k == "perplexity" else 1e-6
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=rtol, err_msg=k)


@pytest.mark.parametrize("name,reg,steps", [("lstm1", 0.0, 2), ("lstm1", 0.0, 4), ("attention", 1.0, 2)])
def test_accumulated_step_matches_tpucap(name, reg, steps):
    jdec, tdec = _decoders(name)
    jp = jax.tree.map(np.asarray, jit_init(jdec, jax.random.key(20)))
    jm, tm, jg, tg = _sgd_steps(
        lambda opt: jloop.make_train_step(jdec, opt, deterministic=True, attention_reg=reg, grad_accum_steps=steps),
        lambda opt: make_train_step(tdec, opt, deterministic=True, attention_reg=reg, grad_accum_steps=steps),
        jp,
        *_batch(name, 21),
    )
    _same_metrics(tm, jm)
    if name == "attention":
        _drop_score_bias(tg, jg)
    _close_to_scale(tg, jg, 1e-5, "accumulated grads")


@pytest.mark.parametrize("steps", [2, 4])
def test_accumulated_joint_step_matches_tpucap(steps):
    jenc, tenc = JaxTinyCNN(), TinyCNN()
    jdec, tdec = _decoders("lstm1", feature_dim=128)
    key = jax.random.key(30)
    jp = jax.tree.map(np.asarray, {"encoder": jenc.init(key), "decoder": jdec.init(jax.random.fold_in(key, 1))})
    rng = np.random.default_rng(31)
    images = rng.uniform(-1, 1, size=(B, 32, 32, 3)).astype(np.float32)
    jm, tm, jg, tg = _sgd_steps(
        lambda opt: jft.make_joint_train_step(jenc, jdec, opt, deterministic=True, grad_accum_steps=steps),
        lambda opt: make_joint_train_step(tenc, tdec, opt, deterministic=True, grad_accum_steps=steps),
        jp,
        images,
        _tokens(rng),
    )
    _same_metrics(tm, jm)
    _close_to_scale(tg, jg, 1e-5, "accumulated joint grads")


def test_accumulation_against_the_ports_own_full_batch():
    _, tdec = _decoders("attention")
    p = params_from_jax(jax.tree.map(np.asarray, jit_init(_decoders("attention")[0], jax.random.key(40))))
    feats, toks = _batch("attention", 41)
    f, t = torch.from_numpy(feats), torch.from_numpy(toks).long()
    g2, s2 = _port_accum(tdec, trainable(p), f, t, 2, 1.0)
    g1, s1 = _port_accum(tdec, trainable(p), f, t, 1, 1.0)
    for k in s1:
        np.testing.assert_allclose(s2[k].item(), s1[k].item(), rtol=1e-6, err_msg=k)
    g1, g2 = params_to_numpy(g1), params_to_numpy(g2)
    _drop_score_bias(g2, g1)
    _close_to_scale(g2, g1, 1e-6, "A=2 against A=1")
    opt = build_optimizer(tcfg.TrainConfig())
    m = [
        make_train_step(tdec, opt, deterministic=True, attention_reg=1.0, grad_accum_steps=a)(TrainState.create(p, opt, None), f, t)[1]
        for a in (1, 2)
    ]
    for k in m[0]:
        np.testing.assert_allclose(m[1][k].item(), m[0][k].item(), rtol=1e-6, err_msg=k)


def test_indivisible_batch_raises_tpucaps_error():
    jdec, tdec = _decoders("lstm1")
    feats, toks = _batch("lstm1", 50)
    opt = build_optimizer(tcfg.TrainConfig())
    p = params_from_jax(jax.tree.map(np.asarray, jit_init(jdec, jax.random.key(51))))
    with pytest.raises(ValueError) as ours:
        make_train_step(tdec, opt, grad_accum_steps=3)(TrainState.create(p, opt, None), torch.from_numpy(feats), torch.from_numpy(toks).long())
    with pytest.raises(ValueError) as theirs:
        # The check runs while tracing, before anything is computed.
        jloop.accumulated_sum_grads(None, None, jnp.asarray(feats), jnp.asarray(toks), None, steps=3)
    assert str(ours.value) == str(theirs.value).splitlines()[0] == "batch size 8 not divisible by grad_accum_steps 3"
