"""tpucap_torch's optimizer surface against tpucap's ``build_optimizer``, on
the CPU: adam, adamw, sgd (momentum 0 and 0.9), rmsprop and adagrad, each
at a constant lr, under cosine decay and under exponential decay, with and
without a linear warmup, through ``train.build_optimizer``.

Each optimizer runs 6 steps of seeded gradients on a small tree (a dense
kernel, a bias, a list of cells), tpucap's update jitted as its training
step jits it. The cosine horizon is 4 steps less the warmup, so the steps
cross the warmup boundary and run past the horizon; the exponential decay
halves the lr every 3 steps. Tolerance: every update within 1e-6 of its
tensor's scale (max |tpucap's update|). The schedules are computed in f32
on the count tensor on both sides; jax's cos and pow may differ from
torch's in the last bit, and rsqrt too.

Also: the optimizer state round-trips bit for bit through the port's
``CheckpointManager`` in every layout (None for sgd at a constant lr, a
dict for one stateful member, a tuple for several), a restore whose flags
give another layout is refused, the default ``TrainConfig()`` keeps plain
Adam's ``{"count", "mu", "nu"}`` dict and its update, a global-norm clip
still comes first and the encoder's update scale last under a scheduled
sgd, and ``fit`` with sgd, momentum 0.9, cosine decay and warmup gives
tpucap's per-epoch loss, accuracy and perplexity within 1e-5 relative
(fit's bound: f32 sums in another order). Every optimizer under every
schedule, with warmup and EMA, trains through the port's ``fit``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpucap import config as jcfg
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.train import build_optimizer as jax_build_optimizer
from tpucap.train.finetune import encoder_learning_rate_optimizer as jax_encoder_lr
from tpucap_torch import config as tcfg
from tpucap_torch.checkpoint import CheckpointManager
from tpucap_torch.convert import load_npz, params_from_jax
from tpucap_torch.core import tree_leaves, tree_map
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer
from tpucap_torch.train import TrainState, build_optimizer, encoder_learning_rate_optimizer

from ports_init import build_on_ports_init

torch.set_num_threads(2)

STEPS = 6
TOTAL_STEPS = 4
#: Optimizer choices: (name, TrainConfig fields).
OPTIMIZERS = {
    "adam": dict(optimizer="adam"),
    "adamw": dict(optimizer="adamw", weight_decay=0.05),
    "sgd": dict(optimizer="sgd"),
    "sgd-momentum": dict(optimizer="sgd", momentum=0.9),
    "rmsprop": dict(optimizer="rmsprop"),
    "adagrad": dict(optimizer="adagrad"),
}
SCHEDULES = {
    "constant": dict(lr_schedule="constant"),
    "cosine": dict(lr_schedule="cosine"),
    "exponential": dict(lr_schedule="exponential", lr_decay_rate=0.5, lr_decay_steps=3),
}


def _fields(opt, sched, warmup, **extra):
    return dict(learning_rate=0.05, **OPTIMIZERS[opt], **SCHEDULES[sched], warmup_steps=warmup, **extra)


def _tree(rng, scale=1.0):
    return {
        "w": (scale * rng.normal(size=(6, 5))).astype(np.float32),
        "b": (scale * rng.normal(size=(5,))).astype(np.float32),
        "cells": [{"kernel": (scale * rng.normal(size=(4, 3))).astype(np.float32)}],
    }


def _run_both(fields, *, joint=False, encoder_lr_scale=None):
    """6 steps of each package's optimizer from the same params and
    gradients -> [(port's updates, tpucap's updates)] as numpy trees."""
    rng = np.random.default_rng(11)
    params = {"encoder": _tree(rng), "decoder": _tree(rng)} if joint else _tree(rng)
    grads = [
        {"encoder": _tree(rng, 0.5), "decoder": _tree(rng, 0.5)} if joint else _tree(rng, 0.5)
        for _ in range(STEPS)
    ]
    jopt = jax_build_optimizer(jcfg.TrainConfig(**fields), total_steps=TOTAL_STEPS)
    topt = build_optimizer(tcfg.TrainConfig(**fields), total_steps=TOTAL_STEPS)
    if encoder_lr_scale is not None:
        jopt = jax_encoder_lr(jopt, encoder_lr_scale=encoder_lr_scale)
        topt = encoder_learning_rate_optimizer(topt, encoder_lr_scale=encoder_lr_scale)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update)
    out = []
    for g in grads:
        ju, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jp)
        tu, tstate = topt.update(tree_map(torch.from_numpy, g), tstate, tp)
        jp = optax.apply_updates(jp, ju)
        tp = tree_map(torch.add, tp, tu)
        out.append((tree_map(lambda t: t.numpy(), tu), jax.tree.map(np.asarray, ju)))
    return out


def _close_to_scale(got, want, tol, what):
    for i, (g, w) in enumerate(zip(jax.tree.leaves(got), jax.tree.leaves(want))):
        assert g.shape == w.shape, (what, i)
        err = np.abs(g - w).max()
        assert err <= tol * np.abs(w).max(), (what, i, err, np.abs(w).max())


@pytest.mark.parametrize("warmup", [0, 2])
@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_updates_match_tpucap(opt, sched, warmup):
    steps = _run_both(_fields(opt, sched, warmup))
    for k, (got, want) in enumerate(steps):
        _close_to_scale(got, want, 1e-6, f"step {k}")
    if warmup:  # the ramp starts at 0: no update at all on the first step
        assert all(not np.any(u) for u in tree_leaves(steps[0][0]))


@pytest.mark.parametrize("encoder_lr_scale", [None, 0.1])
def test_clip_first_and_encoder_scale_last_under_a_scheduled_sgd(encoder_lr_scale):
    """A clip at 1.0 of gradients whose joint norm is about 3, sgd with
    momentum under cosine with warmup, and fine-tuning's encoder scale:
    the clip sees the joint tree, the scale only the encoder's updates."""
    fields = _fields("sgd-momentum", "cosine", 2, grad_clip_norm=1.0)
    steps = _run_both(fields, joint=True, encoder_lr_scale=encoder_lr_scale)
    for k, (got, want) in enumerate(steps):
        _close_to_scale(got, want, 1e-6, f"step {k}")
    assert max(np.abs(want["encoder"]["w"]).max() for _, want in steps) > 0


#: Layouts of the port's optimizer state: (TrainConfig fields, container).
LAYOUTS = {
    "adam": (dict(), dict),
    "adam-cosine": (dict(lr_schedule="cosine"), tuple),
    "adamw-clip-exponential": (
        dict(optimizer="adamw", weight_decay=0.01, grad_clip_norm=1.0, lr_schedule="exponential"),
        tuple,
    ),
    "sgd": (dict(optimizer="sgd"), type(None)),
    "sgd-momentum": (dict(optimizer="sgd", momentum=0.9), dict),
    "sgd-cosine": (dict(optimizer="sgd", lr_schedule="cosine"), dict),
    "sgd-momentum-cosine-warmup": (
        dict(optimizer="sgd", momentum=0.9, lr_schedule="cosine", warmup_steps=2),
        tuple,
    ),
    "rmsprop-exponential": (dict(optimizer="rmsprop", lr_schedule="exponential"), tuple),
    "adagrad": (dict(optimizer="adagrad"), dict),
}


def _trained_state(fields, steps=2):
    rng = np.random.default_rng(5)
    params = tree_map(torch.from_numpy, _tree(rng))
    opt = build_optimizer(tcfg.TrainConfig(**fields), total_steps=TOTAL_STEPS)
    state = TrainState.create(params, opt, torch.Generator().manual_seed(0))
    for _ in range(steps):
        u, opt_state = opt.update(tree_map(torch.from_numpy, _tree(rng)), state.opt_state, state.params)
        state = TrainState(state.step + 1, tree_map(torch.add, state.params, u), opt_state, state.rng)
    return state, opt


def _same_tree(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif a is not None:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_opt_state_round_trips_through_the_checkpoint_manager(layout, tmp_path):
    fields, container = LAYOUTS[layout]
    state, opt = _trained_state(fields)
    assert isinstance(state.opt_state, container)
    mgr = CheckpointManager(tmp_path, best_metric=None)
    assert mgr.save(state)
    template = TrainState.create(tree_map(torch.zeros_like, state.params), opt, torch.Generator())
    got = mgr.restore(template)
    assert got.step == state.step
    _same_tree(got.params, state.params)
    _same_tree(got.opt_state, state.opt_state)
    # A step from the restored state is the step from the saved one.
    g = tree_map(torch.ones_like, state.params)
    _same_tree(opt.update(g, got.opt_state, got.params), opt.update(g, state.opt_state, state.params))


@pytest.mark.parametrize(
    "saved,restored",
    [
        ("sgd", "adam"),
        ("adam", "sgd"),
        ("sgd-momentum", "rmsprop-exponential"),
        ("sgd-momentum", "adagrad"),
        ("adam-cosine", "adam"),
        ("sgd-cosine", "sgd-momentum-cosine-warmup"),
    ],
)
def test_restore_with_another_optimizer_layout_is_refused(saved, restored, tmp_path):
    state, _ = _trained_state(LAYOUTS[saved][0])
    mgr = CheckpointManager(tmp_path, best_metric=None)
    mgr.save(state)
    opt = build_optimizer(tcfg.TrainConfig(**LAYOUTS[restored][0]))
    template = TrainState.create(state.params, opt, None)
    with pytest.raises(ValueError, match="opt_state"):
        mgr.restore(template)
    with pytest.raises(ValueError, match="opt_state"):
        mgr.average_params(template, last_k=1)


def test_plain_adam_state_layout_and_update_unchanged(tmp_path):
    """TrainConfig() is plain Adam: the state is the dict {count, mu, nu}
    (count an int32 scalar), the checkpoint's keys are opt_state/count and
    the moments under opt_state/mu and opt_state/nu, and the update is
    Adam's own arithmetic bit for bit."""
    state, opt = _trained_state({}, steps=3)
    s = state.opt_state
    assert list(s) == ["count", "mu", "nu"] and s["count"].dtype == torch.int32
    assert int(s["count"]) == 3
    CheckpointManager(tmp_path, best_metric=None).save(state)
    flat = load_npz(tmp_path / "3" / "state.npz")
    assert sorted(flat) == ["opt_state", "params", "rng", "step"]
    assert list(flat["opt_state"]) == ["count", "mu", "nu"]
    g = tree_map(lambda t: torch.full_like(t, 0.25), state.params)
    u, new = opt.update(g, s, state.params)
    c = torch.tensor(4.0)
    for name in ("w", "b"):
        m = 0.1 * g[name] + 0.9 * s["mu"][name]
        v = 0.001 * (g[name] * g[name]) + 0.999 * s["nu"][name]
        bc1 = 1 - torch.tensor(0.9) ** c
        bc2 = 1 - torch.tensor(0.999) ** c
        want = -1e-3 * ((m / bc1) / (torch.sqrt(v / bc2) + 1e-8))
        assert torch.equal(u[name], want) and torch.equal(new["mu"][name], m)


def test_build_optimizer_refusals_match_tpucap():
    for fields in (dict(optimizer="lion"), dict(lr_schedule="step")):
        with pytest.raises(ValueError) as want:
            jax_build_optimizer(jcfg.TrainConfig(**fields))
        with pytest.raises(ValueError) as got:
            build_optimizer(tcfg.TrainConfig(**fields))
        assert str(got.value) == str(want.value)


CAPTIONS = {
    "a": ["a dog runs on the grass", "the brown dog is running"],
    "b": ["a child plays in the water", "a kid splashes water"],
    "c": ["two dogs play with a ball", "dogs chase the red ball"],
    "d": ["a man rides a bike on the road", "a cyclist on a road"],
    "e": ["a girl in a red dress smiles", "the girl smiles at the camera"],
    "f": ["a black dog jumps over a log", "the dog leaps in the park"],
}


def test_fit_with_sgd_momentum_cosine_and_warmup_matches_tpucap():
    """6 rows a batch of 12 training rows: 2 steps an epoch, 3 epochs, so
    the cosine horizon (6 - 2 warmup steps) ends with the run."""
    train = dict(batch_size=6, learning_rate=0.5, seed=3, optimizer="sgd", momentum=0.9,
                 lr_schedule="cosine", warmup_steps=2)
    dec = dict(embed_dim=16, hidden_dim=32, dropout_rate=0.0)
    jpipe = JaxPipeline(
        jcfg.Config(
            encoder=jcfg.encoder_config("vit_tiny"), decoder=jcfg.DecoderConfig(**dec),
            decode=jcfg.DecodeConfig(max_len=8), train=jcfg.TrainConfig(**train), precision="f32",
        )
    )
    jpipe.fit_tokenizer(CAPTIONS)
    build_on_ports_init(jpipe, 4)
    pipe = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.encoder_config("vit_tiny"), decoder=tcfg.DecoderConfig(**dec),
            decode=tcfg.DecodeConfig(max_len=8), train=tcfg.TrainConfig(**train), precision="f32",
        ),
        tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()),
        device="cpu",
    )
    pipe.build(init_params=False)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    feats = {k: np.random.default_rng(80).normal(size=64).astype(np.float32) for k in CAPTIONS}
    want = jpipe.fit(CAPTIONS, feats, epochs=3, log=None)
    got = pipe.fit(CAPTIONS, feats, epochs=3, log=None)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and g["epoch"] == w["epoch"]
        for k in ("loss", "accuracy", "perplexity", "tokens"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    assert got[-1]["loss"] < got[0]["loss"]


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd-momentum", "rmsprop", "adagrad"])
def test_every_optimizer_and_schedule_trains_with_ema(opt, sched):
    """Each optimizer under each schedule, with warmup and EMA, through
    ``fit`` (2 epochs of 2 steps): finite losses, a shadow of every leaf,
    and every leaf moved by the training."""
    cfg = tcfg.Config(
        encoder=tcfg.encoder_config("vit_tiny"),
        decoder=tcfg.DecoderConfig(embed_dim=16, hidden_dim=32, dropout_rate=0.0),
        decode=tcfg.DecodeConfig(max_len=8),
        train=tcfg.TrainConfig(batch_size=6, seed=3, ema_decay=0.9, **_fields(opt, sched, 1)),
        precision="f32",
    )
    pipe = CaptioningPipeline(cfg, device="cpu")
    pipe.fit_tokenizer(CAPTIONS)
    pipe.build()
    before = [t.clone() for t in tree_leaves(pipe.params["decoder"])]
    feats = {k: np.random.default_rng(81).normal(size=64).astype(np.float32) for k in CAPTIONS}
    hist = pipe.fit(CAPTIONS, feats, epochs=2, log=None)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    after = tree_leaves(pipe.params["decoder"])
    shadow = tree_leaves(pipe.ema_params["decoder"])
    assert len(shadow) == len(after) == len(before)
    assert all(torch.isfinite(e).all() for e in shadow)
    assert sum(not torch.equal(a, b) for a, b in zip(after, before)) >= len(after) - 1


def test_train_config_fields_are_tpucaps():
    """The six fields this surface reads have tpucap's defaults and are no
    longer refused by config_from_dict."""
    names = ("momentum", "lr_schedule", "lr_decay_rate", "lr_decay_steps", "warmup_steps", "ema_decay")
    ours = {f.name: f.default for f in dataclasses.fields(tcfg.TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jcfg.TrainConfig)}
    assert {k: ours[k] for k in names} == {k: theirs[k] for k in names}
    assert not set(names) & set(tcfg.UNPORTED["train"])
    d = tcfg.config_to_dict(tcfg.Config())
    d["train"].update(momentum=0.9, lr_schedule="cosine", warmup_steps=3, ema_decay=0.99)
    got = tcfg.config_from_dict(d).train
    assert (got.momentum, got.lr_schedule, got.warmup_steps, got.ema_decay) == (0.9, "cosine", 3, 0.99)
