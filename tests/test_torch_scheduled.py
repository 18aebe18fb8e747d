"""Scheduled sampling and multi-step dispatch in tpucap_torch against
tpucap, on the CPU: lstm1 with embed 16, hidden 32, vocab 50, 24-d
features, batch 6, T = 8; ``fit`` on tiny_cnn's 128-d features.

tpucap draws the scheduled-sampling coin from a jax key, whose bits torch
cannot reproduce: the mixing is compared on tpucap's coin handed to the
port's ``scheduled_inputs``, and whole steps and fits at eps = 1, where the
coin is all true in both packages.

Tolerances: ``epsilon_for_epoch`` and the mixed tokens exactly (f32); the
eps-0 step, the multi-step's params and ``fit`` at steps_per_dispatch 4
(with a 2-step tail, dropout and scheduled sampling on) bit for bit against
the port's own single steps; a step's update under plain SGD (update =
-lr g, so no Adam sign flips; at lr 1e6, so that the update read back
from the params keeps the gradient's bits) within 1e-6 of each tensor's
scale against tpucap's at eps 1, and the params after tpucap's multi-step
(SGD at lr 0.1) within 1e-6 of each tensor's scale; fit's per-epoch loss,
accuracy and perplexity within 1e-5 relative against tpucap's (as
``tests/test_torch_train.py``), and the epoch losses of a multi-step fit
within 1e-6 relative of its single-step run (the metric sums are added in
another order). Interval and rescue checkpoints land on tpucap's steps;
tpucap's guards raise tpucap's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.models.decoders.lstm import MergeDecoder as JaxDecoder
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.train import loop as jloop
from tpucap.train import scheduled as jsched
from tpucap_torch import config as tcfg
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.core import tree_leaves
from tpucap_torch.models.decoders.lstm import MergeDecoder
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer
from tpucap_torch.train import TrainState, build_optimizer, make_train_step
from tpucap_torch.train.scheduled import epsilon_for_epoch, scheduled_draws, scheduled_inputs

from ports_init import build_on_ports_init, jit_init

torch.set_num_threads(2)

V, FD, B, T = 50, 24, 6, 8
DIMS = dict(vocab_size=V, feature_dim=FD, embed_dim=16, hidden_dim=32)
FEATURES = 128  # tiny_cnn's pooled width


def _corpus(n_images):
    return {
        f"img{i}": [
            "startseq " + " ".join(f"w{(i * 7 + j * 3 + k) % 13}" for k in range(3 + (i + j) % 6)) + " endseq"
            for j in range(2)
        ]
        for i in range(n_images)
    }


def _batch(seed, n=None):
    """Features and tokens (startseq, random ids, ragged post padding),
    with a leading axis of ``n`` stacked batches when given."""
    rng = np.random.default_rng(seed)
    lead = () if n is None else (n,)
    feats = rng.normal(size=(*lead, B, FD)).astype(np.float32)
    toks = rng.integers(2, V, size=(*lead, B, T + 1)).astype(np.int32)
    toks[..., 0] = 1
    for i, length in enumerate(rng.integers(3, T + 1, size=B)):
        toks[..., i, length:] = 0
    return feats, toks


def _decoders():
    return JaxDecoder(dropout_rate=0.0, **DIMS), MergeDecoder(dropout_rate=0.0, **DIMS)


def _init(jdec, seed):
    return jax.tree.map(np.asarray, jit_init(jdec, jax.random.key(seed)))


def _t(*arrays):
    return [torch.from_numpy(a) if a.dtype == np.float32 else torch.from_numpy(a).long() for a in arrays]


def _close_to_scale(got, want, share, what=""):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0, atol=share * np.abs(w).max(), err_msg=what)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


SGD = dict(optimizer="sgd", learning_rate=0.1)
# Plain SGD at a large lr: (params - updated) / lr gives back the gradient
# that a step applied, its rounding that of the gradient, not the params'.
SGD_LR = 1e6


def _grads(before, after):
    return jax.tree.map(lambda a, b: (np.float64(b) - np.asarray(a, np.float64)) / SGD_LR, after, before)


# -- the ramps and the mixing -------------------------------------------------------


@pytest.mark.parametrize("schedule", ["linear", "inv_sigmoid", "constant"])
def test_epsilon_for_epoch_is_tpucaps(schedule):
    for epoch in range(12):
        for total in (1, 12):
            want = jsched.epsilon_for_epoch(epoch, total, max_eps=0.7, schedule=schedule)
            assert epsilon_for_epoch(epoch, total, max_eps=0.7, schedule=schedule) == want
    assert epsilon_for_epoch(0, 12, max_eps=1.0, schedule=schedule) == (1.0 if schedule == "constant" else 0.0)
    with pytest.raises(ValueError, match="unknown ss_schedule 'cosine'"):
        epsilon_for_epoch(0, 3, max_eps=0.5, schedule="cosine")


@pytest.mark.parametrize("pad_scale", [1.0, 60.0])
def test_mixing_with_tpucaps_coin_gives_tpucaps_tokens(pad_scale):
    """tpucap's coin (its bernoulli draw on the same key) handed to the
    port's ``scheduled_inputs``. With ``pad_scale`` the head's pad column is
    scaled up, so pad wins the argmax at some positions and the guard keeps
    their gold token."""
    jdec, tdec = _decoders()
    jp = _init(jdec, 1)
    jp["out"]["kernel"] = jp["out"]["kernel"].copy()
    jp["out"]["kernel"][:, 0] *= pad_scale
    feats, toks = _batch(2)
    inputs = toks[:, :-1]
    key = jax.random.key(7)
    want = np.asarray(jsched.scheduled_inputs(
        jdec, jp, jnp.asarray(feats), jnp.asarray(inputs), eps=jnp.float32(0.5), rng=key
    ))
    coin = np.asarray(jax.random.bernoulli(key, jnp.float32(0.5), (B, T - 1)))
    params = params_from_jax(jp)
    got = scheduled_inputs(tdec, params, *_t(feats, inputs), coin=torch.from_numpy(coin))
    np.testing.assert_array_equal(got.numpy(), want)
    preds = tdec.forward_train(params, *_t(feats, inputs), deterministic=True).argmax(-1)[:, :-1].numpy()
    live = coin & (inputs[:, 1:] != 0)
    np.testing.assert_array_equal(want[:, 1:][live & (preds != 0)], preds[live & (preds != 0)])
    np.testing.assert_array_equal(want[:, 1:][~live | (preds == 0)], inputs[:, 1:][~live | (preds == 0)])
    assert (want[:, 0] == 1).all() and (live & (preds != 0)).any()
    assert (live & (preds == 0)).any() == (pad_scale > 1)
    gen = torch.Generator().manual_seed(0)
    assert scheduled_draws((4, 5), 1.0, gen).all() and not scheduled_draws((4, 5), 0.0, gen).any()


# -- the step -------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_eps0_step_is_the_plain_step(accum):
    """Dropout off: eps 0 mixes nothing, so the update is the plain step's
    bit for bit (the coin still draws from the state's generator)."""
    jdec, tdec = _decoders()
    params = params_from_jax(_init(jdec, 3))
    feats, toks = _t(*_batch(4))
    opt = build_optimizer(tcfg.TrainConfig())
    kw = dict(deterministic=True, grad_accum_steps=accum)
    plain, m0 = make_train_step(tdec, opt, **kw)(TrainState.create(params, opt, None), feats, toks)
    ss, m1 = make_train_step(tdec, opt, scheduled_sampling=True, **kw)(
        TrainState.create(params, opt, torch.Generator().manual_seed(1)), feats, toks, 0.0
    )
    assert _same(plain.params, ss.params) and _same(plain.opt_state, ss.opt_state)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    with pytest.raises(ValueError, match=r"scheduled sampling \(ss_eps\) needs ss_rng"):
        make_train_step(tdec, opt, scheduled_sampling=True, **kw)(
            TrainState.create(params, opt, None), feats, toks, 0.5
        )


@pytest.mark.parametrize("accum", [1, 2])
def test_eps1_step_matches_tpucap(accum):
    jdec, tdec = _decoders()
    jp = _init(jdec, 5)
    feats, toks = _batch(6)
    sgd = dict(optimizer="sgd", learning_rate=SGD_LR)
    jopt, topt = jloop.build_optimizer(jcfg.TrainConfig(**sgd)), build_optimizer(tcfg.TrainConfig(**sgd))
    kw = dict(deterministic=True, grad_accum_steps=accum, scheduled_sampling=True)
    jstate, jm = jloop.make_train_step(jdec, jopt, **kw)(
        jloop.TrainState.create(jax.tree.map(jnp.asarray, jp), jopt, jax.random.key(0)),
        jnp.asarray(feats), jnp.asarray(toks), jnp.float32(1.0),
    )
    tstate, tm = make_train_step(tdec, topt, **kw)(
        TrainState.create(params_from_jax(jp), topt, torch.Generator().manual_seed(0)), *_t(feats, toks), 1.0
    )
    _close_to_scale(_grads(jp, params_to_numpy(tstate.params)), _grads(jp, jax.device_get(jstate.params)),
                    1e-6, "updates")
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-6)
    # The mixed inputs moved the loss off teacher forcing.
    plain = make_train_step(tdec, topt, deterministic=True, grad_accum_steps=accum)
    _, m0 = plain(TrainState.create(params_from_jax(jp), topt, None), *_t(feats, toks))
    assert abs(m0["loss"].item() - tm["loss"].item()) > 1e-6


@pytest.mark.parametrize("ss", [None, 1.0])
def test_multi_step_is_n_single_steps_and_tpucaps(ss):
    """multi_steps=3 on stacked batches: the port's own 3 single steps bit
    for bit (dropout on: the same generator draws), and tpucap's multi-step
    (dropout off, SGD) within 1e-6 of each tensor's scale."""
    n = 3
    jdec = JaxDecoder(dropout_rate=0.0, **DIMS)
    jp = _init(jdec, 8)
    feats, toks = _batch(9, n)
    extra = () if ss is None else (ss,)
    topt = build_optimizer(tcfg.TrainConfig(**SGD))
    tdec = MergeDecoder(dropout_rate=0.5, **DIMS)
    kw = dict(scheduled_sampling=ss is not None)

    def start():
        return TrainState.create(params_from_jax(jp), topt, torch.Generator().manual_seed(2))

    multi, msum = make_train_step(tdec, topt, multi_steps=n, **kw)(start(), *_t(feats, toks), *extra)
    single, ssum = start(), None
    step = make_train_step(tdec, topt, **kw)
    for f, t in zip(*_t(feats, toks)):
        single, m = step(single, f, t, *extra)
        ssum = m if ssum is None else {k: ssum[k] + v for k, v in m.items()}
    assert multi.step == single.step == n and _same(multi.params, single.params)
    assert all(torch.equal(msum[k], ssum[k]) for k in ssum)

    jopt = jloop.build_optimizer(jcfg.TrainConfig(**SGD))
    jextra = () if ss is None else (jnp.float32(ss),)
    jstate, jm = jloop.make_train_step(jdec, jopt, deterministic=True, multi_steps=n, **kw)(
        jloop.TrainState.create(jax.tree.map(jnp.asarray, jp), jopt, jax.random.key(0)),
        jnp.asarray(feats), jnp.asarray(toks), *jextra,
    )
    tstate, tm = make_train_step(tdec, topt, deterministic=True, multi_steps=n, **kw)(
        start(), *_t(feats, toks), *extra
    )
    _close_to_scale(params_to_numpy(tstate.params), jax.device_get(jstate.params), 1e-6, "params")
    for k in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-6, err_msg=k)


# -- fit ------------------------------------------------------------------------------------


def _configs(package, rate, train):
    return package.Config(
        encoder=package.encoder_config("tiny_cnn"),
        decoder=package.DecoderConfig(embed_dim=16, hidden_dim=32, dropout_rate=rate),
        decode=package.DecodeConfig(max_len=8),
        train=package.TrainConfig(**{**dict(batch_size=2, learning_rate=1e-2, seed=3), **train}),
        precision="f32",
    )


def _features(captions):
    rng = np.random.default_rng(80)
    return {k: rng.normal(size=FEATURES).astype(np.float32) for k in captions}


def _pipelines(captions, rate=0.0, **train):
    """tpucap's and the port's pipelines on tiny_cnn, the port holding
    tpucap's built weights, and seeded features of every image."""
    jpipe = JaxPipeline(_configs(jcfg, rate, train))
    jpipe.fit_tokenizer(captions)
    build_on_ports_init(jpipe, 4)
    pipe = CaptioningPipeline(
        _configs(tcfg, rate, train), tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()), device="cpu"
    )
    pipe.build(init_params=False)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    return jpipe, pipe, _features(captions)


def _port_pipeline(captions, rate=0.0, **train):
    pipe = CaptioningPipeline(_configs(tcfg, rate, train), device="cpu")
    pipe.fit_tokenizer(captions)
    pipe.build(seed=4)
    return pipe


def test_fit_with_constant_scheduled_sampling_matches_tpucap():
    captions = _corpus(7)
    jpipe, pipe, feats = _pipelines(captions, scheduled_sampling=1.0, ss_schedule="constant", batch_size=4)
    want = jpipe.fit(captions, feats, epochs=3, log=None)
    got = pipe.fit(captions, feats, epochs=3, log=None)
    assert [sorted(e) for e in got] == [sorted(e) for e in want]
    for g, w in zip(got, want):
        assert g["ss_eps"] == w["ss_eps"] == 1.0
        for k in ("loss", "accuracy", "perplexity", "tokens"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


def test_fit_steps_per_dispatch_is_the_single_step_trajectory():
    """6 steps an epoch at spd 4: one group and a 2-step tail, with
    dropout and a linear scheduled-sampling ramp drawing from one
    generator; 2 epochs."""
    captions = _corpus(6)
    feats = _features(captions)
    histories, params = [], []
    for spd in (1, 4):
        pipe = _port_pipeline(captions, rate=0.5, scheduled_sampling=0.5, steps_per_dispatch=spd)
        histories.append(pipe.fit(captions, feats, epochs=2, log=None))
        params.append(pipe.params["decoder"])
    assert _same(*params)
    for a, b in zip(*histories):
        assert a["ss_eps"] == b["ss_eps"] and sorted(a) == sorted(b)
        for k in ("loss", "accuracy", "perplexity", "tokens"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, err_msg=k)
    assert [h["ss_eps"] for h in histories[0]] == [0.0, 0.5]


class _Recorder:
    """A duck-typed checkpoint manager that records the steps saved."""

    def __init__(self):
        self.saves = []

    def latest_step(self):
        return self.saves[-1][1] if self.saves else None

    def save(self, state, metrics=None):
        self.saves.append(("epoch" if metrics else "interval", int(state.step)))

    def save_rescue(self, state):
        if self.latest_step() != int(state.step):
            self.saves.append(("interval", int(state.step)))


class _FiresAt:
    """A preemption guard that fires on its ``n``-th query."""

    def __init__(self, n):
        self.n, self.queries = n, 0

    @property
    def fired(self):
        self.queries += 1
        return self.queries >= self.n


@pytest.mark.parametrize("spd", [4, 8])
def test_interval_saves_and_preemption_rescue_at_tpucaps_steps(spd):
    """2 epochs of 10 steps, a checkpoint every 5 steps: tpucap saves at the
    first group boundary at or past each multiple (spd 4: 8, 14, 18; spd 8:
    8, 18) besides the epoch save at 10; the tails save nothing. The guard
    is read at dispatch boundaries and after each tail step: it fires on its
    query after step 19 (a tail step), so the run ends there with a
    rescue."""
    captions = _corpus(10)
    jpipe, pipe, feats = _pipelines(captions, checkpoint_every_steps=5, steps_per_dispatch=spd)
    runs = {}
    for name, p in (("tpucap", jpipe), ("port", pipe)):
        mgr, guard = _Recorder(), _FiresAt({4: 7, 8: 5}[spd])
        hist = p.fit(captions, feats, epochs=2, checkpoint_manager=mgr, preemption_guard=guard, log=None)
        runs[name] = (mgr.saves, [sorted(h) for h in hist], [h.get("preempted") for h in hist])
    assert runs["port"] == runs["tpucap"]
    interval = {4: [8, 14, 18], 8: [8, 18]}[spd]
    assert runs["port"][0] == sorted([("interval", s) for s in [*interval, 19]] + [("epoch", 10)], key=lambda x: x[1])
    assert runs["port"][2] == [None, True]


@pytest.mark.parametrize(
    "train, error, match",
    [
        (dict(scheduled_sampling=1.5), ValueError, r"scheduled_sampling=1\.5 must be a probability in \(0, 1\]"),
        (dict(scheduled_sampling=0.5, ss_schedule="cosine"), ValueError, "unknown ss_schedule 'cosine'"),
        (dict(steps_per_dispatch=0), ValueError, "steps_per_dispatch=0 must be >= 1"),
        (dict(steps_per_dispatch=2, ema_decay=0.9), NotImplementedError, "ema_decay updates a per-step"),
    ],
)
def test_fit_guards_raise_tpucaps_messages(train, error, match):
    captions = _corpus(3)
    jpipe, pipe, feats = _pipelines(captions, **train)
    for p in (jpipe, pipe):
        with pytest.raises(error, match=match):
            p.fit(captions, feats, epochs=1, log=None)


def test_fit_finetune_reads_neither_field():
    """tpucap's fit_finetune never reads scheduled_sampling or
    steps_per_dispatch: the port's trains the same with and without them."""
    captions = _corpus(4)
    rng = np.random.default_rng(5)
    images = {k: rng.uniform(-1, 1, size=(32, 32, 3)).astype(np.float32) for k in captions}
    out = []
    for train in (dict(), dict(scheduled_sampling=0.5, ss_schedule="constant", steps_per_dispatch=4)):
        pipe = _port_pipeline(captions, **train)
        hist = pipe.fit_finetune(captions, images, epochs=2, log=None)
        assert all("ss_eps" not in h for h in hist)
        out.append((pipe.params, [h["loss"] for h in hist]))
    assert _same(out[0][0], out[1][0]) and out[0][1] == out[1][1]
