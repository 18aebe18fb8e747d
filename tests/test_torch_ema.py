"""tpucap_torch's EMA of the weights (``TrainConfig.ema_decay``) and its
checkpoint averaging (``use_averaged_weights``) against tpucap's, on the
CPU, after tpucap's ``tests/test_ema.py``: tiny_cnn features (128-d) and
32 x 32 images, lstm1 with embed 8 and hidden 16, dropout off, batch 8,
Adam at lr 1e-2, the same weights in both packages (bridged).

Tolerances:
- the shadow's update, d * e + (1 - d) * p: the port rounds each product
  and then the sum, so its shadow after one step equals that hand value in
  f32 bit for bit; tpucap's jitted update on the CPU fuses it into a
  multiply-add, which leaves d * e unrounded, so the port's update of the
  same arrays is within one ulp of d * e plus one of the result of
  tpucap's (measured: equal at d = 0.5, up to 2.4e-7 apart at 0.9);
- the shadow after ``fit`` against tpucap's: within 1e-5 of each tensor's
  scale (the trained params themselves differ by f32 summation order);
- EMA does not change training: the params equal a run without EMA bit for
  bit;
- ``use_averaged_weights`` on checkpoints holding the same params: the
  average equals tpucap's bit for bit (f32 running sums in the same
  order), with plain Adam's state and with sgd's momentum trace;
- the refusals raise with tpucap's messages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.checkpoint import CheckpointManager as JaxManager
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.train import TrainState as JaxTrainState
from tpucap.train import build_optimizer as jax_build_optimizer
from tpucap_torch import config as tcfg
from tpucap_torch.checkpoint import CheckpointManager
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.core import tree_leaves, tree_map
from tpucap_torch.pipeline import CaptioningPipeline, ema_update
from tpucap_torch.text import Tokenizer
from tpucap_torch.train import TrainState, build_optimizer

torch.set_num_threads(2)

DECAY = 0.9
CAPTIONS = {
    f"i{k}": [c]
    for k, c in enumerate(
        [
            "startseq a black dog runs across the green grass endseq",
            "startseq a dog is running on grass endseq",
            "startseq two children play soccer in the park endseq",
            "startseq a child kicks a ball endseq",
            "startseq a man rides a red bicycle down the street endseq",
            "startseq the man is riding his bike endseq",
            "startseq a woman in a blue shirt climbs a rock wall endseq",
            "startseq a climber scales the rock face endseq",
        ]
    )
}


def _pipes(ema=0.0, **train):
    """(tpucap's pipeline, the port's on the same weights)."""
    kw = dict(batch_size=8, learning_rate=1e-2, seed=0, ema_decay=ema, **train)
    dec = dict(embed_dim=8, hidden_dim=16, dropout_rate=0.0)
    jpipe = JaxPipeline(
        jcfg.Config(
            encoder=jcfg.encoder_config("tiny_cnn"), decoder=jcfg.DecoderConfig(**dec),
            decode=jcfg.DecodeConfig(max_len=10), train=jcfg.TrainConfig(**kw), precision="f32",
        )
    )
    jpipe.fit_tokenizer(CAPTIONS)
    jpipe.build()
    pipe = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.encoder_config("tiny_cnn"), decoder=tcfg.DecoderConfig(**dec),
            decode=tcfg.DecodeConfig(max_len=10), train=tcfg.TrainConfig(**kw), precision="f32",
        ),
        tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()),
        device="cpu",
    )
    pipe.build(init_params=False)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    return jpipe, pipe


def _features(seed=1):
    rng = np.random.default_rng(seed)
    return {i: rng.normal(size=128).astype(np.float32) for i in CAPTIONS}


def _images(seed=2):
    rng = np.random.default_rng(seed)
    return {i: rng.normal(size=(32, 32, 3)).astype(np.float32) for i in CAPTIONS}


def _numpy(tree):
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def _close_to_scale(got, want, tol, what):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        err = np.abs(np.asarray(g) - np.asarray(w)).max()
        assert err <= tol * np.abs(np.asarray(w)).max(), (what, i, err)


def test_ema_update_is_the_hand_value_and_within_an_ulp_of_tpucaps():
    rng = np.random.default_rng(3)
    e, p = (rng.normal(size=(4, 1000)).astype(np.float32) for _ in range(2))
    for d in (0.5, 0.9, 0.999):
        shadow = {"x": torch.from_numpy(e.copy())}
        ema_update(shadow, {"x": torch.from_numpy(p)}, d)
        got = shadow["x"].numpy()
        assert np.array_equal(got, np.float32(d) * e + np.float32(1 - d) * p), d
        want = np.asarray(jax.jit(lambda a, b, d=d: d * a + (1.0 - d) * b)(e, p))
        bound = np.spacing(np.abs(np.float32(d) * e)) + np.spacing(np.abs(want))
        assert np.all(np.abs(got - want) <= bound), d


def test_one_step_hand_value_and_the_shadow_after_fit_match_tpucap():
    """One epoch of one batch is one step: the shadow is d p0 + (1 - d) p1
    exactly. Then three epochs on both packages: the shadows agree."""
    _, pipe = _pipes(DECAY)
    p0 = _numpy(pipe.params["decoder"])
    pipe.fit(CAPTIONS, _features(), epochs=1, log=None)
    p1 = _numpy(pipe.params["decoder"])
    for a0, a1, e in zip(p0, p1, _numpy(pipe.ema_params["decoder"]), strict=True):
        assert np.array_equal(e, np.float32(DECAY) * a0 + np.float32(1 - DECAY) * a1)

    jpipe, pipe = _pipes(DECAY)
    jpipe.fit(CAPTIONS, _features(), epochs=3, log=None)
    pipe.fit(CAPTIONS, _features(), epochs=3, log=None)
    assert list(pipe.ema_params) == ["decoder"]
    want = jax.tree.map(np.asarray, jpipe.ema_params["decoder"])
    _close_to_scale(params_to_numpy(pipe.ema_params["decoder"]), want, 1e-5, "ema")


def test_ema_does_not_change_training():
    _, plain = _pipes()
    _, with_ema = _pipes(DECAY)
    plain.fit(CAPTIONS, _features(), epochs=3, log=None)
    with_ema.fit(CAPTIONS, _features(), epochs=3, log=None)
    assert plain.ema_params is None
    for a, b in zip(_numpy(plain.params["decoder"]), _numpy(with_ema.params["decoder"]), strict=True):
        assert np.array_equal(a, b)


def test_use_ema_weights_swap_and_restore():
    jpipe, pipe = _pipes(DECAY)
    feats = _features()
    jpipe.fit(CAPTIONS, feats, epochs=2, log=None)
    pipe.fit(CAPTIONS, feats, epochs=2, log=None)
    raw = _numpy(pipe.params["decoder"])
    pipe._inference_params()
    replaced = pipe.use_ema_weights()
    assert pipe.params["decoder"] is pipe.ema_params["decoder"] and pipe._bf16_params is None
    x = np.stack([feats["i0"], feats["i1"]])
    jreplaced = jpipe.use_ema_weights()
    assert sorted(replaced) == sorted(jreplaced) == ["decoder"]
    # Greedy on the averaged weights: tpucap's captions.
    assert pipe.generate(x, method="greedy") == jpipe.generate(x, method="greedy")
    pipe.params.update(replaced)
    for a, b in zip(_numpy(pipe.params["decoder"]), raw, strict=True):
        assert np.array_equal(a, b)


def test_ema_guards_with_tpucaps_messages(tmp_path):
    def message(fn, exc):
        with pytest.raises(exc) as info:
            fn()
        return str(info.value)

    feats = _features()
    jpipe, pipe = _pipes(1.5)
    assert message(lambda: pipe.fit(CAPTIONS, feats, epochs=1, log=None), ValueError) == message(
        lambda: jpipe.fit(CAPTIONS, feats, epochs=1, log=None), ValueError
    ) == "ema_decay must be in (0, 1), got 1.5"
    jfresh, fresh = _pipes()
    assert message(fresh.use_ema_weights, ValueError) == message(jfresh.use_ema_weights, ValueError)
    assert message(fresh.use_ema_weights, ValueError).startswith("no EMA weights tracked — ")
    # resume would not restore the shadow: both training paths refuse it.
    jpipe, pipe = _pipes(DECAY)
    mgr, jmgr = CheckpointManager(tmp_path / "port"), JaxManager(str(tmp_path / "tpucap"))
    want = message(lambda: jpipe.fit(CAPTIONS, feats, epochs=1, checkpoint_manager=jmgr, resume=True,
                                     log=None), NotImplementedError)
    jmgr.close()
    assert want == "resume does not restore the EMA shadow; drop ema_decay or restart"
    assert message(lambda: pipe.fit(CAPTIONS, feats, epochs=1, checkpoint_manager=mgr, resume=True,
                                    log=None), NotImplementedError) == want
    assert message(lambda: pipe.fit_finetune(CAPTIONS, _images(), epochs=1, checkpoint_manager=mgr,
                                             resume=True, log=None), NotImplementedError) == want
    assert mgr.all_steps() == []


def test_fit_finetune_tracks_both_trees():
    """One step: each tree's shadow is d p0 + (1 - d) p1 exactly; the
    encoder's too, which moves at 0.1 of the decoder's lr."""
    _, pipe = _pipes(DECAY)
    p0 = {k: _numpy(pipe.params[k]) for k in ("encoder", "decoder")}
    pipe.fit_finetune(CAPTIONS, _images(), epochs=1, log=None)
    assert sorted(pipe.ema_params) == ["decoder", "encoder"]
    for k in ("encoder", "decoder"):
        p1 = _numpy(pipe.params[k])
        assert any(not np.array_equal(a, b) for a, b in zip(p0[k], p1)), k
        for a0, a1, e in zip(p0[k], p1, _numpy(pipe.ema_params[k]), strict=True):
            assert np.array_equal(e, np.float32(DECAY) * a0 + np.float32(1 - DECAY) * a1), k
    replaced = pipe.use_ema_weights()
    assert sorted(replaced) == ["decoder", "encoder"]
    assert len(pipe.generate(np.stack([_features()["i0"]] * 2), method="greedy")) == 2


@pytest.mark.parametrize("train", [{}, dict(optimizer="sgd", momentum=0.9, lr_schedule="cosine")])
def test_use_averaged_weights_matches_tpucap(train, tmp_path):
    """Three checkpoints of the same decoder params in each package's
    manager (each with its optimizer's state), then the average of the
    newest two and of two named steps."""
    jpipe, pipe = _pipes(**train)
    jopt = jax_build_optimizer(jpipe.config.train)
    topt = build_optimizer(pipe.config.train)
    jmgr = JaxManager(str(tmp_path / "tpucap"), best_metric=None)
    mgr = CheckpointManager(tmp_path / "port", best_metric=None)
    rng = np.random.default_rng(4)
    for step in (1, 2, 3):
        tree = jax.tree.map(
            lambda a: (a + rng.normal(size=a.shape)).astype(np.float32),
            jax.tree.map(np.asarray, jpipe.params["decoder"]),
        )
        jtree = jax.tree.map(jnp.asarray, tree)
        jmgr.save(JaxTrainState(step=jnp.asarray(step), params=jtree, opt_state=jopt.init(jtree),
                                rng=jax.random.key(0)))
        ttree = params_from_jax(tree)
        mgr.save(TrainState(step, ttree, topt.init(ttree), None))
    jmgr.close()
    for kw in (dict(last_k=2), dict(steps=[1, 3])):
        before = pipe.params["decoder"]
        replaced = pipe.use_averaged_weights(tmp_path / "port", **kw)
        jpipe.use_averaged_weights(str(tmp_path / "tpucap"), **kw)
        assert replaced is before
        got, want = params_to_numpy(pipe.params["decoder"]), jax.tree.map(np.asarray, jpipe.params["decoder"])
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
            assert np.array_equal(g, w), kw
    # Checkpoints of another optimizer's state are refused.
    pipe.config = dataclasses.replace(pipe.config, train=tcfg.TrainConfig(optimizer="adagrad"))
    with pytest.raises(ValueError, match="opt_state"):
        pipe.use_averaged_weights(tmp_path / "port", last_k=2)


def test_resume_is_refused_before_anything_is_read(tmp_path):
    """fit(resume=True) with EMA raises on an empty directory too, and
    without a manager the missing manager is reported first (tpucap's
    order)."""
    _, pipe = _pipes(DECAY)
    with pytest.raises(ValueError, match="^resume=True needs a checkpoint_manager$"):
        pipe.fit(CAPTIONS, _features(), epochs=1, resume=True, log=None)
    with pytest.raises(NotImplementedError, match="EMA shadow"):
        pipe.fit(CAPTIONS, _features(), epochs=1, checkpoint_manager=CheckpointManager(tmp_path),
                 resume=True, log=None)
    assert pipe.ema_params is None
