"""tpucap_torch's CheckpointManager against tpucap's (orbax 0.11.32), on the
CPU.

- A save -> restore round trip is bit-identical: the step, every param leaf
  with its dtype (f32, bf16, a list level), Adam's count and moments, and
  the dropout generator's state (the restored generator draws what the
  saved one would have drawn).
- Retention and selection: the same drawn sequences of (step increment,
  metrics or None) go through both managers; after every save the
  retained steps, ``latest_step()`` and ``best_step()`` are tpucap's
  (exact), for min and max keying, ``max_to_keep`` 1-3 and
  ``best_metric=None``; metric values are drawn from small sets, so ties
  occur. A reopened manager reads the same steps and metrics back.
- ``average_params`` on bridged trees (conv kernels HWIO -> OIHW) within
  1e-7 of tpucap's: both sum in f32 in step order and divide once.
- A directory of orbax checkpoints is refused; a save cut off before its
  rename leaves no step, and its leftovers are removed when the directory
  is opened again.
- ``fit(checkpoint_manager=...)`` saves tpucap's steps with tpucap's
  metrics (val_loss within rtol 1e-6, fit's drift by summation order;
  val_bleu4 exact) and keeps and picks the same steps, dropout off.
"""

import dataclasses
import os
import tempfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpucap import config as jcfg
from tpucap.checkpoint import CheckpointManager as JaxManager
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.train.loop import TrainState as JaxTrainState
from tpucap_torch import config as tcfg
from tpucap_torch.checkpoint import CheckpointManager, manager
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.core import tree_leaves, tree_map
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer
from tpucap_torch.train import TrainState, build_optimizer

from ports_init import build_on_ports_init

torch.set_num_threads(2)


def _port_state(step, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {
        "dense": {"kernel": torch.randn(3, 4, generator=g), "bias": torch.randn(4, generator=g)},
        "cells": [{"kernel": torch.randn(2, 8, generator=g).to(torch.bfloat16)}],
        "conv": {"kernel": torch.randn(5, 3, 3, 3, generator=g)},
    }
    opt = build_optimizer(tcfg.TrainConfig())
    state = TrainState.create(params, opt, torch.Generator().manual_seed(seed + 1))
    state.opt_state = {
        "count": torch.tensor(step, dtype=torch.int32),
        "mu": tree_map(lambda t: torch.randn(t.shape, generator=g).to(t.dtype), params),
        "nu": tree_map(lambda t: torch.rand(t.shape, generator=g).to(t.dtype), params),
    }
    state.step = step
    return state


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_save_restore_round_trip_is_bit_identical(tmp_path):
    state = _port_state(12)
    torch.rand(7, generator=state.rng)  # the generator has moved on
    mgr = CheckpointManager(tmp_path)
    assert mgr.save(state, {"val_loss": 1.5, "val_bleu4": np.float32(0.25)})
    template = TrainState.create(
        tree_map(torch.zeros_like, state.params), build_optimizer(tcfg.TrainConfig()),
        torch.Generator(),
    )
    for back in (mgr.restore(template), CheckpointManager(tmp_path).restore(template, step=12)):
        assert back.step == 12
        for name in ("params", "opt_state"):
            got, want = tree_leaves(getattr(back, name)), tree_leaves(getattr(state, name))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
        assert isinstance(back.params["cells"], list)
        g = torch.Generator()
        g.set_state(state.rng.get_state())
        torch.testing.assert_close(torch.rand(5, generator=back.rng), torch.rand(5, generator=g),
                                   rtol=0, atol=0)
    assert mgr.metrics(12) == {"val_loss": 1.5, "val_bleu4": 0.25}
    assert sorted(os.listdir(tmp_path / "12")) == [manager.METRICS_FILE, manager.STATE_FILE]
    wrong = dataclasses.replace(template, params={**template.params, "dense": {
        "kernel": torch.zeros(4, 3), "bias": torch.zeros(4)}})
    with pytest.raises(ValueError, match="dense/kernel"):
        mgr.restore(wrong)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(template)


# -- retention and selection against orbax -------------------------------------------

_JAX_STATE = JaxTrainState.create({"w": jnp.zeros(2)}, optax.adam(1e-3), jax.random.key(0))
_metrics = st.one_of(
    st.none(),
    st.fixed_dictionaries({"val_loss": st.sampled_from([0.5, 1.0, 2.0]),
                           "val_bleu4": st.sampled_from([0.0, 0.1, 0.2])}),
)
_sequences = st.lists(st.tuples(st.sampled_from([0, 1, 1, 2, 5]), _metrics), min_size=1,
                      max_size=8)


def _observed(mgr):
    return mgr.all_steps(), mgr.latest_step(), mgr.best_step()


@pytest.mark.parametrize("max_to_keep", [1, 2, 3])
@pytest.mark.parametrize(
    "best_metric,best_mode", [("val_loss", "min"), ("val_bleu4", "max"), (None, "min")]
)
@settings(max_examples=10, deadline=None, derandomize=True, database=None)
@given(seq=_sequences)
def test_retention_and_best_step_follow_orbax(max_to_keep, best_metric, best_mode, seq):
    kw = dict(max_to_keep=max_to_keep, best_metric=best_metric, best_mode=best_mode)
    with tempfile.TemporaryDirectory() as jd, tempfile.TemporaryDirectory() as td:
        theirs, ours = JaxManager(jd, **kw), CheckpointManager(td, **kw)
        step = 0
        for inc, metrics in seq:
            step += inc
            theirs.save(dataclasses.replace(_JAX_STATE, step=jnp.asarray(step)), metrics)
            ours.save(TrainState(step=step, params={"w": torch.zeros(2)}, opt_state=None,
                                 rng=None), metrics)
            assert _observed(ours) == _observed(theirs), (step, metrics)
            assert sorted(os.listdir(td)) == sorted(str(s) for s in ours.all_steps())
        theirs.close()
        again = CheckpointManager(td, **kw)
        assert _observed(again) == _observed(ours)
        assert [again.metrics(s) for s in again.all_steps()] == [
            theirs._mgr.metrics(s) for s in theirs.all_steps()
        ]


def test_average_params_matches_tpucap(tmp_path):
    rng = np.random.default_rng(3)
    jax_trees = [
        {"conv": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                  "bias": rng.normal(size=4).astype(np.float32)},
         "cells": [{"kernel": rng.normal(size=(5, 8)).astype(np.float32)}]}
        for _ in range(3)
    ]
    theirs = JaxManager(str(tmp_path / "jax"), best_metric=None)
    ours = CheckpointManager(tmp_path / "port", best_metric=None)
    opt = build_optimizer(tcfg.TrainConfig())
    for step, tree in zip((3, 6, 9), jax_trees):
        theirs.save(JaxTrainState(step=jnp.asarray(step), params=tree,
                                  opt_state=optax.adam(1e-3).init(tree), rng=jax.random.key(0)))
        ours.save(dataclasses.replace(TrainState.create(params_from_jax(tree), opt, None),
                                      step=step))
    jtemplate = JaxTrainState.create(jax_trees[0], optax.adam(1e-3), jax.random.key(0))
    template = TrainState.create(params_from_jax(jax_trees[0]), opt, None)
    for kw in (dict(), dict(last_k=2), dict(steps=[3, 9])):
        got = params_to_numpy(ours.average_params(template, **kw))
        want = theirs.average_params(jtemplate, **kw)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="not among retained"):
        ours.average_params(template, steps=[4])
    theirs.close()


def test_orbax_directory_and_unported_options_refused(tmp_path):
    jmgr = JaxManager(str(tmp_path / "orbax"))
    jmgr.save(_JAX_STATE, {"val_loss": 1.0})
    jmgr.close()
    with pytest.raises(ValueError, match="orbax"):
        CheckpointManager(tmp_path / "orbax")
    with pytest.raises(NotImplementedError, match="async_save"):
        CheckpointManager(tmp_path / "a", async_save=True)
    with pytest.raises(ValueError, match="best_mode"):
        CheckpointManager(tmp_path / "b", best_mode="lowest")
    mgr = CheckpointManager(tmp_path / "c")
    for method in (mgr.save_sharded, mgr.restore_sharded):
        with pytest.raises(NotImplementedError, match=method.__name__):
            method(_port_state(1))


def test_a_save_cut_off_leaves_no_step(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, best_metric=None)
    mgr.save(_port_state(1))

    def cut(path, tree):
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 half a file")
        raise KeyboardInterrupt

    monkeypatch.setattr(manager, "save_npz", cut)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(_port_state(2))
    assert mgr.all_steps() == [1]
    assert os.path.isdir(tmp_path / "2.tmp") and not os.path.exists(tmp_path / "2")
    (tmp_path / "3").mkdir()  # what a deletion cut off before its rename leaves
    monkeypatch.undo()
    again = CheckpointManager(tmp_path, best_metric=None)
    assert again.all_steps() == [1] and again.latest_step() == 1
    assert not os.path.exists(tmp_path / "2.tmp")
    assert again.save(_port_state(3)) and again.all_steps() == [1, 3]
    assert not again.save(_port_state(3)) and not again.save(_port_state(2))


# -- fit(checkpoint_manager=...) ------------------------------------------------------


def _corpus():
    rng = np.random.default_rng(11)
    words = ["dog", "runs", "ball", "grass", "man", "child", "red", "blue", "water", "sits"]
    caps = {
        f"img{i}": ["startseq a " + " ".join(rng.choice(words, 4)) + " endseq" for _ in range(3)]
        for i in range(10)
    }
    feats = {k: rng.normal(size=64).astype(np.float32) for k in caps}
    return caps, feats


@pytest.mark.parametrize("val_metric,patience,with_val", [
    ("loss", 0, True), ("bleu4", 1, True), ("loss", 0, False),
])
def test_fit_saves_tpucaps_steps_and_metrics(tmp_path, val_metric, patience, with_val):
    caps, feats = _corpus()
    train, held_out = dict(list(caps.items())[:7]), dict(list(caps.items())[7:])
    tr = dict(batch_size=8, learning_rate=3e-2, seed=3, val_metric=val_metric,
              early_stopping_patience=patience)
    dec = dict(embed_dim=16, hidden_dim=32, dropout_rate=0.0)
    jpipe = JaxPipeline(jcfg.Config(
        encoder=jcfg.encoder_config("vit_tiny"), decoder=jcfg.DecoderConfig(**dec),
        decode=jcfg.DecodeConfig(max_len=8), train=jcfg.TrainConfig(**tr), precision="f32"))
    jpipe.fit_tokenizer(caps)
    build_on_ports_init(jpipe, 4)
    pipe = CaptioningPipeline(
        tcfg.Config(encoder=tcfg.encoder_config("vit_tiny"), decoder=tcfg.DecoderConfig(**dec),
                    decode=tcfg.DecodeConfig(max_len=8), train=tcfg.TrainConfig(**tr),
                    precision="f32"),
        tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()), device="cpu")
    pipe.build(init_params=False)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    key = "val_loss" if val_metric == "loss" else f"val_{val_metric}"
    kw = dict(max_to_keep=2, best_metric=key, best_mode="min" if val_metric == "loss" else "max")
    theirs = JaxManager(str(tmp_path / "jax"), **kw)
    ours = CheckpointManager(tmp_path / "port", **kw)
    val = dict(val_data=(held_out, feats)) if with_val else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jpipe.fit(train, feats, epochs=4, checkpoint_manager=theirs, log=None, **val)
    got = pipe.fit(train, feats, epochs=4, checkpoint_manager=ours, log=None, **val)
    assert len(got) == len(want)
    assert _observed(ours) == _observed(theirs)
    for s in ours.all_steps():
        g, w = ours.metrics(s), theirs._mgr.metrics(s)
        assert sorted(g) == sorted(w)
        np.testing.assert_allclose(g["val_loss"], w["val_loss"], rtol=1e-6)
        if key != "val_loss":
            assert g[key] == w[key]
    theirs.close()
