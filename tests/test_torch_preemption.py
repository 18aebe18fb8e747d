"""tpucap_torch's preemption guard, rescue checkpoints and exact resume
(``train/preemption.py``, ``CheckpointManager.save_rescue``, ``fit`` and
``fit_finetune``'s ``resume``, ``handle_preemption``, ``preemption_guard``
and ``TrainConfig.checkpoint_every_steps``), on the CPU.

The contract, tpucap's (``tests/test_preemption.py``): a run cut at an
epoch boundary or mid-epoch and resumed lands on params bit-identical to
an uninterrupted run (tolerance 0). The port's runs here keep dropout on
(0.5), and ``fit_finetune`` also augments (flip and a 2-pixel shift) and
accumulates over 2 microbatches, so every draw of a step must come from
the generator the checkpoint carries. Against tpucap (dropout off, same
weights bridged, ``grad_accum_steps`` 2): the step numbers the manager
holds after a run with ``checkpoint_every_steps`` cut by a guard and after
its resume are tpucap's; the cut and the resumed runs' per-epoch losses
are tpucap's within 1e-5 relative (``fit``'s bound); the validation errors
carry tpucap's messages.
Also: the guard latches SIGTERM and restores the handler, a rescue
survives best-metric retention and at most one is kept, and a resume on an
empty directory starts fresh.
"""

import dataclasses
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.checkpoint import CheckpointManager as JaxManager
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.train import PreemptionGuard as JaxGuard
from tpucap_torch import config as tcfg
from tpucap_torch.checkpoint import CheckpointManager
from tpucap_torch.convert import params_from_jax
from tpucap_torch.core import tree_leaves
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer
from tpucap_torch.train import PreemptionGuard, TrainState

from ports_init import build_on_ports_init

torch.set_num_threads(2)

WORDS = "a b c d e f g h".split()
DESC = {f"im{i}": [f"startseq {WORDS[i]} {WORDS[(i + 3) % 8]} endseq"] * 2 for i in range(8)}


def _configs(pkg, encoder, rate, **train):
    c = jcfg if pkg == "jax" else tcfg
    return c.Config(
        encoder=encoder(c),
        decoder=c.DecoderConfig(embed_dim=16, hidden_dim=16, dropout_rate=rate),
        train=c.TrainConfig(epochs=1, batch_size=4, seed=0, learning_rate=1e-2, **train),
        decode=c.DecodeConfig(max_len=8),
        precision="f32",
    )


_FEATS_ENC = lambda c: c.EncoderConfig(name="tiny_cnn", feature_dim=32)  # noqa: E731
_IMAGE_ENC = lambda c: c.encoder_config("tiny_cnn")  # noqa: E731


def _pipe(rate=0.5, encoder=_FEATS_ENC, **train):
    """The port's pipeline, seeded init; (pipe, per-image inputs)."""
    pipe = CaptioningPipeline(_configs("torch", encoder, rate, **train), device="cpu")
    pipe.fit_tokenizer(DESC)
    pipe.build()
    rng = np.random.default_rng(1)
    shape = (32,) if encoder is _FEATS_ENC else (32, 32, 3)
    return pipe, {k: rng.normal(size=shape).astype(np.float32) for k in DESC}


def _assert_same(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert torch.equal(x, y)


class _FakeGuard:
    """Fires on its ``after``-th query of ``fired``: a preemption after a
    given step, without signals."""

    def __init__(self, after: int):
        self.after, self.calls = after, 0

    @property
    def fired(self) -> bool:
        self.calls += 1
        return self.calls >= self.after


def test_guard_latches_sigterm_and_restores_the_handler():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as g:
        assert not g.fired
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if g.fired:
                break
            time.sleep(0.01)
        assert g.fired
    assert signal.getsignal(signal.SIGTERM) is before
    with PreemptionGuard() as g2:
        assert not g2.fired
        g2.request()
        assert g2.fired
    # Off the main thread the guard installs nothing and only request() fires it.
    seen = []
    t = threading.Thread(target=lambda: seen.append(PreemptionGuard().__enter__()._previous))
    t.start()
    t.join()
    assert seen == [{}] and signal.getsignal(signal.SIGTERM) is before
    assert [n for n in dir(JaxGuard) if not n.startswith("__")] == [
        n for n in dir(PreemptionGuard) if not n.startswith("__")
    ]


@pytest.mark.parametrize("cut", ["epoch", "mid-epoch"])
def test_fit_resume_is_bit_identical(tmp_path, cut):
    pipe_a, feats = _pipe()
    hist_a = pipe_a.fit(DESC, feats, epochs=3, log=None)
    pipe_b, _ = _pipe()
    mgr = CheckpointManager(tmp_path, best_metric=None)
    if cut == "epoch":
        pipe_b.fit(DESC, feats, epochs=2, checkpoint_manager=mgr, log=None)
    else:  # 16 rows / batch 4: the 6th step is the 2nd of epoch 1
        hist_b = pipe_b.fit(DESC, feats, epochs=3, checkpoint_manager=mgr, preemption_guard=_FakeGuard(6), log=None)
        assert hist_b[-1]["preempted"] is True and hist_b[-1]["epoch"] == 1
        assert mgr.latest_step() == 6 and mgr.metrics(6) is None
    lines = []
    pipe_c, _ = _pipe()
    hist_c = pipe_c.fit(DESC, feats, epochs=3, checkpoint_manager=mgr, resume=True, log=lines.append)
    _assert_same(pipe_a.params["decoder"], pipe_c.params["decoder"])
    assert lines[0] == ("resumed from step 8 (epoch 2, batch 0)" if cut == "epoch" else "resumed from step 6 (epoch 1, batch 2)")
    assert hist_c[-1]["loss"] == hist_a[-1]["loss"] and hist_c[-1]["epoch"] == 2


@pytest.mark.parametrize("cut", ["epoch", "mid-epoch"])
def test_fit_finetune_resume_is_bit_identical(tmp_path, cut):
    kw = dict(epochs=2, augment=True, augment_shift=2, log=None)
    pipe_a, images = _pipe(encoder=_IMAGE_ENC, grad_accum_steps=2)
    pipe_a.fit_finetune(DESC, images, **kw)
    pipe_b, _ = _pipe(encoder=_IMAGE_ENC, grad_accum_steps=2)
    mgr = CheckpointManager(tmp_path, best_metric="val_loss")
    if cut == "epoch":
        pipe_b.fit_finetune(DESC, images, checkpoint_manager=mgr, **{**kw, "epochs": 1})
        assert mgr.all_steps() == [4] and mgr.metrics(4) is not None
    else:
        hist = pipe_b.fit_finetune(DESC, images, checkpoint_manager=mgr, preemption_guard=_FakeGuard(3), **kw)
        assert hist[-1]["preempted"] is True and mgr.all_steps() == [3]
    pipe_c, _ = _pipe(encoder=_IMAGE_ENC, grad_accum_steps=2)
    pipe_c.fit_finetune(DESC, images, checkpoint_manager=mgr, resume=True, **kw)
    _assert_same(pipe_a.params, pipe_c.params)


def _port_state(step):
    return TrainState(step=step, params={"w": torch.ones(2)}, opt_state={"m": torch.zeros(2)}, rng=None)


def test_rescue_survives_best_metric_retention_and_one_is_kept(tmp_path):
    mgr = CheckpointManager(tmp_path, best_metric="val_loss", max_to_keep=2)
    mgr.save(_port_state(2), metrics={"val_loss": 0.5})
    mgr.save(_port_state(4), metrics={"val_loss": 0.4})
    mgr.save_rescue(_port_state(5))
    assert mgr.all_steps() == [2, 4, 5] and mgr.best_step() == 4
    mgr.save_rescue(_port_state(7))  # the older rescue goes, the epoch steps stay
    assert mgr.all_steps() == [2, 4, 7]
    mgr.save(_port_state(8), metrics={"val_loss": 0.3})  # best-2 drops step 2, not the rescue
    assert mgr.all_steps() == [4, 7, 8] and mgr.best_step() == 8
    mgr.save_rescue(_port_state(8))  # the latest step already: nothing happens
    assert mgr.all_steps() == [4, 7, 8]
    assert CheckpointManager(tmp_path, best_metric="val_loss", max_to_keep=2).all_steps() == [4, 7, 8]
    # Without a best metric the newest max_to_keep steps stay, rescues among them.
    plain = CheckpointManager(tmp_path / "plain", best_metric=None, max_to_keep=2)
    for s in (1, 2, 3):
        plain.save_rescue(_port_state(s))
    assert plain.all_steps() == [2, 3]


def _cut_and_resumed(pkg, root, after):
    """tpucap's or the port's fit for 2 epochs, dropout off, accumulating
    over 2 microbatches, every 3 steps a checkpoint, cut by a guard after
    step ``after`` and resumed: -> (steps after the
    cut, steps after the resume, the cut run's history, the resumed one's)."""
    cfg = _configs(pkg, _FEATS_ENC, 0.0, checkpoint_every_steps=3, grad_accum_steps=2)
    rng = np.random.default_rng(1)
    feats = {k: rng.normal(size=(32,)).astype(np.float32) for k in DESC}
    if pkg == "jax":
        pipe = JaxPipeline(cfg)
        pipe.fit_tokenizer(DESC)
        build_on_ports_init(pipe, 4)
        init = jax.tree.map(np.asarray, pipe.params)
        mgr = JaxManager(str(root / pkg), best_metric="val_loss", max_to_keep=20)
    else:
        jpipe = JaxPipeline(_configs("jax", _FEATS_ENC, 0.0))
        jpipe.fit_tokenizer(DESC)
        build_on_ports_init(jpipe, 4)
        pipe = CaptioningPipeline(cfg, tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()), device="cpu")
        pipe.build(init_params=False)
        init = params_from_jax(jax.tree.map(np.asarray, jpipe.params))
        pipe.set_params(init)
        mgr = CheckpointManager(root / pkg, best_metric="val_loss", max_to_keep=20)
    cut = pipe.fit(DESC, feats, epochs=2, checkpoint_manager=mgr, preemption_guard=_FakeGuard(after), log=None)
    steps_cut = [int(s) for s in mgr.all_steps()]
    # A new process starts from the config seed's weights.
    if pkg == "jax":
        pipe.params = jax.tree.map(jnp.asarray, init)
    else:
        pipe.set_params(init)
    resumed = pipe.fit(DESC, feats, epochs=2, checkpoint_manager=mgr, resume=True, log=None)
    steps = [int(s) for s in mgr.all_steps()]
    mgr.close()
    return steps_cut, steps, cut, resumed


def test_interval_saves_cut_and_resume_match_tpucap(tmp_path):
    want = _cut_and_resumed("jax", tmp_path, 5)
    got = _cut_and_resumed("torch", tmp_path, 5)
    # 4 steps an epoch: the interval save at 3, the epoch save at 4, the
    # rescue at 5 sweeping 3; after the resume the interval save at 6
    # sweeping 5, the epoch save at 8.
    assert got[:2] == want[:2] == ([4, 5], [4, 6, 8])
    for g_hist, w_hist in zip(got[2:], want[2:]):
        assert [sorted(e) for e in g_hist] == [sorted(e) for e in w_hist]
        for g, w in zip(g_hist, w_hist):
            assert g["epoch"] == w["epoch"] and g.get("preempted") == w.get("preempted")
            for k in ("loss", "accuracy", "perplexity", "tokens"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


def test_validations_with_tpucaps_messages(tmp_path):
    pipe, feats = _pipe()
    with pytest.raises(ValueError, match="^resume=True needs a checkpoint_manager$"):
        pipe.fit(DESC, feats, epochs=1, resume=True, log=None)
    fpipe, images = _pipe(encoder=_IMAGE_ENC)
    with pytest.raises(ValueError, match="^resume=True needs a checkpoint_manager$"):
        fpipe.fit_finetune(DESC, images, epochs=1, resume=True, log=None)
    jpipe = JaxPipeline(_configs("jax", _FEATS_ENC, 0.0))
    jpipe.fit_tokenizer(DESC)
    with pytest.raises(ValueError, match="^resume=True needs a checkpoint_manager$"):
        jpipe.fit(DESC, feats, epochs=1, resume=True, log=None)
    # EMA, whose shadow a resume would not restore, is refused with
    # tpucap's message, as LoRA's checkpoint dials are; sharded checkpoints
    # are refused by name.
    mgr = CheckpointManager(tmp_path / "e", best_metric=None)
    ema = CaptioningPipeline(
        dataclasses.replace(pipe.config, train=dataclasses.replace(pipe.config.train, ema_decay=0.999)),
        tokenizer=pipe.tokenizer, device="cpu",
    )
    with pytest.raises(
        NotImplementedError, match="^resume does not restore the EMA shadow; drop ema_decay or restart$"
    ):
        ema.fit(DESC, feats, epochs=1, checkpoint_manager=mgr, resume=True, log=None)
    for kw, match in ((dict(lora_rank=4), "^LoRA fine-tuning checkpoints its few-MB adapter artifact"),
                      (dict(sharded_checkpoints=True), "sharded_checkpoints")):
        with pytest.raises(NotImplementedError, match=match):
            fpipe.fit_finetune(DESC, images, epochs=1, checkpoint_manager=mgr, resume=True, log=None, **kw)
    # An empty directory starts fresh; a preemption without a manager saves nothing.
    lines = []
    hist = pipe.fit(DESC, feats, epochs=2, checkpoint_manager=mgr, resume=True, log=lines.append)
    assert [h["epoch"] for h in hist] == [0, 1] and not lines[0].startswith("resumed")
    hist = pipe.fit(DESC, feats, epochs=2, preemption_guard=_FakeGuard(1), log=lines.append)
    assert hist == [{**hist[0], "epoch": 0, "preempted": True}]
    assert lines[-1] == "preempted at epoch 0 step 1; NO checkpoint_manager — mid-run state was NOT saved"
