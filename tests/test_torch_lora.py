"""tpucap_torch's LoRA (``train/lora.py``, ``fit_lora``,
``fit_finetune(lora_rank=)``, ``save_lora`` / ``apply_lora_file`` and the
CLI's ``--lora-rank``, ``--lora-alpha``, ``--lora-out``) against tpucap's,
on the CPU.

``keystr`` and ``lora_targets`` equal tpucap's exactly on every family the
port has (the decoders from tpucap's built params, the encoders from
``jax.eval_shape``); ``apply_lora`` and ``merge_lora`` on tpucap's adapters
(b made non-zero) within 1e-6 of each tensor's scale (an 8-term f32 dot
in another order); ``init_lora`` gives b = 0, a of (d_in, r) and an
identity overlay (``torch.equal``); the ``.npz`` artifact crosses both
ways bit for bit.

``make_lora_train_step`` from tpucap's initial adapters, dropout off,
decoder-only and joint (vit_tiny), three steps: under plain SGD, whose
update is linear in the gradient, the loss within 1e-5 relative and the
adapters within 1e-5 of each tensor's scale after every step (measured at
most 1.1e-6); under Adam, whose first steps are sign-like (an entry whose
gradient is near zero may move by +-lr for a last-bit difference), the
optimizer state has the adapters' shapes and the base does not move.

``fit_lora`` and ``fit_finetune(lora_rank=)`` end to end, tpucap's
initial adapters handed to the port (jax's draws cannot be made in torch):
the logged lines equal but for a 4-decimal number, which may differ by
one unit in its last place, and the per-epoch metrics within 1e-5
relative; the adapters and the merged params within 1e-3 of each tensor's
scale (``fit``'s bound, ``tests/test_torch_train.py``). Every refusal
carries tpucap's message. The CLI's namespaces for these flags are
tpucap's; ``train --lora-rank`` on features and under
``--finetune-encoder`` prints tpucap's lines and writes its bundle and
artifact within the same bounds.

Small sizes: lstm1 with embed 16 and hidden 32, vocabulary about 20,
max_len 8, batch 4 or 6.
"""

import contextlib
import dataclasses
import importlib
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cli_finetune import (
    _TPUCAP_PARAMS,
    _build_with_tpucaps_weights,
    _no_dropout,
    _recording_build,
    _same_rounded_lines,
)
from tpucap import config as jcfg
from tpucap.data import generate_fixture_dataset
from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap.models.encoders.registry import build_encoder as jax_build_encoder
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.train import build_optimizer as jax_build_optimizer
from tpucap.train import lora as jlora
from tpucap.train.loop import TrainState as JaxState
from tpucap_torch import config as tcfg
from tpucap_torch.checkpoint import CheckpointManager
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.core import tree_leaves
from tpucap_torch.models.decoders import build_decoder
from tpucap_torch.models.encoders import build_encoder
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.train import TrainState, build_optimizer
from tpucap_torch.train import lora

from ports_init import build_on_ports_init, jit_init

torch.set_num_threads(2)

tcli = importlib.import_module("tpucap_torch.cli.main")
jcli = importlib.import_module("tpucap.cli.main")
tpipe = importlib.import_module("tpucap_torch.pipeline")
V, FD = 40, 24
DIMS = dict(vocab_size=V, feature_dim=FD, embed_dim=16, hidden_dim=32, attention_dim=16)
WORDS = "a b c d e f g h i j k l".split()
DESC = {
    f"im{i}": [f"startseq {WORDS[i % 12]} {WORDS[(i + 3) % 12]} {WORDS[(i * 5) % 12]} endseq",
               f"startseq {WORDS[(i + 1) % 12]} {WORDS[(i + 7) % 12]} endseq"]
    for i in range(10)
}


def _to_torch(adapters):
    return {k: {n: torch.from_numpy(np.array(v, np.float32)) for n, v in ab.items()} for k, ab in adapters.items()}


def _close_to_scale(got, want, share, what=""):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0, atol=share * np.abs(w).max(), err_msg=what)


def _adapters_close(got, want, share):
    assert sorted(got) == sorted(want)
    for k in want:
        for n in ("a", "b"):
            w = np.asarray(want[k][n])
            np.testing.assert_allclose(got[k][n].detach().cpu().numpy(), w, rtol=0,
                                       atol=share * max(np.abs(w).max(), 1e-30), err_msg=f"{k} {n}")


def _tpucaps_init(params, rank, *, generator, target_keys=lora.DEFAULT_TARGET_KEYS):
    """tpucap's init_lora (its jax key seeded as the port seeds its
    generator) in place of the port's draw."""
    ad = jlora.init_lora(params_to_numpy(params), rank, rng=jax.random.key(generator.initial_seed()),
                         target_keys=target_keys)
    return _to_torch(ad)


# -- keys, targets, the overlay and the artifact ----------------------------------------------

_FAMILIES = [
    ("lstm1", "decoder"), ("lstm2", "decoder"), ("inject", "decoder"), ("attention", "decoder"),
    ("vit_b16", "encoder"), ("vit_tiny", "encoder"), ("vgg16", "encoder"), ("resnet50", "encoder"),
    ("inception_v3", "encoder"), ("tiny_cnn", "encoder"),
]


@pytest.mark.parametrize("name,kind", _FAMILIES, ids=[f[0] for f in _FAMILIES])
def test_keystr_and_lora_targets_equal_tpucaps(name, kind):
    if kind == "decoder":
        want_tree = jax_build_decoder(name, **DIMS).init(jax.random.key(0))
        ours = build_decoder(name, **DIMS).init(torch.Generator().manual_seed(0))
    else:
        want_tree = jax.eval_shape(lambda: jax_build_encoder(name).init(jax.random.key(0)))
        ours = build_encoder(name).init(torch.Generator().manual_seed(0))
    tree = {kind: ours}
    want_tree = {kind: want_tree}
    try:
        want = jlora.lora_targets(want_tree)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            lora.lora_targets(tree)
        assert str(got.value) == str(e)
        assert name in ("resnet50", "inception_v3", "tiny_cnn")
        return
    assert lora.lora_targets(tree) == want
    assert lora.lora_targets(tree, target_keys=("kernel", "recurrent", "table")) == jlora.lora_targets(
        want_tree, target_keys=("kernel", "recurrent", "table"))
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(want_tree)[0]]
    assert all(k in paths for k in want)
    if name == "lstm1":
        assert "['decoder']['cells'][0]['kernel']" in want
    if name == "vit_b16":
        assert len(want) == 12 * 4 and not any("patch_embed" in k for k in want)


def _decoder_case(seed=3):
    jdec = jax_build_decoder("lstm1", **DIMS, dropout_rate=0.0)
    jp = jax.tree.map(np.asarray, jit_init(jdec, jax.random.key(seed)))
    return jdec, jp


def test_apply_merge_and_init_lora_match_tpucap():
    _, jp = _decoder_case()
    jad = jlora.init_lora(jp, 4, rng=jax.random.key(7))
    # b made non-zero, so the overlay moves every adapted leaf.
    rng = np.random.default_rng(5)
    jad = {k: {"a": ab["a"], "b": jnp.asarray(rng.normal(size=ab["b"].shape).astype(np.float32))}
           for k, ab in jad.items()}
    base = params_from_jax(jp)
    ad = _to_torch(jad)
    for fn, jfn in ((lora.apply_lora, jlora.apply_lora), (lora.merge_lora, jlora.merge_lora)):
        got = fn(base, ad, scale=2.0)
        want = jfn(jax.tree.map(jnp.asarray, jp), jad, scale=2.0)
        _close_to_scale(params_to_numpy(got), want, 1e-6, fn.__name__)
        assert torch.equal(got["embedding"]["table"], base["embedding"]["table"])
    # init: b = 0, a of (d_in, r), the overlay an identity by value.
    init = lora.init_lora(base, 4, generator=torch.Generator().manual_seed(7))
    assert sorted(init) == sorted(jad)
    for k, (d_in, d_out) in lora.lora_targets(base).items():
        assert init[k]["a"].shape == (d_in, 4) and init[k]["a"].dtype == torch.float32
        assert init[k]["b"].shape == (4, d_out) and not init[k]["b"].any()
    same = lora.apply_lora(base, init, scale=1.0)
    for a, b in zip(tree_leaves(same), tree_leaves(base), strict=True):
        assert torch.equal(a, b)
    n_ad, n_base = lora.lora_param_counts(base, init)
    assert (n_ad, n_base) == jlora.lora_param_counts(jp, jad)
    with pytest.raises(ValueError) as theirs:
        jlora.init_lora(jp, 0, rng=jax.random.key(0))
    with pytest.raises(ValueError) as got:
        lora.init_lora(base, 0, generator=torch.Generator())
    assert str(got.value) == str(theirs.value) == "rank must be >= 1, got 0"


def test_lora_artifact_crosses_both_ways(tmp_path):
    _, jp = _decoder_case()
    jad = jlora.init_lora(jp, 2, rng=jax.random.key(1))
    jlora.save_lora(str(tmp_path / "theirs.npz"), jad, rank=2, alpha=5.0)
    ad, rank, alpha = lora.load_lora(tmp_path / "theirs.npz")
    assert (rank, alpha) == (2, 5.0) and sorted(ad) == sorted(jad)
    for k in jad:
        for n in ("a", "b"):
            np.testing.assert_array_equal(ad[k][n].numpy(), np.asarray(jad[k][n]))
    ours = lora.init_lora(params_from_jax(jp), 3, generator=torch.Generator().manual_seed(2))
    ours = {k: {"a": ab["a"], "b": ab["b"] + 0.5} for k, ab in ours.items()}
    lora.save_lora(tmp_path / "ours.npz", ours, rank=3, alpha=1.5)
    back, rank, alpha = jlora.load_lora(str(tmp_path / "ours.npz"))
    assert (rank, alpha) == (3, 1.5) and sorted(back) == sorted(ours)
    for k in ours:
        for n in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(back[k][n]), ours[k][n].numpy())
    with np.load(tmp_path / "ours.npz") as z:
        assert z["__lora_rank__"].dtype == np.int32 and z["__lora_alpha__"].dtype == np.float32


# -- the step ------------------------------------------------------------------------------------


def _tokens(seed, B, T=8):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, V, size=(B, T + 1)).astype(np.int32)
    toks[:, 0] = 1
    for i, n in enumerate(rng.integers(3, T + 1, size=B)):
        toks[i, n:] = 0
    return toks


@pytest.mark.parametrize("mode", ["decoder", "joint"])
def test_lora_train_step_matches_tpucap_over_three_steps(mode):
    dims = {**DIMS, "feature_dim": build_encoder("vit_tiny").feature_dim if mode == "joint" else FD}
    jdec = jax_build_decoder("lstm1", **dims, dropout_rate=0.0)
    tdec = build_decoder("lstm1", **dims, dropout_rate=0.0)
    jbase = {"decoder": jax.tree.map(np.asarray, jit_init(jdec, jax.random.key(11)))}
    jenc = tenc = None
    B = 6
    rng = np.random.default_rng(12)
    if mode == "joint":
        jenc, tenc = jax_build_encoder("vit_tiny"), build_encoder("vit_tiny")
        jbase["encoder"] = jax.tree.map(np.asarray, jenc.init(jax.random.key(13)))
        x = rng.uniform(-1, 1, size=(3, B, tenc.input_size, tenc.input_size, 3)).astype(np.float32)
    else:
        jbase = jbase["decoder"]
        x = rng.normal(size=(3, B, FD)).astype(np.float32)
    toks = [_tokens(14 + i, B) for i in range(3)]
    jad = jlora.init_lora(jbase, 4, rng=jax.random.key(15))
    tbase = params_from_jax(jbase)
    kw = dict(scale=0.5, deterministic=True)
    for name in ("sgd", "adam"):
        cfg = dict(optimizer=name, learning_rate=0.5 if name == "sgd" else 1e-2)
        jopt, topt = jax_build_optimizer(jcfg.TrainConfig(**cfg)), build_optimizer(tcfg.TrainConfig(**cfg))
        jstep = jlora.make_lora_train_step(jdec, jax.tree.map(jnp.asarray, jbase), jopt, encoder=jenc, **kw)
        tstep = lora.make_lora_train_step(tdec, tbase, topt, encoder=tenc, donate=True, **kw)
        jstate = JaxState.create(jad, jopt, jax.random.key(0))
        tstate = TrainState.create(_to_torch(jad), topt, torch.Generator())
        for i in range(3 if name == "sgd" else 1):
            jstate, jm = jstep(jstate, jnp.asarray(x[i]), jnp.asarray(toks[i]))
            tstate, tm = tstep(tstate, torch.from_numpy(x[i]), torch.from_numpy(toks[i]).long())
            np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
            if name == "sgd":
                _adapters_close(tstate.params, jax.tree.map(np.asarray, jstate.params), 1e-5)
        if name == "adam":
            mu = tstate.opt_state[0]["mu"] if isinstance(tstate.opt_state, (list, tuple)) else tstate.opt_state["mu"]
            assert {k: {n: t.shape for n, t in ab.items()} for k, ab in mu.items()} == {
                k: {n: t.shape for n, t in ab.items()} for k, ab in tstate.params.items()}
    # The base never moved.
    for a, b in zip(tree_leaves(tbase), tree_leaves(params_from_jax(jbase)), strict=True):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="^mesh="):
        lora.make_lora_train_step(tdec, tbase, topt, scale=1.0, mesh=object())


# -- fit_lora and fit_finetune(lora_rank=) ---------------------------------------------------------


def _pipelines(encoder="tiny_cnn", feature_dim=None, **train):
    """tpucap's pipeline built, and the port's with tpucap's weights."""
    made = []
    for c in (jcfg, tcfg):
        enc = c.encoder_config(encoder)
        if feature_dim:
            enc = c.EncoderConfig(name=encoder, feature_dim=feature_dim)
        made.append(c.Config(
            encoder=enc, decoder=c.DecoderConfig(embed_dim=16, hidden_dim=32, dropout_rate=0.0),
            decode=c.DecodeConfig(max_len=8),
            train=c.TrainConfig(batch_size=4, learning_rate=1e-2, seed=3, **train), precision="f32",
        ))
    jpipe = JaxPipeline(made[0])
    jpipe.fit_tokenizer(DESC)
    build_on_ports_init(jpipe)
    pipe = CaptioningPipeline(made[1], device="cpu")
    pipe.fit_tokenizer(DESC)
    pipe.build(init_params=False)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    return jpipe, pipe


def _compare_fits(got, want, got_lines, want_lines):
    _same_rounded_lines(got_lines, want_lines)
    assert [sorted(e) for e in got] == [sorted(e) for e in want]
    for g, w in zip(got, want):
        for k in ("loss", "accuracy", "perplexity", "tokens"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


def test_fit_lora_matches_tpucap_and_round_trips(tmp_path, monkeypatch):
    monkeypatch.setattr(tpipe, "init_lora", _tpucaps_init)
    jpipe, pipe = _pipelines(feature_dim=FD)
    rng = np.random.default_rng(20)
    feats = {k: rng.normal(size=FD).astype(np.float32) for k in DESC}
    base = params_to_numpy(pipe.params["decoder"])
    want_lines, got_lines = [], []
    want = jpipe.fit_lora(DESC, feats, rank=4, alpha=8.0, epochs=3, log=want_lines.append)
    got = pipe.fit_lora(DESC, feats, rank=4, alpha=8.0, epochs=3, log=got_lines.append)
    _compare_fits(got, want, got_lines, want_lines)
    assert got_lines[0] == want_lines[0] and got_lines[0].startswith("LoRA rank 4: ")
    assert got_lines[1].startswith("lora epoch 0: loss=")
    assert pipe.lora_meta == jpipe.lora_meta == {"rank": 4, "alpha": 8.0}
    _adapters_close(pipe.lora_adapters, jax.tree.map(np.asarray, jpipe.lora_adapters), 1e-3)
    _close_to_scale(params_to_numpy(pipe.params["decoder"]), jpipe.params["decoder"], 1e-3, "merged")
    # The artifact into a fresh pipeline: the merged params bit for bit.
    pipe.save_lora(tmp_path / "a.npz")
    fresh = CaptioningPipeline(pipe.config, tokenizer=pipe.tokenizer, device="cpu")
    fresh.build(init_params=False)
    fresh.set_params({"encoder": pipe.params["encoder"], "decoder": params_from_jax(base)})
    fresh.apply_lora_file(tmp_path / "a.npz")
    for a, b in zip(tree_leaves(fresh.params["decoder"]), tree_leaves(pipe.params["decoder"]), strict=True):
        assert torch.equal(a, b)
    # merge=False leaves the params alone; unmerged, apply_lora's view decodes as the merge.
    view = CaptioningPipeline(pipe.config, tokenizer=pipe.tokenizer, device="cpu")
    view.build(init_params=False)
    view.set_params({"encoder": pipe.params["encoder"], "decoder": params_from_jax(base)})
    view.fit_lora(DESC, feats, rank=4, alpha=8.0, epochs=1, merge=False, log=None)
    for a, b in zip(tree_leaves(view.params["decoder"]), tree_leaves(params_from_jax(base)), strict=True):
        assert torch.equal(a, b)
    x = np.stack([feats[k] for k in DESC])
    merged = view.lora_adapters
    view.params["decoder"] = lora.apply_lora(view.params["decoder"], merged, scale=2.0)
    on_view = view.generate(x, method="greedy")
    view.params["decoder"] = params_from_jax(base)
    view.lora_meta = {"rank": 4, "alpha": 8.0}
    view.save_lora(tmp_path / "b.npz")
    view.apply_lora_file(tmp_path / "b.npz")
    assert view.generate(x, method="greedy") == on_view


def test_fit_finetune_lora_matches_tpucap(monkeypatch):
    monkeypatch.setattr(tpipe, "init_lora", _tpucaps_init)
    jpipe, pipe = _pipelines("vit_tiny")
    size = pipe.encoder.input_size
    rng = np.random.default_rng(21)
    images = {k: rng.uniform(-1, 1, size=(size, size, 3)).astype(np.float32) for k in DESC}
    want_lines, got_lines = [], []
    want = jpipe.fit_finetune(DESC, images, epochs=2, lora_rank=4, log=want_lines.append)
    got = pipe.fit_finetune(DESC, images, epochs=2, lora_rank=4, log=got_lines.append)
    _compare_fits(got, want, got_lines, want_lines)
    assert got_lines[0].startswith("LoRA rank 4 (joint): ")
    assert any(k.startswith("['encoder']") for k in pipe.lora_adapters)
    _adapters_close(pipe.lora_adapters, jax.tree.map(np.asarray, jpipe.lora_adapters), 1e-3)
    _close_to_scale(params_to_numpy(pipe.params), jpipe.params, 1e-3, "merged")
    # freeze_encoder: the adapters over the decoder only, the encoder put.
    enc = [t.clone() for t in tree_leaves(pipe.params["encoder"])]
    pipe.fit_finetune(DESC, images, epochs=1, lora_rank=2, lora_alpha=1.0, freeze_encoder=True, log=None)
    assert pipe.lora_adapters and all(k.startswith("['decoder']") for k in pipe.lora_adapters)
    assert all(torch.equal(a, b) for a, b in zip(enc, tree_leaves(pipe.params["encoder"])))


def test_lora_refusals_carry_tpucaps_messages(tmp_path):
    jpipe, pipe = _pipelines("vit_tiny")
    size = pipe.encoder.input_size
    rng = np.random.default_rng(22)
    images = {k: rng.uniform(-1, 1, size=(size, size, 3)).astype(np.float32) for k in DESC}
    feats = {k: rng.normal(size=pipe.config.encoder.feature_dim).astype(np.float32) for k in DESC}
    with pytest.raises(ValueError) as theirs:
        jpipe.save_lora(str(tmp_path / "x.npz"))
    with pytest.raises(ValueError) as ours:
        pipe.save_lora(tmp_path / "x.npz")
    assert str(ours.value) == str(theirs.value) == "no trained LoRA adapters on this pipeline"
    cases = [
        ("fit_finetune", dict(lora_rank=4, checkpoint_manager=CheckpointManager(tmp_path / "m")), {}),
        ("fit_finetune", dict(lora_rank=4, handle_preemption=True), {}),
        ("fit_finetune", dict(lora_rank=4, parallelism="fsdp"), {}),
        ("fit_finetune", dict(lora_rank=4, remat_encoder=True), {}),
        ("fit_finetune", dict(lora_rank=4), dict(grad_accum_steps=2)),
        ("fit_finetune", dict(lora_rank=4), dict(ema_decay=0.9)),
        ("fit_lora", dict(rank=4), dict(grad_accum_steps=2)),
        ("fit_lora", dict(rank=4, parallelism="tp"), {}),
    ]
    for method, kw, train in cases:
        for p in (jpipe, pipe):
            p.config = dataclasses.replace(p.config, train=dataclasses.replace(p.config.train, **train))
        data = images if method == "fit_finetune" else feats
        jkw = {k: (None if k == "checkpoint_manager" else v) for k, v in kw.items()}
        if "checkpoint_manager" in kw:
            jkw["resume"] = False
            jkw["checkpoint_manager"] = object()
        with pytest.raises(NotImplementedError) as theirs:
            getattr(jpipe, method)(DESC, data, epochs=1, log=None, **jkw)
        with pytest.raises(NotImplementedError) as ours:
            getattr(pipe, method)(DESC, data, epochs=1, log=None, **kw)
        assert str(ours.value) == str(theirs.value), (method, kw, train)
        for p in (jpipe, pipe):
            p.config = dataclasses.replace(p.config, train=dataclasses.replace(
                p.config.train, grad_accum_steps=1, ema_decay=0.0))
    # Data parallelism is refused by name (tpucap's dp branch is not ported).
    with pytest.raises(NotImplementedError, match="^parallelism='dp' is not ported"):
        pipe.fit_lora(DESC, feats, epochs=1, parallelism="dp", log=None)
    with pytest.raises(NotImplementedError, match="^parallelism='dp' is not ported"):
        pipe.fit_finetune(DESC, images, epochs=1, lora_rank=4, parallelism="dp", log=None)


# -- the CLI -----------------------------------------------------------------------------------------


_LINES = [
    ["train", "--lora-rank", "8"],
    ["train", "--lora-rank", "4", "--lora-alpha", "16", "--lora-out", "a.npz", "--features", "f"],
    ["train", "--finetune-encoder", "--images", "d", "--lora-rank", "2", "--lora-out", "b.npz"],
    ["train", "--features", "f", "--stream-features", "--epochs", "2"],
]


@pytest.mark.parametrize("argv", _LINES, ids=lambda a: " ".join(a[1:4]))
def test_cli_namespaces_equal_tpucaps(argv, monkeypatch):
    seen = []
    monkeypatch.setattr(jcli, "cmd_train", seen.append)
    jcli.main(argv)
    got = tcli.build_parser()[0].parse_args(argv)
    assert {k: v for k, v in vars(got).items() if k != "fn"} == {k: v for k, v in vars(seen[0]).items() if k != "fn"}


_REFUSED = [
    ["--features", "f.npz", "--lora-out", "a.npz"],
    *[["--features", "f.npz", "--lora-rank", "4", *flags] for flags in (
        ["--ema-decay", "0.9"], ["--stream-features"], ["--val-split", "v.txt"], ["--parallelism", "fsdp"],
        ["--grad-accum-steps", "2"], ["--stream-features", "--grad-accum-steps", "3"], ["--resume"],
        ["--handle-preemption"],
    )],
    ["--finetune-encoder", "--images", "d", "--lora-rank", "4", "--remat-encoder"],
]


@pytest.mark.parametrize("flags", _REFUSED, ids=lambda f: " ".join(f[2:]))
def test_cli_lora_refusals_exit_with_tpucaps_message_before_any_io(flags, monkeypatch):
    """Every path named is missing and the card is reported absent: the
    check must come first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["train", "--tokens", "/nonexistent", *flags]
    with pytest.raises(SystemExit) as ours:
        tcli.main(argv)
    with pytest.raises(SystemExit) as theirs:
        jcli.main(argv)
    assert isinstance(ours.value.code, str) and ours.value.code == theirs.value.code


def _run(main, argv, out):
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main(argv)
    return [ln.replace(str(out), "<out>") for ln in stdout.getvalue().splitlines() if "absl" not in ln]


def test_cli_lora_on_features_and_finetune_matches_tpucap(tmp_path):
    data = generate_fixture_dataset(tmp_path / "data", n_images=6, image_size=32, seed=7)
    img_dir, tokens, train, _ = (tmp_path / "data" / "images", *data[1:])
    rng = np.random.default_rng(7)
    feats = str(tmp_path / "features.npz")
    np.savez(feats, **{p.stem: rng.normal(size=128).astype(np.float32) for p in img_dir.glob("*.jpg")})
    common = ["train", "--encoder", "tiny_cnn", "--max-len", "8", "--embed-dim", "16", "--hidden-dim", "16",
              "--tokens", tokens, "--split", train, "--epochs", "2", "--batch-size", "4", "--lr", "0.01"]
    commands = {
        "features": ["--features", feats, "--lora-rank", "4", "--lora-alpha", "8", "--lora-out", "{out}/a.npz",
                     "--checkpoint-dir", "{out}/f"],
        "finetune": ["--finetune-encoder", "--images", str(img_dir), "--lora-rank", "2", "--lora-out",
                     "{out}/b.npz", "--checkpoint-dir", "{out}/j"],
        "refused": ["--finetune-encoder", "--images", str(img_dir), "--lora-rank", "2",
                    "--checkpoint-every-steps", "2", "--checkpoint-dir", "{out}/r"],
    }
    mains = {"tpucap": jcli.main, "port": lambda argv: tcli.main(argv, device="cpu")}
    lines = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "_build_config", _no_dropout(jcli._build_config))
        mp.setattr(tcli, "_build_config", _no_dropout(tcli._build_config))
        mp.setattr(CaptioningPipeline, "build", _build_with_tpucaps_weights(CaptioningPipeline.build))
        mp.setattr(JaxPipeline, "build", _recording_build(JaxPipeline.build))
        mp.setattr(tpipe, "init_lora", _tpucaps_init)
        for pkg, main in mains.items():
            out = tmp_path / pkg
            out.mkdir()
            for name, flags in commands.items():
                argv = common + [f.format(out=out) for f in flags]
                if name == "refused":
                    with pytest.raises(SystemExit) as e:
                        main(argv)
                    lines[pkg, name] = e.value.code
                else:
                    lines[pkg, name] = _run(main, argv, out)
    _TPUCAP_PARAMS.clear()
    assert lines["port", "refused"] == lines["tpucap", "refused"]
    assert lines["port", "refused"].startswith("--lora-rank checkpoints its adapter artifact via --lora-out")
    for name in ("features", "finetune"):
        _same_rounded_lines(lines["port", name], lines["tpucap", name])
    assert lines["port", "features"][-2:] == ["LoRA adapters in <out>/a.npz"] + [
        lines["port", "features"][-1]] and lines["port", "features"][-1].startswith("lora-trained 2 epochs; ")
    assert lines["port", "features"][-1].endswith("bundle in <out>/f/bundle")
    assert lines["port", "finetune"][-2] == "LoRA adapters in <out>/b.npz"
    for artifact in ("a.npz", "b.npz"):
        got, rank, alpha = lora.load_lora(tmp_path / "port" / artifact)
        want, jrank, jalpha = jlora.load_lora(str(tmp_path / "tpucap" / artifact))
        assert (rank, alpha) == (jrank, jalpha)
        _adapters_close(got, jax.tree.map(np.asarray, want), 1e-3)
    ours = CaptioningPipeline.load(tmp_path / "port" / "f" / "bundle", device="cpu")
    jbundle = JaxPipeline.load(str(tmp_path / "tpucap" / "f" / "bundle"))
    _close_to_scale(params_to_numpy(ours.params["decoder"]), jbundle.params["decoder"], 1e-3, "bundle")
