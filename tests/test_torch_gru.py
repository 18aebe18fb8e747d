"""tpucap_torch's GRU merge decoders (gru1, gru2) against tpucap's, on the
CPU, params bridged through ``convert.params_from_jax``, dropout off unless
a test draws it, f32:

- ``gru_cell_step`` (Keras GRU-v2, reset_after=True) within 1e-6 of
  tpucap's; in bf16 the same bf16 values but where the f32 gate math of
  the two packages rounds across a bf16 boundary (one ulp, rarely);
- ``init_state``, ``step``, ``step_hidden`` and ``forward_train`` within
  1e-5 absolute of tpucap's on O(1) states and logits (sums in another
  order); the port's dropout draws the feature mask, then the embedding
  mask, from one generator (its bits are not jax's);
- greedy tokens, beam-3 tokens and lengths equal, scores within 1e-5;
- the slice: a uint8 batch through ``caption_batch`` (K1's plain version,
  tiny_cnn, gru1, beam 3) gives tpucap's ``caption_dataset`` body's
  captions;
- one ``make_train_step`` under plain SGD (lr 0.5: the update is -lr g, so
  the gradients are compared without Adam's sign function) gives tpucap's
  loss within 1e-6 relative and its updated params within 1e-5;
- a gru1 + lstm1 ensemble gives tpucap's ``generate_ensemble`` captions;
- gru2 and the adaptive decoder through diverse search, a forced prefix,
  must-include words and MBR as tpucap's (an adaptive member of an
  ensemble too), the sampler at top_k = 1 as greedy, the batch server as
  ``generate``; gru1 and the adaptive decoder through ``fit``'s dev split
  with the bleu4 monitor and the EMA, scheduled sampling with
  steps_per_dispatch 2, and ``fit_lora`` (the port alone: jax's draws
  cannot be made in torch);
- the GRU's bias (2, 3U) and the adaptive decoder's tree cross
  ``params_from_jax`` / ``params_to_numpy`` both ways bit for bit;
- the port's CLI alone: ``extract``, ``train --decoder gru2``, ``caption``
  and ``export`` on a fixture dataset, the captions the restored
  pipeline's ``generate``, the ``.h5`` imported back bit for bit.
"""

import contextlib
import dataclasses
import importlib
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.decode import beam_decode as jax_beam_decode
from tpucap.decode import greedy_decode as jax_greedy_decode
from tpucap.decode import ids_to_captions
from tpucap.models import layers as jlayers
from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap.ops.preprocess import fused_preprocess
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.text import Tokenizer as JaxTokenizer
from tpucap.train import loop as jloop
from tpucap_torch import config as tcfg
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.decode import beam_decode, greedy_decode
from tpucap_torch.models import layers as tlayers
from tpucap_torch.models.decoders import build_decoder
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.train import TrainState, build_optimizer, make_train_step

from ports_init import jit_init

torch.set_num_threads(2)

V, D, B, T = 29, 12, 4, 6
START, END, MAXLEN = 1, 2, 10
DIMS = dict(vocab_size=V, feature_dim=D, embed_dim=8, hidden_dim=16, dropout_rate=0.0)
ATOL = 1e-5
CORPUS = {f"img{i}": [f"startseq w{a} w{b} endseq" for a in "abcd" for b in "xyz"][i::3] for i in range(3)}


def _bridged(name, seed=0, tilt=0.12):
    jdec = jax_build_decoder(name, **DIMS)
    tdec = build_decoder(name, **DIMS)
    jp = jax.tree.map(np.asarray, jit_init(jdec, jax.random.key(seed)))
    # Tilt the head toward END, so that some captions end early.
    jp["out"]["bias"] = jp["out"]["bias"] + np.eye(V, dtype=np.float32)[END] * tilt
    return jdec, jp, tdec, params_from_jax(jp)


def _feats(seed=0, batch=B):
    return np.random.default_rng(seed).normal(size=(batch, D)).astype(np.float32)


def make_pipes(decoder, seed=0, decode=None, tilt=2.0):
    """(tpucap's pipeline, the port's) on tiny_cnn (its block grid for the
    adaptive decoder), the port's random init from ``seed`` with the head
    sharpened and tilted toward endseq by ``tilt``, carried to tpucap."""
    features = "spatial" if decoder in ("attention", "adaptive") else "pooled"
    decode = {"max_len": 10, **(decode or {})}
    parts = lambda m: dict(  # noqa: E731
        encoder=m.encoder_config("tiny_cnn", features),
        decoder=m.DecoderConfig(name=decoder, embed_dim=16, hidden_dim=32, attention_dim=24, dropout_rate=0.0),
        decode=m.DecodeConfig(**decode), precision="f32",
    )
    pipe = CaptioningPipeline(tcfg.Config(**parts(tcfg)), device="cpu")
    pipe.fit_tokenizer(CORPUS)
    pipe.build(seed=seed)
    dec = pipe.params["decoder"]
    dec["out"]["kernel"].mul_(4)
    dec["out"]["bias"][pipe.tokenizer.word_index["endseq"]] += tilt
    jpipe = JaxPipeline(jcfg.Config(**parts(jcfg)), tokenizer=JaxTokenizer.from_json(pipe.tokenizer.to_json()))
    jpipe.build(init_params=False)
    jpipe.params = jax.tree.map(jnp.asarray, params_to_numpy(pipe.params))
    return jpipe, pipe


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gru_cell_step_matches_tpucap(dtype):
    rng = np.random.default_rng(0)
    cell = {
        "kernel": rng.normal(size=(12, 48)).astype(np.float32) * 0.4,
        "recurrent": rng.normal(size=(16, 48)).astype(np.float32) * 0.4,
        "bias": rng.normal(size=(2, 48)).astype(np.float32),
    }
    x = rng.normal(size=(64, 12)).astype(np.float32)
    h = rng.normal(size=(64, 16)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jax.jit(jlayers.gru_cell_step)(
        {k: jnp.asarray(v, jdt) for k, v in cell.items()}, jnp.asarray(x, jdt), jnp.asarray(h, jdt))
    got = tlayers.gru_cell_step(
        {k: torch.from_numpy(v).to(tdt) for k, v in cell.items()}, torch.from_numpy(x).to(tdt),
        torch.from_numpy(h).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (64, 16)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        # |h'| < 1: one bf16 ulp is at most 2^-8; the f32 gates part by
        # ~1e-7, so a rounding boundary is crossed only rarely.
        np.testing.assert_allclose(got, want, atol=2.0**-8, rtol=0)
        assert (got != want).mean() < 0.01


@pytest.mark.parametrize("name", ["gru1", "gru2"])
def test_steps_match_tpucap(name):
    jdec, jp, tdec, tp = _bridged(name)
    assert tdec.num_layers == (2 if name == "gru2" else 1)
    feats = _feats()
    jinit, jstep = jax.jit(jdec.init_state), jax.jit(jdec.step)
    js = jinit(jp, jnp.asarray(feats))
    ts = tdec.init_state(tp, torch.from_numpy(feats))
    assert sorted(ts) == sorted(js) == ["fe", "h"]
    assert tuple(ts["h"].shape) == (B, tdec.num_layers, 16)
    rng = np.random.default_rng(1)
    for t in range(4):
        tok = rng.integers(1, V, size=(B,))
        jl, js = jstep(jp, js, jnp.asarray(tok, jnp.int32))
        tl, ts = tdec.step(tp, ts, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, err_msg=f"step {t}")
        for key in js:
            np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), atol=ATOL, err_msg=key)
    jh, _ = jax.jit(jdec.step_hidden)(jp, js, jnp.asarray(tok, jnp.int32))
    th, _ = tdec.step_hidden(tp, ts, torch.from_numpy(tok))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    toks = rng.integers(1, V, size=(B, T))
    want = jax.jit(jdec.forward_train)(jp, jnp.asarray(feats), jnp.asarray(toks, jnp.int32))
    got = tdec.forward_train(tp, torch.from_numpy(feats), torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dropout_draws_features_then_tokens():
    """One generator draws the feature dropout, then the embedding dropout
    (as MergeDecoder does; its bits are not jax's)."""
    _, _, _, tp = _bridged("gru1")
    dec = build_decoder("gru1", **{**DIMS, "dropout_rate": 0.5})
    feats = torch.from_numpy(_feats())
    toks = torch.from_numpy(np.random.default_rng(4).integers(1, V, size=(B, T)))
    got = dec.forward_train(tp, feats, toks, rng=torch.Generator().manual_seed(7), deterministic=False)
    gen = torch.Generator().manual_seed(7)
    f_keep = torch.rand(feats.shape, generator=gen) < 0.5
    x_keep = torch.rand((B, T, DIMS["embed_dim"]), generator=gen) < 0.5
    xs = tp["embedding"]["table"][toks]
    xs = torch.where(x_keep, xs / 0.5, torch.zeros_like(xs))
    plain = build_decoder("gru1", **DIMS)
    state = plain.init_state(tp, torch.where(f_keep, feats / 0.5, torch.zeros_like(feats)))
    logits = []
    for t in range(T):
        # The step on an embedded input: the table row swapped for xs[:, t].
        out, state = plain.step({**tp, "embedding": {"table": xs[:, t]}}, state, torch.arange(B))
        logits.append(out)
    assert torch.equal(got, torch.stack(logits, dim=1))


@pytest.mark.parametrize("name", ["gru1", "gru2"])
@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_engines_match_tpucap(name, method):
    """With the bigram ban: a random GRU repeats one word to max_len, and
    the ban with an endseq tilt makes captions and lengths differ."""
    jdec, jp, tdec, tp = _bridged(name, seed=5, tilt={"gru1": 0.7, "gru2": 0.4}[name])
    feats = _feats(seed=5, batch=5)
    js = jax.jit(jdec.init_state)(jp, jnp.asarray(feats))
    ts = tdec.init_state(tp, torch.from_numpy(feats))
    kw = dict(start_id=START, end_id=END, max_len=MAXLEN, no_repeat_ngram_size=2)
    if method == "beam":
        ref = jax_beam_decode(jdec.step, jp, js, beam_width=3, decoder=jdec, **kw)
        got = beam_decode(tdec.step, tp, ts, beam_width=3, decoder=tdec, **kw)
        np.testing.assert_array_equal(got.beam_tokens.numpy(), np.asarray(ref.beam_tokens))
        np.testing.assert_allclose(got.beam_scores.numpy(), np.asarray(ref.beam_scores), atol=ATOL)
    else:
        ref = jax_greedy_decode(jdec.step, jp, js, **kw)
        got = greedy_decode(tdec.step, tp, ts, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=ATOL)
    assert len({tuple(r) for r in got.tokens.numpy()}) > 1
    assert (got.lengths.numpy() < MAXLEN).any()


def test_caption_batch_matches_tpucaps_body():
    """gru1's serving path at tiny_cnn's input 32, beam 3 with the bigram
    ban, f32: K1's plain version (tf mode) -> tiny_cnn -> gru1 -> beam,
    against tpucap's ``caption_dataset`` body on the same uint8 batch of
    solid colours (whose features differ more than noise images')."""
    jpipe, pipe = make_pipes("gru1", seed=4, decode={"beam_width": 3, "no_repeat_ngram_size": 2}, tilt=0.0)
    colors = np.array([[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255], [0, 255, 0], [128, 128, 128]])
    images = (colors[:, None, None, :] * np.ones((1, 40, 36, 1))).astype(np.uint8)
    start_id, end_id = jpipe._token_ids()
    p = jpipe._inference_params()
    x = fused_preprocess(jnp.asarray(images), jpipe.encoder.input_size, jpipe.encoder.preprocess_mode,
                         out_dtype=jnp.float32)
    state = jax.jit(jpipe.decoder.init_state)(p["decoder"], jax.jit(jpipe._apply_encoder)(p["encoder"], x))
    res = jax_beam_decode(jpipe.decoder.step, p["decoder"], state, beam_width=3, decoder=jpipe.decoder,
                          start_id=start_id, end_id=end_id, max_len=10, no_repeat_ngram_size=2)
    want = ids_to_captions(jpipe.tokenizer, res.tokens, res.lengths, end_id=end_id)
    assert type(pipe.decoder).__name__ == "GruMergeDecoder"
    assert pipe.caption_batch(images, method="beam") == want
    assert len(set(want)) > 1


def _batch(seed, batch=6, width=D):
    """Features and tokens (B, T + 1): startseq, random ids, post padding of
    varied length."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(batch, width)).astype(np.float32)
    toks = rng.integers(3, V, size=(batch, T + 1)).astype(np.int32)
    toks[:, 0] = START
    for i, n in enumerate(rng.integers(3, T + 2, size=batch)):
        toks[i, n:] = 0
    return feats, toks


def sgd_step_matches(jdec, tdec, jp, feats, toks, **step_kw):
    """One training step of each package from ``jp`` under plain SGD at lr
    0.5, dropout off: loss within 1e-6 relative, every updated param within
    1e-5. -> (tpucap's metrics, the port's)."""
    jopt = jloop.build_optimizer(jcfg.TrainConfig(optimizer="sgd", learning_rate=0.5))
    topt = build_optimizer(tcfg.TrainConfig(optimizer="sgd", learning_rate=0.5))
    jstep = jloop.make_train_step(jdec, jopt, deterministic=True, **step_kw)
    tstep = make_train_step(tdec, topt, deterministic=True, **step_kw)
    jstate = jloop.TrainState.create(jax.tree.map(jnp.asarray, jp), jopt, jax.random.key(0))
    tstate = TrainState.create(params_from_jax(jp), topt, None)
    jstate, jm = jstep(jstate, jnp.asarray(feats), jnp.asarray(toks))
    tstate, tm = tstep(tstate, torch.from_numpy(feats), torch.from_numpy(toks).long())
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-6)
    moved = 0.0
    for path, want in jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jstate.params))[0]:
        node = params_to_numpy(tstate.params)
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_allclose(node, want, atol=1e-5, rtol=0, err_msg=str(path))
        moved = max(moved, float(np.abs(want - _at(jp, path)).max()))
    assert moved > 1e-3  # the step moved the params well past the tolerance
    return jm, tm


def _at(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", None))]
    return tree


@pytest.mark.parametrize("name", ["gru1", "gru2"])
def test_train_step_matches_tpucap(name):
    jdec, jp, tdec, _ = _bridged(name, seed=11)
    sgd_step_matches(jdec, tdec, jp, *_batch(12))


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_generate_ensemble_of_gru1_and_lstm1_matches_tpucap(method):
    decode = {"no_repeat_ngram_size": 2}
    (jg, pg), (jl, pl) = make_pipes("gru1", 3, decode, tilt=1.0), make_pipes("lstm1", 5, decode, tilt=1.0)
    x = np.random.default_rng(8).normal(size=(5, 128)).astype(np.float32)
    kw = dict(method=method, beam_width=3)
    got = pg.generate_ensemble(x, [pl], weights=[0.6, 0.4], **kw)
    assert got == jg.generate_ensemble(x, [jl], weights=[0.6, 0.4], **kw)
    assert len(set(got)) > 1


def _rows(name, n, seed):
    shape = (n, 16, 128) if name == "adaptive" else (n, 128)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", ["gru2", "adaptive"])
def test_decode_toolkit_and_server_drive_the_family(name):
    """The decode engines drive the family unchanged, against tpucap's:
    diverse search (captions exact, scores within 1e-5), a forced prefix,
    must-include words, MBR over beam pools; for the adaptive decoder an
    ensemble with an lstm1 member on pooled rows, the adaptive member's
    grids kept under its prefixed shared keys. The sampler at top_k = 1 is
    greedy's, and the batch server gives ``generate``'s captions."""
    from tpucap_torch.serve import CaptionServer

    jpipe, pipe = make_pipes(name, seed=6, decode={"max_len": 8}, tilt=1.0)
    x = _rows(name, 4, seed=9)
    got = pipe.generate_diverse(x, num_groups=2, group_width=2)
    want = jpipe.generate_diverse(x, num_groups=2, group_width=2)
    assert [[c for c, _ in row] for row in got] == [[c for c, _ in row] for row in want]
    np.testing.assert_allclose([s for row in got for _, s in row], [s for row in want for _, s in row], atol=1e-5)
    assert pipe.generate_continuation(x, "wa wx") == jpipe.generate_continuation(x, "wa wx")
    assert pipe.generate_constrained(x, ["wy"]) == jpipe.generate_constrained(x, ["wy"])
    mbr = dict(candidates="beam", n_candidates=3)
    assert pipe.generate_mbr(x, **mbr) == jpipe.generate_mbr(x, **mbr)
    if name == "adaptive":
        jl, pl = make_pipes("lstm1", seed=5, tilt=1.0)
        pooled = _rows("gru2", 4, seed=10)
        assert pl.generate_ensemble([pooled, x], [pipe]) == jl.generate_ensemble([pooled, x], [jpipe])
    greedy = pipe.generate(x, method="greedy")
    assert pipe.generate(x, method="sample", top_k=1, seed=3) == greedy
    with CaptionServer(pipe, max_batch=4) as srv:
        assert [f.result(60) for f in srv.submit_many(x)] == pipe.generate(x)


@pytest.mark.parametrize("name", ["gru1", "adaptive"])
def test_training_dials_run_the_family(name):
    """fit's dials on the family, the port alone (jax's draws cannot be
    made in torch): a dev split with the bleu4 monitor and the EMA, then
    scheduled sampling with steps_per_dispatch 2, then ``fit_lora``: finite
    histories of the epochs asked for, the EMA kept, the params moved."""
    _, pipe = make_pipes(name, seed=7)
    pipe.config = dataclasses.replace(pipe.config, train=dataclasses.replace(
        pipe.config.train, batch_size=2, epochs=2, val_metric="bleu4", ema_decay=0.9))
    feats = {k: _rows(name, 1, seed=20 + i)[0] for i, k in enumerate(CORPUS)}
    before = params_to_numpy(pipe.params["decoder"])
    hist = pipe.fit(CORPUS, feats, val_data=(CORPUS, feats), log=None)
    assert [h["epoch"] for h in hist] == [0, 1] and np.isfinite([h["val_loss"] for h in hist]).all()
    assert "val_bleu4" in hist[0] and pipe.ema_params is not None
    pipe.config = dataclasses.replace(pipe.config, train=dataclasses.replace(
        pipe.config.train, val_metric="loss", ema_decay=0.0, scheduled_sampling=0.5, steps_per_dispatch=2))
    hist = pipe.fit(CORPUS, feats, log=None)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) and "ss_eps" in h for h in hist)
    after = params_to_numpy(pipe.params["decoder"])
    assert any(not np.array_equal(a, b) for a, b in zip(jax.tree.leaves(after), jax.tree.leaves(before)))
    hist = pipe.fit_lora(CORPUS, feats, rank=2, epochs=1, log=None)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"]) and pipe.lora_adapters


@pytest.mark.parametrize("name", ["gru2", "adaptive"])
def test_weight_bridge_carries_both_families(name):
    """tpucap's tree -> the port's tensors -> numpy, bit for bit, with the
    GRU bias (2, 3U) kept two rows; and the port's own init back through
    tpucap's layout."""
    jdec = jax_build_decoder(name, **DIMS)
    jp = jax.tree.map(np.asarray, jit_init(jdec, jax.random.key(9)))
    jp = jax.tree.map(lambda a: a + np.float32(0.25), jp)  # nonzero biases
    tp = params_from_jax(jp)
    if name == "gru2":
        assert [tuple(c["bias"].shape) for c in tp["cells"]] == [(2, 48), (2, 48)]
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    own = build_decoder(name, **DIMS).init(torch.Generator().manual_seed(1))
    again = params_from_jax(params_to_numpy(own))
    for a, b in zip(jax.tree.leaves(params_to_numpy(again)), jax.tree.leaves(params_to_numpy(own))):
        np.testing.assert_array_equal(a, b)


def test_cli_gru2_trains_captions_and_exports(tmp_path):
    """The port's CLI alone on a fixture dataset: ``extract``, ``train
    --decoder gru2``, ``caption`` (the restored pipeline's ``generate``)
    and ``export`` (tpucap-layout params back from the ``.h5`` bit for
    bit)."""
    from tpucap.data import generate_fixture_dataset
    from tpucap_torch.checkpoint import KerasH5Model, gru_merge_decoder_params_from_keras

    cli = importlib.import_module("tpucap_torch.cli.main")
    img_dir, tokens, train, _ = generate_fixture_dataset(tmp_path / "data", n_images=4, image_size=32, seed=6)
    model = ["--encoder", "tiny_cnn", "--decoder", "gru2", "--embed-dim", "16", "--hidden-dim", "32",
             "--max-len", "8"]
    feats, ckpt, h5 = str(tmp_path / "f.npz"), str(tmp_path / "ckpt"), str(tmp_path / "gru2.h5")
    images = sorted(str(p) for p in Path(img_dir).glob("*.jpg"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), contextlib.redirect_stderr(io.StringIO()):
        cli.main(["extract", *model, "--images", str(img_dir), "--out", feats, "--batch-size", "4"], device="cpu")
        cli.main(["train", *model, "--tokens", tokens, "--split", train, "--features", feats,
                  "--checkpoint-dir", ckpt, "--epochs", "1", "--batch-size", "4"], device="cpu")
        start = len(printed.getvalue().splitlines())
        cli.main(["caption", *model, "--image", *images, "--checkpoint-dir", ckpt, "--method", "greedy"],
                 device="cpu")
        lines = printed.getvalue().splitlines()[start:]
        cli.main(["export", *model, "--checkpoint-dir", ckpt, "--out", h5], device="cpu")
    args = cli.build_parser()[0].parse_args(["caption", *model, "--image", *images, "--checkpoint-dir", ckpt])
    pipe = cli._restore_pipeline(args, torch.device("cpu"))
    assert type(pipe.decoder).__name__ == "GruMergeDecoder" and pipe.decoder.num_layers == 2
    caps = pipe.generate(pipe.extract_features(images), method="greedy")
    assert lines == [f"{p}\t{c}" for p, c in zip(images, caps)]
    got = gru_merge_decoder_params_from_keras(KerasH5Model(h5))
    want = params_to_numpy(pipe.params["decoder"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
