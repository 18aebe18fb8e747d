"""tpucap_torch's InjectDecoder and soft-attention AttentionDecoder (CONFIG_4)
against tpucap's, on the CPU, params bridged through
``convert.params_from_jax``, dropout off unless a test draws it, f32.

- ``init_state``, ``step`` (and the attention maps at k = 1 and at k = 3
  hypotheses sharing one grid) and ``forward_train`` within 1e-5 absolute
  of tpucap's on O(1) states and logits (sums in another order);
- beam search (k = 3) with ``decoder=`` keeps ``features`` and
  ``att_feat`` (B, L, .) inside every step, and gives tpucap's tokens,
  lengths and scores (scores within 1e-5); greedy gives tpucap's tokens;
- the slice: a uint8 batch through ``caption_batch`` (K1's plain version
  in caffe mode -> VGG16's block5 grid at input 64, 4 x 4 -> the attention
  decoder -> beam 3 and greedy) gives tpucap's ``caption_dataset`` body's
  captions;
- the pipeline's ``step_fn`` stays the fused K2 + K3 step for a 1-layer
  merge decoder on the card (CONFIG_2 and CONFIG_5) and the plain step for
  inject and attention; every preset builds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap.config import Config, DecodeConfig, DecoderConfig
from tpucap.config import encoder_config as jax_encoder_config
from tpucap.decode import beam_decode as jax_beam_decode
from tpucap.decode import greedy_decode as jax_greedy_decode
from tpucap.decode import ids_to_captions
from tpucap.ops.preprocess import fused_preprocess
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap_torch import config as tcfg
from tpucap.text import Tokenizer as JaxTokenizer
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.decode import beam_decode, greedy_decode
from tpucap_torch.models.decoders import build_decoder
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer

from ports_init import jit_init

torch.set_num_threads(2)

V, D, L, B, T = 29, 12, 9, 4, 6
START, END, MAXLEN = 1, 2, 10
DIMS = dict(vocab_size=V, feature_dim=D, embed_dim=8, hidden_dim=16, dropout_rate=0.0)
ATOL = 1e-5


def _bridged(name, seed=0, **extra):
    jdec = jax_build_decoder(name, **DIMS, **extra)
    tdec = build_decoder(name, **DIMS, **extra)
    jp = jit_init(jdec, jax.random.key(seed))
    # Tilt the head toward END, so that some captions end early.
    jp["out"]["bias"] = jp["out"]["bias"].at[END].add(0.12)
    return jdec, jp, tdec, params_from_jax(jax.tree.map(np.asarray, jp))


def _feats(name, seed=0, batch=B):
    shape = (batch, L, D) if name == "attention" else (batch, D)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name,num_layers", [("inject", 1), ("inject", 2), ("attention", 1)])
def test_steps_match_tpucap(name, num_layers):
    extra = {"num_layers": num_layers} if name == "inject" else {}
    jdec, jp, tdec, tp = _bridged(name, **extra)
    feats = _feats(name)
    js = jax.jit(jdec.init_state)(jp, jnp.asarray(feats))
    ts = tdec.init_state(tp, torch.from_numpy(feats))
    assert sorted(ts) == sorted(js)
    for key in js:
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), atol=ATOL, err_msg=key)
    rng = np.random.default_rng(1)
    jstep = jax.jit(jdec.step)
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


def test_attention_with_a_shared_grid_matches_tpucap():
    """k = 3 hypotheses an image over one (B, L, .) grid: the maps and the
    context as tpucap's, and as the same step on a grid tiled k times."""
    jdec, jp, tdec, tp = _bridged("attention")
    feats = _feats("attention")
    js = jax.jit(jdec.init_state)(jp, jnp.asarray(feats))
    ts = tdec.init_state(tp, torch.from_numpy(feats))
    h = np.random.default_rng(2).normal(size=(3 * B, DIMS["hidden_dim"])).astype(np.float32)
    js = dict(js, h=jnp.asarray(h), c=jnp.asarray(h))
    ts = dict(ts, h=torch.from_numpy(h), c=torch.from_numpy(h))
    jctx, jalpha = jax.jit(jdec._attend)(jp, js)
    tctx, talpha = tdec._attend(tp, ts)
    assert tuple(talpha.shape) == (3 * B, L)
    np.testing.assert_allclose(talpha.numpy(), np.asarray(jalpha), atol=ATOL)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), atol=ATOL)
    tiled = {k: v.repeat_interleave(3, dim=0) if k in tdec.beam_shared_keys else v for k, v in ts.items()}
    ctx1, alpha1 = tdec._attend(tp, tiled)
    torch.testing.assert_close(alpha1, talpha, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(ctx1, tctx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(talpha.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", ["inject", "attention"])
def test_forward_train_matches_tpucap(name):
    jdec, jp, tdec, tp = _bridged(name)
    feats = _feats(name)
    toks = np.random.default_rng(3).integers(1, V, size=(B, T))
    want = jax.jit(jdec.forward_train)(jp, jnp.asarray(feats), jnp.asarray(toks, jnp.int32))
    got = tdec.forward_train(tp, torch.from_numpy(feats), torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if name == "attention":
        wl, wa = jax.jit(jdec.forward_train_with_alphas)(jp, jnp.asarray(feats), jnp.asarray(toks, jnp.int32))
        gl, ga = tdec.forward_train_with_alphas(tp, torch.from_numpy(feats), torch.from_numpy(toks))
        assert tuple(ga.shape) == (B, T, L)
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), atol=ATOL)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=ATOL)


@pytest.mark.parametrize("name", ["inject", "attention"])
def test_dropout_draws_features_then_tokens(name):
    """One generator draws the feature dropout, then the embedding dropout
    (as MergeDecoder does; its bits are not jax's)."""
    _, _, _, tp = _bridged(name)
    dec = build_decoder(name, **{**DIMS, "dropout_rate": 0.5})
    feats = torch.from_numpy(_feats(name))
    toks = torch.from_numpy(np.random.default_rng(4).integers(1, V, size=(B, T)))
    got = dec.forward_train(tp, feats, toks, rng=torch.Generator().manual_seed(7), deterministic=False)
    gen = torch.Generator().manual_seed(7)
    f_keep = torch.rand(feats.shape, generator=gen) < 0.5
    x_keep = torch.rand((B, T, DIMS["embed_dim"]), generator=gen) < 0.5
    feats = torch.where(f_keep, feats / 0.5, torch.zeros_like(feats))
    xs = tp["embedding"]["table"][toks]
    xs = torch.where(x_keep, xs / 0.5, torch.zeros_like(xs))
    plain = build_decoder(name, **DIMS)
    state = plain.init_state(tp, feats)
    logits = []
    for t in range(T):
        # The step on an embedded input: the table row swapped for xs[:, t].
        table = {**tp, "embedding": {"table": xs[:, t]}}
        out, state = plain.step(table, state, torch.arange(B))
        logits.append(out)
    assert torch.equal(got, torch.stack(logits, dim=1))
    assert not torch.equal(got, dec.forward_train(tp, torch.from_numpy(_feats(name)), toks))


def _shape_checked(dec, seen):
    def step(params, state, token):
        seen.append({k: tuple(state[k].shape) for k in dec.beam_shared_keys})
        return dec.step(params, state, token)

    return step


@pytest.mark.parametrize("name", ["inject", "attention"])
@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_engines_match_tpucap(name, method):
    jdec, jp, tdec, tp = _bridged(name, seed=5)
    feats = _feats(name, seed=5, batch=5)
    js = jax.jit(jdec.init_state)(jp, jnp.asarray(feats))
    ts = tdec.init_state(tp, torch.from_numpy(feats))
    kw = dict(start_id=START, end_id=END, max_len=MAXLEN)
    if method == "beam":
        seen = []
        step = _shape_checked(tdec, seen) if name == "attention" else tdec.step
        ref = jax_beam_decode(jdec.step, jp, js, beam_width=3, decoder=jdec, **kw)
        got = beam_decode(step, tp, ts, beam_width=3, decoder=tdec, **kw)
        np.testing.assert_array_equal(got.beam_tokens.numpy(), np.asarray(ref.beam_tokens))
        np.testing.assert_allclose(got.beam_scores.numpy(), np.asarray(ref.beam_scores), atol=ATOL)
        if name == "attention":
            assert seen and all(s == {"features": (5, L, D), "att_feat": (5, L, 256)} for s in seen)
            # Without decoder= the grids are tiled; the tokens are the same.
            tiled = beam_decode(tdec.step, tp, ts, beam_width=3, **kw)
            assert torch.equal(tiled.beam_tokens, got.beam_tokens)
    else:
        ref = jax_greedy_decode(jdec.step, jp, js, **kw)
        got = greedy_decode(tdec.step, tp, ts, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=ATOL)
    assert len({tuple(r) for r in got.tokens.numpy()}) > 1
    assert (got.lengths.numpy() < MAXLEN).any()


CORPUS = {"img": [f"startseq w{a} w{b} endseq" for a in "abcd" for b in "xyz"]}


WORDS = [f"w{a}{b}" for a in "abcdefg" for b in "xyz"]
SENTENCES = {"img": ["startseq " + " ".join(WORDS[i : i + 5]) + " endseq" for i in range(0, len(WORDS), 3)]}


@pytest.mark.parametrize("method", ["beam", "greedy"])
def test_caption_batch_config4_matches_tpucaps_body(method):
    """CONFIG_4's serving path at input 64, f32: VGG16's block5 grid (16 x
    512) -> the attention decoder (embed 16, hidden 32, attention 24) on
    four solid-colour images, whose grids differ more than noise images'."""
    dec = dict(name="attention", embed_dim=16, hidden_dim=32, attention_dim=24, dropout_rate=0.0)
    decode = dict(method=method, beam_width=3, max_len=8)
    # The port's seeded init (torch's VGG16 init takes a second where
    # tpucap's eager one takes tens), carried to tpucap; seed 1's captions
    # differ across the four colours (seed 0's are all empty).
    pipe = CaptioningPipeline(
        tcfg.Config(encoder=tcfg.encoder_config("vgg16", "spatial"), decoder=tcfg.DecoderConfig(**dec),
                    decode=tcfg.DecodeConfig(**decode), precision="f32"), device="cpu")
    pipe.encoder = dataclasses.replace(pipe.encoder, input_size=64)
    pipe.fit_tokenizer(SENTENCES)
    pipe.build(seed=1)
    last = pipe.params["encoder"]["block5_conv3"]
    last["kernel"].mul_(0.2)
    last["bias"].mul_(0.2)
    pipe.params["decoder"]["out"]["kernel"].mul_(4)
    jpipe = JaxPipeline(Config(encoder=jax_encoder_config("vgg16", "spatial"), decoder=DecoderConfig(**dec),
                               decode=DecodeConfig(**decode), precision="f32"),
                        tokenizer=JaxTokenizer.from_json(pipe.tokenizer.to_json()))
    jpipe.encoder = dataclasses.replace(jpipe.encoder, input_size=64)
    jpipe.build(init_params=False)
    jpipe.params = jax.tree.map(jnp.asarray, params_to_numpy(pipe.params))
    colors = np.array([[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]])
    images = (colors[:, None, None, :] * np.ones((1, 70, 60, 1))).astype(np.uint8)

    start_id, end_id = jpipe._token_ids()
    p = jpipe._inference_params()
    x = fused_preprocess(jnp.asarray(images), 64, "caffe", out_dtype=jnp.float32)
    feats = jpipe._apply_encoder(p["encoder"], x)
    assert feats.shape == (4, 16, 512)
    state = jpipe.decoder.init_state(p["decoder"], feats)
    kw = dict(start_id=start_id, end_id=end_id, max_len=8)
    if method == "beam":
        res = jax_beam_decode(jpipe.decoder.step, p["decoder"], state, beam_width=3, decoder=jpipe.decoder, **kw)
    else:
        res = jax_greedy_decode(jpipe.decoder.step, p["decoder"], state, **kw)
    want = ids_to_captions(jpipe.tokenizer, res.tokens, res.lengths, end_id=end_id)
    assert pipe.caption_batch(images) == want
    assert len(set(want)) > 1


@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config4", "config5"])
def test_every_preset_builds_with_its_step(name):
    """Each preset's pipeline builds (decoder params at the preset's
    widths), and step_fn is the fused step on the card exactly for a
    1-layer merge decoder."""
    cfg = tcfg.PRESETS[name]
    tok = Tokenizer()
    tok.fit_on_texts(CORPUS["img"])
    pipe = CaptioningPipeline(cfg, tokenizer=tok, device="cpu")
    pipe.build(init_params=False)
    dp = pipe.decoder.init(torch.Generator().manual_seed(0))
    expect = {"lstm1": "MergeDecoder", "lstm2": "MergeDecoder", "attention": "AttentionDecoder"}
    assert type(pipe.decoder).__name__ == expect[cfg.decoder.name]
    assert pipe.decoder.feature_dim == cfg.encoder.feature_dim == pipe.encoder.feature_dim
    assert dp["out"]["kernel"].shape == (cfg.decoder.hidden_dim, pipe.vocab_size)
    assert pipe.step_fn() == pipe.decoder.step  # the CPU
    pipe.device = torch.device("cuda")  # the card's branch, nothing launched
    fused = name in ("config1", "config2", "config5")
    assert (pipe.step_fn().__qualname__ == "make_fused_merge_step.<locals>.step") == fused
    if name == "config2":
        for dec in ("inject", "attention"):
            other = CaptioningPipeline(
                tcfg.Config(encoder=tcfg.encoder_config("inception_v3", "spatial" if dec == "attention" else "pooled"),
                            decoder=tcfg.DecoderConfig(name=dec)),
                tokenizer=tok, device="cpu")
            other.build(init_params=False)
            other.device = torch.device("cuda")
            assert other.step_fn() == other.decoder.step
