"""tpucap_torch's greedy and beam engines, token-exact.

- against tpucap/decode/oracle.py (the JAX package's host step loops), run
  on the port step's own logits, so both sides rank identical numbers;
- a constructed tie case pinning the (score desc, parent asc, word asc)
  order that torch.topk does not promise;
- banned words against the JAX engines on bridged params;
- the golden fixture: tpucap's pinned training, its decoder bridged, must
  give tests/fixtures/golden_captions.json's greedy and beam captions.

Scores: the oracle takes log_softmax through jax, the engine subtracts a
torch logsumexp; 1e-5 absolute on sums of ~12 log-probs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap.decode import beam_decode as jax_beam_decode
from tpucap.decode import greedy_decode as jax_greedy_decode
from tpucap.decode.oracle import beam_oracle, greedy_oracle
from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap_torch.convert import params_from_jax
from tpucap_torch.decode import beam_decode, greedy_decode
from tpucap_torch.models.decoders import build_decoder

from ports_init import jit_init

torch.set_num_threads(2)

V, FEAT, START, END, MAXLEN, B = 23, 11, 1, 2, 12, 5
DIMS = dict(vocab_size=V, feature_dim=FEAT, embed_dim=8, hidden_dim=16, dropout_rate=0.0)
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden_captions.json")


def _model(name, seed=0):
    gen = torch.Generator().manual_seed(seed)
    dec = build_decoder(name, **DIMS)
    params = dec.init(gen)
    # Tilt the output toward END so beams finish at different steps and
    # the frozen-beam and early-exit paths run.
    params["out"]["bias"][END] += 1.5
    feats = torch.randn((B, FEAT), generator=gen)
    return dec, params, dec.init_state(params, feats)


def _oracle_step(dec, params):
    """The port's step behind the oracle's jax-array interface."""

    def step(_, state, token):
        st = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
        logits, new = dec.step(params, st, torch.from_numpy(np.array(token)).long())
        return jnp.asarray(logits.numpy()), {k: jnp.asarray(v.numpy()) for k, v in new.items()}

    return step


def _jax_state(state):
    return {k: jnp.asarray(v.numpy()) for k, v in state.items()}


@pytest.mark.parametrize("name", ["lstm1", "lstm2"])
@pytest.mark.parametrize("min_len", [0, 3])
def test_greedy_matches_oracle(name, min_len):
    dec, params, state = _model(name)
    res = greedy_decode(
        dec.step, params, state, start_id=START, end_id=END, max_len=MAXLEN, min_len=min_len
    )
    ot, ol, osc = greedy_oracle(
        _oracle_step(dec, params), None, _jax_state(state),
        start_id=START, end_id=END, max_len=MAXLEN, min_len=min_len,
    )
    np.testing.assert_array_equal(res.tokens.numpy(), ot)
    np.testing.assert_array_equal(res.lengths.numpy(), ol)
    np.testing.assert_allclose(res.scores.numpy(), osc, atol=1e-5)
    assert (ol < MAXLEN).any()


@pytest.mark.parametrize(
    "name,k,min_len,penalty",
    [
        ("lstm1", 3, 0, "simple"),
        ("lstm1", 2, 0, "gnmt"),
        ("lstm1", 3, 4, "simple"),
        ("lstm2", 3, 0, "simple"),
    ],
)
def test_beam_matches_oracle(name, k, min_len, penalty):
    dec, params, state = _model(name)
    res = beam_decode(
        dec.step, params, state, start_id=START, end_id=END, max_len=MAXLEN,
        beam_width=k, min_len=min_len, length_penalty=penalty,
    )
    bt, bl, bs, all_t, all_l, all_s = beam_oracle(
        _oracle_step(dec, params), None, _jax_state(state),
        start_id=START, end_id=END, max_len=MAXLEN, beam_width=k,
        min_len=min_len, length_penalty=penalty,
    )
    np.testing.assert_array_equal(res.beam_tokens.numpy(), all_t)
    np.testing.assert_array_equal(res.beam_lengths.numpy(), all_l)
    np.testing.assert_allclose(res.beam_scores.numpy(), all_s, atol=1e-5)
    np.testing.assert_array_equal(res.tokens.numpy(), bt)
    np.testing.assert_array_equal(res.lengths.numpy(), bl)
    assert (all_l < MAXLEN).any()


def test_tie_order_is_parent_then_word():
    """Every beam sees the same logits with exact ties among words 3..6:
    the top-k must take them in ascending word order from the lowest
    parent, as lax.top_k does."""
    row = np.array([5.0, -9, -9, 1, 1, 1, 1, 0.5], np.float32)  # pad, START, END, ...

    def step(_, state, token):
        n = token.shape[0]
        if isinstance(token, torch.Tensor):
            return torch.from_numpy(np.tile(row, (n, 1))), state
        return jnp.asarray(np.tile(row, (n, 1))), state

    state = {"h": torch.zeros((2, 1))}
    res = beam_decode(step, None, state, start_id=START, end_id=END, max_len=3, beam_width=3)
    oracle = beam_oracle(
        step, None, {"h": jnp.zeros((2, 1))}, start_id=START, end_id=END,
        max_len=3, beam_width=3,
    )
    np.testing.assert_array_equal(res.beam_tokens.numpy(), oracle[3])
    # Step 0 fills slots with words 3, 4, 5; from then on parent 0 wins
    # every tie, so each slot extends slot 0's prefix with words 3, 4, 5.
    np.testing.assert_array_equal(res.beam_tokens[0].numpy(), [[3, 3, 3], [3, 3, 4], [3, 3, 5]])
    greedy = greedy_decode(step, None, state, start_id=START, end_id=END, max_len=2)
    np.testing.assert_array_equal(greedy.tokens.numpy(), [[3, 3], [3, 3]])


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_banned_ids_match_jax_engine(method):
    jdec = jax_build_decoder("lstm1", **DIMS)
    jp = jit_init(jdec, jax.random.key(3))
    tdec = build_decoder("lstm1", **DIMS)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    feats = np.random.default_rng(3).normal(size=(B, FEAT)).astype(np.float32)
    js = jdec.init_state(jp, jnp.asarray(feats))
    ts = tdec.init_state(tp, torch.from_numpy(feats))
    kw = dict(start_id=START, end_id=END, max_len=MAXLEN, banned_ids=(4, 7, 9))
    if method == "beam":
        ref = jax_beam_decode(jdec.step, jp, js, beam_width=3, **kw)
        got = beam_decode(tdec.step, tp, ts, beam_width=3, **kw)
    else:
        ref = jax_greedy_decode(jdec.step, jp, js, **kw)
        got = greedy_decode(tdec.step, tp, ts, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    assert not np.isin(got.tokens.numpy(), [4, 7, 9]).any()


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_primed_rows_match_jax_engine(method):
    """Per-row start ids and init_scores (a primed prefix's state): tokens
    exact, scores within 1e-5 absolute."""
    jdec = jax_build_decoder("lstm1", **DIMS)
    jp = jit_init(jdec, jax.random.key(5))
    tdec = build_decoder("lstm1", **DIMS)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(B, FEAT)).astype(np.float32)
    starts = rng.integers(3, V, size=(B,)).astype(np.int32)
    init = rng.normal(size=(B,)).astype(np.float32) * 3
    js = jdec.init_state(jp, jnp.asarray(feats))
    ts = tdec.init_state(tp, torch.from_numpy(feats))
    kw = dict(end_id=END, max_len=MAXLEN)
    if method == "beam":
        ref = jax_beam_decode(
            jdec.step, jp, js, start_id=jnp.asarray(starts), init_scores=jnp.asarray(init),
            beam_width=3, **kw,
        )
        got = beam_decode(
            tdec.step, tp, ts, start_id=torch.from_numpy(starts), init_scores=init,
            beam_width=3, **kw,
        )
    else:
        ref = jax_greedy_decode(
            jdec.step, jp, js, start_id=jnp.asarray(starts), init_scores=jnp.asarray(init), **kw
        )
        got = greedy_decode(
            tdec.step, tp, ts, start_id=torch.from_numpy(starts), init_scores=init, **kw
        )
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=1e-5)


def test_unported_dials_raise():
    """``unroll`` (a while-loop dial) takes 1 only; a negative n-gram size
    raises as tpucap's does (the ban itself is ``test_torch_ngram.py``'s)."""
    dec, params, state = _model("lstm1")
    kw = dict(start_id=START, end_id=END, max_len=4)
    with pytest.raises(ValueError, match="unroll"):
        greedy_decode(dec.step, params, state, unroll=2, **kw)
    with pytest.raises(ValueError, match="no_repeat_ngram_size"):
        beam_decode(dec.step, params, state, beam_width=2, no_repeat_ngram_size=-1, **kw)
    with pytest.raises(ValueError, match="no_repeat_ngram_size"):
        greedy_decode(dec.step, params, state, no_repeat_ngram_size=-1, **kw)


def test_golden_captions_reproduce(tmp_path):
    """tpucap's pinned training run (tests/test_golden_captions.py), then
    the port decodes its features with the bridged decoder."""
    from tpucap.config import Config, DecodeConfig, DecoderConfig, EncoderConfig, TrainConfig
    from tpucap.data import (
        generate_fixture_dataset,
        load_descriptions,
        load_split,
        prepare_descriptions,
    )
    from tpucap.pipeline import CaptioningPipeline as JaxPipeline
    from tpucap_torch import config as tcfg
    from tpucap_torch.pipeline import CaptioningPipeline
    from tpucap_torch.text import Tokenizer

    img_dir, token_file, train_file, _ = generate_fixture_dataset(
        tmp_path, n_images=8, image_size=32, seed=123
    )
    prepared = prepare_descriptions(load_descriptions(token_file), load_split(train_file))
    train_ids = load_split(train_file)
    jpipe = JaxPipeline(
        Config(
            encoder=EncoderConfig(name="tiny_cnn", feature_dim=128),
            decoder=DecoderConfig(embed_dim=16, hidden_dim=32, dropout_rate=0.0),
            decode=DecodeConfig(max_len=12),
            train=TrainConfig(batch_size=6, learning_rate=5e-3, seed=42),
            precision="f32",
        )
    )
    jpipe.fit_tokenizer(prepared)
    jpipe.build()
    feats = jpipe.extract_features([f"{img_dir}/{i}.jpg" for i in train_ids], batch_size=6)
    jpipe.fit(prepared, dict(zip(train_ids, feats)), epochs=25, log=None)

    # The port's encoder is unused here: features come from tpucap's
    # tiny_cnn, so only the decoder's input width (128) matters.
    pipe = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.EncoderConfig(name="resnet50", feature_dim=128),
            decoder=tcfg.DecoderConfig(embed_dim=16, hidden_dim=32, dropout_rate=0.0),
            decode=tcfg.DecodeConfig(max_len=12),
            precision="f32",
        ),
        tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()),
        device="cpu",
    )
    pipe.build(init_params=False)
    pipe.set_params(
        {"decoder": params_from_jax(jax.tree.map(np.asarray, jpipe.params["decoder"]))}
    )
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert train_ids == golden["ids"]
    assert pipe.generate(feats, method="greedy") == golden["greedy"]
    assert pipe.generate(feats, method="beam", beam_width=3) == golden["beam"]
