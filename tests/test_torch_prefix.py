"""Forced-prefix decoding in the port (``tpucap_torch/decode/prefix.py``,
``CaptioningPipeline.generate_continuation``) against tpucap's on the CPU.

- ``prime_prefix`` on lstm1 and the soft-attention decoder, the port's
  random params carried to tpucap's decoders by ``convert.params_to_numpy``:
  mixed per-row prefix lengths (0 included) in one padded batch;
- ``generate_continuation`` greedy and beam on a tiny_cnn + lstm1 pipeline
  (embed 16, hidden 32, max_len 10, f32, the port's random weights with
  the head sharpened and tilted toward endseq, carried to tpucap), mixed
  per-row prefixes of 0, 1, 3 and 5 words; a shared one is that string on
  every row; the empty prefix is ``generate``; a batch decomposes into its
  single rows; min_len, the n-gram ban and bad_words act on the
  continuation;
- the refusals (a word outside the vocabulary, the method, the row count,
  the KV-cache capacity rule) with tpucap's texts; a ``step_chunk``
  decoder is primed in one chunk (the transformer's own parity is in
  ``test_torch_transformer.py``).

Tolerance: tokens, lengths, ``last`` and captions exact. Every state leaf
within 1e-5 absolute and the prefix log-prob within 1e-5 absolute (f32;
the two packages' matmuls and logsumexp round differently in the last
bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.decode.prefix import prime_prefix as jax_prime_prefix
from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.text import Tokenizer as JaxTokenizer
from tpucap_torch import config as tcfg
from tpucap_torch.convert import params_to_numpy
from tpucap_torch.decode import prime_prefix
from tpucap_torch.models.decoders import build_decoder
from tpucap_torch.pipeline import CaptioningPipeline

torch.set_num_threads(2)

V, FEAT, START = 23, 11, 1
DIMS = dict(vocab_size=V, feature_dim=FEAT, embed_dim=8, hidden_dim=16, dropout_rate=0.0)
DEC = dict(embed_dim=16, hidden_dim=32, dropout_rate=0.0)
CORPUS = {
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
# Per-row prefixes of 0, 1, 3 and 5 words (P padded to 8), one with a
# capital and punctuation the tokenizer normalizes away.
PREFIXES = ["", "a", "a black dog", "two children play soccer in", "The man,", "", "woman", "a dog is"]


def _configs(decode):
    return (
        jcfg.Config(
            encoder=jcfg.encoder_config("tiny_cnn"), decoder=jcfg.DecoderConfig(**DEC),
            decode=jcfg.DecodeConfig(**decode), precision="f32",
        ),
        tcfg.Config(
            encoder=tcfg.encoder_config("tiny_cnn"), decoder=tcfg.DecoderConfig(**DEC),
            decode=tcfg.DecodeConfig(**decode), precision="f32",
        ),
    )


def make_pipes(decode=None, seed=0):
    """(tpucap's pipeline, the port's on the same weights): the port's random
    init from ``seed`` (torch's, much quicker than tpucap's eager one) with
    the head sharpened and tilted toward endseq, carried to tpucap by
    ``convert.params_to_numpy``. A random decoder repeats one word;
    ``no_repeat_ngram_size`` 2 (the default here) makes captions differ
    from row to row and end at different steps."""
    jc, tc = _configs({"max_len": 10, "no_repeat_ngram_size": 2, **(decode or {})})
    pipe = CaptioningPipeline(tc, device="cpu")
    pipe.fit_tokenizer(CORPUS)
    pipe.build(seed=seed)
    dec = pipe.params["decoder"]
    dec["out"]["kernel"].mul_(4)
    dec["out"]["bias"][pipe.tokenizer.word_index["endseq"]] += 2.0
    jpipe = JaxPipeline(jc, tokenizer=JaxTokenizer.from_json(pipe.tokenizer.to_json()))
    jpipe.build(init_params=False)
    jpipe.params = jax.tree.map(jnp.asarray, params_to_numpy(pipe.params))
    return jpipe, pipe


@pytest.fixture(scope="module")
def pipes():
    return make_pipes()


def _rows(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 128)).astype(np.float32)


@pytest.mark.parametrize("name", ["lstm1", "attention"])
def test_prime_prefix_matches_tpucap(name):
    jdec, tdec = jax_build_decoder(name, **DIMS), build_decoder(name, **DIMS)
    tp = tdec.init(torch.Generator().manual_seed(7))
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(5, FEAT) if name == "lstm1" else (5, 6, FEAT)).astype(np.float32)
    prefix = rng.integers(3, V, size=(5, 4)).astype(np.int32)
    lengths = np.array([0, 1, 4, 2, 3], np.int32)
    js, jl, jlp = jax.jit(
        lambda p, f, pre, n: jax_prime_prefix(
            jdec.step, p, jdec.init_state(p, f), pre, n, start_id=START, decoder=jdec
        )
    )(jp, jnp.asarray(feats), jnp.asarray(prefix), jnp.asarray(lengths))
    ts, tl, tlp = prime_prefix(
        tdec.step, tp, tdec.init_state(tp, torch.from_numpy(feats)), prefix, lengths,
        start_id=START, decoder=tdec,
    )
    assert set(ts) == set(js)
    for key in js:
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), atol=1e-5, rtol=0, err_msg=key)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tl.numpy(), [START, prefix[1, 0], prefix[2, 3], prefix[3, 1], prefix[4, 2]])
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5, rtol=0)
    assert tlp[0] == 0 and (tlp[1:] < 0).all()
    # A row of length 0 keeps the state init_state gave it.
    init = tdec.init_state(tp, torch.from_numpy(feats))
    for key in ts:
        torch.testing.assert_close(ts[key][0], init[key][0], rtol=0, atol=0)
    # P = 0 is the state itself.
    same, last, lp = prime_prefix(tdec.step, tp, init, np.zeros((5, 0), np.int32), np.zeros(5), start_id=START)
    assert same is init and (last == START).all() and (lp == 0).all()


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_continuation_matches_tpucap(pipes, method):
    jpipe, pipe = pipes
    x = _rows(len(PREFIXES), seed=1)
    want = jpipe.generate_continuation(x, PREFIXES, method=method)
    got = pipe.generate_continuation(x, PREFIXES, method=method)
    assert got == want
    assert got[4].startswith("the man ") and got[3].startswith("two children play soccer in")
    # One shared opening is that string on every row; the empty prefix is
    # generate.
    shared = pipe.generate_continuation(x, "a dog", method=method)
    assert shared == pipe.generate_continuation(x, ["a dog"] * len(x), method=method)
    plain = pipe.generate(x, method=method)
    assert pipe.generate_continuation(x, "", method=method) == plain
    assert len({len(c.split()) for c in plain}) > 1  # captions end at different steps
    # A batch decomposes into its rows, each primed at its own padded length.
    for i in (0, 2, 3, 7):
        assert pipe.generate_continuation(x[i : i + 1], [PREFIXES[i]], method=method) == [got[i]]


def test_continuation_dials_match_tpucap():
    """min_len counts generated tokens only, the n-gram history starts
    after the prefix (size 1 here: no word of the continuation repeats, a
    prefix word may), bad_words and the gnmt length penalty act on the
    continuation, as in tpucap."""
    jpipe, pipe = make_pipes(
        {"min_len": 3, "bad_words": ("grass", "bike"), "length_penalty": "gnmt",
         "no_repeat_ngram_size": 1},
        seed=1,
    )
    x = _rows(len(PREFIXES), seed=2)
    for method in ("greedy", "beam"):
        want = jpipe.generate_continuation(x, PREFIXES, method=method)
        got = pipe.generate_continuation(x, PREFIXES, method=method)
        assert got == want
        heads = pipe.tokenizer.sequences_to_texts(pipe.encode_prefixes(PREFIXES))
        for h, cap in zip(heads, got):
            tail = cap[len(h):].split()
            assert len(tail) >= 3 and not {"grass", "bike"} & set(tail)
            assert len(set(tail)) == len(tail)


class _Capped:
    """A decoder with a KV-cache capacity (tpucap's transformer has one)."""

    def __init__(self, dec, n):
        self._dec, self.max_positions = dec, n

    def __getattr__(self, name):
        return getattr(self._dec, name)


def test_continuation_refusals_match_tpucap(pipes):
    jpipe, pipe = pipes
    x = _rows(2, seed=3)
    for args, kw in (
        ((x, "a zzznotaword dog"), {}),
        ((x, "a"), {"method": "sample"}),
        ((x, ["a", "a", "a"]), {}),
        ((x, ["", "DOG!?"]), {"method": "diverse"}),
    ):
        with pytest.raises(ValueError) as jerr:
            jpipe.generate_continuation(*args, **kw)
        with pytest.raises(ValueError) as err:
            pipe.generate_continuation(*args, **kw)
        assert str(err.value) == str(jerr.value)
    # The KV-cache rule: max(P, longest prefix + max_len) <= max_positions.
    jdec, tdec = jpipe.decoder, pipe.decoder
    try:
        jpipe.decoder, pipe.decoder = _Capped(jdec, 14), _Capped(tdec, 14)
        with pytest.raises(ValueError) as jerr:
            jpipe.generate_continuation(x, ["a black dog runs across", ""])
        with pytest.raises(ValueError) as err:
            pipe.generate_continuation(x, ["a black dog runs across", ""])
        assert str(err.value) == str(jerr.value)
        assert "exceeds decoder.max_positions 14" in str(err.value)
    finally:
        jpipe.decoder, pipe.decoder = jdec, tdec


def test_chunked_priming_refused_by_name():
    """A decoder with ``step_chunk`` (tpucap's KV-cache transformer, now
    ported) is primed in one chunk over [start, p0, .., p_{P-2}], as
    tpucap's ``_prime_chunked``, never through the step loop: ``pos`` set to
    each row's length, ``last`` its last prefix token (start for an empty
    one), logp summed over its own length."""

    class Chunked:
        def __init__(self):
            self.chunks = []

        def step_chunk(self, params, state, tokens):
            self.chunks.append(tokens.clone())
            B, C = tokens.shape
            logits = torch.zeros((B, C, 5))
            logits[:, :, 3] = 1.0
            return logits, dict(state, pos=state["pos"] + C)

    dec = Chunked()
    state = {"pos": torch.zeros(3, dtype=torch.int32)}
    prefix, lengths = np.array([[3, 4, 3], [4, 0, 0], [0, 0, 0]]), np.array([3, 1, 0])
    got, last, logp = prime_prefix(None, None, state, prefix, lengths, start_id=START, decoder=dec)
    assert len(dec.chunks) == 1 and dec.chunks[0].tolist() == [[START, 3, 4], [START, 4, 0], [START, 0, 0]]
    assert got["pos"].tolist() == [3, 1, 0] and got["pos"].dtype == torch.int32
    assert last.tolist() == [3, 4, START]
    lp = np.log(np.e / (np.e + 4.0)), np.log(1.0 / (np.e + 4.0))
    np.testing.assert_allclose(logp.numpy(), [2 * lp[0] + lp[1], lp[1], 0.0], atol=1e-6)
