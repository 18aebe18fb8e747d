"""The port's sampling decode (``tpucap_torch/decode/sample.py``,
``generate(method="sample")``), its n-best list (``generate_n_best``) and
the sampling batch server against tpucap's on the CPU.

- ``sample_decode`` on tpucap's own draws: the engine is handed, a step, the
  Gumbel noise that tpucap's loop draws (``key, sub = split(key)``, then
  ``gumbel(sub, (B, V), f32)``), on lstm1 and the soft-attention decoder
  (the port's random params carried to tpucap by
  ``convert.params_to_numpy``), at temperature, top-k (ties at the k-th
  value included: the logits rounded to halves), top-p, the repetition
  penalty, min_len, bad_words, the n-gram ban and ``init_scores``;
- top_k = 1 is greedy; the argument refusals with tpucap's texts;
- ``generate(method="sample", seed=s)`` reproducible, and its parallelism
  refusal tpucap's;
- ``generate_n_best`` against tpucap's, entry 0 ``generate(method="beam")``;
- a sampling ``CaptionServer`` in features and images mode equals
  ``generate(method="sample")`` on the same (bucket-sized) batch, and its
  refusals of ``prefix`` and ``include_words`` carry tpucap's texts.

A ``seed`` gives other captions than tpucap's: its draws come from a jax
key, which torch cannot reproduce. Tolerance: tokens, lengths and captions
exact; scores within 1e-5 absolute (f32; the packages' log-softmax and
matmuls round differently in the last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.decode.sample import sample_decode as jax_sample_decode
from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.serve import CaptionServer as JaxServer
from tpucap.text import Tokenizer as JaxTokenizer
from tpucap_torch import config as tcfg
from tpucap_torch.convert import params_to_numpy
from tpucap_torch.decode import greedy_decode, sample_decode
from tpucap_torch.models.decoders import build_decoder
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.serve import CaptionServer

torch.set_num_threads(2)

V, FEAT, START, END, B, T = 23, 11, 1, 2, 6, 9
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
        ]
    )
}


@pytest.fixture(scope="module")
def decoders():
    """name -> (tpucap's decoder, its params, the port's decoder, its
    params, features), the port's random init carried to tpucap."""
    out = {}
    rng = np.random.default_rng(5)
    for name in ("lstm1", "attention"):
        jdec, tdec = jax_build_decoder(name, **DIMS), build_decoder(name, **DIMS)
        tp = tdec.init(torch.Generator().manual_seed(5))
        tp["out"]["kernel"].mul_(3)  # sharper: the masks then move the draw
        tp["out"]["bias"][END] += 1.5  # captions end at different steps
        jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
        shape = (B, FEAT) if name == "lstm1" else (B, 5, FEAT)
        out[name] = (jdec, jp, tdec, tp, rng.normal(size=shape).astype(np.float32))
    return out


def _draws(seed):
    """tpucap's loop draws: a split a step, then the step's Gumbel noise."""
    key, out = jax.random.key(seed), []
    for _ in range(T):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.gumbel(sub, (B, V), jnp.float32)))
    return jax.random.key(seed), out


def _halves(step, round_):
    """The step with its logits rounded to halves: ties at the k-th value."""

    def rounded(p, s, tok):
        logits, s = step(p, s, tok)
        return round_(logits * 2) / 2, s

    return rounded


# One tpucap compile a case, so the dials are grouped; each is in one case.
CASES = {
    "plain": {},
    "temperature_top_k_ties": dict(temperature=0.7, top_k=4, ties=True),
    "top_p": dict(top_p=0.6),
    "repetition_penalty": dict(repetition_penalty=1.8),
    "min_len_bad_words_ngram_init_scores": dict(min_len=4, banned_ids=(3, 7), no_repeat_ngram_size=1,
                                                init_scores=True),
    "top_p_top_k_penalty": dict(top_p=0.9, top_k=8, temperature=0.8, repetition_penalty=1.5),
}


@pytest.mark.parametrize("name,case", [("lstm1", c) for c in list(CASES)[:5]]
                         + [("attention", "top_p_top_k_penalty")])
def test_sample_decode_on_tpucaps_draws(decoders, name, case):
    jdec, jp, tdec, tp, feats = decoders[name]
    kw = dict(CASES[case])
    ties = kw.pop("ties", False)
    if kw.pop("init_scores", False):
        kw["init_scores"] = np.linspace(-2.0, 0.0, B).astype(np.float32)
    jstep, tstep = (jdec.step, tdec.step)
    if ties:
        jstep, tstep = _halves(jstep, jnp.round), _halves(tstep, torch.round)
    key, draws = _draws(sum(map(ord, case)))
    common = dict(start_id=START, end_id=END, max_len=T, **kw)
    want = jax.jit(lambda p, f, k: jax_sample_decode(jstep, p, jdec.init_state(p, f), rng=k, **common))(
        jp, jnp.asarray(feats), key)
    with torch.inference_mode():
        got = sample_decode(tstep, tp, tdec.init_state(tp, torch.from_numpy(feats)), draws=draws, **common)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5, rtol=0)
    lengths = got.lengths.numpy()
    assert len(set(lengths.tolist())) > 1 or "min_len" in case, lengths  # rows end apart
    if "banned_ids" in kw:
        assert not np.isin(got.tokens.numpy(), kw["banned_ids"]).any()
        assert (lengths >= 4).all()


def test_top_k_one_is_greedy_and_refusals(decoders):
    _, _, tdec, tp, feats = decoders["lstm1"]
    state = lambda: tdec.init_state(tp, torch.from_numpy(feats))  # noqa: E731
    common = dict(start_id=START, end_id=END, max_len=T)
    with torch.inference_mode():
        got = sample_decode(tdec.step, tp, state(), top_k=1, temperature=0.5,
                            generator=torch.Generator().manual_seed(3), **common)
        want = greedy_decode(tdec.step, tp, state(), **common)
    np.testing.assert_array_equal(got.tokens.numpy(), want.tokens.numpy())
    np.testing.assert_array_equal(got.lengths.numpy(), want.lengths.numpy())
    jdec, jp, *_ = decoders["lstm1"]
    for bad in (dict(temperature=0.0), dict(top_k=0), dict(top_p=0.0), dict(top_p=1.5),
                dict(repetition_penalty=0.0)):
        with pytest.raises(ValueError) as jerr:
            jax_sample_decode(jdec.step, jp, jdec.init_state(jp, jnp.asarray(feats)),
                              rng=jax.random.key(0), **common, **bad)
        with pytest.raises(ValueError) as err:
            sample_decode(tdec.step, tp, state(), generator=torch.Generator(), **common, **bad)
        assert str(err.value) == str(jerr.value), bad


def make_pipes(decode=None):
    """(tpucap's pipeline, the port's) on the port's tiny_cnn + lstm1 random
    weights (embed 16, hidden 32, max_len 10, f32), carried to tpucap."""
    decode = {"max_len": 10, "no_repeat_ngram_size": 2, **(decode or {})}
    kw = dict(encoder=tcfg.encoder_config("tiny_cnn"), decoder=tcfg.DecoderConfig(**DEC),
              decode=tcfg.DecodeConfig(**decode), precision="f32")
    pipe = CaptioningPipeline(tcfg.Config(**kw), device="cpu")
    pipe.fit_tokenizer(CORPUS)
    pipe.build(seed=3)
    pipe.params["decoder"]["out"]["bias"][pipe.tokenizer.word_index["endseq"]] += 2.0
    jpipe = JaxPipeline(
        jcfg.Config(encoder=jcfg.encoder_config("tiny_cnn"), decoder=jcfg.DecoderConfig(**DEC),
                    decode=jcfg.DecodeConfig(**decode), precision="f32"),
        tokenizer=JaxTokenizer.from_json(pipe.tokenizer.to_json()),
    )
    jpipe.build(init_params=False)
    jpipe.params = jax.tree.map(jnp.asarray, params_to_numpy(pipe.params))
    return jpipe, pipe


@pytest.fixture(scope="module")
def pipes():
    return make_pipes()


def _rows(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 128)).astype(np.float32)


def test_generate_sample_is_seeded_and_refuses_parallelism(pipes):
    jpipe, pipe = pipes
    x = _rows(8, 1)
    a = pipe.generate(x, method="sample", seed=4, top_p=0.9, temperature=1.3)
    assert a == pipe.generate(x, method="sample", seed=4, top_p=0.9, temperature=1.3)
    assert a != pipe.generate(x, method="sample", seed=5, top_p=0.9, temperature=1.3)
    assert len(set(a)) > 1
    with pytest.raises(ValueError) as jerr:
        jpipe.generate(x, method="sample", parallelism="dp")
    with pytest.raises(ValueError) as err:
        pipe.generate(x, method="sample", parallelism="dp")
    assert str(err.value) == str(jerr.value) == "sampling decode does not support parallelism"
    with pytest.raises(NotImplementedError, match="parallelism='tp' is not ported"):
        pipe.generate(x, method="beam", parallelism="tp")
    with pytest.raises(ValueError) as jerr:
        jpipe.generate_submit(x, method="sample")
    with pytest.raises(ValueError) as err:
        pipe.generate_submit(x, method="sample")
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("decode,n", [({}, None), ({"length_penalty": "gnmt", "alpha": 0.7, "beam_width": 4}, 3)])
def test_generate_n_best_matches_tpucap(decode, n):
    jpipe, pipe = make_pipes(decode)
    x = _rows(5, 2)
    want = jpipe.generate_n_best(x, n=n)
    got = pipe.generate_n_best(x, n=n)
    assert [[c for c, _ in row] for row in got] == [[c for c, _ in row] for row in want]
    np.testing.assert_allclose([[s for _, s in row] for row in got],
                               [[s for _, s in row] for row in want], atol=1e-5, rtol=0)
    assert [row[0][0] for row in got] == pipe.generate(x, method="beam")
    k = pipe.config.decode.beam_width
    assert all(len(row) == (n or k) for row in got)
    with pytest.raises(ValueError) as jerr:
        jpipe.generate_n_best(x, n=k + 1)
    with pytest.raises(ValueError) as err:
        pipe.generate_n_best(x, n=k + 1)
    assert str(err.value) == str(jerr.value)


def test_sampling_server_matches_generate(pipes):
    jpipe, pipe = pipes
    x = _rows(4, 3)
    images = np.random.default_rng(3).uniform(size=(4, 32, 32, 3)).astype(np.float32)
    with CaptionServer(pipe, max_batch=4, max_delay_ms=500, method="sample") as srv:
        got = [f.result(60) for f in srv.submit_many(x)]
    assert got == pipe.generate(x, method="sample")
    with CaptionServer(pipe, mode="images", max_batch=4, max_delay_ms=500, method="sample") as srv:
        got = [f.result(60) for f in srv.submit_many(images)]
    assert got == pipe.generate(pipe.encode_images(images), method="sample")
    with JaxServer(jpipe, max_batch=4, method="sample") as jsrv, CaptionServer(
        pipe, max_batch=4, method="sample"
    ) as srv:
        for kw in (dict(prefix="a dog"), dict(include_words=["dog"])):
            with pytest.raises(ValueError) as jerr:
                jsrv.submit(x[0], **kw)
            with pytest.raises(ValueError) as err:
                srv.submit(x[0], **kw)
            assert str(err.value) == str(jerr.value), kw
