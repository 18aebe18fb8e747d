"""The rest of the decode toolkit in the port against tpucap's, on the CPU:
diverse beam search (``decode/diverse.py``, ``generate_diverse``), the
product-of-experts ensemble (``decode/ensemble.py``,
``generate_ensemble``), MBR reranking (``decode/mbr.py``, the smoothed
sentence BLEU of ``train/evaluate.py``, ``generate_mbr``) and the attention
maps (``generate_with_attention``).

- ``diverse_beam_decode`` on tpucap's lstm1 and soft-attention decoders
  (the attention grids are the shared keys) at G in {1, 2, 3}, k' in {1,
  2, 3}, lambda in {0, 0.5, 5}, with min_len, banned ids, the n-gram ban
  and both length penalties; the port's random params carried to tpucap
  by ``convert.params_to_numpy``. G = 1 is the port's ``beam_decode`` of
  width k', and lambda = 0 makes every group that beam;
- the pipelines: tiny_cnn + lstm1 (embed 16, hidden 32, max_len 10, f32)
  and tiny_cnn spatial + the attention decoder, each the port's random
  init with the head sharpened and tilted toward endseq, carried to
  tpucap; tpucap's pipelines are built once per module (``conftest.py``
  clears jax's caches per module);
- the sentence BLEU against NLTK's ``sentence_bleu(...,
  smoothing_function=method1)`` and ``mbr_select`` against tpucap's on
  hand-made and random pools (one-word, empty and unmatched hypotheses
  among them);
- ``caption --dump-attention`` through ``main(..., device="cpu")`` on a
  small attention checkpoint of the port.

Tolerances: tokens, lengths, captions, MBR picks and every refusal text
exact; scores 1e-5 absolute (sums of up to 10 f32 log-probs, whose
matmuls and logsumexp round differently in the two packages); MBR
utilities and sentence BLEU 1e-12 absolute (host float64 arithmetic);
alphas 1e-5 absolute, every row, those past a caption's end included.
"""

import contextlib
import importlib
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from nltk.translate.bleu_score import SmoothingFunction
from nltk.translate.bleu_score import sentence_bleu as nltk_sentence_bleu

from tpucap import config as jcfg
from tpucap.decode import EnsembleDecoder as JaxEnsemble
from tpucap.decode import diverse_beam_decode as jax_diverse
from tpucap.decode import mbr_select as jax_mbr_select
from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.text import Tokenizer as JaxTokenizer
from tpucap_torch import config as tcfg
from tpucap_torch.convert import params_to_numpy
from tpucap_torch.decode import (
    DiverseBeamResult,
    EnsembleDecoder,
    beam_decode,
    diverse_beam_decode,
    mbr_select,
)
from tpucap_torch.models.decoders import build_decoder
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.train.evaluate import sentence_bleu

torch.set_num_threads(2)

V, FEAT, START, END, B = 23, 11, 1, 2, 4
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
FIELDS = ("tokens", "lengths", "beam_tokens", "beam_lengths")


def _decoder(name, seed, tilt=0.5):
    """tpucap's decoder and the port's on the port's random params from
    ``seed``, the head tilted toward END so that beams end at different
    steps."""
    tdec = build_decoder(name, **DIMS)
    tp = tdec.init(torch.Generator().manual_seed(seed))
    tp["out"]["kernel"].mul_(3)
    tp["out"]["bias"][END] += tilt
    return jax_build_decoder(name, **DIMS), jax.tree.map(jnp.asarray, params_to_numpy(tp)), tdec, tp


def _features(name, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, FEAT) if name == "lstm1" else (B, 6, FEAT)).astype(np.float32)


def _check(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    for f in ("scores", "beam_scores"):
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)), atol=1e-5, rtol=0, err_msg=f)


# name, G, k', lambda, max_len, min_len, banned, n-gram, penalty
_DIVERSE = [
    ("lstm1", 1, 3, 0.5, 10, 0, (), 0, "simple"),
    ("lstm1", 2, 2, 0.0, 10, 0, (4,), 0, "simple"),
    ("lstm1", 2, 3, 0.5, 10, 2, (4,), 0, "gnmt"),
    ("lstm1", 3, 1, 5.0, 10, 0, (), 2, "simple"),
    ("lstm1", 3, 2, 0.5, 10, 1, (4, 7), 2, "gnmt"),
    ("lstm1", 3, 3, 5.0, 10, 0, (), 0, "simple"),
    ("attention", 2, 2, 0.5, 8, 1, (4,), 0, "simple"),
    ("attention", 3, 3, 5.0, 8, 0, (), 2, "gnmt"),
    ("attention", 3, 1, 0.0, 8, 2, (), 0, "simple"),
]


@pytest.mark.parametrize("name,G,kg,lam,max_len,min_len,banned,ngram,penalty", _DIVERSE)
def test_diverse_engine_matches_tpucap(name, G, kg, lam, max_len, min_len, banned, ngram, penalty):
    jdec, jp, tdec, tp = _decoder(name, seed=10 * G + kg)
    feats = _features(name, seed=G + kg)
    kw = dict(
        start_id=START, end_id=END, max_len=max_len, num_groups=G, group_width=kg,
        diversity=lam, min_len=min_len, banned_ids=banned, no_repeat_ngram_size=ngram,
        length_penalty=penalty,
    )
    want = jax.jit(lambda p, f: jax_diverse(jdec.step, p, jdec.init_state(p, f), decoder=jdec, **kw))(
        jp, jnp.asarray(feats)
    )
    got = diverse_beam_decode(tdec.step, tp, tdec.init_state(tp, torch.from_numpy(feats)), decoder=tdec, **kw)
    assert isinstance(got, DiverseBeamResult)
    _check(got, want)
    assert got.tokens.shape == (B, G, max_len) and got.beam_tokens.shape == (B, G, kg, max_len)
    if banned:
        assert not np.isin(got.beam_tokens.numpy(), banned).any()
    if G == 1 or lam == 0.0:
        # Every group is the port's own beam search of width k', bit for bit.
        beam = beam_decode(
            tdec.step, tp, tdec.init_state(tp, torch.from_numpy(feats)), start_id=START,
            end_id=END, max_len=max_len, beam_width=kg, min_len=min_len, banned_ids=banned,
            no_repeat_ngram_size=ngram, length_penalty=penalty, decoder=tdec,
        )
        for g in range(G):
            for f in ("tokens", "lengths", "scores"):
                np.testing.assert_array_equal(
                    getattr(got, f)[:, g].numpy(), getattr(beam, f).numpy(), err_msg=f)
            for f in ("beam_tokens", "beam_lengths", "beam_scores"):
                np.testing.assert_array_equal(
                    getattr(got, f)[:, g].numpy(), getattr(beam, f).numpy(), err_msg=f)
    elif lam == 5.0:
        # A large penalty keeps a later group off the earlier groups' first
        # words where the vocabulary leaves it another.
        first = got.tokens[:, :, 0].numpy()
        assert any(len(set(row)) > 1 for row in first)


def test_diverse_engine_refusal_matches_tpucap():
    jdec, jp, tdec, tp = _decoder("lstm1", seed=0)
    for G, kg in ((0, 2), (2, 0)):
        kw = dict(start_id=START, end_id=END, max_len=4, num_groups=G, group_width=kg)
        with pytest.raises(ValueError) as jerr:
            jax_diverse(jdec.step, jp, jdec.init_state(jp, jnp.zeros((2, FEAT))), **kw)
        with pytest.raises(ValueError) as err:
            diverse_beam_decode(tdec.step, tp, tdec.init_state(tp, torch.zeros(2, FEAT)), **kw)
        assert str(err.value) == str(jerr.value)


# -- the ensemble's decoder ----------------------------------------------------------------

def test_ensemble_decoder_step_and_refusals_match_tpucap():
    """The weighted log-prob sum of an lstm1 + attention pair, and the flat
    ``m{i}/`` state with its prefixed shared keys, against tpucap's; the
    weight checks with tpucap's texts."""
    ja, jpa, ta, tpa = _decoder("lstm1", seed=1)
    jb, jpb, tb, tpb = _decoder("attention", seed=2)
    pooled, grid = _features("lstm1", 3), _features("attention", 4)
    jens, tens = JaxEnsemble([ja, jb], weights=[1.0, 3.0]), EnsembleDecoder([ta, tb], weights=[1.0, 3.0])
    assert tens.weights == jens.weights and tens.beam_shared_keys == jens.beam_shared_keys
    jstate = jens.init_state((jpa, jpb), (jnp.asarray(pooled), jnp.asarray(grid)))
    tstate = tens.init_state((tpa, tpb), (torch.from_numpy(pooled), torch.from_numpy(grid)))
    assert sorted(tstate) == sorted(jstate)
    tok = np.array([START, 5, 9, END])
    want, jnew = jax.jit(jens.step)((jpa, jpb), jstate, jnp.asarray(tok))
    got, tnew = tens.step((tpa, tpb), tstate, torch.from_numpy(tok))
    assert got.dtype == torch.float32 and sorted(tnew) == sorted(jnew)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for decoders, weights in (([], None), ([ta, tb], [1.0]), ([ta, tb], [1.0, -1.0])):
        with pytest.raises(ValueError) as jerr:
            JaxEnsemble([ja, jb][: len(decoders)], weights=weights)
        with pytest.raises(ValueError) as err:
            EnsembleDecoder(decoders, weights=weights)
        assert str(err.value) == str(jerr.value)


# -- the pipelines -------------------------------------------------------------------------

def make_pipes(seed=0, decoder="lstm1", decode=None):
    """(tpucap's pipeline, the port's) on the port's random init from
    ``seed``, the head sharpened and tilted toward endseq, carried to
    tpucap."""
    features = "spatial" if decoder == "attention" else "pooled"
    decode = {"max_len": 10, **(decode or {})}
    parts = lambda m: dict(  # noqa: E731
        encoder=m.encoder_config("tiny_cnn", features), decoder=m.DecoderConfig(name=decoder, **DEC),
        decode=m.DecodeConfig(**decode), precision="f32",
    )
    pipe = CaptioningPipeline(tcfg.Config(**parts(tcfg)), device="cpu")
    pipe.fit_tokenizer(CORPUS)
    pipe.build(seed=seed)
    dec = pipe.params["decoder"]
    dec["out"]["kernel"].mul_(4)
    dec["out"]["bias"][pipe.tokenizer.word_index["endseq"]] += 2.0
    jpipe = JaxPipeline(jcfg.Config(**parts(jcfg)), tokenizer=JaxTokenizer.from_json(pipe.tokenizer.to_json()))
    jpipe.build(init_params=False)
    jpipe.params = jax.tree.map(jnp.asarray, params_to_numpy(pipe.params))
    return jpipe, pipe


@pytest.fixture(scope="module")
def pipes():
    """{"a": lstm1 seed 0 with no_repeat_ngram 2, "b": lstm1 seed 1,
    "att": the attention decoder seed 2}, each (tpucap's, the port's)."""
    return {
        "a": make_pipes(0, decode={"no_repeat_ngram_size": 2}),
        "b": make_pipes(1),
        "att": make_pipes(2, decoder="attention", decode={"max_len": 8}),
    }


def _rows(n, seed, spatial=False):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 16, 128) if spatial else (n, 128)).astype(np.float32)


def _same_groups(got, want):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert [c for c, _ in g_row] == [c for c, _ in w_row]
        np.testing.assert_allclose([s for _, s in g_row], [s for _, s in w_row], atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [dict(num_groups=3, group_width=2), dict(num_groups=2, diversity=0.0)])
def test_generate_diverse_matches_tpucap(pipes, kw):
    jpipe, pipe = pipes["a"]
    x = _rows(5, seed=1)
    got = pipe.generate_diverse(x, **kw)
    _same_groups(got, jpipe.generate_diverse(x, **kw))
    assert all(len(row) == kw["num_groups"] for row in got)
    if kw.get("diversity") == 0.0:
        # Each group is the beam of width config.decode.beam_width.
        beam = pipe.generate(x, method="beam")
        assert all(cap == b for row, b in zip(got, beam) for cap, _ in row)


def test_generate_mbr_matches_tpucap(pipes):
    """beam and diverse pools give tpucap's picks and pools exactly; the
    sampled pools are the port's own ``generate(method="sample",
    seed=seed + i)``, and the pick is ``mbr_select``'s over them."""
    jpipe, pipe = pipes["a"]
    x = _rows(5, seed=2)
    for kw in (
        dict(candidates="beam", n_candidates=4, metric="cider"),
        dict(candidates="beam", n_candidates=2, beam_width=3, metric="bleu4"),
        dict(candidates="diverse", n_candidates=3, beam_width=2, diversity=0.5),
        dict(candidates="diverse", n_candidates=2, metric="bleu4", diversity=5.0),
    ):
        got = pipe.generate_mbr(x, return_candidates=True, **kw)
        assert got == jpipe.generate_mbr(x, return_candidates=True, **kw), kw
        assert pipe.generate_mbr(x, **kw) == got[0]
    kw = dict(n_candidates=4, temperature=1.5, top_k=6, seed=7)
    caps, pools = pipe.generate_mbr(x, return_candidates=True, **kw)
    runs = [pipe.generate(x, method="sample", temperature=1.5, top_k=6, seed=7 + i) for i in range(4)]
    assert pools == [list(p) for p in zip(*runs)]
    picks, _ = mbr_select(pools)
    assert caps == [pool[i] for pool, i in zip(pools, picks)]
    for bad in (dict(candidates="greedy"), dict(n_candidates=0), dict(candidates="beam", metric="rouge")):
        with pytest.raises(ValueError) as jerr:
            jpipe.generate_mbr(x[:1], **bad)
        with pytest.raises(ValueError) as err:
            pipe.generate_mbr(x[:1], **bad)
        assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_generate_ensemble_matches_tpucap(pipes, method):
    """A singleton (``generate``'s captions), two lstm1 members, one-hot
    weights (member 0's ``generate``) and the lstm1 + attention pair on
    per-member features."""
    (ja, pa), (jb, pb), (jt, pt) = pipes["a"], pipes["b"], pipes["att"]
    x, grid = _rows(5, seed=3), _rows(5, seed=4, spatial=True)
    kw = dict(method=method, beam_width=3)
    single = pa.generate_ensemble(x, [], **kw)
    assert single == ja.generate_ensemble(x, [], **kw) == pa.generate(x, **kw)
    pair = pa.generate_ensemble(x, [pb], **kw)
    assert pair == ja.generate_ensemble(x, [jb], **kw)
    one_hot = pa.generate_ensemble(x, [pb], weights=[1.0, 0.0], **kw)
    assert one_hot == ja.generate_ensemble(x, [jb], weights=[1.0, 0.0], **kw) == single
    mixed = pb.generate_ensemble([x, grid], [pt], weights=[0.4, 0.6], **kw)
    assert mixed == jb.generate_ensemble([x, grid], [jt], weights=[0.4, 0.6], **kw)
    assert len(set(mixed)) > 1


def test_generate_ensemble_refusals_match_tpucap(pipes):
    (ja, pa), (jb, pb) = pipes["a"], pipes["b"]
    x = _rows(2, seed=5)
    cases = [
        (dict(features=x, others=[pb], method="sample"), dict(features=x, others=[jb], method="sample")),
        (dict(features=[x], others=[pb]), dict(features=[x], others=[jb])),
        (dict(features=x, others=[pb], weights=[1.0]), dict(features=x, others=[jb], weights=[1.0])),
    ]
    for ours, theirs in cases:
        with pytest.raises(ValueError) as jerr:
            ja.generate_ensemble(theirs.pop("features"), theirs.pop("others"), **theirs)
        with pytest.raises(ValueError) as err:
            pa.generate_ensemble(ours.pop("features"), ours.pop("others"), **ours)
        assert str(err.value) == str(jerr.value)
    # A member with another vocabulary: tpucap's text, before any decode.
    with pytest.MonkeyPatch.context() as mp:
        for tok in (pb.tokenizer, jb.tokenizer):
            mp.setattr(tok, "word_index", {**tok.word_index, "zebra": 99})
        with pytest.raises(ValueError) as jerr:
            ja.generate_ensemble(x, [jb])
        with pytest.raises(ValueError) as err:
            pa.generate_ensemble(x, [pb])
    assert str(err.value) == str(jerr.value) and "different tokenizer" in str(err.value)


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_generate_with_attention_matches_tpucap(pipes, method):
    jpipe, pipe = pipes["att"]
    grid = _rows(4, seed=6, spatial=True)
    caps, alphas, lengths = pipe.generate_with_attention(grid, method=method, beam_width=2)
    jcaps, jalphas, jlengths = jpipe.generate_with_attention(grid, method=method, beam_width=2)
    assert caps == jcaps == pipe.generate(grid, method=method, beam_width=2)
    assert lengths.dtype == np.int32 and alphas.dtype == np.float32
    np.testing.assert_array_equal(lengths, np.asarray(jlengths))
    assert alphas.shape == (4, 8, 16) and len(set(lengths.tolist())) > 1
    np.testing.assert_allclose(alphas, np.asarray(jalphas), atol=1e-5, rtol=0)
    np.testing.assert_allclose(alphas.sum(-1), 1.0, atol=1e-5)


def test_generate_with_attention_refusals_match_tpucap(pipes):
    for key, kw in (("a", {}), ("att", dict(method="sample"))):
        jpipe, pipe = pipes[key]
        x = _rows(1, seed=7, spatial=key == "att")
        with pytest.raises(ValueError) as jerr:
            jpipe.generate_with_attention(x, **kw)
        with pytest.raises(ValueError) as err:
            pipe.generate_with_attention(x, **kw)
        assert str(err.value) == str(jerr.value)


# -- MBR's utilities -----------------------------------------------------------------------

_HAND = [
    ["a dog runs", "a dog runs fast", "the cat sleeps", "a dog"],
    ["dog", "dog", "dog"],
    ["", "a man rides a bike", "a man rides"],
    ["zebra", "a child kicks a ball", "a child kicks the ball", "two children play"],
    ["only one"],
    ["x y z w v", "x y z w v", "q r s t u"],
]


def _random_pools(seed, n_pools=12):
    rng = np.random.default_rng(seed)
    words = "a the dog cat man runs on grass red ball".split()
    pools = []
    for _ in range(n_pools):
        n = int(rng.integers(1, 6))
        pools.append([" ".join(rng.choice(words, size=int(rng.integers(0, 9)))) for _ in range(n)])
    return pools


@pytest.mark.parametrize("seed", [0, 1])
def test_sentence_bleu_matches_nltk_method1(seed):
    smooth = SmoothingFunction().method1
    for pool in _HAND + _random_pools(seed):
        toks = [c.split() for c in pool]
        for i, hyp in enumerate(toks):
            refs = toks[:i] + toks[i + 1:] or [["a", "dog"]]
            want = float(nltk_sentence_bleu(refs, hyp, smoothing_function=smooth))
            assert abs(sentence_bleu(refs, hyp) - want) <= 1e-12, (refs, hyp)


@pytest.mark.parametrize("metric", ["cider", "bleu4"])
def test_mbr_select_matches_tpucap(metric):
    for pools in (_HAND, _random_pools(2), _random_pools(3)):
        picks, utils = mbr_select(pools, metric=metric)
        jpicks, jutils = jax_mbr_select(pools, metric=metric)
        assert picks == jpicks
        np.testing.assert_allclose(utils, jutils, atol=1e-12, rtol=0)
    assert mbr_select([], metric=metric) == ([], [])
    assert mbr_select([["one caption"]], metric=metric) == ([0], [0.0])
    assert mbr_select([["a b", "a b", "a b"]], metric=metric)[0] == [0]
    with pytest.raises(ValueError) as jerr:
        jax_mbr_select(_HAND, metric="rouge")
    with pytest.raises(ValueError) as err:
        mbr_select(_HAND, metric="rouge")
    assert str(err.value) == str(jerr.value)


# -- caption --dump-attention --------------------------------------------------------------

def test_cli_dump_attention_writes_tpucaps_keys(tmp_path):
    """``caption --decoder attention --features-kind spatial
    --dump-attention`` on a checkpoint that the port's ``train`` wrote: the
    npz holds tpucap's keys and dtypes, and its maps, lengths and captions
    are the restored pipeline's ``generate_with_attention`` on the images'
    features."""
    from tpucap.data import generate_fixture_dataset

    cli = importlib.import_module("tpucap_torch.cli.main")
    img_dir, tokens, train, _ = generate_fixture_dataset(tmp_path / "data", n_images=4, image_size=32, seed=5)
    model = ["--encoder", "tiny_cnn", "--features-kind", "spatial", "--decoder", "attention",
             "--embed-dim", "16", "--hidden-dim", "32", "--max-len", "8"]
    feats, ckpt, out = str(tmp_path / "f.npz"), str(tmp_path / "ckpt"), str(tmp_path / "att.npz")
    images = sorted(str(p) for p in Path(img_dir).glob("*.jpg"))
    stderr = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(stderr):
        cli.main(["extract", *model, "--images", str(img_dir), "--out", feats, "--batch-size", "4"], device="cpu")
        cli.main(["train", *model, "--tokens", tokens, "--split", train, "--features", feats,
                  "--checkpoint-dir", ckpt, "--epochs", "1", "--batch-size", "4"], device="cpu")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            cli.main(["caption", *model, "--image", *images, "--checkpoint-dir", ckpt,
                      "--method", "greedy", "--dump-attention", out], device="cpu")
    got = np.load(out)
    assert got.files == ["alphas", "lengths", "captions", "images", "spatial_positions"]
    assert got["alphas"].dtype == np.float32 and got["lengths"].dtype == np.int32
    assert got["captions"].dtype.kind == "U" and got["images"].dtype.kind == "U"
    assert got["spatial_positions"].dtype == np.int32 and int(got["spatial_positions"]) == 16
    assert got["alphas"].shape == (4, 8, 16) and list(got["images"]) == images
    assert stderr.getvalue().splitlines()[-1] == f"wrote attention maps (4, 8, 16) to {out}"
    args = cli.build_parser()[0].parse_args(["caption", *model, "--image", *images, "--checkpoint-dir", ckpt])
    pipe = cli._restore_pipeline(args, torch.device("cpu"))
    caps, alphas, lengths = pipe.generate_with_attention(pipe.extract_features(images), method="greedy")
    assert list(got["captions"]) == caps
    assert printed.getvalue().splitlines() == [f"{p}\t{c}" for p, c in zip(images, caps)]
    np.testing.assert_array_equal(got["lengths"], lengths)
    np.testing.assert_array_equal(got["alphas"], alphas)
