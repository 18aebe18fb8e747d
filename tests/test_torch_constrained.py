"""Constrained beam search in the port (``tpucap_torch/decode/constrained.py``,
``CaptioningPipeline.generate_constrained``) against tpucap's on the CPU,
and the dials through the port's batch server and CLI.

- ``constrained_beam_decode`` at C = 1, 2 and 3 (padded to 4), with pad
  slots in some rows, min_len, banned ids and the gnmt penalty, on tpucap's
  lstm1 and soft-attention decoders (the attention grids are the beam's
  shared keys), the port's random params carried to tpucap by
  ``convert.params_to_numpy``; a max_len too short for every word, so the
  fallback bank and the dead slots are exercised;
- ``_constraint_ids``' refusals and ``generate_constrained(return_details=
  True)`` on a tiny_cnn + lstm1 pipeline (embed 16, hidden 32, max_len 10,
  f32, the port's random weights with the head sharpened and tilted toward
  endseq, carried to tpucap);
- the batch server with plain, prefixed and constrained requests in one
  window (features and images mode), each reply the offline call's on the
  same row; ``caption --prefix`` / ``--include-words`` offline and through
  ``--server``.

Tolerance: every ``ConstrainedBeamResult`` field exact (tokens, lengths,
satisfied, num_satisfied and every bank's beams, dead slots included),
except the scores: 1e-5 absolute on sums of up to 12 f32 log-probs (the
two packages' matmuls and logsumexp round differently in the last bits).
Captions and satisfaction dicts exact; the details' normalized score within
1e-5 absolute.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.decode import constrained_beam_decode as jax_constrained
from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.text import Tokenizer as JaxTokenizer
from tpucap_torch import config as tcfg
from tpucap_torch.convert import params_to_numpy
from tpucap_torch.decode import MAX_CONSTRAINTS, ConstrainedBeamResult, constrained_beam_decode
from tpucap_torch.models.decoders import build_decoder
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.serve import CaptionServer

torch.set_num_threads(2)

V, FEAT, START, END, B = 23, 11, 1, 2, 5
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
MODEL_FLAGS = ["--encoder", "tiny_cnn", "--embed-dim", "16", "--hidden-dim", "32", "--max-len", "10"]
FIELDS = ("tokens", "lengths", "satisfied", "num_satisfied", "beam_tokens", "beam_lengths")


def _decoder(name, seed, tilt=0.0):
    """tpucap's decoder and the port's, on the port's random params from
    ``seed`` (the head tilted toward END by ``tilt``, so that beams finish
    at different steps) carried to tpucap by ``convert.params_to_numpy``."""
    tdec = build_decoder(name, **DIMS)
    tp = tdec.init(torch.Generator().manual_seed(seed))
    tp["out"]["bias"][END] += tilt
    return jax_build_decoder(name, **DIMS), jax.tree.map(jnp.asarray, params_to_numpy(tp)), tdec, tp


def _constraints(C, seed):
    """(B, C) distinct ids per row, not pad/START/END/banned 4; row 0's last
    slot and, for C > 1, all but row 1's first slot padded (pre-satisfied)."""
    rng = np.random.default_rng(seed)
    cids = np.stack([rng.choice(np.arange(5, V), size=C, replace=False) for _ in range(B)])
    cids[0, -1] = 0
    if C > 1:
        cids[1, 1:] = 0
    return cids.astype(np.int32)


def _check(got, want):
    assert isinstance(got, ConstrainedBeamResult)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    for f in ("scores", "beam_scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "name,C,max_len,min_len,penalty,tilt",
    [
        ("lstm1", 1, 12, 0, "simple", 0.5),
        ("lstm1", 2, 12, 3, "gnmt", 0.5),
        ("lstm1", 3, 12, 2, "simple", 0.5),
        ("lstm1", 2, 1, 0, "simple", 0.5),  # unreachable: 2 words in 1 token
        ("attention", 1, 8, 1, "simple", 0.0),
    ],
)
def test_constrained_engine_matches_tpucap(name, C, max_len, min_len, penalty, tilt):
    jdec, jp, tdec, tp = _decoder(name, seed=C + max_len, tilt=tilt)
    rng = np.random.default_rng(C)
    feats = rng.normal(size=(B, FEAT) if name == "lstm1" else (B, 6, FEAT)).astype(np.float32)
    cids = _constraints(C, seed=C + max_len)
    if C == 3:  # the engine's widest program: C padded to 4 with pad slots
        cids = np.concatenate([cids, np.zeros((B, 1), np.int32)], axis=1)
    kw = dict(
        start_id=START, end_id=END, max_len=max_len, beam_width=3, min_len=min_len,
        banned_ids=(4,), length_penalty=penalty,
    )
    want = jax.jit(
        lambda p, f, c: jax_constrained(
            jdec.step, p, jdec.init_state(p, f), constraint_ids=c, decoder=jdec, **kw
        )
    )(jp, jnp.asarray(feats), jnp.asarray(cids))
    got = constrained_beam_decode(
        tdec.step, tp, tdec.init_state(tp, torch.from_numpy(feats)), constraint_ids=cids,
        decoder=tdec, **kw,
    )
    _check(got, want)
    n_real = (cids != 0).sum(1)
    real_satisfied = got.num_satisfied.numpy() - (cids == 0).sum(1)  # pad slots read satisfied
    short = n_real > max_len
    if max_len == 1:
        # The fallback: rows with more words than tokens end in the
        # most-satisfied reachable bank; banks the decode could not reach
        # stay dead (NEG_INF), their slots still walked.
        assert short.any() and (real_satisfied[short] < n_real[short]).all()
        assert (got.beam_scores.numpy() < -1e29).any()
    else:
        assert len(set(got.lengths.tolist())) > 1
    assert (real_satisfied[~short] == n_real[~short]).all()
    assert not np.isin(got.tokens.numpy(), [4]).any()


def test_constrained_engine_refuses_slot_counts():
    jdec, jp, tdec, tp = _decoder("lstm1", seed=0)
    state = tdec.init_state(tp, torch.zeros(2, FEAT))
    kw = dict(start_id=START, end_id=END, max_len=4, beam_width=2)
    for cids in (np.zeros((2, 0), np.int32), np.full((2, MAX_CONSTRAINTS + 1), 5)):
        with pytest.raises(ValueError) as jerr:
            jax_constrained(jdec.step, jp, jdec.init_state(jp, jnp.zeros((2, FEAT))),
                            constraint_ids=jnp.asarray(cids), **kw)
        with pytest.raises(ValueError) as err:
            constrained_beam_decode(tdec.step, tp, state, constraint_ids=cids, **kw)
        assert str(err.value) == str(jerr.value)


def make_pipes(decode=None, seed=0):
    """(tpucap's pipeline, the port's on the same weights): the port's random
    init from ``seed`` with the head sharpened and tilted toward endseq,
    carried to tpucap by ``convert.params_to_numpy``."""
    decode = {"max_len": 10, **(decode or {})}
    pipe = CaptioningPipeline(
        tcfg.Config(encoder=tcfg.encoder_config("tiny_cnn"), decoder=tcfg.DecoderConfig(**DEC),
                    decode=tcfg.DecodeConfig(**decode), precision="f32"),
        device="cpu",
    )
    pipe.fit_tokenizer(CORPUS)
    pipe.build(seed=seed)
    dec = pipe.params["decoder"]
    dec["out"]["kernel"].mul_(4)
    dec["out"]["bias"][pipe.tokenizer.word_index["endseq"]] += 2.0
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
    return make_pipes({"bad_words": ("bike",)})


def _rows(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 128)).astype(np.float32)


_REFUSALS = [
    ([], 2, None),
    (["dog"], 0, None),
    ([["dog"], ["man"], ["grass"]], 2, None),
    (["a dog"], 2, None),
    (["zzznotaword"], 2, None),
    (["Startseq"], 2, None),
    (["endseq"], 2, None),
    (["bike"], 2, None),
    (["dog", "Dog!"], 2, None),
    ([["dog"], ["man", "red", "street", "rock", "wall"]], 2, None),
    (["dog", "grass"], 2, 1),
    (["dog"], 2, 5),
]


@pytest.mark.parametrize("words,batch,num_slots", _REFUSALS)
def test_constraint_ids_refusals_match_tpucap(pipes, words, batch, num_slots):
    jpipe, pipe = pipes
    with pytest.raises(ValueError) as jerr:
        jpipe._constraint_ids(words, batch, num_slots)
    with pytest.raises(ValueError) as err:
        pipe._constraint_ids(words, batch, num_slots)
    assert str(err.value) == str(jerr.value)


def test_constraint_ids_caps_and_pads_like_tpucap():
    """A num_words cap: a word at or above it is refused with tpucap's text
    (and bad_words drops it), through the one shared vocabulary rule; ids
    and padding otherwise equal tpucap's."""
    jpipe, pipe = make_pipes({"bad_words": ("dog", "street")})
    jpipe.tokenizer.num_words = pipe.tokenizer.num_words = 20
    capped = next(w for w, i in pipe.tokenizer.word_index.items() if i >= 20)
    assert pipe._banned_ids() == tuple(jpipe._banned_ids())
    assert pipe._normalize_vocab_entry(f"A {capped}!") == jpipe._normalize_vocab_entry(f"A {capped}!")
    with pytest.raises(ValueError) as jerr:
        jpipe._constraint_ids([capped], 1)
    with pytest.raises(ValueError) as err:
        pipe._constraint_ids([capped], 1)
    assert str(err.value) == str(jerr.value) and "num_words cap" in str(err.value)
    low = [w for w, i in pipe.tokenizer.word_index.items() if i < 20 and w not in ("startseq", "endseq", "dog")]
    words = [low[:2], [], low[2:3]]
    np.testing.assert_array_equal(pipe._constraint_ids(words, 3, 4), jpipe._constraint_ids(words, 3, 4))
    jpipe, pipe = make_pipes({"no_repeat_ngram_size": 2})
    with pytest.raises(NotImplementedError) as jerr:
        jpipe.generate_constrained(_rows(1, 0), ["man"])
    with pytest.raises(NotImplementedError) as err:
        pipe.generate_constrained(_rows(1, 0), ["man"])
    assert str(err.value) == str(jerr.value)


def test_generate_constrained_matches_tpucap(pipes):
    jpipe, pipe = pipes
    x = _rows(6, seed=4)
    for words, kw in (
        (["grass", "man"], {}),
        ([["dog"], ["man", "red", "bicycle"], [], ["soccer", "park"], ["rock"], ["the", "a", "wall"]],
         {"beam_width": 2}),
    ):
        want = jpipe.generate_constrained(x, words, return_details=True, **kw)
        got = pipe.generate_constrained(x, words, return_details=True, **kw)
        assert pipe.generate_constrained(x, words, **kw) == [g["caption"] for g in got]
        for g, w in zip(got, want):
            assert (g["caption"], g["satisfied"], g["num_satisfied"]) == (
                w["caption"], w["satisfied"], w["num_satisfied"]
            )
            assert abs(g["score"] - w["score"]) <= 1e-5
            for word, ok in g["satisfied"].items():
                assert ok == (word in g["caption"].split())
    # num_slots pads the constraint axis without changing a caption.
    fin = pipe.generate_constrained_submit(x, ["dog"], num_slots=4, return_details=True)
    assert [d["caption"] for d in fin()] == pipe.generate_constrained(x, ["dog"])


def _offline(pipe, rows, dial):
    prefix, words = dial
    if words:
        return pipe.generate_constrained(rows, [list(words)])[0]
    if prefix:
        return pipe.generate_continuation(rows, prefix, method="beam")[0]
    return pipe.generate(rows, method="beam")[0]


@pytest.mark.parametrize("mode", ["features", "images"])
def test_server_window_of_dials_matches_offline(pipes, mode, monkeypatch):
    """Plain, prefixed and constrained requests in one batch window of the
    port's beam server: every reply is the offline call's on the same row;
    the constrained rows go out in a dispatch of their own, C bucketed to 1,
    2 or 4; in images mode each dispatch reads the params once (the encoder
    and the decode on one snapshot)."""
    _, pipe = pipes
    dials = [("", ()), ("a dog", ()), ("", ("dog",)), ("two children", ()), ("", ("man", "red", "grass")),
             ("", ()), ("", ("grass", "park"))]
    if mode == "images":
        xs = np.random.default_rng(5).normal(size=(len(dials), 32, 32, 3)).astype(np.float32)
        feats = pipe.encode_images(xs).numpy()
    else:
        xs = feats = _rows(len(dials), seed=5)
    want = [_offline(pipe, feats[i : i + 1], d) for i, d in enumerate(dials)]
    calls, reads = [], []
    for name in ("generate_constrained_submit", "encode_constrained_submit", "generate_continuation_submit",
                 "encode_continuation_submit", "generate_submit", "encode_submit"):
        real = getattr(pipe, name)
        monkeypatch.setattr(pipe, name, lambda x, *a, _n=name, _r=real, **kw: (
            calls.append((_n, len(x), kw.get("num_slots"))), _r(x, *a, **kw))[1])
    real_params = pipe._inference_params
    monkeypatch.setattr(pipe, "_inference_params", lambda: (reads.append(1), real_params())[1])
    with CaptionServer(pipe, mode=mode, max_batch=8, max_delay_ms=500, method="beam") as srv:
        futs = [srv.submit(x, prefix=p or None, include_words=list(w) or None) for x, (p, w) in zip(xs, dials)]
        got = [f.result(timeout=120) for f in futs]
    assert got == want
    route = "encode" if mode == "images" else "generate"
    assert sorted(calls) == sorted([(f"{route}_constrained_submit", 4, 4), (f"{route}_continuation_submit", 4, None)])
    assert len(reads) == 2
    # Per-row dials through submit_many: the same replies.
    with CaptionServer(pipe, mode=mode, max_batch=8, method="beam") as srv:
        futs = srv.submit_many(xs, prefixes=[p for p, _ in dials], include_words_rows=[list(w) for _, w in dials])
        assert [f.result(timeout=120) for f in futs] == want


def test_caption_cli_prefix_and_include_words(pipes, tmp_path, monkeypatch, capsys):
    """``caption --prefix`` and ``--include-words`` offline print the library
    calls' captions on the restored pipeline, and the "could not include"
    line where max_len is too short; through ``--server`` the same lines."""
    from PIL import Image

    from tpucap_torch.checkpoint import CheckpointManager
    from tpucap_torch.serve_http import CaptionHTTPServer
    from tpucap_torch.train import TrainState, build_optimizer

    cli = importlib.import_module("tpucap_torch.cli.main")
    _, pipe = pipes
    ckpt = tmp_path / "ckpt"
    args = cli.build_parser()[0].parse_args(["caption", "--image", "x", *MODEL_FLAGS])
    state = TrainState.create(pipe.params["decoder"], build_optimizer(cli._build_config(args).train),
                              torch.Generator())
    CheckpointManager(str(ckpt)).save(state)
    pipe.tokenizer.save(str(ckpt / "tokenizer.json"))
    paths = []
    for s in (30, 31, 32):
        paths.append(str(tmp_path / f"img{s}.jpg"))
        arr = np.random.default_rng(s).integers(0, 255, size=(32, 32, 3)).astype(np.uint8)
        Image.fromarray(arr).save(paths[-1], format="JPEG", quality=95)
    common = [*MODEL_FLAGS, "--checkpoint-dir", str(ckpt)]
    restored = cli._restore_pipeline(cli.build_parser()[0].parse_args(["caption", "--image", "x", *common]),
                                     torch.device("cpu"))
    feats = restored.extract_features(paths)
    runs = {
        ("--prefix", "a black dog", "--method", "greedy"):
            restored.generate_continuation(feats, "a black dog", method="greedy"),
        ("--include-words", "dog, grass"): restored.generate_constrained(feats, ["dog", "grass"]),
    }
    offline = {}
    for flags, caps in runs.items():
        cli.main(["caption", "--image", *paths, *common, *flags], device="cpu")
        out = capsys.readouterr()
        assert out.out.splitlines() == [f"{p}\t{c}" for p, c in zip(paths, caps)]
        assert "could not include" not in out.err
        offline[flags] = out.out.splitlines()
    cli.main(["caption", "--image", *paths, *MODEL_FLAGS[:-2], "--max-len", "1", "--checkpoint-dir", str(ckpt),
              "--include-words", "dog,grass"], device="cpu")
    err = capsys.readouterr().err
    assert f"{paths[0]}: could not include" in err and "within --max-len" in err

    remote = {}

    def serve_forever(self):  # drive the running server from inside serve
        host, port = self.serve_background()
        for flags in runs:
            cli.main(["caption", "--server", f"{host}:{port}", "--image", *paths, *flags[:2]])
            remote[flags] = capsys.readouterr().out.splitlines()

    monkeypatch.setattr(CaptionHTTPServer, "serve_forever", serve_forever)
    cli.main(["serve", *common, "--port", "0", "--no-warmup", "--method", "beam"], device="cpu")
    beam_prefix = restored.generate_continuation(feats, "a black dog", method="beam")
    assert remote[("--prefix", "a black dog", "--method", "greedy")] == [
        f"{p}\t{c}" for p, c in zip(paths, beam_prefix)
    ]
    assert remote[("--include-words", "dog, grass")] == offline[("--include-words", "dog, grass")]
