"""Caption scoring (``score_captions``, the ``score`` command) and the
paired bootstrap (``train/compare.py``, the ``compare`` command) in
tpucap_torch against tpucap, on the CPU: tiny_cnn, lstm1 with embed 16,
hidden 32, the port holding tpucap's built weights.

Tolerances: ``score_captions``' logp within 1e-5 x max(1, |logp|) of
tpucap's at f32 (one forward, summed in another order), the token counts
equal; the score of ``generate``'s own captions within 1e-5 of the greedy
engine's score (both the port's plain f32 step here); ``compare``'s
statistics, scores and bootstrap results within 1e-12 of tpucap's (the
same resampled indices from ``np.random.default_rng(seed)``; scores summed
in the same order), its printed lines equal tpucap's; the ``score``
command's lines those of ``score_captions`` on the restored bundle, in
tpucap's format.
"""

import contextlib
import dataclasses
import importlib
import io
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.data import generate_fixture_dataset
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.train import compare as jcmp
from tpucap_torch import config as tcfg
from tpucap_torch.convert import params_from_jax
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer
from tpucap_torch.train import compare as tcmp

torch.set_num_threads(2)

jcli = importlib.import_module("tpucap.cli.main")
tcli = importlib.import_module("tpucap_torch.cli.main")
CORPUS = {
    "a": ["startseq a black dog runs across the green grass endseq", "startseq a dog is running on grass endseq"],
    "b": ["startseq two children play soccer in the park endseq", "startseq a child kicks a ball endseq"],
    "c": ["startseq a man rides a red bicycle down the street endseq", "startseq the man is riding endseq"],
}
CAPTIONS = [
    "a dog runs",
    "startseq the man is riding a red bicycle down the green grass endseq",
    "",
    "two children play soccer in the park",
    "startseq a child kicks a ball",
]


@pytest.fixture(scope="module")
def pipes():
    def config(package):
        return package.Config(
            encoder=package.encoder_config("tiny_cnn"),
            decoder=package.DecoderConfig(embed_dim=16, hidden_dim=32, dropout_rate=0.0),
            decode=package.DecodeConfig(max_len=10),
            precision="f32",
        )

    jpipe = JaxPipeline(config(jcfg))
    jpipe.fit_tokenizer(CORPUS)
    jpipe.build()
    pipe = CaptioningPipeline(config(tcfg), tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()), device="cpu")
    pipe.build(init_params=False)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    return jpipe, pipe


def _feats(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 128)).astype(np.float32)


def test_score_captions_matches_tpucap(pipes):
    jpipe, pipe = pipes
    feats = _feats(len(CAPTIONS))
    want = jpipe.score_captions(feats, CAPTIONS)
    got = pipe.score_captions(feats, CAPTIONS)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and g["tokens"] == w["tokens"]
        for k in ("logp", "logp_per_token"):
            assert abs(g[k] - w[k]) <= 1e-5 * max(1.0, abs(w[k])), k
        np.testing.assert_allclose(g["perplexity"], w["perplexity"], rtol=1e-5)
    # "a dog runs" + endseq: 4 tokens; the empty caption scores its endseq.
    assert [g["tokens"] for g in got] == [4, 12, 1, 8, 6]


def test_score_strips_sentinels_broadcasts_and_refuses_as_tpucap(pipes):
    jpipe, pipe = pipes
    feats = _feats(2, 1)
    plain = pipe.score_captions(feats, ["a dog runs", "a dog runs"])
    assert pipe.score_captions(feats, ["startseq a dog runs endseq"] * 2) == plain
    assert pipe.score_captions(feats, "a dog runs") == plain
    for p in (jpipe, pipe):
        with pytest.raises(ValueError, match="3 captions for 2 feature rows"):
            p.score_captions(feats, ["a", "b", "c"])
        with pytest.raises(ValueError, match="prefix 'a zebra runs' contains words outside the tokenizer vocabulary"):
            p.score_captions(feats, ["a dog", "a zebra runs"])
    # Counted under the tokenizer's own normalization: punctuation splits.
    assert pipe.encode_prefixes(["a dog, running"]) == jpipe.encode_prefixes(["a dog, running"])


def test_score_of_generated_captions_is_the_greedy_engines_score(pipes):
    """A model trained on the corpus, so that greedy rows end with endseq
    (the engine's score has its closing term only then): scoring
    ``generate``'s captions of the rows that ended gives the engine's
    scores."""
    _, base = pipes
    pipe = CaptioningPipeline(base.config, tokenizer=base.tokenizer, device="cpu")
    pipe.build(init_params=False)
    pipe.set_params(base.params)
    pipe.config = dataclasses.replace(pipe.config, train=tcfg.TrainConfig(batch_size=6, learning_rate=3e-2))
    feats = dict(zip(CORPUS, _feats(len(CORPUS), 3)))
    pipe.fit(CORPUS, feats, epochs=60, log=None)
    x = np.concatenate([np.stack(list(feats.values())), _feats(13, 2)])
    res = pipe._decode(pipe.params["decoder"], torch.from_numpy(x), "greedy", 1)
    caps = pipe._captions(res)
    assert caps == pipe.generate(x, method="greedy")
    ended = (res.lengths < pipe.config.decode.max_len).numpy()
    assert ended.sum() >= 12 and len({len(c.split()) for c in caps}) > 2
    got = [s["logp"] for s in pipe.score_captions(x[ended], [c for c, e in zip(caps, ended) if e])]
    np.testing.assert_allclose(got, res.scores.numpy()[ended], rtol=0, atol=1e-5)


def test_encodes_decodes_and_scores_under_the_pipelines_own_flags(pipes):
    """The TF32 flags are process-wide: a pipeline built later ("mixed",
    TF32 on) must not turn an f32 pipeline's encoder, decode or score to
    TF32 (tpucap's programs take the matmul precision per call). The flags
    are read inside the calls and are as they were after them."""
    _, pipe = pipes
    seen = []

    def reading(fn):
        def wrapped(*args, **kwargs):
            seen.append((fn.__name__, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            return fn(*args, **kwargs)

        return wrapped

    CaptioningPipeline(tcfg.Config(encoder=tcfg.encoder_config("tiny_cnn"), precision="mixed"), device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    with pytest.MonkeyPatch.context() as mp:
        for obj, name in ((pipe.decoder, "init_state"), (pipe.decoder, "forward_train"), (pipe.encoder, "apply")):
            mp.setattr(type(obj), name, reading(getattr(type(obj), name)))
        pipe.encode_images(np.zeros((1, 32, 32, 3), np.float32))
        pipe.generate(_feats(2), method="greedy")
        pipe.score_captions(_feats(2), "a dog runs")
    assert sorted({name for name, *_ in seen}) == ["apply", "forward_train", "init_state"]
    assert all(flags == [False, False] for _, *flags in seen)
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


# -- the paired bootstrap -------------------------------------------------------------

WORDS = "a b c d e f g h i j".split()


def _rand_corpus(rng, n_images, min_len=1, max_len=12):
    refs, hyps = [], []
    for _ in range(n_images):
        refs.append([
            [WORDS[rng.integers(0, len(WORDS))] for _ in range(rng.integers(min_len, max_len))]
            for _ in range(rng.integers(1, 4))
        ])
        hyps.append([WORDS[rng.integers(0, len(WORDS))] for _ in range(rng.integers(min_len, max_len))])
    return refs, hyps


def _close(got, want, what=""):
    if isinstance(want, dict):
        assert list(got) == list(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple, np.ndarray)) and np.ndim(want):
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=0, atol=1e-12,
                                   err_msg=what)
    elif isinstance(want, (bool, str, np.bool_)) or want is None:
        assert got == want, what
    else:
        assert abs(got - want) <= 1e-12, what


def test_bleu_statistics_match_tpucap():
    refs, hyps = _rand_corpus(np.random.default_rng(1), 30)
    hyps[3] = []
    for r, h in zip(refs, hyps):
        for g, w in zip(tcmp.bleu_sentence_stats(r, h), jcmp.bleu_sentence_stats(r, h), strict=True):
            _close(g, w)
    ts, js = tcmp.corpus_stats(refs, hyps), jcmp.corpus_stats(refs, hyps)
    _close(ts, js)
    idx = np.random.default_rng(2).integers(0, 30, size=(5, 30))
    for w in ((1.0, 0, 0, 0), (0.5, 0.5, 0, 0), (1 / 3, 1 / 3, 1 / 3, 0), (0.25,) * 4):
        _close(tcmp.corpus_bleu_from_stats(ts, w), jcmp.corpus_bleu_from_stats(js, w))
        _close(tcmp.corpus_bleu_from_stats({k: v[idx] for k, v in ts.items()}, w),
               jcmp.corpus_bleu_from_stats({k: v[idx] for k, v in js.items()}, w))


@pytest.mark.parametrize("metric", tcmp.METRICS)
def test_paired_bootstrap_matches_tpucap(metric):
    rng = np.random.default_rng(3)
    refs, hyps_a = _rand_corpus(rng, 24, min_len=3)
    hyps_b = [r[0] if i % 3 else h for i, (r, h) in enumerate(zip(refs, hyps_a))]
    if metric in ("cider", "rouge_l", "meteor"):
        for h in (hyps_a, hyps_b):
            _close(tcmp.per_sentence_scores(refs, h, metric), jcmp.per_sentence_scores(refs, h, metric))
    got = tcmp.paired_bootstrap(refs, hyps_a, hyps_b, metric=metric, n_resamples=300, seed=4)
    want = jcmp.paired_bootstrap(refs, hyps_a, hyps_b, metric=metric, n_resamples=300, seed=4)
    _close(got, want)
    assert got["score_b"] > got["score_a"]


def _dump(path, ids, caps, refs):
    with open(path, "w") as f:
        for i, c, r in zip(ids, caps, refs):
            f.write(json.dumps({"image_id": i, "caption": c, "references": r, "bleu4": 0.0}) + "\n")
    return str(path)


def _dumps(tmp_path):
    refs_tok, hyps_tok = _rand_corpus(np.random.default_rng(8), 20, min_len=4)
    ids = [f"img{i}" for i in range(20)]
    refs = [["startseq " + " ".join(r) + " endseq" for r in rs] for rs in refs_tok]
    caps_b = [r[0].replace("startseq ", "").replace(" endseq", "") if i % 2 else " ".join(h)
              for i, (r, h) in enumerate(zip(refs, hyps_tok))]
    return (ids, refs, _dump(tmp_path / "a.jsonl", ids, [" ".join(h) for h in hyps_tok], refs),
            _dump(tmp_path / "b.jsonl", ids, caps_b, refs))


def test_compare_caption_files_matches_tpucap(tmp_path):
    ids, refs, pa, pb = _dumps(tmp_path)
    assert tcmp.load_caption_dump(pa) == jcmp.load_caption_dump(pa)
    for metric in ("bleu4", "cider"):
        _close(tcmp.compare_caption_files(pa, pb, metric=metric, n_resamples=200, seed=1),
               jcmp.compare_caption_files(pa, pb, metric=metric, n_resamples=200, seed=1))
    bad = {
        "sets": _dump(tmp_path / "s.jsonl", ids[:-1], ["a"] * 19, refs[:-1]),
        "refs": _dump(tmp_path / "r.jsonl", ids, ["a"] * 20, [["startseq other endseq"]] + refs[1:]),
    }
    for path in bad.values():
        errors = []
        for mod in (jcmp, tcmp):
            with pytest.raises(ValueError) as e:
                mod.compare_caption_files(pa, path)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    rows = {
        "missing": '{"image_id": "x"}\n',
        "duplicate": '{"image_id": "x", "caption": "a", "references": ["a"]}\n' * 2,
        "no_refs": '{"image_id": "x", "caption": "a", "references": []}\n',
        "empty": "\n",
    }
    for name, text in rows.items():
        (tmp_path / f"{name}.jsonl").write_text(text)
        errors = []
        for mod in (jcmp, tcmp):
            with pytest.raises(ValueError) as e:
                mod.load_caption_dump(str(tmp_path / f"{name}.jsonl"))
            errors.append(str(e.value))
        assert errors[0] == errors[1], name


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue().splitlines(), err.getvalue().splitlines()


@pytest.mark.parametrize("flags", [[], ["--metric", "meteor", "--bootstrap", "100", "--seed", "3"]])
def test_compare_command_prints_tpucaps_lines(tmp_path, flags, monkeypatch):
    """Host numpy only: it runs with no card and no device named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, pa, pb = _dumps(tmp_path)
    want = _run(jcli.main, ["compare", pa, pb, *flags])
    got = _run(tcli.main, ["compare", pa, pb, *flags])
    assert got[1] == want[1] and len(got[0]) == len(want[0]) == 1
    _close(json.loads(got[0][0]), json.loads(want[0][0]))
    assert re.fullmatch(r"# \w+: A=\d\.\d{4} B=\d\.\d{4} delta=[+-]\d\.\d{4} ci95=\[[+-]\d\.\d{4}, [+-]\d\.\d{4}\] "
                        r"p=\d\.\d{3} -> .*", got[1][0])


@pytest.mark.parametrize("argv", [
    ["score", "--image", "a.jpg", "b.jpg", "--caption", "a dog", "--caption", "a cat", "--checkpoint-dir", "c"],
    ["score", "--preset", "config1", "--image", "a.jpg", "--captions-file", "f.txt", "--average-last", "2"],
    ["compare", "a.jsonl", "b.jsonl", "--metric", "cider", "--bootstrap", "10", "--seed", "2"],
])
def test_score_and_compare_parsers_match_tpucaps(argv, monkeypatch):
    seen = []
    monkeypatch.setattr(jcli, f"cmd_{argv[0]}", seen.append)
    jcli.main(argv)
    got = tcli.build_parser()[0].parse_args(argv)
    assert {k: v for k, v in vars(got).items() if k != "fn"} == {k: v for k, v in vars(seen[0]).items() if k != "fn"}


def test_score_command_prints_score_captions_lines(tmp_path):
    """extract, train, then ``score`` of two images from the checkpoint:
    each line is tpucap's format (``tpucap/cli/main.py:1251-1254``) around
    the in-process ``score_captions`` of the same restored pipeline."""
    img_dir, tokens, train, _ = generate_fixture_dataset(tmp_path / "data", n_images=4, image_size=32, seed=5)
    common = ["--encoder", "tiny_cnn", "--max-len", "12"]
    feats, ckpt = str(tmp_path / "features.npz"), str(tmp_path / "ckpt")
    device_main = lambda argv: tcli.main(argv, device="cpu")  # noqa: E731
    _run(device_main, ["extract", *common, "--images", str(img_dir), "--out", feats, "--batch-size", "4"])
    _run(device_main, ["train", *common, "--tokens", tokens, "--split", train, "--features", feats,
                       "--checkpoint-dir", ckpt, "--epochs", "1", "--batch-size", "4"])
    images = sorted(str(p) for p in Path(img_dir).glob("*.jpg"))[:2]
    vocab = tcli.load_tokenizer(f"{ckpt}/tokenizer.json").word_index
    words = [w for w in vocab if w not in ("startseq", "endseq")]
    caps = [" ".join(words[:3]), "startseq " + " ".join(words[3:5]) + " endseq"]
    (tmp_path / "caps.txt").write_text("\n".join(caps) + "\n\n")
    argv = ["score", *common, "--image", *images, "--checkpoint-dir", ckpt]
    out, _ = _run(device_main, [*argv, "--captions-file", str(tmp_path / "caps.txt")])
    assert _run(device_main, [*argv, "--caption", caps[0], "--caption", caps[1]])[0] == out
    pipe = tcli._restore_pipeline(tcli.build_parser()[0].parse_args(argv), torch.device("cpu"))
    scores = pipe.score_captions(pipe.extract_features(images), caps)
    assert out == [f"{p}\tlogp={s['logp']:.4f}\tppl={s['perplexity']:.3f}\ttokens={s['tokens']}\t{c}"
                   for p, c, s in zip(images, caps, scores)]
    assert [s["tokens"] for s in scores] == [4, 3]
    for extra, match in (([], "give exactly one of --caption"), (["--caption", "a"], "1 captions for 2 images")):
        with pytest.raises(SystemExit, match=match):
            device_main([*argv, *extra])
