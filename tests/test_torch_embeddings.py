"""Pretrained and frozen embedding tables in tpucap_torch against tpucap,
on the CPU: the GloVe parser, the matrix, ``set_pretrained_embeddings``,
the frozen table in ``fit`` and ``fit_finetune`` (tiny_cnn, lstm1 with
embed 8, hidden 16) and the CLI's ``--embeddings`` / ``--freeze-embeddings``
with the other flags of this slice (``--scheduled-sampling``,
``--ss-schedule``, ``--steps-per-dispatch``).

Tolerances: the parsed vectors, the matrix and the installed table equal
tpucap's exactly (the same text parsed by the same numpy call), the same
errors and the same coverage line; a frozen table bit for bit the one
installed, after adamw with weight decay too, while every other leaf
moves; the parsed CLI namespace and ``_build_config`` equal tpucap's.
"""

import contextlib
import dataclasses
import importlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.data import generate_fixture_dataset
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.text import Tokenizer as JaxTokenizer
from tpucap.text import embeddings as jemb
from tpucap_torch import config as tcfg
from tpucap_torch.checkpoint import CheckpointManager
from tpucap_torch.convert import params_to_numpy
from tpucap_torch.core import tree_leaves
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer
from tpucap_torch.text.embeddings import build_embedding_matrix, load_word_vectors
from tpucap_torch.train import TrainState, build_optimizer

from ports_init import build_on_ports_init

torch.set_num_threads(2)

jcli = importlib.import_module("tpucap.cli.main")
tcli = importlib.import_module("tpucap_torch.cli.main")
EMBED = 8
CORPUS = [
    "startseq a black dog runs across the green grass endseq",
    "startseq a dog is running on grass endseq",
    "startseq two children play soccer in the park endseq",
    "startseq a child kicks a ball endseq",
    "startseq a man rides a red bicycle down the street endseq",
    "startseq the man is riding his bike endseq",
]


def _write(path, rows, header=None):
    with open(path, "w", encoding="utf-8") as fh:
        if header is not None:
            fh.write(header + "\n")
        for word, vec in rows:
            fh.write(word + " " + " ".join(f"{v:.6f}" for v in vec) + "\n")
    return str(path)


def _vectors(words, seed, dim=EMBED):
    rng = np.random.default_rng(seed)
    return [(w, rng.normal(size=dim)) for w in words]


def _parse_both(path):
    """-> (tpucap's result, the port's): the dict, or the error's type and
    message."""
    out = []
    for load in (jemb.load_word_vectors, load_word_vectors):
        try:
            out.append(load(path))
        except ValueError as e:
            out.append((type(e), str(e)))
    return out


@pytest.mark.parametrize("case", ["plain", "header", "duplicate", "dim_mismatch", "empty", "no_values"])
def test_load_word_vectors_matches_tpucap(tmp_path, case):
    rows = _vectors(["dog", "grass", "man", "ball"], 1)
    path = tmp_path / "vectors.txt"
    if case == "plain":
        _write(path, rows)
    elif case == "header":
        _write(path, rows, header=f"{len(rows)} {EMBED}")
    elif case == "duplicate":
        _write(path, rows + [("dog", np.ones(EMBED))])
    elif case == "dim_mismatch":
        _write(path, rows + [("cat", np.ones(EMBED + 1))])
    elif case == "empty":
        path.write_text("\n\n")
    else:
        path.write_text("dog\n")
    want, got = _parse_both(str(path))
    if isinstance(want, dict):
        assert list(got) == list(want)
        for w in want:
            assert got[w].dtype == want[w].dtype == np.float32
            np.testing.assert_array_equal(got[w], want[w])
        if case == "duplicate":
            assert not (got["dog"] == 1).any()  # the first line's vector
    else:
        assert got == want and case in ("dim_mismatch", "empty", "no_values")


@pytest.mark.parametrize("vocab_size", [None, 6])
def test_build_embedding_matrix_matches_tpucap(vocab_size):
    jtok, tok = JaxTokenizer(), Tokenizer()
    jtok.fit_on_texts(CORPUS)
    tok.fit_on_texts(CORPUS)
    vecs = {w: np.float32(v) for w, v in _vectors(["dog", "grass", "man", "bike", "zebra", "a"], 2)}
    want = jemb.build_embedding_matrix(jtok, vecs, vocab_size=vocab_size)
    got = build_embedding_matrix(tok, vecs, vocab_size=vocab_size)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and not got[0][0].any()
    with pytest.raises(ValueError, match="pretrained vectors have dim 8, decoder embed_dim is 4"):
        build_embedding_matrix(tok, vecs, embed_dim=4)


def _config(package, **train):
    return package.Config(
        encoder=package.encoder_config("tiny_cnn"),
        decoder=package.DecoderConfig(embed_dim=EMBED, hidden_dim=16, dropout_rate=0.0),
        decode=package.DecodeConfig(max_len=10),
        train=package.TrainConfig(batch_size=4, learning_rate=1e-2, seed=0, **train),
        precision="f32",
    )


def _port_pipe(**train):
    pipe = CaptioningPipeline(_config(tcfg, **train), device="cpu")
    pipe.fit_tokenizer({"a": CORPUS})
    pipe.build()
    return pipe


def test_set_pretrained_embeddings_matches_tpucap(tmp_path):
    """From a file, a dict and a matrix, with tpucap's guards and coverage
    line; the cached bf16 params are dropped."""
    jpipe = JaxPipeline(_config(jcfg))
    jpipe.fit_tokenizer({"a": CORPUS})
    build_on_ports_init(jpipe)
    pipe = _port_pipe()
    rows = _vectors(["dog", "grass", "man", "startseq", "endseq", "unicorn"], 3)
    path = _write(tmp_path / "glove.txt", rows)
    sources = {"file": path, "dict": {w: np.float32(v) for w, v in rows}}
    vocab = pipe.vocab_size
    sources["matrix"] = np.random.default_rng(4).normal(size=(vocab, EMBED)).astype(np.float32)
    for name, source in sources.items():
        lines = {"tpucap": [], "port": []}
        want = jpipe.set_pretrained_embeddings(source, freeze=name == "dict", log=lines["tpucap"].append)
        pipe._bf16_params = object()
        got = pipe.set_pretrained_embeddings(source, freeze=name == "dict", log=lines["port"].append)
        assert got == want and lines["port"] == lines["tpucap"] and pipe._bf16_params is None, name
        assert pipe._freeze_embeddings == (name == "dict")
        np.testing.assert_array_equal(
            pipe.params["decoder"]["embedding"]["table"].numpy(),
            np.asarray(jpipe.params["decoder"]["embedding"]["table"]),
        )
    assert lines["port"] == [] and got == vocab  # a matrix: no coverage line, its rows
    assert pipe.generate(np.zeros((2, 128), np.float32), method="greedy")
    for p in (jpipe, pipe):
        with pytest.raises(ValueError, match=r"embedding matrix shape \(3, 8\) != decoder table shape"):
            p.set_pretrained_embeddings(np.zeros((3, EMBED), np.float32), log=None)
    bare = CaptioningPipeline(_config(tcfg), device="cpu")
    with pytest.raises(ValueError, match="a fitted tokenizer is required"):
        bare.set_pretrained_embeddings(sources["dict"], log=None)


def _features(seed, n=8):
    rng = np.random.default_rng(seed)
    desc = {f"i{k}": [CORPUS[k % len(CORPUS)]] for k in range(n)}
    return desc, {i: rng.normal(size=128).astype(np.float32) for i in desc}


@pytest.mark.parametrize("freeze", [True, False])
def test_frozen_table_stays_under_adamw_with_decay(freeze, tmp_path):
    """adamw's decay moves leaves that get no gradient: masking the updates
    is what keeps a frozen table put. The checkpoint made with the freeze
    restores into a template built without it (the optimizer's state is
    the base optimizer's)."""
    pipe = _port_pipe(optimizer="adamw", weight_decay=0.01)
    pipe.set_pretrained_embeddings({w: np.float32(v) for w, v in _vectors(["dog", "man", "a"], 5)},
                                   freeze=freeze, log=None)
    before = params_to_numpy(pipe.params["decoder"])
    desc, feats = _features(6)
    mgr = CheckpointManager(tmp_path / "ckpt", best_metric=None)
    pipe.fit(desc, feats, epochs=2, checkpoint_manager=mgr, log=None)
    after = params_to_numpy(pipe.params["decoder"])
    moved = jax.tree.map(lambda a, b: bool((a != b).any()), before, after)
    assert moved.pop("embedding")["table"] != freeze
    assert all(jax.tree.leaves(moved))
    template = TrainState.create(
        pipe.params["decoder"], build_optimizer(pipe.config.train), torch.Generator()
    )
    restored = mgr.restore(template)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored.params), tree_leaves(pipe.params["decoder"])))
    mgr.close()


def test_frozen_table_in_fit_finetune():
    pipe = _port_pipe()
    pipe.set_pretrained_embeddings({w: np.float32(v) for w, v in _vectors(["dog", "ball"], 7)}, freeze=True,
                                   log=None)
    before = params_to_numpy(pipe.params)
    desc = {f"i{k}": [CORPUS[k]] for k in range(4)}
    rng = np.random.default_rng(8)
    images = {i: rng.uniform(-1, 1, size=(32, 32, 3)).astype(np.float32) for i in desc}
    pipe.fit_finetune(desc, images, epochs=2, log=None)
    after = params_to_numpy(pipe.params)
    np.testing.assert_array_equal(after["decoder"]["embedding"]["table"], before["decoder"]["embedding"]["table"])
    assert (after["decoder"]["out"]["kernel"] != before["decoder"]["out"]["kernel"]).any()
    assert any((a != b).any() for a, b in zip(jax.tree.leaves(after["encoder"]), jax.tree.leaves(before["encoder"])))


def test_freeze_embeddings_alone_exits_before_any_io(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["train", "--encoder", "tiny_cnn", "--tokens", "/nonexistent", "--features", "/nonexistent",
            "--freeze-embeddings"]
    with pytest.raises(SystemExit) as theirs:
        jcli.main(argv)
    with pytest.raises(SystemExit) as ours:
        tcli.main(argv, device="cpu")
    assert str(ours.value) == str(theirs.value) == "--freeze-embeddings needs --embeddings FILE"


def _slice_flags(glove):
    return ["--embeddings", glove, "--freeze-embeddings", "--scheduled-sampling", "0.5", "--ss-schedule",
            "inv_sigmoid", "--steps-per-dispatch", "2"]


@pytest.mark.parametrize("preset", [False, True])
def test_slice_flags_parse_and_reach_the_config_as_tpucaps(preset, monkeypatch):
    """The flags of this slice give tpucap's namespace and tpucap's config
    (tpucap's tests/test_multistep.py guards a flag that never reached
    TrainConfig)."""
    argv = ["train", *(["--preset", "config1"] if preset else []), "--tokens", "t", "--features", "f",
            *_slice_flags("g.txt")]
    seen = []
    monkeypatch.setattr(jcli, "cmd_train", seen.append)
    jcli.main(argv)
    got = tcli.build_parser()[0].parse_args(argv)
    assert {k: v for k, v in vars(got).items() if k != "fn"} == {k: v for k, v in vars(seen[0]).items() if k != "fn"}
    cfg = tcli._build_config(got)
    assert (cfg.train.scheduled_sampling, cfg.train.ss_schedule, cfg.train.steps_per_dispatch) == (
        0.5, "inv_sigmoid", 2)
    norm = lambda d: json.loads(json.dumps(d))  # noqa: E731
    assert norm(tcfg.config_to_dict(cfg)) == norm(dataclasses.asdict(jcli._build_config(seen[0])))


def test_cli_train_with_the_slice_flags(tmp_path):
    """extract, then train with a frozen GloVe table, scheduled sampling and
    2 steps a dispatch: the coverage line, and every checkpoint's table is
    the file's matrix."""
    img_dir, tokens, train, _ = generate_fixture_dataset(tmp_path / "data", n_images=6, image_size=32, seed=3)
    common = ["--encoder", "tiny_cnn", "--max-len", "12"]
    feats, ckpt = str(tmp_path / "features.npz"), tmp_path / "ckpt"
    tcli.main(["extract", *common, "--images", str(img_dir), "--out", feats, "--batch-size", "4"], device="cpu")
    words = sorted({w for line in open(tokens) for w in line.split("\t")[1].lower().split() if w.isalpha()})
    glove = _write(tmp_path / "glove.txt", _vectors([*words[:6], "zebra"], 9, dim=256))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tcli.main(["train", *common, "--tokens", tokens, "--split", train, "--features", feats,
                   "--checkpoint-dir", str(ckpt), "--epochs", "2", "--batch-size", "4",
                   *_slice_flags(glove)], device="cpu")
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("pretrained embeddings: ") and lines[0].endswith(", table frozen")
    assert lines[-1].startswith("trained 2 epochs; final loss ")
    pipe = CaptioningPipeline(tcli._build_config(tcli.build_parser()[0].parse_args(
        ["train", *common, *_slice_flags(glove)])), device="cpu")
    pipe.tokenizer = tcli.load_tokenizer(ckpt / "tokenizer.json")
    pipe.build()
    pipe.set_pretrained_embeddings(glove, log=None)
    want = pipe.params["decoder"]["embedding"]["table"]
    mgr = CheckpointManager(ckpt, best_metric=None)
    template = TrainState.create(pipe.params["decoder"], build_optimizer(pipe.config.train), torch.Generator())
    assert len(mgr.all_steps()) == 2
    for step in mgr.all_steps():
        assert torch.equal(mgr.restore(template, step).params["embedding"]["table"], want)
    mgr.close()
