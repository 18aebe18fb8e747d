"""tpucap_torch's CLI (``extract``, ``train``, ``caption``, ``evaluate``)
against tpucap's, on the CPU.

One module fixture runs tpucap's CLI and the port's (``main(argv,
device="cpu")``) through the same workflow on a generated Flickr8k-format
dataset (6 JPEGs at 32 x 32, tpucap's ``generate_fixture_dataset``):
tiny_cnn features, lstm1 with max_len 12, three epochs at lr 0.01 with a
dev split, the bleu4 monitor and patience 1, then beam captions of every
image from the best checkpoint, and evaluate (every metric, METEOR's synonym
file, --dump-captions, --coco-results; then --average-last 2 with beam);
``train --bundle-out`` writes a bundle the port loads; then caption's
offline modes on that checkpoint: --method diverse, --method mbr from beam
and diverse pools, --ensemble-with the bundle (uniform and weighted). Each
package initializes from its own generator, so the port's
``CaptioningPipeline.build`` installs ``convert.params_from_jax`` of
tpucap's ``build()`` on the same config and tokenizer; in the presets'
fixture tpucap's ``build`` installs the port's seeded init instead
(``_build_with_ports_weights``: torch's InceptionV3 and VGG16 inits take a
second where tpucap's eager ones take tens); both ``_build_config``s set
dropout_rate 0 (training parity needs dropout off). Nothing of tpucap
changes.

Tolerances: printed lines, captions, the dump and COCO files identical
(paths to each package's own outputs replaced by one placeholder), except
that a number ``train`` prints rounded to 4 decimals may differ by one unit
in its last place (a value within rtol 1e-6 of tpucap's can round to the
neighbouring digit); features within f32 atol 1e-5; per-epoch losses
within rtol 1e-6 (fit's drift by summation order; perplexity, their
exponential, within fit's 1e-5); evaluate's scores within 1e-12 with
tpucap's key order; the checkpoint steps kept and the best step the same.
At lr 0.02-0.03 the drift reached 2-3e-6 in val_loss: Adam's first steps
move an entry whose gradient is near zero by +-lr on a last-bit difference
(``tests/test_torch_train.py``). At 0.01 it stays within 1e-6, and the
captions are already words of the corpus.

Also: both parsers give the same namespace for the same command line,
``_build_config`` gives tpucap's config field by field (presets and flags),
the port's ``Config()`` and ``PRESETS`` are tpucap's, each unported flag
exits naming itself before any file is read, unported config fields,
encoders and decoders raise NotImplementedError, and without a card the
commands raise.
"""

import contextlib
import dataclasses
import importlib
import io
import json
import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.checkpoint import CheckpointManager as JaxManager
from tpucap.data import generate_fixture_dataset
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.text import Tokenizer as JaxTokenizer
from tpucap_torch import config as tcfg
from tpucap_torch.checkpoint import CheckpointManager
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer

from ports_init import jit_build

torch.set_num_threads(2)

# The modules (each package's ``cli`` exports the function ``main``).
jcli = importlib.import_module("tpucap.cli.main")
tcli = importlib.import_module("tpucap_torch.cli.main")
ROOT = Path(__file__).resolve().parents[1]
COMMON = ["--encoder", "tiny_cnn", "--max-len", "12"]
MONITOR = ["--val-metric", "bleu4"]


def _no_dropout(build_config):
    def build(args):
        cfg = build_config(args)
        return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, dropout_rate=0.0))

    return build


#: tpucap's built params (numpy), by config, seed and vocabulary: what its
#: ``build()`` gave in this module's fixtures (``_recording_build``).
_TPUCAP_PARAMS: dict = {}


def _build_key(jconfig, jtok):
    """The config (its train.seed included) and the vocabulary: all that
    tpucap's ``build()`` reads."""
    return json.dumps(dataclasses.asdict(jconfig), sort_keys=True), jtok and jtok.to_json()


def _recording_build(orig):
    """tpucap's ``build`` with its init jitted (``ports_init.jit_build``:
    for tiny_cnn and lstm1 the eager build's bits, compiled once instead of
    op by op), its params recorded as numpy copies."""

    def build(self, rng=None, init_params=True):
        if not init_params:
            return orig(self, rng, init_params)
        out = jit_build(self, rng)
        if rng is None:
            _TPUCAP_PARAMS[_build_key(self.config, self.tokenizer)] = jax.tree.map(np.array, self.params)
        return out

    return build


def _build_with_ports_weights(orig):
    """tpucap's ``build`` with the port's weights for the same config and
    vocabulary (the port's own seeded init, carried across by
    ``convert.params_to_numpy``): torch's init takes a second where tpucap's
    eager one of InceptionV3 or VGG16 takes tens. The port's ``build``
    needs no patch then: its own init is those weights."""

    def build(self, rng=None, init_params=True):
        orig(self, rng, init_params=False)
        if init_params:
            if rng is not None:
                raise AssertionError("a keyed tpucap build has no port counterpart")
            tconfig = tcfg.config_from_dict(json.loads(json.dumps(dataclasses.asdict(self.config))))
            ttok = None if self.tokenizer is None else Tokenizer.from_json(self.tokenizer.to_json())
            pipe = CaptioningPipeline(tconfig, tokenizer=ttok, device="cpu")
            pipe.build()
            self.params = jax.tree.map(jnp.asarray, params_to_numpy(pipe.params))
        return self.params

    return build


def _build_with_tpucaps_weights(orig):
    """The port's build with tpucap's weights for the same config and
    vocabulary: those its own command recorded, else a tpucap build made
    here."""

    def build(self, seed=None, init_params=True):
        orig(self, seed, init_params=False)
        if init_params:
            jconfig = jcfg.config_from_dict(json.loads(json.dumps(tcfg.config_to_dict(self.config))))
            jtok = None if self.tokenizer is None else JaxTokenizer.from_json(self.tokenizer.to_json())
            key = _build_key(jconfig, jtok)
            if key not in _TPUCAP_PARAMS:
                jpipe = JaxPipeline(jconfig, tokenizer=jtok)
                jpipe.build()
                _TPUCAP_PARAMS[key] = jax.tree.map(np.asarray, jpipe.params)
            self.set_params(params_from_jax(_TPUCAP_PARAMS[key]))
        return self.params

    return build


#: caption's offline decode modes, run on the workflow's checkpoint (the
#: ensemble with the bundle that its train command wrote).
TOOLKIT = {
    "diverse": ["--method", "diverse", "--diverse-groups", "3"],
    "mbr-beam": ["--method", "mbr", "--mbr-from", "beam", "--mbr-candidates", "3"],
    "mbr-diverse": ["--method", "mbr", "--mbr-from", "diverse", "--mbr-metric", "bleu4",
                    "--beam-width", "2"],
    "ensemble": ["--ensemble-with", "<out>/bundle"],
    "ensemble-weights": ["--method", "greedy", "--ensemble-with", "<out>/bundle",
                         "--ensemble-weights", "0.3,0.7"],
}


def _workflow(data, out):
    img_dir, tokens, train, test = data
    feats, ckpt = f"{out}/features.npz", f"{out}/ckpt"
    synonyms = str(Path(tokens).parent / "synonyms.txt")
    Path(synonyms).write_text("# groups\ndog hound\nchild kid, youngster\n")
    images = sorted(str(p) for p in Path(img_dir).glob("*.jpg"))
    return {
        "extract": ["extract", *COMMON, "--images", str(img_dir), "--out", feats,
                    "--batch-size", "4"],
        "train": ["train", *COMMON, "--tokens", tokens, "--split", train, "--val-split", test,
                  *MONITOR, "--early-stopping-patience", "1", "--features", feats,
                  "--checkpoint-dir", ckpt, "--epochs", "3", "--batch-size", "4", "--lr", "0.01",
                  "--metrics-log", f"{out}/metrics.jsonl", "--bundle-out", f"{out}/bundle"],
        "caption": ["caption", *COMMON, "--image", *images, "--checkpoint-dir", ckpt, *MONITOR],
        "evaluate": ["evaluate", *COMMON, "--tokens", tokens, "--split", test, "--features",
                     feats, "--checkpoint-dir", ckpt, *MONITOR, "--batch-size", "4",
                     "--metrics", "bleu,cider,rouge_l,meteor,diversity", "--meteor-synonyms",
                     synonyms, "--dump-captions", f"{out}/dump.jsonl", "--coco-results",
                     f"{out}/coco.json"],
        "evaluate-average": ["evaluate", *COMMON, "--tokens", tokens, "--features", feats,
                             "--checkpoint-dir", ckpt, *MONITOR, "--method", "beam",
                             "--average-last", "2", "--batch-size", "4"],
        "caption-ngram": ["caption", *COMMON, "--no-repeat-ngram", "2", "--image", *images,
                          "--checkpoint-dir", ckpt, *MONITOR],
        "evaluate-ngram": ["evaluate", *COMMON, "--no-repeat-ngram", "2", "--tokens", tokens,
                           "--features", feats, "--checkpoint-dir", ckpt, *MONITOR,
                           "--batch-size", "4", "--metrics", "bleu,cider,diversity"],
        **{
            f"caption-{name}": ["caption", *COMMON, "--image", *images, "--checkpoint-dir", ckpt,
                                *MONITOR, *flags]
            for name, flags in TOOLKIT.items()
        },
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> {package: {"out": dir, command: (stdout lines, stderr lines)}},
    each package's own output directory replaced by "<out>" in the lines."""
    root = tmp_path_factory.mktemp("cli")
    data = generate_fixture_dataset(root / "data", n_images=6, image_size=32, seed=3)
    mains = {"tpucap": jcli.main, "port": lambda argv: tcli.main(argv, device="cpu")}
    result = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "_build_config", _no_dropout(jcli._build_config))
        mp.setattr(tcli, "_build_config", _no_dropout(tcli._build_config))
        mp.setattr(CaptioningPipeline, "build", _build_with_tpucaps_weights(CaptioningPipeline.build))
        mp.setattr(JaxPipeline, "build", _recording_build(JaxPipeline.build))
        for pkg, main in mains.items():
            out = root / pkg
            out.mkdir()
            result[pkg] = {"out": out}
            for name, argv in _workflow(data, out).items():
                argv = [a.replace("<out>", str(out)) for a in argv]
                stdout, stderr = io.StringIO(), io.StringIO()
                with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr), \
                        warnings.catch_warnings():
                    warnings.simplefilter("ignore")  # NLTK's on orders without matches
                    main(argv)
                result[pkg][name] = tuple(
                    [ln.replace(str(out), "<out>") for ln in s.getvalue().splitlines()
                     if "absl" not in ln]
                    for s in (stdout, stderr)
                )
    _TPUCAP_PARAMS.clear()
    return result


def test_cli_extract_matches_tpucap(runs):
    ours, theirs = runs["port"], runs["tpucap"]
    assert ours["extract"] == theirs["extract"]
    assert ours["extract"][0] == ["wrote 6 features to <out>/features.npz"]
    got, want = np.load(ours["out"] / "features.npz"), np.load(theirs["out"] / "features.npz")
    assert got.files == want.files
    for k in want.files:
        assert got[k].dtype == np.float32 and got[k].shape == (128,)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)


_NUMBER = re.compile(r"-?\d+\.(\d+)")


def _same_rounded_lines(got, want):
    """Lines equal but for printed decimals, which may differ by one unit
    in their last place."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _NUMBER.sub("#", g) == _NUMBER.sub("#", w), (g, w)
        for a, b in zip(_NUMBER.finditer(g), _NUMBER.finditer(w)):
            assert abs(float(a[0]) - float(b[0])) <= 1.01 * 10.0 ** -len(b[1]), (g, w)


def test_cli_train_matches_tpucap(runs):
    ours, theirs = runs["port"], runs["tpucap"]
    _same_rounded_lines(ours["train"][0], theirs["train"][0])
    assert ours["train"][1] == theirs["train"][1]
    assert ours["train"][0][-2].startswith("trained ")
    assert ours["train"][0][-1] == "wrote pipeline bundle to <out>/bundle"
    read = lambda run: [json.loads(ln) for ln in (run["out"] / "metrics.jsonl").read_text().splitlines()]  # noqa: E731
    got, want = read(ours), read(theirs)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert g["epoch"] == w["epoch"] and isinstance(g["wall_time"], float)
        for k in ("loss", "accuracy", "val_loss", "val_accuracy"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
        # exp(loss) turns the losses' agreement into a relative one of
        # |loss| x 1e-6 (losses up to 8 here): fit's 1e-5.
        np.testing.assert_allclose(g["perplexity"], w["perplexity"], rtol=1e-5)
        assert abs(g["val_bleu4"] - w["val_bleu4"]) <= 1e-12
    kw = dict(best_metric="val_bleu4", best_mode="max")
    mine, orbax = CheckpointManager(ours["out"] / "ckpt", **kw), JaxManager(str(theirs["out"] / "ckpt"), **kw)
    assert mine.all_steps() == orbax.all_steps() and mine.best_step() == orbax.best_step()
    for s in mine.all_steps():
        g, w = mine.metrics(s), orbax._mgr.metrics(s)
        assert sorted(g) == sorted(w)
        np.testing.assert_allclose(g["val_loss"], w["val_loss"], rtol=1e-6)
        assert abs(g["val_bleu4"] - w["val_bleu4"]) <= 1e-12
    orbax.close()
    tok = lambda run: json.loads((run["out"] / "ckpt" / "tokenizer.json").read_text())  # noqa: E731
    assert tok(ours) == tok(theirs)
    bundle = CaptioningPipeline.load(ours["out"] / "bundle", device="cpu")
    assert json.loads(bundle.tokenizer.to_json()) == tok(ours)
    assert json.loads(json.dumps(tcfg.config_to_dict(bundle.config))) == json.loads(
        (theirs["out"] / "bundle" / "config.json").read_text())


def test_cli_caption_matches_tpucap(runs):
    ours, theirs = runs["port"], runs["tpucap"]
    assert ours["caption"] == theirs["caption"]
    lines = ours["caption"][0]
    assert len(lines) == 6 and all(ln.split("\t")[0].endswith(".jpg") for ln in lines)
    assert ours["caption"][1][0].startswith("note: no --keras-h5 given")


def test_cli_caption_with_no_repeat_ngram_matches_tpucap(runs):
    ours, theirs = runs["port"], runs["tpucap"]
    assert ours["caption-ngram"] == theirs["caption-ngram"]
    for line in ours["caption-ngram"][0]:
        words = line.split("\t")[1].split()
        bigrams = list(zip(words, words[1:]))
        assert len(bigrams) == len(set(bigrams)), line


@pytest.mark.parametrize("name", list(TOOLKIT))
def test_cli_caption_toolkit_matches_tpucap(runs, name):
    """--method diverse (a line a group, its 3-decimal score to the last
    digit), --method mbr from beam and diverse pools, and --ensemble-with
    the train command's bundle (uniform and weighted) print tpucap's
    lines."""
    ours, theirs = runs["port"], runs["tpucap"]
    got, want = ours[f"caption-{name}"], theirs[f"caption-{name}"]
    _same_rounded_lines(got[0], want[0])
    assert got[1] == want[1]
    assert len(got[0]) == (18 if name == "diverse" else 6)


@pytest.mark.parametrize("name", ["evaluate", "evaluate-average", "evaluate-ngram"])
def test_cli_evaluate_matches_tpucap(runs, name):
    ours, theirs = runs["port"], runs["tpucap"]
    (got_out, got_err), (want_out, want_err) = ours[name], theirs[name]
    assert got_err == want_err and got_out[:-1] == want_out[:-1]
    got, want = json.loads(got_out[-1]), json.loads(want_out[-1])
    assert list(got) == list(want)
    for k, w in want.items():
        assert (got[k] is None) == (w is None), k
        if w is not None:
            assert abs(got[k] - w) <= 1e-12, k
    if name == "evaluate":
        assert {"bleu4", "cider", "rouge_l", "meteor", "distinct_1"} <= set(got)
        for f in ("dump.jsonl", "coco.json"):
            assert (ours["out"] / f).read_text() == (theirs["out"] / f).read_text(), f
        assert len(json.loads((ours["out"] / "coco.json").read_text())) == 2


# -- the presets: CONFIG_2, CONFIG_4 and CONFIG_5 ----------------------------------------

PRESET_EXTRACT = {"config2": "config2", "config4": "config4", "config5": "config2"}


def _preset_workflow(data, out):
    """extract once per encoder (config5's InceptionV3 is config2's, same
    seed), then train, caption and evaluate on each preset, at the presets'
    lr 1e-3: each package trains on its own features, and at 1e-2 Adam's
    first steps carried their last-bit differences (1e-6 of VGG16's grid)
    to 2.5e-4 of config4's loss in two epochs (3e-6 from the same
    features)."""
    img_dir, tokens, train, test = data
    images = sorted(str(p) for p in Path(img_dir).glob("*.jpg"))[:2]
    cmds = {
        f"extract-{p}": ["extract", "--preset", p, "--images", str(img_dir), "--out",
                         f"{out}/{p}.npz", "--batch-size", "4"]
        for p in ("config2", "config4")
    }
    for p, feats in PRESET_EXTRACT.items():
        feats, ckpt = f"{out}/{feats}.npz", f"{out}/ckpt-{p}"
        cmds[f"train-{p}"] = ["train", "--preset", p, "--tokens", tokens, "--split", train,
                              "--features", feats, "--checkpoint-dir", ckpt, "--epochs", "2",
                              "--batch-size", "4",
                              *(["--attention-reg", "0.01"] if p == "config4" else [])]
        cmds[f"caption-{p}"] = ["caption", "--preset", p, "--image", *images, "--checkpoint-dir", ckpt]
        cmds[f"evaluate-{p}"] = ["evaluate", "--preset", p, "--tokens", tokens, "--split", test,
                                 "--features", feats, "--checkpoint-dir", ckpt, "--batch-size", "4",
                                 "--metrics", "bleu,cider"]
    return cmds


@pytest.fixture(scope="module")
def preset_runs(tmp_path_factory):
    """-> {package: {"out": dir, command: (stdout lines, stderr lines)}} for
    the preset workflows, as ``runs`` makes them (5 images at 32 x 32, which
    the host resizes to 299 or 224)."""
    root = tmp_path_factory.mktemp("cli-presets")
    data = generate_fixture_dataset(root / "data", n_images=5, image_size=32, seed=4)
    mains = {"tpucap": jcli.main, "port": lambda argv: tcli.main(argv, device="cpu")}
    result = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "_build_config", _no_dropout(jcli._build_config))
        mp.setattr(tcli, "_build_config", _no_dropout(tcli._build_config))
        mp.setattr(JaxPipeline, "build", _build_with_ports_weights(JaxPipeline.build))
        for pkg, main in mains.items():
            out = root / pkg
            out.mkdir()
            result[pkg] = {"out": out}
            for name, argv in _preset_workflow(data, out).items():
                stdout, stderr = io.StringIO(), io.StringIO()
                with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr), \
                        warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    main(argv)
                result[pkg][name] = tuple(
                    [ln.replace(str(out), "<out>") for ln in s.getvalue().splitlines()
                     if "absl" not in ln]
                    for s in (stdout, stderr)
                )
    _TPUCAP_PARAMS.clear()
    return result


@pytest.mark.parametrize("preset,dim", [("config2", 2048), ("config4", 196 * 512)])
def test_cli_preset_extract_matches_tpucap(preset_runs, preset, dim):
    """InceptionV3 pooled at 299 (config2 and config5) and VGG16's block5
    grid at 224 (config4): f32, within 1e-5 of the features' scale."""
    ours, theirs = preset_runs["port"], preset_runs["tpucap"]
    assert ours[f"extract-{preset}"] == theirs[f"extract-{preset}"]
    got, want = np.load(ours["out"] / f"{preset}.npz"), np.load(theirs["out"] / f"{preset}.npz")
    assert got.files == want.files and len(want.files) == 5
    for k in want.files:
        assert got[k].size == dim
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * np.abs(want[k]).max())


@pytest.mark.parametrize("preset", ["config2", "config4", "config5"])
def test_cli_preset_train_caption_evaluate_match_tpucap(preset_runs, preset):
    """train's lines (4-decimal numbers to their last digit), caption's
    lines, and evaluate's scores within 1e-12; config4 trains with
    --attention-reg 0.01 (the coverage term over 196 cells is about 190
    here: at 1.0 the loss's last printed digit would be its 7th)."""
    ours, theirs = preset_runs["port"], preset_runs["tpucap"]
    _same_rounded_lines(ours[f"train-{preset}"][0], theirs[f"train-{preset}"][0])
    assert ours[f"train-{preset}"][0][-1].startswith("trained 2 epochs")
    assert ours[f"caption-{preset}"] == theirs[f"caption-{preset}"]
    assert len(ours[f"caption-{preset}"][0]) == 2
    (got_out, got_err), (want_out, want_err) = ours[f"evaluate-{preset}"], theirs[f"evaluate-{preset}"]
    assert got_err == want_err and got_out[:-1] == want_out[:-1]
    got, want = json.loads(got_out[-1]), json.loads(want_out[-1])
    assert list(got) == list(want)
    for k, w in want.items():
        assert (got[k] is None) == (w is None), k
        if w is not None:
            assert abs(got[k] - w) <= 1e-12, k


# -- parsers and config resolution -----------------------------------------------------

_LINES = [
    ["extract", "--images", "d", "--out", "o"],
    ["train"],
    ["caption", "--image", "a.jpg"],
    ["evaluate", "--features", "f.npz"],
    ["train", "--preset", "config1", "--tokens", "t", "--features", "f", "--lr", "0.01",
     "--val-metric", "cider", "--early-stopping-patience", "2", "--train-precision", "bf16",
     "--optimizer", "adamw", "--weight-decay", "0.01", "--grad-clip-norm", "1.0"],
    ["caption", "--preset", "config3", "--image", "a.jpg", "b.jpg", "--method", "greedy",
     "--approx-topk", "--average-last", "2"],
    ["evaluate", "--preset", "config1", "--features", "f", "--metrics", "bleu,meteor"],
    ["train", "--encoder", "resnet50", "--decoder", "lstm2", "--embed-dim", "64",
     "--hidden-dim", "96", "--max-len", "20", "--min-len", "2", "--bad-words", "a,b",
     "--length-penalty", "gnmt", "--lr", "0.01", "--epochs", "3", "--batch-size", "16",
     "--train-precision", "bf16", "--val-metric", "rouge_l", "--early-stopping-patience", "2",
     "--optimizer", "adamw", "--weight-decay", "0.01", "--grad-clip-norm", "1.0",
     "--features-kind", "spatial", "--num-layers", "3"],
    ["caption", "--encoder", "vit_tiny", "--image", "a.jpg", "--method", "beam",
     "--beam-width", "5", "--max-len", "16", "--no-repeat-ngram", "2", "--approx-topk"],
]


def _tpucap_namespace(argv, monkeypatch):
    seen = []
    for name in ("cmd_extract", "cmd_train", "cmd_caption", "cmd_evaluate"):
        monkeypatch.setattr(jcli, name, seen.append)
    jcli.main(argv)
    return seen[0]


@pytest.mark.parametrize("argv", _LINES, ids=lambda a: " ".join(a[:3]))
def test_parsers_and_build_config_match_tpucap(argv, monkeypatch):
    want = _tpucap_namespace(argv, monkeypatch)
    got = tcli.build_parser()[0].parse_args(argv)
    assert {k: v for k, v in vars(got).items() if k != "fn"} == {
        k: v for k, v in vars(want).items() if k != "fn"
    }
    ours = tcfg.config_to_dict(tcli._build_config(got))
    theirs = dataclasses.asdict(jcli._build_config(want))
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(theirs))


def test_config_defaults_and_presets_match_tpucap():
    """Every field of the port's Config(), and of each preset, is tpucap's
    (the encoder default is VGG16 / pooled / 4096 in both)."""
    norm = lambda d: json.loads(json.dumps(d))  # noqa: E731
    assert tcfg.Config().encoder == tcfg.EncoderConfig("vgg16", "pooled", 4096)
    assert norm(tcfg.config_to_dict(tcfg.Config())) == norm(dataclasses.asdict(jcfg.Config()))
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    for name, cfg in tcfg.PRESETS.items():
        assert norm(tcfg.config_to_dict(cfg)) == norm(dataclasses.asdict(jcfg.PRESETS[name])), name
        assert tcfg.config_from_dict(tcfg.config_to_dict(cfg)) == cfg
        # tpucap's own config.json of the preset reads as the port's preset.
        assert tcfg.config_from_dict(norm(dataclasses.asdict(jcfg.PRESETS[name]))) == cfg, name


_REFUSED = [
    ["extract", "--images", "/nonexistent", "--out", "o.npz", "--parallelism", "dp"],
    *[
        ["train", "--tokens", "/nonexistent", "--features", "/nonexistent", *flags]
        for flags in (
            ["--parallelism", "dp"], ["--parallelism", "pp"],
            ["--parallelism", "sp"], ["--sharded-checkpoints"], ["--scst-epochs", "2"], ["--scst-lr", "1e-4"],
            ["--scst-temperature", "0.5"], ["--tokenizer", "bpe"], ["--bpe-vocab-size", "512"],
            ["--parallelism", "tp"], ["--data-parallel"],
            ["--parallelism", "ep"], ["--parallelism", "fsdp"], ["--model-devices", "2"],
            ["--tensorboard-dir", "tb"],
        )
    ],
    *[
        ["export", "--checkpoint-dir", "/nonexistent", "--out", "/nonexistent/d.h5", *flags]
        for flags in (
            ["--format", "aot"], ["--aot-batch-size", "8"], ["--aot-ladder"], ["--include-encoder"],
        )
    ],
    *[
        ["caption", "--image", "/nonexistent.jpg", "--checkpoint-dir", "/nonexistent", *flags]
        for flags in (
            ["--method", "speculative"], ["--method", "diverse"], ["--method", "mbr"],
            ["--dump-attention", "a.npz"], ["--mbr-candidates", "3"], ["--mbr-from", "beam"],
            ["--mbr-metric", "bleu4"], ["--diverse-groups", "3"], ["--diversity", "0.1"],
            # Ported: what exits first is tpucap's own check of the dial
            # against a method or an ensemble.
            ["--ensemble-with", "b", "--prefix", "a dog"], ["--method", "greedy", "--include-words", "dog"],
            ["--draft-bundle", "b"],
            ["--gamma", "2"], ["--ensemble-with", "b"], ["--ensemble-weights", "1,1"],
        )
    ],
    *[
        ["serve", "--model-dir", "/nonexistent", "--checkpoint-dir", "/nonexistent", *flags]
        for flags in (
            ["--aot-bundle", "/nonexistent"],
            # Ported: what exits first is tpucap's own check of the pair.
            ["--extra-model", "b=/nonexistent", "--engine", "continuous"],
        )
    ],
    ["evaluate", "--features", "/nonexistent", "--checkpoint-dir", "/nonexistent",
     "--parallelism", "tp"],
    ["evaluate", "--features", "/nonexistent", "--checkpoint-dir", "/nonexistent",
     "--model-devices", "2"],
]


@pytest.mark.parametrize("argv", _REFUSED, ids=lambda a: f"{a[0]} {' '.join(a[-2:])}")
def test_unported_flags_exit_before_any_file_is_read(argv, monkeypatch):
    """Every path named is missing, so any read would raise another error;
    the card is reported absent, so the refusal also comes first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flag = next(a for a in reversed(argv) if a.startswith("--"))
    ported = {
        # The continuous engine and the dials are ported: tpucap's refusal
        # of the pair, in tpucap's words, before any file is read.
        "--engine": "--extra-model needs --engine batch",
        "--prefix": "--prefix supports --method greedy|beam (no ensemble)",
        "--include-words": "--include-words supports --method beam only (no ensemble/prefix/dump-attention)",
        "--dump-attention": "--dump-attention needs an attention decoder family "
        "(attention|adaptive|transformer), got --decoder lstm1",
        "--ensemble-weights": "--ensemble-weights needs --ensemble-with",
    }
    # Ported, and no check of tpucap's fires: without a card the device's
    # error comes first, before any file is read.
    no_card = ("--tensorboard-dir", "--mbr-candidates", "--mbr-from", "--mbr-metric",
               "--diverse-groups", "--diversity", "--ensemble-with")
    if argv[-2] in no_card or argv[-2:] in (["--method", "diverse"], ["--method", "mbr"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)
        return
    if argv[-2] in ported:
        with pytest.raises(SystemExit) as jerr:
            jcli.main(argv)
        with pytest.raises(SystemExit) as err:
            tcli.main(argv)
        assert str(err.value) == str(jerr.value) == ported[argv[-2]]
        return
    with pytest.raises(SystemExit, match=f"^{flag}.*not ported"):
        tcli.main(argv)


@pytest.mark.parametrize("argv,match", [
    (["--model-devices", "4"], "model_devices"),
    (["--decoder", "lstm2", "--model-devices", "8"], "model_devices"),
    (["--preset", "config1", "--model-devices", "4"], "model_devices"),
    (["--model-devices", "2"], "model_devices"),
    (["--preset", "config3", "--model-devices", "2"], "model_devices"),
    (["--preset", "config5", "--model-devices", "8"], "model_devices"),
])
def test_unported_config_fields_raise_from_build_config(argv, match):
    args = tcli.build_parser()[0].parse_args(["train", *argv])
    with pytest.raises(NotImplementedError, match=match):
        tcli._build_config(args)


@pytest.mark.parametrize("argv,match", [
    (["--decoder", "gru1"], "gru1"),
    (["--decoder", "gru2"], "gru2"),
    (["--decoder", "adaptive"], "adaptive"),
    (["--decoder", "transformer"], "transformer"),
])
def test_unported_encoders_and_decoders_raise(argv, match, monkeypatch):
    """gru1, gru2, adaptive and the transformer (all ported) build from the
    CLI's config, the decoder tpucap's class with tpucap's fields and param
    shapes (``jax.eval_shape`` of its init: nothing compiled)."""
    line = ["train", "--encoder", "tiny_cnn", *argv, "--embed-dim", "16", "--hidden-dim", "24",
            "--tokens", "t", "--features", "f"]
    tok = Tokenizer()
    tok.fit_on_texts(["startseq a dog runs endseq"])
    pipe = CaptioningPipeline(tcli._build_config(tcli.build_parser()[0].parse_args(line)), tokenizer=tok,
                              device="cpu")
    pipe.build(seed=0)
    jpipe = JaxPipeline(jcli._build_config(_tpucap_namespace(line, monkeypatch)),
                        tokenizer=JaxTokenizer.from_json(tok.to_json()))
    jpipe.build(init_params=False)
    assert type(pipe.decoder).__name__ == type(jpipe.decoder).__name__
    assert dataclasses.asdict(pipe.decoder) == dataclasses.asdict(jpipe.decoder)
    want = jax.eval_shape(jpipe.decoder.init, jax.random.key(0))
    got = params_to_numpy(pipe.params["decoder"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(got)] == [a.shape for a in jax.tree.leaves(want)]


def test_commands_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in _LINES[:4]:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)
    out = subprocess.run([sys.executable, "-m", "tpucap_torch", "caption", "--image", "a.jpg"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    helped = subprocess.run([sys.executable, "-m", "tpucap_torch", "--help"], cwd=ROOT,
                            capture_output=True, text=True, timeout=120)
    assert helped.returncode == 0 and (
        "{extract,train,caption,score,evaluate,compare,export,serve,doctor,profile}" in helped.stdout)
