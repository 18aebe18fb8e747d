"""tpucap_torch's ``train --finetune-encoder`` and train's checkpoint flags
(``--resume``, ``--handle-preemption``, ``--checkpoint-every-steps``,
``--grad-accum-steps``) against tpucap's CLI, on the CPU.

One module fixture runs both packages' CLIs (the port's through
``main(argv, device="cpu")``) on a generated Flickr8k-format dataset of 5
JPEGs at 32 x 32 (tpucap's ``generate_fixture_dataset``) with tiny_cnn and
lstm1 (max_len 12), batch 4, lr 0.01, two epochs; as in
``tests/test_torch_cli.py`` the port's ``CaptioningPipeline.build``
installs ``convert.params_from_jax`` of tpucap's ``build()`` and both
``_build_config``s set dropout 0. Each package runs
``train --finetune-encoder --remat-encoder --grad-accum-steps 2
--checkpoint-every-steps 2 --handle-preemption`` once: the printed lines
equal but for a 4-decimal number, which may differ by one unit in its last
place (``tests/test_torch_cli.py``); the checkpoint steps each manager holds
after it equal; the port's bundle loads and its greedy captions of every
image equal tpucap's bundle's. The port then runs tpucap's resume workflow
(``tests/test_cli.py``) with tpucap's lines: the same command cut by its
guard (patched in the fixture: a subclass that fires on its 2nd query,
after the 2nd step), ``--resume`` to the end (the bundle's params equal the
uncut run's bit for bit), and ``--resume`` again with nothing left; the
features path (features from the port's ``extract``) with
``--grad-accum-steps 2 --checkpoint-every-steps 2`` cut and resumed the
same way; and ``--augment --augment-shift 2``, which is not compared with
tpucap (jax's draws cannot be made in torch,
``tests/test_torch_augment.py``), cut and resumed against its own uncut
run, bit for bit. Each refused flag combination exits with tpucap's
message before any file is read.
"""

import contextlib
import dataclasses
import importlib
import io
import json
import warnings

import jax
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
from tpucap_torch.convert import params_from_jax
from tpucap_torch.core import tree_leaves
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.train import PreemptionGuard

torch.set_num_threads(2)

jcli = importlib.import_module("tpucap.cli.main")
tcli = importlib.import_module("tpucap_torch.cli.main")
tpipe = importlib.import_module("tpucap_torch.pipeline")
COMMON = ["--encoder", "tiny_cnn", "--max-len", "12"]
_NUMBER = __import__("re").compile(r"-?\d+\.(\d+)")


def _no_dropout(build_config):
    def build(args):
        cfg = build_config(args)
        return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, dropout_rate=0.0))

    return build


#: tpucap's built params (numpy), by config, seed and vocabulary: what its
#: ``build()`` gave in this module's fixture (``_recording_build``).
_TPUCAP_PARAMS: dict = {}


def _build_key(jconfig, jtok):
    """The config (its train.seed included) and the vocabulary: all that
    tpucap's ``build()`` reads."""
    return json.dumps(dataclasses.asdict(jconfig), sort_keys=True), jtok and jtok.to_json()


def _recording_build(orig):
    """tpucap's ``build``, its params recorded as numpy copies."""

    def build(self, rng=None, init_params=True):
        out = orig(self, rng, init_params)
        if rng is None and init_params:
            _TPUCAP_PARAMS[_build_key(self.config, self.tokenizer)] = jax.tree.map(np.array, self.params)
        return out

    return build


def _build_with_tpucaps_weights(orig):
    """The port's build with tpucap's weights for the same config and
    vocabulary: those a tpucap command recorded, else a tpucap build made
    here."""

    def build(self, seed=None, init_params=True):
        orig(self, seed, init_params=False)
        if init_params:
            jconfig = jcfg.config_from_dict(json.loads(json.dumps(tcfg.config_to_dict(self.config))))
            jtok = JaxTokenizer.from_json(self.tokenizer.to_json())
            key = _build_key(jconfig, jtok)
            if key not in _TPUCAP_PARAMS:
                jpipe = JaxPipeline(jconfig, tokenizer=jtok)
                jpipe.build()
                _TPUCAP_PARAMS[key] = jax.tree.map(np.asarray, jpipe.params)
            self.set_params(params_from_jax(_TPUCAP_PARAMS[key]))
        return self.params

    return build


def _guard_after(base, n):
    """``base`` (each package's PreemptionGuard) that fires on its n-th query."""

    class Guard(base):
        calls = 0

        @property
        def fired(self):
            Guard.calls += 1
            return Guard.calls >= n or super().fired

    return Guard


def _train(data, out, ckpt, *flags):
    img_dir, tokens, train, _ = data
    return ["train", *COMMON, "--tokens", tokens, "--split", train, "--checkpoint-dir", f"{out}/{ckpt}",
            "--epochs", "2", "--batch-size", "4", "--lr", "0.01", *flags]


def _finetune(data, out, ckpt="ft", *flags):
    return _train(data, out, ckpt, "--finetune-encoder", "--images", str(data[0]), *flags)


FT_DIALS = ["--remat-encoder", "--grad-accum-steps", "2", "--checkpoint-every-steps", "2"]
FIT_DIALS = ["--grad-accum-steps", "2", "--checkpoint-every-steps", "2"]


def _steps(pkg, directory):
    if pkg == "tpucap":
        mgr = JaxManager(str(directory), best_metric="val_loss")
        steps = [int(s) for s in mgr.all_steps()]
        mgr.close()
        return steps
    return CheckpointManager(directory).all_steps()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> {package: {"out": dir, command: (stdout lines, steps held after it)}}:
    tpucap runs the fine-tune once, the port that run and its workflows."""
    root = tmp_path_factory.mktemp("clift")
    data = generate_fixture_dataset(root / "data", n_images=5, image_size=32, seed=5)
    feats = str(root / "features.npz")
    tcli.main(["extract", *COMMON, "--images", str(data[0]), "--out", feats, "--batch-size", "4"], device="cpu")
    mains = {"tpucap": jcli.main, "port": lambda argv: tcli.main(argv, device="cpu")}
    aug = ["--augment", "--augment-shift", "2", "--checkpoint-every-steps", "2"]
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
            commands = {"ft": (_finetune(data, out, "ft", *FT_DIALS, "--handle-preemption"), "ft")}
            if pkg == "port":
                commands.update({
                    "ft-cut": (_finetune(data, out, "wf", *FT_DIALS, "--handle-preemption"), "wf"),
                    "ft-resume": (_finetune(data, out, "wf", *FT_DIALS, "--resume"), "wf"),
                    "ft-again": (_finetune(data, out, "wf", *FT_DIALS, "--resume"), "wf"),
                    "fit-cut": (_train(data, out, "fit", "--features", feats, *FIT_DIALS, "--handle-preemption"), "fit"),
                    "fit-resume": (_train(data, out, "fit", "--features", feats, *FIT_DIALS, "--resume",
                                          "--bundle-out", f"{out}/fit-bundle"), "fit"),
                    "aug-cut": (_finetune(data, out, "aug", *aug, "--handle-preemption"), "aug"),
                    "aug-resume": (_finetune(data, out, "aug", *aug, "--resume"), "aug"),
                    "aug-uncut": (_finetune(data, out, "aug-uncut", *aug), "aug-uncut"),
                })
            for name, (argv, ckpt) in commands.items():
                stdout = io.StringIO()
                with contextlib.ExitStack() as stack:
                    if name.endswith("-cut"):
                        stack.enter_context(pytest.MonkeyPatch.context()).setattr(
                            tpipe, "PreemptionGuard", _guard_after(PreemptionGuard, 2))
                    stack.enter_context(contextlib.redirect_stdout(stdout))
                    stack.enter_context(warnings.catch_warnings())
                    warnings.simplefilter("ignore")
                    main(argv)
                lines = [ln.replace(str(out), "<out>") for ln in stdout.getvalue().splitlines() if "absl" not in ln]
                result[pkg][name] = (lines, _steps(pkg, out / ckpt))
    _TPUCAP_PARAMS.clear()
    return result


def _same_rounded_lines(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert _NUMBER.sub("#", g) == _NUMBER.sub("#", w), (g, w)
        for a, b in zip(_NUMBER.finditer(g), _NUMBER.finditer(w)):
            assert abs(float(a[0]) - float(b[0])) <= 1.01 * 10.0 ** -len(b[1]), (g, w)


def test_finetune_lines_and_checkpoint_steps_match_tpucap(runs):
    (got, got_steps), (want, want_steps) = runs["port"]["ft"], runs["tpucap"]["ft"]
    _same_rounded_lines(got, want)
    # 15 rows, batch 4: 3 steps an epoch; interval saves at 2 and 4, each
    # metric-less one sweeping the one before, epoch saves at 3 and 6.
    assert got_steps == want_steps == [3, 4, 6]
    assert got[-1].startswith("finetuned 2 epochs; final loss ") and got[-1].endswith("bundle in <out>/ft/bundle")


#: The resume workflow's lines (tpucap's): the cut after step 2, its
#: resume, a second resume with nothing left; the features path's too.
_WORKFLOW = {
    "ft-cut": ("preempted at epoch 0 step 2; rescue checkpoint written",
               "preempted after 1 epoch entries; rescue checkpoint written — rerun the same command with "
               "--resume to continue (checkpoints in <out>/wf; bundle in <out>/wf/bundle carries the "
               "mid-run weights)"),
    "ft-resume": ("resumed from step 2 (epoch 0, batch 2)", "finetuned 2 epochs; final loss "),
    "ft-again": ("resumed from step 6 (epoch 2, batch 0)",
                 "nothing to train: the restored checkpoint already covers the requested epochs; "
                 "checkpoints in <out>/wf"),
    "fit-cut": ("preempted at epoch 0 step 2; rescue checkpoint written",
                "preempted after 1 epoch entries; rerun the same command with --resume to continue "
                "(checkpoints in <out>/fit)"),
    "fit-resume": ("resumed from step 2 (epoch 0, batch 2)", "wrote pipeline bundle to <out>/fit-bundle"),
}


@pytest.mark.parametrize("name", list(_WORKFLOW))
def test_resume_workflow_lines_and_steps(runs, name):
    lines, steps = runs["port"][name]
    first, last = _WORKFLOW[name]
    assert lines[0].startswith(first) and lines[-1].startswith(last), lines
    assert steps == {"ft-cut": [2], "fit-cut": [2]}.get(name, [3, 4, 6])
    if name == "ft-resume":
        assert lines[-1] == runs["port"]["ft"][0][-1].replace("<out>/ft/", "<out>/wf/")
    if name == "fit-resume":
        assert lines[-2].startswith("trained 2 epochs; final loss ")


def test_resumed_bundle_equals_the_uncut_one(runs):
    out = runs["port"]["out"]
    got = CaptioningPipeline.load(out / "wf" / "bundle", device="cpu").params
    want = CaptioningPipeline.load(out / "ft" / "bundle", device="cpu").params
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert torch.equal(a, b)


def test_finetuned_bundle_loads_and_captions_as_tpucaps(runs):
    ours, theirs = runs["port"]["out"], runs["tpucap"]["out"]
    bundle = CaptioningPipeline.load(ours / "ft" / "bundle", device="cpu")
    assert json.loads(json.dumps(tcfg.config_to_dict(bundle.config))) == json.loads(
        (theirs / "ft" / "bundle" / "config.json").read_text())
    images = sorted(str(p) for p in (ours.parent / "data" / "images").glob("*.jpg"))
    jbundle = JaxPipeline.load(str(theirs / "ft" / "bundle"))
    assert bundle.caption_images(images) == jbundle.caption_images(images)


def test_resumed_augmented_bundle_equals_the_uncut_one(runs):
    port = runs["port"]
    assert port["aug-cut"][0][-1].startswith("preempted after 1 epoch entries")
    assert port["aug-resume"][0][-1].startswith("finetuned 2 epochs")
    assert port["aug-uncut"][0][-1] == port["aug-resume"][0][-1].replace("<out>/aug/", "<out>/aug-uncut/")
    got = CaptioningPipeline.load(port["out"] / "aug" / "bundle", device="cpu").params
    want = CaptioningPipeline.load(port["out"] / "aug-uncut" / "bundle", device="cpu").params
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert torch.equal(a, b)


_REFUSED = [
    ["--features", "f.npz", "--augment"],
    ["--features", "f.npz", "--augment-shift", "2"],
    ["--features", "f.npz", "--remat-encoder"],
    ["--features", "f.npz", "--resume", "--ema-decay", "0.9"],
    ["--features", "f.npz", "--handle-preemption", "--ema-decay", "0.9"],
    ["--finetune-encoder"],
    ["--finetune-encoder", "--images", "d", "--val-split", "v.txt"],
    ["--finetune-encoder", "--images", "d", "--early-stopping-patience", "2"],
    ["--finetune-encoder", "--images", "d", "--val-split", "v.txt", "--early-stopping-patience", "2"],
    [],
]


@pytest.mark.parametrize("flags", _REFUSED, ids=lambda f: " ".join(f) or "no-features")
def test_refused_combinations_exit_with_tpucaps_message(flags):
    """Every path named is missing: the check must come before any file is
    read."""
    argv = ["train", "--tokens", "/nonexistent", *flags]
    with pytest.raises(SystemExit) as ours:
        tcli.main(argv, device="cpu")
    with pytest.raises(SystemExit) as theirs:
        jcli.main(argv)
    assert isinstance(ours.value.code, str) and ours.value.code == theirs.value.code
