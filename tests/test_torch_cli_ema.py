"""tpucap_torch's ``train --ema-decay`` with tpucap's optimizer flags, and
the restore commands' template built from the same flags, against tpucap's
CLI, on the CPU.

One module fixture runs both packages' CLIs (the port's through
``main(argv, device="cpu")``) on a generated Flickr8k-format dataset (6
JPEGs at 32 x 32, tpucap's ``generate_fixture_dataset``: 4 training images
with 5 captions each) and one shared features file of seeded 128-d rows
(tiny_cnn's width): lstm1 (max_len 12), batch 4, three epochs of 5 steps at
lr 0.05 under ``--optimizer sgd --momentum 0.9 --lr-schedule cosine
--warmup-steps 2 --ema-decay 0.9``, then ``evaluate --average-last 2`` and
``caption`` (the best step) with the same optimizer flags. As in
``tests/test_torch_cli_finetune.py``, whose helpers this file takes, the
port's ``CaptioningPipeline.build`` installs ``convert.params_from_jax``
of tpucap's ``build()`` (recorded from tpucap's own command) and both
``_build_config``s set dropout 0.

Tolerances: train's lines equal but for a 4-decimal number, which may
differ by one unit in its last place (``tests/test_torch_cli.py``); the
checkpoint steps the same; ``bundle_ema``'s params within 1e-5 of each
tensor's scale of tpucap's (the trained params differ by f32 summation
order; ``tests/test_torch_ema.py``) and its config.json tpucap's;
evaluate's scores within 1e-12, caption's lines identical. The port alone:
rmsprop and adagrad checkpoints restore with their own flags and are
refused with plain Adam's.
"""

import contextlib
import io
import json
import warnings

import jax
import numpy as np
import pytest
import torch

# The fine-tune CLI test's helpers: dropout off, tpucap's weights recorded
# and installed, lines compared to their last printed digit.
from test_torch_cli_finetune import (
    _TPUCAP_PARAMS,
    COMMON,
    _build_with_tpucaps_weights,
    _no_dropout,
    _recording_build,
    _same_rounded_lines,
    jcli,
    tcli,
)
from tpucap.checkpoint import CheckpointManager as JaxManager
from tpucap.data import generate_fixture_dataset
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap_torch import config as tcfg
from tpucap_torch.checkpoint import CheckpointManager
from tpucap_torch.convert import params_to_numpy
from tpucap_torch.pipeline import CaptioningPipeline

torch.set_num_threads(2)

OPTIMIZER = ["--optimizer", "sgd", "--momentum", "0.9", "--lr-schedule", "cosine", "--warmup-steps", "2"]

def _commands(data, feats, out, optimizer=OPTIMIZER):
    img_dir, tokens, train, test = data
    ckpt = f"{out}/ckpt"
    images = sorted(str(p) for p in img_dir.glob("*.jpg"))
    return {
        "train": ["train", *COMMON, "--tokens", tokens, "--split", train, "--features", feats,
                  "--checkpoint-dir", ckpt, "--epochs", "3", "--batch-size", "4", "--lr", "0.05",
                  "--ema-decay", "0.9", *optimizer, "--bundle-out", f"{out}/bundle"],
        "evaluate": ["evaluate", *COMMON, "--tokens", tokens, "--split", test, "--features", feats,
                     "--checkpoint-dir", ckpt, "--average-last", "2", "--batch-size", "4",
                     "--metrics", "bleu,cider", *optimizer],
        "caption": ["caption", *COMMON, "--image", *images[:2], "--checkpoint-dir", ckpt, *optimizer],
    }


def _run(main, argv, out):
    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main(argv)
    return tuple(
        [ln.replace(str(out), "<out>") for ln in s.getvalue().splitlines() if "absl" not in ln]
        for s in (stdout, stderr)
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> {package: {"out": dir, command: (stdout lines, stderr lines)}}."""
    root = tmp_path_factory.mktemp("cliema")
    data = generate_fixture_dataset(root / "data", n_images=6, image_size=32, seed=6)
    data = (root / "data" / "images", *data[1:])
    rng = np.random.default_rng(6)
    feats = str(root / "features.npz")
    np.savez(feats, **{p.stem: rng.normal(size=128).astype(np.float32) for p in data[0].glob("*.jpg")})
    mains = {"tpucap": jcli.main, "port": lambda argv: tcli.main(argv, device="cpu")}
    result = {"data": data, "features": feats}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "_build_config", _no_dropout(jcli._build_config))
        mp.setattr(tcli, "_build_config", _no_dropout(tcli._build_config))
        mp.setattr(CaptioningPipeline, "build", _build_with_tpucaps_weights(CaptioningPipeline.build))
        mp.setattr(JaxPipeline, "build", _recording_build(JaxPipeline.build))
        for pkg, main in mains.items():
            out = root / pkg
            out.mkdir()
            result[pkg] = {"out": out}
            for name, argv in _commands(data, feats, out).items():
                result[pkg][name] = _run(main, argv, out)
    _TPUCAP_PARAMS.clear()
    return result


def test_train_lines_and_bundle_ema_match_tpucap(runs):
    ours, theirs = runs["port"], runs["tpucap"]
    _same_rounded_lines(ours["train"][0], theirs["train"][0])
    assert ours["train"][0][-3] == "EMA weights (decay 0.9) bundled in <out>/ckpt/bundle_ema"
    assert ours["train"][0][-2].startswith("trained 3 epochs; final loss ")
    mgr, jmgr = CheckpointManager(ours["out"] / "ckpt"), JaxManager(str(theirs["out"] / "ckpt"))
    assert mgr.all_steps() == [int(s) for s in jmgr.all_steps()] == [5, 10, 15]
    jmgr.close()
    bundle = CaptioningPipeline.load(ours["out"] / "ckpt" / "bundle_ema", device="cpu")
    assert json.loads(json.dumps(tcfg.config_to_dict(bundle.config))) == json.loads(
        (theirs["out"] / "ckpt" / "bundle_ema" / "config.json").read_text())
    assert bundle.config.train.ema_decay == 0.9 and bundle.config.train.optimizer == "sgd"
    jbundle = JaxPipeline.load(str(theirs["out"] / "ckpt" / "bundle_ema"))
    got, want = params_to_numpy(bundle.params), jax.tree.map(np.asarray, jbundle.params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    # The EMA bundle is not the trained iterate that --bundle-out holds.
    raw = CaptioningPipeline.load(ours["out"] / "bundle", device="cpu")
    assert not torch.equal(raw.params["decoder"]["out"]["kernel"], bundle.params["decoder"]["out"]["kernel"])


@pytest.mark.parametrize("name", ["evaluate", "caption"])
def test_restores_with_the_optimizer_flags_match_tpucap(runs, name):
    (got_out, got_err), (want_out, want_err) = runs["port"][name], runs["tpucap"][name]
    assert got_err == want_err
    if name == "caption":
        assert got_out == want_out and len(got_out) == 2
        return
    assert got_out[:-1] == want_out[:-1]
    got, want = json.loads(got_out[-1]), json.loads(want_out[-1])
    assert list(got) == list(want) and "cider" in got
    for k, w in want.items():
        assert (got[k] is None) == (w is None), k
        if w is not None:
            assert abs(got[k] - w) <= 1e-12, k


@pytest.mark.parametrize("optimizer", ["rmsprop", "adagrad"])
def test_rmsprop_and_adagrad_checkpoints_restore_with_their_flags(runs, optimizer, tmp_path):
    flags = ["--optimizer", optimizer, "--lr-schedule", "exponential", "--lr-decay-steps", "3"]
    cmds = _commands(runs["data"], runs["features"], tmp_path, flags)
    main = lambda argv: tcli.main(argv, device="cpu")  # noqa: E731
    lines = _run(main, cmds["train"], tmp_path)[0]
    assert lines[-2].startswith("trained 3 epochs") and lines[-3].endswith("<out>/ckpt/bundle_ema")
    scores = json.loads(_run(main, cmds["evaluate"], tmp_path)[0][-1])
    assert 0.0 <= scores["bleu4"] <= 1.0
    plain = _commands(runs["data"], runs["features"], tmp_path, [])["evaluate"]
    with pytest.raises(ValueError, match="opt_state"):
        _run(main, plain, tmp_path)
