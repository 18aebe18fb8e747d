"""tpucap_torch stands alone: no module of it, nor chip_smoke.py, imports
jax, anything of tpucap, nltk, PIL, h5py, tensorflow, tensorboard, tf_keras
or keras (its JPEG files go through its own decoder only, whatever the host
has installed; its BLEU, METEOR and Porter stemmer are its own; it writes and
reads Keras .h5 files with its own HDF5 code, and TensorBoard event files
with its own writer), and its JPEG decoder links no libjpeg; its
HTTP client imports only the standard library; scoring
captions with every metric loads none of them either; its entry points
refuse to run on the CPU
unless asked; chip_smoke.py fails, printing no result, without a card or
outside the repo."""

import json
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tpucap_torch
from tpucap_torch.config import Config
from tpucap_torch.pipeline import CaptioningPipeline

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

# Runs in a fresh interpreter: a finder that refuses jax, tpucap, nltk, PIL and
# the HDF5 / Keras / TensorBoard stack, then every module of the package and
# chip_smoke, a Keras .h5 and an event file written and read back by the port,
# then a look at sys.modules.
_REFUSE = """
import importlib, importlib.abc, json, pkgutil, sys

REFUSED = (
    "jax", "jaxlib", "tpucap", "nltk", "PIL", "h5py", "tensorflow", "tf_keras", "keras",
    "tensorboard",
)

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
"""
_PROBE = _REFUSE + """
import tpucap_torch
names = ["chip_smoke"] + [
    m.name for m in pkgutil.walk_packages(tpucap_torch.__path__, "tpucap_torch.")
]
for n in names:
    importlib.import_module(n)

import os, tempfile
import torch
from tpucap_torch.checkpoint import KerasH5Model, export_h5, merge_decoder_params_from_keras
from tpucap_torch.models.decoders import build_decoder

dec = build_decoder("lstm1", vocab_size=7, feature_dim=5, embed_dim=4, hidden_dim=4)
params = dec.init(torch.Generator().manual_seed(0))
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "decoder.h5")
    export_h5(dec, params, path, max_len=3)
    back = merge_decoder_params_from_keras(KerasH5Model(path))
h5_ok = bool((back["out"]["kernel"] == params["out"]["kernel"].numpy()).all())
from tpucap_torch.utils import MetricsLogger, read_scalars

with tempfile.TemporaryDirectory() as tmp:
    with MetricsLogger(tensorboard_dir=tmp) as log:
        log.log({"epoch": 1, "loss": 0.5})
    h5_ok = h5_ok and read_scalars(tmp) == [("loss", 1, 0.5)]
loaded = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
print(json.dumps({"imported": names, "loaded": loaded, "h5": h5_ok}))
"""
# evaluate_captions with every metric, METEOR's synonym stage included.
_SCORE = _REFUSE + """
from tpucap_torch.train.evaluate import METRICS, evaluate_captions

scores = evaluate_captions(
    {"a": ["startseq a dog runs on grass endseq"], "b": ["startseq two dogs played endseq"]},
    {"a": "a hound running on grass", "b": "two dogs playing"},
    metrics=METRICS, meteor_synonyms={"dog": ["hound"]},
)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
print(json.dumps({"scores": sorted(scores), "loaded": loaded}))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_tpucap():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert res["h5"]
    want = {m.name for m in pkgutil.walk_packages(tpucap_torch.__path__, "tpucap_torch.")}
    assert want <= set(res["imported"])
    assert {
        "tpucap_torch.pipeline", "tpucap_torch.ops.decoder_step",
        "tpucap_torch.ops.bottleneck", "tpucap_torch.ops.attention",
        "tpucap_torch.models.encoders.vit", "tpucap_torch.text.padding",
        "tpucap_torch.train", "tpucap_torch.train.sequences",
        "tpucap_torch.train.loss", "tpucap_torch.train.loop",
        "tpucap_torch.train.finetune", "tpucap_torch.ops.jpeg",
        "tpucap_torch.data.preprocess", "tpucap_torch.data.pipeline",
        "tpucap_torch.train.evaluate", "tpucap_torch.train.metrics",
        "tpucap_torch.text.porter", "tpucap_torch.checkpoint.hdf5",
        "tpucap_torch.checkpoint.keras_import", "tpucap_torch.checkpoint.keras_export",
        "tpucap_torch.serve", "tpucap_torch.serve_http", "tpucap_torch.client",
        "tpucap_torch.decode.sample", "tpucap_torch.utils.events",
        "tpucap_torch.utils.profiling", "tpucap_torch.utils.debug",
    } <= want


def test_client_imports_only_the_standard_library():
    """The client drops into any process: importing it loads neither torch
    nor numpy (nor anything of tpucap or jax)."""
    probe = _REFUSE + """
import tpucap_torch.client
heavy = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "numpy") + REFUSED)
print(json.dumps(heavy))
"""
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_scoring_with_every_metric_loads_no_nltk():
    out = subprocess.run(
        [sys.executable, "-c", _SCORE], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert {"bleu4", "cider", "rouge_l", "meteor", "distinct_1"} <= set(res["scores"])


def test_jpeg_decoder_links_no_libjpeg():
    from tpucap_torch import _build

    src = (ROOT / "tpucap_torch" / "csrc" / "jpeg_decode.cpp").read_text()
    assert "jpeglib" not in src
    lib = _build.build_host("jpeg_decode")
    out = subprocess.run(["ldd", lib._name], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "libjpeg" not in out.stdout and "libstdc++" in out.stdout


def test_pipeline_without_device_refuses_a_cpu_only_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CaptioningPipeline(Config())
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        CaptioningPipeline(Config(), device="cuda")
    assert CaptioningPipeline(Config(), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, where):
    """Here there is no card; alone, chip_smoke.py also has no package."""
    if torch.cuda.is_available() and where == "repo":
        pytest.skip("a card is present: chip_smoke.py would run")
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
