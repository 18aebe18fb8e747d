"""The port's tools against tpucap's on the CPU: ``MetricsLogger``'s
TensorBoard event files (``tpucap_torch/utils/events.py``, written with the
standard library) against the ones tpucap writes through TensorFlow,
``read_scalars``, ``StepTimer``, ``debug_mode`` and ``checked`` (after
tpucap's ``tests/test_utils.py``), and the CLI's ``doctor``, ``profile`` and
``train --tensorboard-dir`` through ``main(..., device="cpu")``.

TensorFlow's ``summary_iterator`` is the independent reader of both
packages' files (as in tpucap's ``tests/test_keras_export.py``): every
record's tag, step, value, dtype and plugin must be equal, the value bit
for bit (both write the f32 of the logged number). The profile traces are
Chrome trace JSON: each holds exactly ``--steps`` ``profile_step`` ranges.
"""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from tensorflow.python.summary.summary_iterator import summary_iterator

from tpucap.data import generate_fixture_dataset
from tpucap.utils import MetricsLogger as JaxMetricsLogger
from tpucap_torch.utils import MetricsLogger, StepTimer, checked, debug_mode, read_scalars
from tpucap_torch.utils.events import crc32c, masked_crc

torch.set_num_threads(2)

jcli = importlib.import_module("tpucap.cli.main")
tcli = importlib.import_module("tpucap_torch.cli.main")

RECORDS = [
    {"epoch": 1, "loss": 2.5, "val_bleu4": 0.125, "preempted": False, "note": "text"},
    {"epoch": 2, "loss": 1.0 / 3.0, "count": 123456789, "wall_time": 7.0},
    {"loss": 0.75, "flag": True},  # the running counter: 2 log calls so far
    {"step": 40, "lr": 1e-3, "nested": {"a": 1}, "big": 2**40},
    {"loss": -1.5e-8},
]


def _events(path):
    """(tag, step, dtype, plugin, value bytes, simple_value) of every scalar
    TensorFlow reads from the event file in ``path``; the file_version."""
    (f,) = Path(path).glob("*tfevents*")
    out, version = [], None
    for e in summary_iterator(str(f)):
        if e.file_version:
            version = e.file_version
        for v in e.summary.value:
            out.append((v.tag, e.step, v.tensor.dtype, v.metadata.plugin_data.plugin_name,
                        v.tensor.tensor_content, tuple(v.tensor.tensor_shape.dim), v.simple_value))
    return out, version


def test_event_files_hold_tpucaps_records(tmp_path):
    for cls, name in ((JaxMetricsLogger, "tpucap"), (MetricsLogger, "port")):
        with cls(tmp_path / f"{name}.jsonl", tensorboard_dir=tmp_path / name) as log:
            for r in RECORDS:
                log.log(r)
    got, got_version = _events(tmp_path / "port")
    want, want_version = _events(tmp_path / "tpucap")
    assert got == want and got_version == want_version == "brain.Event:2"
    assert [g[0] for g in got] == ["loss", "val_bleu4", "preempted", "loss", "count", "loss", "flag",
                                   "lr", "big", "loss"]
    (port_file,) = (tmp_path / "port").glob("*tfevents*")
    assert "tfevents" in port_file.name
    # read_scalars reads either package's file, and the values are the f32s.
    back = read_scalars(tmp_path / "port")
    assert back == read_scalars(next((tmp_path / "tpucap").glob("*tfevents*")))
    assert back[:3] == [("loss", 1, 2.5), ("val_bleu4", 1, 0.125), ("preempted", 1, 0.0)]
    assert back[5:7] == [("loss", 2, 0.75), ("flag", 2, 1.0)]
    assert back[-1] == ("loss", 4, float(np.float32(-1.5e-8)))
    # The JSONL half is unchanged.
    lines = [json.loads(ln) for ln in (tmp_path / "port.jsonl").read_text().splitlines()]
    assert [{k: v for k, v in ln.items() if k != "wall_time"} for ln in lines] == [
        {k: v for k, v in r.items() if k != "wall_time"} for r in RECORDS
    ]
    assert lines[1]["wall_time"] == 7.0


def test_crc32c_check_values():
    # RFC 3720's check value, and the masked form TFRecord frames with.
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0
    assert masked_crc(b"") == 0xA282EAD8


def test_read_scalars_refuses_a_corrupt_file(tmp_path):
    with MetricsLogger(tensorboard_dir=tmp_path) as log:
        log.log({"step": 3, "loss": 1.5})
    (f,) = tmp_path.glob("*tfevents*")
    assert read_scalars(f) == [("loss", 3, 1.5)]
    data = bytearray(f.read_bytes())
    data[-6] ^= 1
    f.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bad record data"):
        read_scalars(f)
    f.write_bytes(bytes(data[:-2]))  # cut inside the last checksum
    with pytest.raises(ValueError, match="bad record data"):
        read_scalars(f)


def test_step_timer_sync():
    t = StepTimer()
    x = torch.arange(1000.0)
    t.start()
    y = (x * 2).sum()
    dt = t.stop(sync_value={"loss": y, "n": [y, 3]})
    assert dt > 0 and t.median == dt and t.rate(100) > 0
    assert StepTimer().median == 0.0 and StepTimer().rate(5) == 0.0


def test_debug_mode_and_checked():
    x = torch.tensor([1.0, -1.0])
    assert torch.isnan(torch.log(x)).any()  # no check outside
    with pytest.raises(FloatingPointError, match="nan"):
        with debug_mode(nans=True):
            torch.log(x)
    with debug_mode(nans=False, disable_jit=True):
        torch.log(x)
    with debug_mode():
        torch.log(x.abs())

    @checked
    def f(v, scale=2.0):
        return torch.log(v) * scale

    assert float(f(torch.tensor(1.0), scale=4.0)) == 0.0
    with pytest.raises(FloatingPointError):
        f(torch.tensor(-1.0))
    idx = checked(lambda v, i: (v.index_select(0, i), v.gather(0, i), v[i]))
    idx(torch.arange(3.0), torch.tensor([0, 2, 1]))
    for bad in ([3], [-1]):
        with pytest.raises(IndexError, match="aten.index_select.default: an index leaves"):
            idx(torch.arange(3.0), torch.tensor(bad))
    assert checked(lambda v, i: v[i])(torch.arange(3.0), torch.tensor([-1])).tolist() == [2.0]
    with pytest.raises(IndexError, match="aten.index.Tensor: an index leaves"):
        checked(lambda v, i: v[i])(torch.arange(3.0), torch.tensor([-4]))
    emb = checked(lambda w, i: torch.nn.functional.embedding(i, w))
    with pytest.raises(IndexError, match="aten.embedding.default: an index leaves"):
        emb(torch.ones(4, 2), torch.tensor([4]))
    div = checked(lambda a, b: (a // b, a % b))
    div(torch.tensor([7]), torch.tensor([2]))
    with pytest.raises(ZeroDivisionError):
        div(torch.tensor([7]), torch.tensor([0]))
    assert checked(lambda a: a / 0.0, nan=False)(torch.tensor([0.0])).isnan().all()
    assert checked(lambda a, b: a / b)(torch.tensor([1]), torch.tensor([0])).isinf().all()  # true division
    with pytest.raises(ZeroDivisionError):
        div(torch.tensor([7]), 0)
    loose = checked(lambda v, i: v.index_select(0, i), oob=False, nan=False)
    with pytest.raises(IndexError):  # torch's own check on the CPU
        loose(torch.arange(3.0), torch.tensor([5]))


def _doctor(capsys, argv, device="cpu"):
    tcli.main(["doctor", *argv], device=device)
    return json.loads(capsys.readouterr().out)


def test_doctor_reports_tpucaps_layout(capsys, monkeypatch):
    jcli.main(["doctor"])
    theirs = json.loads(capsys.readouterr().out)
    ours = _doctor(capsys, [])
    # Every key of tpucap's that has a counterpart in the port.
    counterparts = {"jax": "torch", "tpucap": "tpucap_torch", "compile_cache": "kernel_build_dir"}
    shared = [counterparts.get(k, k) for k in theirs if k not in ("flax", "optax", "orbax.checkpoint",
                                                                  "grain", "nltk")]
    assert [k for k in ours if k in shared] == shared  # tpucap's order
    assert ours["platform"] == "cpu" and ours["devices"] == ["cpu"]
    assert ours["torch"] == torch.__version__ and ours["jpeg_extension"] == "ok"
    assert ours["kernels"] == "skipped (cpu)" and ours["matmul_ok"] is True
    assert {"cuda", "nvcc", "numpy"} <= set(ours)
    quiet = _doctor(capsys, ["--no-device-smoke"])
    assert set(ours) - set(quiet) == {"matmul_smoke_s", "matmul_ok"}
    # No card and no device="cpu": the report with the device's error, exit 1.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        tcli.main(["doctor"])
    assert err.value.code == 1
    report = json.loads(capsys.readouterr().out)
    assert report["platform"].startswith("ERROR (RuntimeError: no CUDA device")
    assert "matmul_ok" not in report and "kernels" not in report


@pytest.mark.parametrize("workload,extra", [
    ("decode", []), ("decode", ["--method", "beam", "--beam-width", "2", "--dtype", "f32"]),
    ("train", []), ("encoder", []),
])
def test_profile_writes_a_trace_of_the_steps(tmp_path, capsys, workload, extra):
    out = tmp_path / "trace"
    tcli.main(["profile", "--workload", workload, "--encoder", "tiny_cnn", "--batch", "2", "--steps", "3",
               "--max-len", "6", "--out", str(out), *extra], device="cpu")
    cap = capsys.readouterr()
    (trace,) = out.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert sum(1 for e in events if e.get("name") == "profile_step" and e["cat"] == "user_annotation") == 3
    assert cap.err.splitlines()[-2:] == [f"compiling + warmup ({workload})...",
                                         f"tracing 3 steps -> {out}"]
    assert cap.out.splitlines()[-1] == (f"trace written: {trace}; view with Perfetto "
                                        "(ui.perfetto.dev) or chrome://tracing")


def test_profile_parser_is_tpucaps(monkeypatch):
    argv = ["profile", "--workload", "train", "--encoder", "tiny_cnn", "--batch", "2", "--out", "o",
            "--train-precision", "bf16", "--preset", "config1"]
    seen = []
    monkeypatch.setattr(jcli, "cmd_profile", seen.append)
    jcli.main(argv)
    got = tcli.build_parser()[0].parse_args(argv)
    assert {k: v for k, v in vars(got).items() if k != "fn"} == {
        k: v for k, v in vars(seen[0]).items() if k != "fn"
    }


def test_train_tensorboard_dir(tmp_path, capsys):
    _, tokens, train, _ = generate_fixture_dataset(tmp_path / "data", n_images=6, image_size=32, seed=6)
    ids = [ln.split("#")[0].removesuffix(".jpg") for ln in open(tokens)]
    rng = np.random.default_rng(6)
    feats = tmp_path / "features.npz"
    np.savez(feats, **{i: rng.normal(size=128).astype(np.float32) for i in dict.fromkeys(ids)})
    base = ["train", "--encoder", "tiny_cnn", "--embed-dim", "16", "--hidden-dim", "16", "--max-len", "8",
            "--tokens", tokens, "--split", train, "--features", str(feats), "--epochs", "2",
            "--batch-size", "4"]
    # Only --tensorboard-dir: a logger is made all the same.
    tcli.main([*base, "--checkpoint-dir", str(tmp_path / "a"), "--tensorboard-dir", str(tmp_path / "tb")],
              device="cpu")
    tcli.main([*base, "--checkpoint-dir", str(tmp_path / "b"), "--metrics-log", str(tmp_path / "m.jsonl")],
              device="cpu")
    capsys.readouterr()
    history = [json.loads(ln) for ln in (tmp_path / "m.jsonl").read_text().splitlines()]
    got = read_scalars(tmp_path / "tb")
    want = [(k, h["epoch"], float(np.float32(v))) for h in history for k, v in h.items()
            if k not in ("epoch", "step", "wall_time") and isinstance(v, (int, float))]
    assert got == want and {t for t, _, _ in got} >= {"loss"}
    assert [s for t, s, _ in got if t == "loss"] == [0, 1]  # fit counts epochs from 0
