"""tpucap_torch's streamed training input (``data.pipeline``'s
``caption_batch_stream`` and ``prefetch_iterator``, ``fit(stream=True)``
and ``train --stream-features``) against tpucap's, on the CPU.

``caption_batch_stream`` gives tpucap's batches bit for bit for the same
seed, with and without ``start_batch`` (tolerance 0: the same numpy
draws and the same rows). ``prefetch_iterator`` keeps order, raises a
worker's error at the next pull, and leaves no live thread once closed or
abandoned.

``fit(stream=True)`` on a lazy ``np.load`` handle of an uncompressed
``.npz`` gives the port's ``fit(stream=False)`` params and history bit for
bit (dropout on: the draws come from the same generator in the same
order), and tpucap's ``fit(stream=True)`` within the port's ``fit`` bounds
(``tests/test_torch_train.py``, dropout off, the same weights bridged):
per-epoch loss, accuracy and perplexity within 1e-5 relative, the params
within 1e-3 of each tensor's scale. A streamed run cut mid-epoch and
resumed equals the uncut streamed run bit for bit, and its resumed epoch
reads no row of the batches it skips; ``steps_per_dispatch=2`` on the
stream equals spd 1 bit for bit. ``train --stream-features`` writes the
bundle of ``train`` without it, bit for bit, and closes its handle.

Small sizes throughout: lstm1 with embed and hidden 16, 32-d features,
batch 4, max_len 8.
"""

import dataclasses
import importlib
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.data import pipeline as jdata
from tpucap.data import generate_fixture_dataset
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap_torch import config as tcfg
from tpucap_torch.checkpoint import CheckpointManager
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.core import tree_leaves
from tpucap_torch.data.pipeline import caption_batch_stream, prefetch_iterator
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.train import batch_iterator

torch.set_num_threads(2)

tcli = importlib.import_module("tpucap_torch.cli.main")
jcli = importlib.import_module("tpucap.cli.main")
FD = 32
WORDS = "a b c d e f g h i j".split()
DESC = {
    f"im{i}": [f"startseq {WORDS[i % 10]} {WORDS[(i + 3) % 10]} {WORDS[(i * 7) % 10]} endseq",
               f"startseq {WORDS[(i + 1) % 10]} {WORDS[(i + 5) % 10]} endseq"]
    for i in range(11)
}


class CountingStore:
    """A feature mapping that counts its row reads (as an ``np.load``
    handle's reads go to disk)."""

    def __init__(self, data):
        self.data, self.reads = data, 0

    def __getitem__(self, key):
        self.reads += 1
        return self.data[key]


def _feats(seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=FD).astype(np.float32) for k in DESC}


def _npz(tmp_path, feats):
    path = tmp_path / "features.npz"
    np.savez(path, **feats)
    return path


def _pipe(pkg, rate, **train):
    c = jcfg if pkg == "jax" else tcfg
    cfg = c.Config(
        encoder=c.EncoderConfig(name="tiny_cnn", feature_dim=FD),
        decoder=c.DecoderConfig(embed_dim=16, hidden_dim=16, dropout_rate=rate),
        train=c.TrainConfig(batch_size=4, seed=2, learning_rate=1e-2, **train),
        decode=c.DecodeConfig(max_len=8),
        precision="f32",
    )
    if pkg == "jax":
        pipe = JaxPipeline(cfg)
        pipe.fit_tokenizer(DESC)
        pipe.build()
        return pipe
    pipe = CaptioningPipeline(cfg, device="cpu")
    pipe.fit_tokenizer(DESC)
    pipe.build()
    return pipe


def _same(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert torch.equal(x, y)


# -- the stream and the prefetch thread ---------------------------------------------------


@pytest.mark.parametrize("start_batch", [0, 2])
def test_caption_batch_stream_gives_tpucaps_batches(start_batch):
    ids = [f"k{i % 7}" for i in range(23)]
    tokens = np.arange(23 * 5, dtype=np.int32).reshape(23, 5)
    feats = {f"k{i}": np.full(3, i, np.float64) for i in range(7)}
    ours = CountingStore(feats)
    got = list(caption_batch_stream(ids, tokens, ours, 5, rng=np.random.default_rng(4), start_batch=start_batch))
    want = list(jdata.caption_batch_stream(ids, tokens, feats, 5, rng=np.random.default_rng(4),
                                           start_batch=start_batch))
    assert len(got) == len(want) == 4 - start_batch
    for (gf, gt), (wf, wt) in zip(got, want):
        assert gf.dtype == np.float32
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gt, wt)
    # Nothing assembled before start_batch; the order is batch_iterator's.
    assert ours.reads == 5 * len(got)
    stacked = (np.stack([feats[i] for i in ids]).astype(np.float32), tokens)
    memory = list(batch_iterator(stacked, 5, rng=np.random.default_rng(4)))[start_batch:]
    for (gf, gt), (mf, mt) in zip(got, memory):
        np.testing.assert_array_equal(gf, mf)
        np.testing.assert_array_equal(gt, mt)
    tail = list(caption_batch_stream(ids, tokens, feats, 5, drop_remainder=False))
    assert [len(t) for _, t in tail] == [5, 5, 5, 5, 3]
    with pytest.raises(ValueError) as theirs:
        next(jdata.caption_batch_stream(ids, tokens[:-1], feats, 5))
    with pytest.raises(ValueError) as ours_err:
        next(caption_batch_stream(ids, tokens[:-1], feats, 5))
    assert str(ours_err.value) == str(theirs.value) == "23 row ids vs 22 token rows"


def _live_workers():
    return [t for t in threading.enumerate() if t.name == "tpucap-torch-prefetch" and t.is_alive()]


def _wait_no_workers():
    for _ in range(100):
        if not _live_workers():
            return True
        time.sleep(0.05)
    return False


def test_prefetch_iterator_keeps_order_reraises_and_stops_when_closed():
    assert list(prefetch_iterator(iter(range(300)), depth=2, transform=lambda x: x * 3)) == [
        3 * i for i in range(300)
    ]

    def failing():
        yield from range(3)
        raise KeyError("row 3")

    it = prefetch_iterator(failing(), depth=1)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(KeyError, match="row 3"):
        next(it)

    def endless():
        i = 0
        while True:
            yield np.full(1000, i)
            i += 1

    # Closed after one pull, and abandoned: the worker, blocked on a full
    # queue, exits either way.
    it = prefetch_iterator(endless(), depth=2)
    assert next(it)[0] == 0
    time.sleep(0.2)
    assert _live_workers()
    it.close()
    assert _wait_no_workers()
    it = prefetch_iterator(endless(), depth=2)
    next(it)
    del it
    assert _wait_no_workers()


# -- fit(stream=True) ---------------------------------------------------------------------


def test_streamed_fit_equals_in_memory_fit_and_tpucaps(tmp_path):
    feats = _feats()
    path = _npz(tmp_path, feats)
    memory = _pipe("torch", 0.5)
    want = memory.fit(DESC, feats, epochs=3, log=None)
    streamed = _pipe("torch", 0.5)
    with np.load(path) as handle:
        got = streamed.fit(DESC, handle, epochs=3, stream=True, prefetch=3, log=None)
    assert got == want
    _same(streamed.params, memory.params)
    assert not _live_workers()

    # Against tpucap's stream, dropout off, tpucap's weights bridged.
    jpipe = _pipe("jax", 0.0)
    port = _pipe("torch", 0.0)
    port.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    with np.load(path) as handle:
        theirs = jpipe.fit(DESC, handle, epochs=3, stream=True, log=None)
    with np.load(path) as handle:
        ours = port.fit(DESC, handle, epochs=3, stream=True, log=None)
    assert [sorted(e) for e in ours] == [sorted(e) for e in theirs]
    for g, w in zip(ours, theirs):
        assert g["epoch"] == w["epoch"]
        for k in ("loss", "accuracy", "perplexity", "tokens"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    for g, w in zip(jax.tree.leaves(params_to_numpy(port.params["decoder"])), jax.tree.leaves(jpipe.params["decoder"])):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * np.abs(w).max())


class _FakeGuard:
    """Fires on its ``after``-th query: a preemption after that step."""

    def __init__(self, after: int):
        self.after, self.calls = after, 0

    @property
    def fired(self) -> bool:
        self.calls += 1
        return self.calls >= self.after


def test_streamed_resume_and_steps_per_dispatch_equal_the_uncut_stream(tmp_path):
    """5 steps an epoch; the cut comes after step 7 (epoch 1, batch 2)."""
    feats = _feats(3)
    uncut = _pipe("torch", 0.5, checkpoint_every_steps=3)
    store = CountingStore(feats)
    want = uncut.fit(DESC, store, epochs=3, stream=True, checkpoint_manager=CheckpointManager(
        tmp_path / "uncut", best_metric=None), log=None)
    assert store.reads == 3 * 5 * 4

    cut = _pipe("torch", 0.5, checkpoint_every_steps=3)
    mgr = CheckpointManager(tmp_path / "cut", best_metric=None)
    hist = cut.fit(DESC, feats, epochs=3, stream=True, checkpoint_manager=mgr, preemption_guard=_FakeGuard(7),
                   log=None)
    assert hist[-1]["preempted"] and mgr.latest_step() == 7
    resumed = _pipe("torch", 0.5, checkpoint_every_steps=3)
    store = CountingStore(feats)
    lines = []
    rest = resumed.fit(DESC, store, epochs=3, stream=True, checkpoint_manager=mgr, resume=True,
                       log=lines.append)
    assert lines[0] == "resumed from step 7 (epoch 1, batch 2)"
    assert store.reads == (3 + 5) * 4  # the resumed epoch reads its last 3 batches only
    # The resumed epoch averages its last 3 batches only; the next is whole.
    assert [h["epoch"] for h in rest] == [1, 2] and rest[1] == want[2]
    _same(resumed.params, uncut.params)

    spd = _pipe("torch", 0.5, steps_per_dispatch=2)
    got = spd.fit(DESC, feats, epochs=3, stream=True, log=None)
    plain = _pipe("torch", 0.5)
    ref = plain.fit(DESC, feats, epochs=3, stream=True, log=None)
    _same(spd.params, plain.params)
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-6)
    assert not _live_workers()


# -- train --stream-features ----------------------------------------------------------------


def test_cli_stream_features_writes_the_in_memory_bundle(tmp_path, monkeypatch, capsys):
    data = generate_fixture_dataset(tmp_path / "data", n_images=6, image_size=32, seed=6)
    _, tokens, train, _ = data
    ids = [ln.split("#")[0].removesuffix(".jpg") for ln in open(tokens)]
    rng = np.random.default_rng(6)
    feats = tmp_path / "features.npz"
    # tiny_cnn's 128-d rows.
    np.savez(feats, **{i: rng.normal(size=128).astype(np.float32) for i in dict.fromkeys(ids)})
    handles = []
    real_load = np.load

    def recording_load(*args, **kwargs):
        out = real_load(*args, **kwargs)
        handles.append(out)
        return out

    monkeypatch.setattr(tcli.np, "load", recording_load)
    lines = {}
    for name, extra in (("memory", []), ("stream", ["--stream-features"])):
        argv = ["train", "--encoder", "tiny_cnn", "--embed-dim", "16", "--hidden-dim", "16", "--max-len", "8",
                "--tokens", tokens, "--split", train, "--features", str(feats), "--checkpoint-dir",
                str(tmp_path / name), "--epochs", "2", "--batch-size", "4", "--bundle-out",
                str(tmp_path / name / "bundle"), *extra]
        tcli.main(argv, device="cpu")
        lines[name] = capsys.readouterr().out.replace(str(tmp_path / name), "<run>").splitlines()
        # The namespace is tpucap's.
        seen = []
        monkeypatch.setattr(jcli, "cmd_train", seen.append)
        jcli.main(argv)
        got = tcli.build_parser()[0].parse_args(argv)
        assert {k: v for k, v in vars(got).items() if k != "fn"} == {
            k: v for k, v in vars(seen[0]).items() if k != "fn"
        }
    assert lines["stream"] == lines["memory"]
    assert all(h.zip is None for h in handles)  # every handle closed
    got = CaptioningPipeline.load(tmp_path / "stream" / "bundle", device="cpu")
    want = CaptioningPipeline.load(tmp_path / "memory" / "bundle", device="cpu")
    _same(got.params, want.params)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
