"""The port's continuous-batching server (``serve.ContinuousCaptionServer``),
its HTTP routes (``CaptionHTTPServer(engine="continuous")``: the streaming
routes, ``/reload``, ``/metrics``) and ``serve --engine continuous`` against
tpucap's, on the CPU: tiny_cnn (128-d features, 32 x 32 JPEGs made by PIL),
lstm1 embed 16 / hidden 32, max_len 8, no_repeat_ngram_size 2 (random
weights repeat a word otherwise), f32, tpucap's random weights carried across
by ``convert.params_from_jax`` with the head tilted toward endseq, so that
caption lengths differ (0 to 8 words), 4 slots, 2 ticks a sync group.

Tolerance: none. Captions token for token tpucap's and the port's own
``generate`` (greedy, and beam at width 2), whatever the admission order;
streamed spans equal tpucap's and concatenate to the caption; the HTTP
routes' status codes, ndjson lines and error texts equal tpucap's (a body
that is no JPEG: the port's decoder adds why to tpucap's text). Also:
``warmup``, ``max_queue``, the shape checks, a reload draining the lanes,
the wedge on ``close`` and the loop crash that fails pending futures.
"""

import http.client
import importlib
import io
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.serve import ContinuousCaptionServer as JaxContinuous
from tpucap.serve_http import CaptionHTTPServer as JaxHTTPServer
from tpucap_torch import config as tcfg
from tpucap_torch.client import CaptionClient
from tpucap_torch.convert import params_from_jax
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.serve import ContinuousCaptionServer, Overloaded
from tpucap_torch.serve_http import CaptionHTTPServer
from tpucap_torch.text import Tokenizer

torch.set_num_threads(2)

DEC = dict(embed_dim=16, hidden_dim=32, dropout_rate=0.0)
MAX_LEN, SLOTS, TICKS = 8, 4, 2
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
        ]
    )
}
CONTINUOUS = dict(port=0, max_batch=SLOTS, ticks_per_sync=TICKS, method="greedy", engine="continuous")


def _jax_params(jpipe, seed):
    """tpucap's ``build`` random init, run as one jitted program."""
    jpipe.build(init_params=False)
    enc, dec = jax.random.split(jax.random.key(seed))
    jpipe.params = jax.jit(lambda e, d: {"encoder": jpipe.encoder.init(e), "decoder": jpipe.decoder.init(d)})(enc, dec)
    dec = jpipe.params["decoder"]
    dec["out"]["kernel"] = dec["out"]["kernel"] * 2
    dec["out"]["bias"] = dec["out"]["bias"].at[jpipe.tokenizer.word_index["endseq"]].add(1.0)
    return jpipe.params


def _jax_pipe(seed=0):
    jpipe = JaxPipeline(
        jcfg.Config(
            encoder=jcfg.encoder_config("tiny_cnn"),
            decoder=jcfg.DecoderConfig(**DEC),
            decode=jcfg.DecodeConfig(max_len=MAX_LEN, no_repeat_ngram_size=2),
            precision="f32",
        )
    )
    jpipe.fit_tokenizer(CORPUS)
    jpipe.params = _jax_params(jpipe, seed)
    return jpipe


def _port_pipe(jpipe, seed=None):
    """The port's pipeline on ``jpipe``'s weights, or on the port's own
    random weights from ``seed`` (tilted as ``_jax_params`` tilts)."""
    pipe = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.encoder_config("tiny_cnn"),
            decoder=tcfg.DecoderConfig(**DEC),
            decode=tcfg.DecodeConfig(max_len=MAX_LEN, no_repeat_ngram_size=2),
            precision="f32",
        ),
        tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()),
        device="cpu",
    )
    if seed is None:
        pipe.build(init_params=False)
        pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
        return pipe
    pipe.build(seed=seed)
    dec = pipe.params["decoder"]
    dec["out"]["kernel"] = dec["out"]["kernel"] * 2
    dec["out"]["bias"][pipe.tokenizer.word_index["endseq"]] += 1.0
    pipe._params_changed()
    return pipe


def _jpeg(seed, size=32):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 255, size=(size, size, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def _rows(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 128)).astype(np.float32)


def _images(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def pipes():
    jpipe = _jax_pipe(0)
    return jpipe, _port_pipe(jpipe)


@pytest.fixture(scope="module")
def hosts(pipes):
    """{"tpucap": server, "port": server}: the continuous engine, greedy,
    /reload enabled."""
    jpipe, pipe = pipes
    out = {
        "tpucap": JaxHTTPServer(jpipe, allow_reload=True, **CONTINUOUS),
        "port": CaptionHTTPServer(pipe, allow_reload=True, **CONTINUOUS),
    }
    for srv in out.values():
        srv.serve_background()
    yield out
    for srv in out.values():
        srv.close()


def _raw(srv, path, body):
    """(status, content type, body bytes) of one POST."""
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=120)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _features(x, **extra):
    return json.dumps({"features": np.asarray(x).tolist(), **extra}).encode()


def _staggered(submit, items, gap=0.003):
    """Submit ``items`` from one thread each, ``gap`` seconds apart. ->
    their results in order."""
    out = [None] * len(items)

    def run(i):
        time.sleep(gap * i)
        out[i] = submit(items[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return out


def test_http_captions_match_tpucap_and_generate(hosts, pipes):
    """Feature rows, one a request from staggered threads and all at once,
    and JPEGs in one /caption_batch and one /caption: tpucap's captions, and
    the port's generate of the same rows."""
    _, pipe = pipes
    rows = _rows(7, seed=1)
    jpegs = [_jpeg(s) for s in range(4)]
    got, want = ({name: [] for name in ("single", "batch", "jpeg", "jpeg_batch")} for _ in range(2))
    for name, out in (("port", got), ("tpucap", want)):
        c = CaptionClient(*hosts[name].address, timeout=120)
        out["single"] = _staggered(c.caption_features, list(rows))
        out["batch"] = c.caption_features_many(rows)
        out["jpeg_batch"] = c.caption_jpegs_many(jpegs)
        out["jpeg"] = c.caption(jpegs[0])
    assert got == want
    assert got["single"] == got["batch"] == pipe.generate(rows)
    assert got["jpeg"] == got["jpeg_batch"][0]
    assert len({len(c.split()) for c in got["single"]}) > 2  # lanes retire at different ticks


@pytest.mark.parametrize("route", ["/caption_stream", "/caption_stream_features"])
def test_http_streaming_routes_match_tpucap(hosts, route):
    """Status, content type and every ndjson line equal tpucap's: word
    spans, then {"done": true, "caption": ...}; the spans concatenate to
    the caption."""
    for seed in range(3):
        body = _jpeg(10 + seed) if route == "/caption_stream" else _features(_rows(1, seed=20 + seed)[0])
        want = _raw(hosts["tpucap"], route, body)
        got = _raw(hosts["port"], route, body)
        assert got == want
        assert got[0] == 200 and got[1] == "application/x-ndjson"
        lines = [json.loads(ln) for ln in got[2].decode().splitlines()]
        assert lines[-1]["done"] is True
        words = [w for ln in lines[:-1] for w in ln["words"]]
        assert " ".join(words) == lines[-1]["caption"]


def _status_cases(route_body):
    row = _rows(1, seed=30)[0]
    jpeg = _jpeg(30)
    return [
        ("/caption_stream?model=zz", jpeg),
        ("/caption_stream", b"notajpeg"),
        ("/caption_stream?prefix=a", jpeg),
        ("/caption_stream_features?model=zz", _features(row)),
        ("/caption_stream_features", b"not json"),
        ("/caption_stream_features", json.dumps({"rows": []}).encode()),
        ("/caption_stream_features", _features([1.0, 2.0])),
        ("/caption_stream_features", _features(row, model="zz")),
        ("/caption_stream_features", _features(row, include_words=["dog"])),
    ] + route_body


@pytest.mark.parametrize("engine", ["continuous", "batch"])
def test_http_statuses_and_texts_match_tpucap(hosts, pipes, engine):
    """Each streaming route's unknown model and bad body, and the dials,
    give tpucap's status and text on either engine: the model is resolved
    and the body parsed before the batch engine's 400."""
    row = _rows(1, seed=31)[0]
    extra = [
        ("/caption_features", _features(row, prefix="a dog")),
        ("/caption_batch", _features(row[None], prefix="a dog")),
        ("/caption_batch", _features(row[None], prefixes=["a"])),
        ("/caption?include_words=dog", _jpeg(31)),
    ] if engine == "continuous" else [
        ("/caption_stream", _jpeg(32)),
        ("/caption_stream_features", _features(row)),
    ]
    if engine == "continuous":
        servers = hosts
    else:
        jpipe, pipe = pipes
        servers = {"tpucap": JaxHTTPServer(jpipe, port=0, method="greedy"),
                   "port": CaptionHTTPServer(pipe, port=0, method="greedy")}
        for srv in servers.values():
            srv.serve_background()
    try:
        for path, body in _status_cases(extra):
            want = _raw(servers["tpucap"], path, body)
            got = _raw(servers["port"], path, body)
            assert got[0] == want[0] == 400, (path, got, want)
            if body == b"notajpeg":
                assert json.loads(got[2])["error"].startswith(json.loads(want[2])["error"])
                continue
            assert got == want, path
    finally:
        if engine == "batch":
            for srv in servers.values():
                srv.close()


def test_http_metrics_stats_and_reload(hosts, pipes, tmp_path):
    """/metrics has tpucap's families, the continuous ones included, and
    /stats its keys; /reload on the continuous engine reloads both servers
    and answers once both have."""
    jpipe, pipe = pipes
    c, jc = (CaptionClient(*hosts[n].address, timeout=120) for n in ("port", "tpucap"))
    c.caption_features(_rows(1, seed=40)[0])
    jc.caption_features(_rows(1, seed=40)[0])

    def families(text):
        return [ln for ln in text.splitlines() if ln.startswith("#")]

    assert families(c.metrics()) == families(jc.metrics())
    assert "# TYPE tpucap_ticks_total counter" in c.metrics()
    assert "# TYPE tpucap_mean_occupancy gauge" in c.metrics()
    stats, jstats = c.stats(), jc.stats()
    assert sorted(stats) == sorted(jstats) == ["features", "images"]
    assert sorted(stats["features"]) == sorted(jstats["features"])
    assert stats["features"]["ticks"] > 0 and stats["features"]["mean_occupancy"] > 0
    # A bundle of other weights: the reply waits for both servers. Then the
    # original weights again, for the module's later tests.
    pipe.save(str(tmp_path / "a"))
    other = _port_pipe(jpipe, seed=3)
    other.save(str(tmp_path / "b"))
    rows = _rows(4, seed=41)
    before = c.caption_features_many(rows)
    assert c.reload(str(tmp_path / "b")) == {"ok": True, "bundle": str(tmp_path / "b")}
    assert c.caption_features_many(rows) == other.generate(rows) != before
    assert c.caption(_jpeg(41)) == other.generate(other.encode_images(_preprocess(_jpeg(41), other)))[0]
    assert c.reload(str(tmp_path / "a"))["ok"]
    assert c.caption_features_many(rows) == before


def _preprocess(blob, pipe):
    from tpucap_torch.serve_http import _preprocess_jpeg

    return _preprocess_jpeg(blob, pipe.encoder.input_size, pipe.encoder.preprocess_mode)[None]


@pytest.mark.parametrize("beam", [1, 2], ids=["greedy", "beam2"])
def test_server_captions_and_streams_match_tpucap(pipes, beam):
    """features mode: staggered submits and submit_many give tpucap's
    captions and generate's; a streamed request's spans equal tpucap's and
    concatenate to its caption; a raising callback is swallowed."""
    jpipe, pipe = pipes
    rows = _rows(6, seed=50)
    # Two slots: six requests recycle them, and tpucap's engine compiles
    # two admission buckets, not three.
    kw = dict(slots=2, ticks_per_sync=TICKS, beam_width=beam)
    jsrv, srv = JaxContinuous(jpipe, **kw), ContinuousCaptionServer(pipe, **kw)
    try:
        method = dict(method="beam", beam_width=beam) if beam > 1 else dict(method="greedy")
        want = pipe.generate(rows, **method)
        for server in (jsrv, srv):
            assert _staggered(lambda x: server.submit(x).result(60), list(rows)) == want
            assert [f.result(60) for f in server.submit_many(rows)] == want
        for i in range(3):
            spans = {}
            for name, server in (("tpucap", jsrv), ("port", srv)):
                spans[name] = []
                fut = server.submit_stream(rows[i], spans[name].append)
                spans[name].append(fut.result(60))
            assert spans["port"] == spans["tpucap"]
            assert " ".join(w for s in spans["port"][:-1] for w in s) == spans["port"][-1] == want[i]

        def boom(words):
            raise RuntimeError("client gone")

        assert srv.submit_stream(rows[0], boom).result(60) == want[0]
        stats = srv.stats()
        assert stats["ticks"] > 0 and 0 < stats["mean_occupancy"] <= 2
    finally:
        jsrv.close()
        srv.close()


def test_images_mode_matches_generate(pipes):
    """mode='images': each admission wave is encoded, then decoded on the
    engine's snapshot of the params, as encode_images + generate."""
    _, pipe = pipes
    imgs = _images(5, seed=60)
    srv = ContinuousCaptionServer(pipe, slots=SLOTS, ticks_per_sync=TICKS, mode="images")
    try:
        want = pipe.generate(pipe.encode_images(imgs))
        assert [f.result(60) for f in srv.submit_many(imgs)] == want
        assert _staggered(lambda x: srv.caption(x), list(imgs)) == want
    finally:
        srv.close()


def test_warmup_runs_every_bucket_and_resets_stats(pipes, monkeypatch):
    _, pipe = pipes
    srv = ContinuousCaptionServer(pipe, slots=SLOTS, ticks_per_sync=TICKS, mode="images")
    try:
        seen = []
        admit = srv._engine.admit

        def spy(state, idx, feats):
            seen.append((len(idx), tuple(feats.shape)))
            return admit(state, idx, feats)

        monkeypatch.setattr(srv._engine, "admit", spy)
        srv.warmup()
        assert seen == [(1, (1, 128)), (2, (2, 128)), (4, (4, 128))]
        stats = srv.stats()
        assert (stats["requests"], stats["batches"], stats["ticks"], stats["p50_ms"]) == (0, 0, 0, None)
        assert srv.caption(_images(1, seed=61)[0], timeout=60) == pipe.generate(
            pipe.encode_images(_images(1, seed=61)))[0]
    finally:
        srv.close()


def _held(server, monkeypatch):
    """Park the engine loop inside its next tick group until the returned
    event is set."""
    release = threading.Event()
    tick = server._engine.tick

    def held(state, n):
        release.wait(30)
        return tick(state, n)

    monkeypatch.setattr(server._engine, "tick", held)
    return release


def test_shape_checks_and_max_queue_match_tpucap(pipes, monkeypatch):
    jpipe, pipe = pipes
    kw = dict(slots=SLOTS, ticks_per_sync=TICKS, max_queue=2)
    jsrv, srv = JaxContinuous(jpipe, **kw), ContinuousCaptionServer(pipe, **kw)
    try:
        for call in (
            lambda s: s.submit(np.zeros(7, np.float32)),
            lambda s: s.submit_many(np.zeros((2, 7), np.float32)),
            lambda s: s.submit_many(np.zeros(128, np.float32)),
            lambda s: s.submit_stream(np.zeros(128, np.float32), "not callable"),
            lambda s: type(s)(s._pipe, mode="video"),
        ):
            errors = []
            for server in (jsrv, srv):
                with pytest.raises((ValueError, TypeError)) as e:
                    call(server)
                errors.append((type(e.value), str(e.value)))
            assert errors[0] == errors[1]
        assert srv.submit_many(np.zeros((0, 128), np.float32)) == []
        release = _held(srv, monkeypatch)
        rows = _rows(6, seed=70)
        first = srv.submit(rows[0])  # admitted, then the loop parks in its tick
        time.sleep(0.2)
        queued = srv.submit_many(rows[1:3])  # at max_queue
        with pytest.raises(Overloaded, match=r"^request queue at max_queue=2$"):
            srv.submit_many(rows[3:6])  # atomic: none of the three enqueued
        assert srv._queue.qsize() == 2
        release.set()
        assert [f.result(60) for f in [first, *queued]] == pipe.generate(rows[:3])
    finally:
        jsrv.close()
        srv.close()


def test_reload_drains_lanes_then_swaps(pipes, monkeypatch):
    """Requests before the reload decode on the old weights, after it on
    the new; a bad tree fails its future and the old weights serve on. A
    reload of the pipeline by anyone else leaves the engine's snapshot."""
    jpipe, pipe = pipes
    old = params_from_jax(jax.tree.map(np.asarray, jpipe.params))
    new_pipe = _port_pipe(jpipe, seed=5)
    rows = _rows(6, seed=80)
    want_old, want_new = pipe.generate(rows), new_pipe.generate(rows)
    assert want_old != want_new
    srv = ContinuousCaptionServer(pipe, slots=SLOTS, ticks_per_sync=TICKS)
    other = ContinuousCaptionServer(pipe, slots=SLOTS, ticks_per_sync=TICKS)
    try:
        release = _held(srv, monkeypatch)
        before = srv.submit_many(rows)  # 4 in lanes, 2 queued
        time.sleep(0.2)
        swap = srv.reload(new_pipe.params)
        after = srv.submit_many(rows)
        release.set()
        assert [f.result(60) for f in before] == want_old
        assert swap.result(60) is True
        assert [f.result(60) for f in after] == want_new
        # ``other`` was built on the old tree: the pipeline's reload by
        # ``srv`` did not reach its engine.
        assert [f.result(60) for f in other.submit_many(rows)] == want_old
        bad = srv.reload({"decoder": {}})
        with pytest.raises(ValueError):
            bad.result(60)
        assert [f.result(60) for f in srv.submit_many(rows)] == want_new
    finally:
        srv.close()
        other.close()
        pipe.reload_params(old)


def test_close_fails_a_wedged_loops_futures(pipes, monkeypatch):
    jpipe, pipe = pipes
    srv = ContinuousCaptionServer(pipe, slots=SLOTS, ticks_per_sync=TICKS)
    release = _held(srv, monkeypatch)
    rows = _rows(6, seed=90)
    futs = srv.submit_many(rows)  # 4 in lanes, 2 queued
    time.sleep(0.2)
    srv.close(timeout=0.2)
    for f in futs:
        with pytest.raises(TimeoutError, match="continuous engine loop did not drain within 0.2s"):
            f.result(10)
    release.set()
    with pytest.raises(RuntimeError, match="server is closed"):
        srv.submit(rows[0])
    srv.close()  # idempotent


def test_loop_crash_fails_pending_futures_and_closes(pipes, monkeypatch):
    _, pipe = pipes
    srv = ContinuousCaptionServer(pipe, slots=SLOTS, ticks_per_sync=TICKS)
    hold = threading.Event()

    def crash(state, n):
        hold.wait(30)
        raise RuntimeError("device lost")

    monkeypatch.setattr(srv._engine, "tick", crash)
    futs = srv.submit_many(_rows(6, seed=91))
    time.sleep(0.1)
    hold.set()
    for f in futs:
        with pytest.raises(RuntimeError, match="^device lost$"):
            f.result(10)
    srv._thread.join(10)
    with pytest.raises(RuntimeError, match="server is closed"):
        srv.submit(_rows(1, seed=92)[0])


def test_serve_command_with_the_continuous_engine(pipes, tmp_path, monkeypatch, capsys):
    """``serve --engine continuous`` serves a bundle through the continuous
    servers: the streamed caption and the plain one are generate's."""
    cli = importlib.import_module("tpucap_torch.cli.main")
    _, pipe = pipes
    bundle = tmp_path / "bundle"
    pipe.save(str(bundle))
    seen = {}

    def serve_forever(self):
        host, port = self.serve_background()
        c = CaptionClient(host, port, timeout=60)
        row = _rows(1, seed=95)[0]
        spans = []
        seen["stream"] = c.caption_stream_features(row, spans.append)
        seen["spans"] = spans
        seen["caption"] = c.caption_features(row)
        seen["engines"] = (type(self._images).__name__, self._features._beam_width)

    monkeypatch.setattr(CaptionHTTPServer, "serve_forever", serve_forever)
    cli.main(["serve", "--model-dir", str(bundle), "--port", "0", "--engine", "continuous",
              "--method", "beam", "--beam-width", "2", "--max-batch", "2", "--no-warmup"],
             device="cpu")
    want = pipe.generate(_rows(1, seed=95), method="beam", beam_width=2)[0]
    assert seen["stream"] == seen["caption"] == want
    assert " ".join(w for s in seen["spans"] for w in s) == want
    assert seen["engines"] == ("ContinuousCaptionServer", 2)
    assert "drained; bye" in capsys.readouterr().err
