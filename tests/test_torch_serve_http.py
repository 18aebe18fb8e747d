"""The port's HTTP front end (``tpucap_torch/serve_http.py``), its client
(``tpucap_torch/client.py``) and the CLI's ``serve`` and ``caption
--server`` against tpucap's, on the CPU, after tpucap's
``tests/test_serve_http.py``, ``test_client.py`` and
``test_multimodel_serve.py``: tiny_cnn (32 x 32 JPEGs made by PIL, 128-d
features), lstm1 embed 16 / hidden 32, max_len 10, greedy, f32, tpucap's
random weights carried across by ``convert.params_from_jax``, an extra model
of another seed behind the same port.

Tolerance: none. The same requests to tpucap's ``CaptionHTTPServer`` and the
port's, each on port 0, give the same status codes and the same JSON bodies
(captions token for token, ``/stats`` keys, ``/metrics`` series, the 400 /
403 / 404 / 413 / 503 texts), except ``/healthz``'s backend (the port names
its pipeline's device type); the per-request dials (prefix, include_words)
give tpucap's captions or its 400 texts. Each client against the other's server; ``serve``'s flag checks;
``caption --server`` against a port server started by ``serve`` gives the
lines offline ``caption`` gives; SIGTERM drains and exits 0; a ``/reload``
never splits a ``/caption_batch`` whose rows span two batches.
"""

import base64
import http.client
import importlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.client import CaptionClient as JaxClient
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.serve_http import CaptionHTTPServer as JaxHTTPServer
from tpucap_torch import config as tcfg
from tpucap_torch.client import CaptionClient, ServerError
from tpucap_torch.convert import params_from_jax, save_npz
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.serve_http import CaptionHTTPServer
from tpucap_torch.text import Tokenizer

from ports_init import build_on_ports_init

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
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
SERVE = dict(port=0, max_batch=4, max_delay_ms=5, method="greedy", max_body_bytes=1 << 16)
MODEL_FLAGS = ["--encoder", "tiny_cnn", "--embed-dim", "16", "--hidden-dim", "32", "--max-len", "10"]


def _jax_pipe(seed):
    """tpucap's pipeline from ``seed``, its head sharpened and tilted toward
    endseq so that captions differ from row to row."""
    jpipe = JaxPipeline(
        jcfg.Config(
            encoder=jcfg.encoder_config("tiny_cnn"),
            decoder=jcfg.DecoderConfig(**DEC),
            decode=jcfg.DecodeConfig(max_len=10),
            precision="f32",
        )
    )
    jpipe.fit_tokenizer(CORPUS)
    build_on_ports_init(jpipe, seed)
    dec = jpipe.params["decoder"]
    dec["out"]["kernel"] = dec["out"]["kernel"] * 4
    dec["out"]["bias"] = dec["out"]["bias"].at[jpipe.tokenizer.word_index["endseq"]].add(0.5)
    return jpipe


def _port_pipe(jpipe):
    pipe = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.encoder_config("tiny_cnn"),
            decoder=tcfg.DecoderConfig(**DEC),
            decode=tcfg.DecodeConfig(max_len=10),
            precision="f32",
        ),
        tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()),
        device="cpu",
    )
    pipe.build(init_params=False)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    return pipe


def _jpeg(seed, size=32):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 255, size=(size, size, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def _rows(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{"tpucap": (server, pipe, extra pipe), "port": ...}: each serves its
    package's model "default" and an extra model "b" (another seed), with
    /reload enabled; plus a bundle of seed 2 that both packages can read."""
    j0, jb = _jax_pipe(0), _jax_pipe(1)
    p0, pb = _port_pipe(j0), _port_pipe(jb)
    bundle = tmp_path_factory.mktemp("bundle") / "seed2"
    j2 = _jax_pipe(2)
    j2.save(str(bundle))
    save_npz(bundle / "params.npz", params_from_jax(jax.tree.map(np.asarray, j2.params)))
    out = {}
    for name, cls, pipe, extra in (
        ("tpucap", JaxHTTPServer, j0, jb),
        ("port", CaptionHTTPServer, p0, pb),
    ):
        srv = cls(pipe, allow_reload=True, extra_models={"b": extra}, **SERVE)
        srv.serve_background()
        out[name] = (srv, pipe, extra)
    out["bundle"] = str(bundle)
    yield out
    for name in ("tpucap", "port"):
        out[name][0].close()


def _request(srv, method, path, body=None, headers=None):
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=120)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type")
        return resp.status, (json.loads(raw) if ctype == "application/json" else raw.decode()), dict(
            resp.getheaders()
        )
    finally:
        conn.close()


def _both(servers, method, path, body=None, headers=None):
    """(tpucap's (status, body), the port's)."""
    return tuple(
        _request(servers[name][0], method, path, body, headers)[:2] for name in ("tpucap", "port")
    )


def _features(x, **extra):
    return json.dumps({"features": np.asarray(x).tolist(), **extra}).encode()


def test_captions_match_tpucap(servers):
    """Every caption route, for both models, gives tpucap's captions."""
    jpeg = _jpeg(1)
    rows = _rows(3, seed=11)
    b64 = [base64.b64encode(_jpeg(s)).decode() for s in (2, 3)]
    requests = [
        ("POST", "/caption", jpeg),
        ("POST", "/caption?model=b", jpeg),
        ("POST", "/caption_features", _features(rows[0])),
        ("POST", "/caption_features", _features(rows[1], model="b")),
        ("POST", "/caption_batch", _features(rows)),
        ("POST", "/caption_batch?model=b", _features(rows)),
        ("POST", "/caption_batch", json.dumps({"images_b64": b64}).encode()),
    ]
    seen = set()
    for method, path, body in requests:
        want, got = _both(servers, method, path, body)
        assert got == want and got[0] == 200, path
        seen.update(got[1].get("captions", [got[1].get("caption")]))
    assert len(seen) > 2  # the rows' captions differ
    _, pipe, _ = servers["port"]
    assert _request(servers["port"][0], "POST", "/caption_batch", _features(rows))[1] == {
        "captions": pipe.generate(rows)
    }


def test_error_statuses_and_texts_match_tpucap(servers):
    """400 / 404 / 413 texts equal tpucap's, byte for byte."""
    jpeg = _jpeg(4)
    row = _rows(1, seed=12)
    big = {"Content-Length": str(1 << 20)}
    cases = [
        ("GET", "/nope", None, None),
        ("POST", "/nope", b"{}", None),
        ("POST", "/caption_features", b"not json", None),
        ("POST", "/caption_features", _features([1.0, 2.0, 3.0]), None),
        ("POST", "/caption_features?model=zz", _features(row[0]), None),
        ("POST", "/caption_batch", _features(row[0]), None),
        ("POST", "/caption_batch", json.dumps({"features": [], "images_b64": ["x"]}).encode(), None),
        ("POST", "/caption_batch", json.dumps({"images_b64": []}).encode(), None),
        ("POST", "/caption_batch", _features(row, prefixes=["a", "b"]), None),
        ("POST", "/caption_batch", _features(row, prefix="a", prefixes=[""]), None),
        ("POST", "/caption_features", _features(row[0], prefix="zzznotaword"), None),
        ("POST", "/caption_features", _features(row[0], include_words="dog"), None),
        ("POST", "/caption_stream", jpeg, None),
        ("POST", "/caption_stream?prefix=a", jpeg, None),
        ("POST", "/caption_stream_features", _features(row[0]), None),
        ("POST", "/caption_stream_features", _features(row[0], prefix="a"), None),
        ("POST", "/reload", json.dumps({"bundle": "/nonexistent/bundle"}).encode(), None),
        ("POST", "/caption_features", None, {"Content-Length": "-1"}),
        ("POST", "/caption_features", None, big),
    ]
    for method, path, body, headers in cases:
        want, got = _both(servers, method, path, body, headers)
        assert got[0] == want[0] and got[0] in (400, 404, 413, 500), (path, body, got, want)
        if path == "/reload":  # the port reads params.npz, tpucap an orbax tree
            continue
        assert got == want, (path, body)
    # A body that is no JPEG: the port's decoder adds why to tpucap's text.
    want, got = _both(servers, "POST", "/caption", b"notajpeg")
    assert got[0] == want[0] == 400 and got[1]["error"].startswith(want[1]["error"])


def test_reload_403_and_503_match_tpucap(servers, monkeypatch):
    """A server without allow_reload answers /reload with tpucap's 403; a
    full queue answers 503 with Retry-After and tpucap's text."""
    _, jpipe, _ = servers["tpucap"]
    _, pipe, _ = servers["port"]
    row = _rows(1, seed=13)[0]
    results = {}
    for name, cls, p in (("tpucap", JaxHTTPServer, jpipe), ("port", CaptionHTTPServer, pipe)):
        release = threading.Event()
        real = p.generate_submit

        def held(*a, _real=real, _release=release, **kw):
            _release.wait(30)
            return _real(*a, **kw)

        monkeypatch.setattr(p, "generate_submit", held)
        with cls(p, max_queue=1, **SERVE) as srv:
            srv.serve_background()
            reload_ = _request(srv, "POST", "/reload", json.dumps({"bundle": "x"}).encode())[:2]
            codes = []
            first = threading.Thread(
                target=lambda: codes.append(_request(srv, "POST", "/caption_features", _features(row))[0])
            )
            first.start()  # parks the batcher inside its dispatch
            srv_features = srv._features
            for _ in range(500):
                if srv_features._current_futs:
                    break
                threading.Event().wait(0.01)
            second = threading.Thread(
                target=lambda: codes.append(_request(srv, "POST", "/caption_features", _features(row))[0])
            )
            second.start()  # queued: the one slot
            for _ in range(500):
                if srv_features._queue.qsize():
                    break
                threading.Event().wait(0.01)
            status, body, headers = _request(srv, "POST", "/caption_features", _features(row))
            release.set()
            first.join(60)
            second.join(60)
            results[name] = (reload_, status, body, headers.get("Retry-After"), sorted(codes))
        monkeypatch.setattr(p, "generate_submit", real)
    assert results["port"] == results["tpucap"]
    assert results["port"][0][0] == 403 and results["port"][1:4] == (
        503, {"error": "request queue at max_queue=1"}, "1"
    ) and results["port"][4] == [200, 200]


def test_monitoring_surfaces_match_tpucap(servers):
    """/healthz, /stats keys, /metrics series and the demo page."""
    for name in ("tpucap", "port"):  # some traffic on both models first
        srv = servers[name][0]
        for path in ("/caption_features", "/caption_features?model=b"):
            assert _request(srv, "POST", path, _features(_rows(1, seed=14)[0]))[0] == 200
    health = _both(servers, "GET", "/healthz")
    assert health[0] == health[1] == (200, {"ok": True, "backend": "cpu"})
    (ws, want), (gs, got) = _both(servers, "GET", "/stats")
    assert ws == gs == 200 and sorted(got) == sorted(want) == ["b", "default"]
    for model in got:
        assert sorted(got[model]) == sorted(want[model]) == ["features", "images"]
        for ep in got[model]:
            assert sorted(got[model][ep]) == sorted(want[model][ep])
    (ws, want), (gs, got) = _both(servers, "GET", "/metrics")

    def series(text):
        return sorted(
            {ln.split("{")[0] for ln in text.splitlines() if ln and not ln.startswith("#")}
            | {ln for ln in text.splitlines() if ln.startswith("#")}
        )

    assert ws == gs == 200 and series(got) == series(want)
    assert 'tpucap_requests_total{model="b",endpoint="features"}' in got
    demo = _both(servers, "GET", "/")
    assert demo[0] == demo[1] and demo[1][0] == 200


def test_dials_answer_501_by_name(servers):
    """The dials are served (the name is kept from when the port answered
    them 501): prefix as a JSON field, as a query parameter, per row on
    /caption_batch and on the images route, and include_words on a beam
    server of each package (shared, per row, on the images route), give
    tpucap's status and body; bad dials tpucap's 400 texts."""
    word = "dog"
    row = _rows(2, seed=15)
    cases = [
        ("/caption_features", _features(row[0], prefix=word), 200),
        ("/caption_features?prefix=" + word, _features(row[0]), 200),
        ("/caption_batch", _features(row, prefixes=["", "a " + word]), 200),
        ("/caption?prefix=" + word, _jpeg(5), 200),
        ("/caption_features", _features(row[0], prefix="zzznotaword"), 400),
        ("/caption_batch", _features(row, prefixes=["", "zzznotaword"]), 400),
        # include_words on a greedy server.
        ("/caption_features", _features(row[0], include_words=[word]), 400),
    ]
    for path, body, status in cases:
        want, got = _both(servers, "POST", path, body)
        assert got == want and got[0] == status, (path, got)
        if b"prefixes" in body and status == 400:
            assert got[1]["error"].startswith("row 1: prefix 'zzznotaword'")
    beam = {}
    try:
        for name, cls in (("tpucap", JaxHTTPServer), ("port", CaptionHTTPServer)):
            srv = cls(servers[name][1], **{**SERVE, "method": "beam"})
            srv.serve_background()
            beam[name] = (srv,)
        cases = [
            ("/caption_features", _features(row[0], include_words=[word, "grass"]), 200),
            ("/caption_features?include_words=" + word, _features(row[0]), 200),
            ("/caption_batch", _features(row, include_words_rows=[[word], []]), 200),
            ("/caption?include_words=" + word, _jpeg(6), 200),
            ("/caption_features", _features(row[0], include_words=["zzznotaword"]), 400),
            ("/caption_features", _features(row[0], include_words=["a dog"]), 400),
            ("/caption_features", _features(row[0], include_words=word), 400),
        ]
        for path, body, status in cases:
            want, got = _both(beam, "POST", path, body)
            assert got == want and got[0] == status, (path, got)
            if status == 200 and "caption" in got[1]:
                assert word in got[1]["caption"].split()
    finally:
        for (srv,) in beam.values():
            srv.close()


def test_reload_swaps_both_endpoints(servers):
    """POST /reload of a bundle both packages read: afterwards each server's
    captions are the bundle's, and equal tpucap's; model b is untouched."""
    rows = _rows(3, seed=16)
    jpeg = _jpeg(6)
    before = _both(servers, "POST", "/caption_batch?model=b", _features(rows))
    want, got = _both(servers, "POST", "/reload", json.dumps({"bundle": servers["bundle"]}).encode())
    assert got == want == (200, {"ok": True, "bundle": servers["bundle"]})
    for path, body in (("/caption_batch", _features(rows)), ("/caption", jpeg)):
        want, got = _both(servers, "POST", path, body)
        assert got == want and got[0] == 200
    after = _both(servers, "POST", "/caption_batch?model=b", _features(rows))
    assert after == before
    _, pipe, _ = servers["port"]
    reloaded = CaptioningPipeline.load(servers["bundle"], device="cpu")
    assert _request(servers["port"][0], "POST", "/caption_batch", _features(rows))[1] == {
        "captions": reloaded.generate(rows, method="greedy")
    }


def test_reload_never_splits_a_request_across_the_swap(servers, monkeypatch):
    """A /caption_batch whose rows span two batches (max_batch 2, 4 rows)
    while /reload arrives between them: the images server's queue reaches
    the reload at once, but the swap waits for the features batcher, so
    every row is decoded on the old weights; the next request on the new."""
    from tpucap_torch.serve import _Reload

    pipe = _port_pipe(_jax_pipe(3))
    rows = _rows(4, seed=17)
    old = pipe.generate(rows, method="greedy")
    new = CaptioningPipeline.load(servers["bundle"], device="cpu").generate(rows, method="greedy")
    assert old[2:] != new[2:]  # a half-swapped reply would show
    entered, release = threading.Event(), threading.Event()
    real = pipe.generate_submit

    def held(x, **kw):
        finalize = real(x, **kw)  # dispatched on this moment's params
        if not entered.is_set():
            entered.set()
            release.wait(30)
        return finalize

    monkeypatch.setattr(pipe, "generate_submit", held)
    with CaptionHTTPServer(pipe, **{**SERVE, "max_batch": 2}, allow_reload=True) as srv:
        srv.serve_background()
        replies = {}
        batch = threading.Thread(
            target=lambda: replies.update(batch=_request(srv, "POST", "/caption_batch", _features(rows))[:2])
        )
        batch.start()
        assert entered.wait(30)  # rows 0-1 dispatched, rows 2-3 queued
        reload_ = threading.Thread(
            target=lambda: replies.update(
                reload=_request(srv, "POST", "/reload", json.dumps({"bundle": servers["bundle"]}).encode())[:2]
            )
        )
        reload_.start()
        for _ in range(3000):  # the swap ran, or waits for the features batcher
            if not reload_.is_alive() or any(isinstance(i, _Reload) for i in list(srv._features._queue.queue)):
                break
            threading.Event().wait(0.01)
        release.set()
        batch.join(60)
        reload_.join(60)
        assert replies["batch"] == (200, {"captions": old})
        assert replies["reload"] == (200, {"ok": True, "bundle": servers["bundle"]})
        assert _request(srv, "POST", "/caption_batch", _features(rows))[:2] == (200, {"captions": new})


def test_clients_against_each_others_servers(servers):
    """tpucap's client on the port's server and the port's client on
    tpucap's give the same answers, errors included."""
    jpegs = [_jpeg(s) for s in (7, 8, 9)]
    rows = _rows(2, seed=17)
    ports = {name: servers[name][0].address for name in ("tpucap", "port")}
    by_pair = {}
    for client_cls, server_name in ((JaxClient, "port"), (CaptionClient, "tpucap")):
        c = client_cls(*ports[server_name])
        by_pair[server_name] = (
            c.caption(jpegs[0]),
            c.caption(jpegs[0], model="b"),
            c.caption_features(rows[0]),
            c.caption_features(rows[0].tolist(), model="b"),
            c.caption_features_many(rows),
            c.caption_jpegs_many(jpegs[:2]),
            c.caption_many(jpegs),
            c.healthz(),
            sorted(c.stats()),
            "tpucap_requests_total" in c.metrics(),
        )
    assert by_pair["port"] == by_pair["tpucap"]
    c = CaptionClient(*ports["port"])
    with pytest.raises(ServerError) as err:
        c.caption_features(rows[0], model="zz")
    assert err.value.status == 400 and "unknown model" in str(err.value)
    # The dials, served: the port's client on the port's server gives
    # tpucap's client on tpucap's, a bad dial tpucap's 400 text.
    jc = JaxClient(*ports["tpucap"])
    assert c.caption_features(rows[0], prefix="dog") == jc.caption_features(rows[0], prefix="dog")
    with pytest.raises(ServerError) as err:
        c.caption_features(rows[0], prefix="zzznotaword")
    with pytest.raises(Exception) as jerr:
        jc.caption_features(rows[0], prefix="zzznotaword")
    assert err.value.status == 400 and str(err.value) == str(jerr.value)
    with pytest.raises(ServerError) as err:
        c.caption_stream(jpegs[0])
    assert err.value.status == 400 and "engine='continuous'" in str(err.value)
    with pytest.raises(TypeError, match="include_words must be a sequence"):
        c.caption(jpegs[0], include_words="dog")


def test_construction_refusals(servers):
    _, pipe, _ = servers["port"]
    jpipe = servers["tpucap"][1]
    # The continuous engine is ported: its method check, tpucap's text.
    with pytest.raises(ValueError) as jerr:
        JaxHTTPServer(jpipe, engine="continuous", method="sample")
    with pytest.raises(ValueError) as err:
        CaptionHTTPServer(pipe, engine="continuous", method="sample")
    assert str(err.value) == str(jerr.value)
    assert "engine='continuous' supports method 'greedy'|'beam', got 'sample'" in str(err.value)
    with pytest.raises(ValueError, match="extra_models needs engine='batch'"):
        CaptionHTTPServer(pipe, engine="continuous", extra_models={"x": pipe})
    with pytest.raises(ValueError, match="'default' names the positional pipeline"):
        CaptionHTTPServer(pipe, extra_models={"default": pipe})
    with pytest.raises(NotImplementedError, match="parallelism='dp' is not ported"):
        CaptionHTTPServer(pipe, parallelism="dp")


def test_serve_flag_checks_match_tpucap():
    """serve's flag checks run before any model is loaded, with tpucap's
    texts; what the port lacks exits naming the flag."""
    from tpucap.cli.main import main as jax_main
    from tpucap_torch.cli.main import main

    for argv in (
        ["serve", "--extra-model", "nameonly"],
        ["serve", "--extra-model", "a=x", "--extra-model", "a=y"],
        ["serve", "--extra-model", "default=x"],
        ["serve", "--extra-model", "a=x", "--engine", "continuous"],
        ["serve", "--allow-reload", "--aot-bundle", "x"],
    ):
        with pytest.raises(SystemExit) as jerr:
            jax_main(argv)
        with pytest.raises(SystemExit) as err:
            main(argv, device="cpu")
        assert str(err.value) == str(jerr.value), argv
    for argv, flag in ((["serve", "--aot-bundle", "x"], "--aot-bundle x"),):
        with pytest.raises(SystemExit, match=f"^{flag}: not ported to tpucap_torch \\(serve\\)$"):
            main(argv, device="cpu")
    # --engine continuous is ported: the parser takes it and no flag check
    # refuses it.
    from tpucap_torch.cli.main import build_parser, refuse_unported_flags

    parser, commands = build_parser()
    args = parser.parse_args(["serve", "--engine", "continuous", "--method", "greedy"])
    assert args.engine == "continuous"
    refuse_unported_flags(commands["serve"], args)
    for argv in (
        ["caption", "--image", "x.jpg", "--server-model", "b"],
        ["caption", "--image", "x.jpg", "--server", "h:1", "--method", "mbr"],
        ["caption", "--image", "x.jpg", "--server", "h:1", "--prefix", "a", "--include-words", "b"],
        ["caption", "--image", "x.jpg", "--server", "nope"],
    ):
        with pytest.raises(SystemExit) as jerr:
            jax_main(argv)
        with pytest.raises(SystemExit) as err:
            main(argv, device="cpu")
        assert str(err.value) == str(jerr.value), argv


def test_serve_command_and_caption_server_lines(servers, tmp_path, monkeypatch, capsys):
    """``serve`` restores a checkpoint as ``caption`` does and serves it;
    ``caption --server`` against it prints the lines of offline
    ``caption`` on the same checkpoint, and an unreachable server exits."""
    from tpucap_torch.checkpoint import CheckpointManager
    from tpucap_torch.train import TrainState, build_optimizer

    # The package's ``main`` attribute is the function; the module by name.
    cli = importlib.import_module("tpucap_torch.cli.main")

    _, pipe, _ = servers["port"]
    ckpt = tmp_path / "ckpt"
    args = cli.build_parser()[0].parse_args(["caption", "--image", "x", *MODEL_FLAGS])
    cfg = cli._build_config(args)
    state = TrainState.create(pipe.params["decoder"], build_optimizer(cfg.train), torch.Generator())
    CheckpointManager(str(ckpt)).save(state)
    pipe.tokenizer.save(str(ckpt / "tokenizer.json"))
    paths = []
    for s in (20, 21, 22):
        paths.append(str(tmp_path / f"img{s}.jpg"))
        Path(paths[-1]).write_bytes(_jpeg(s))
    common = [*MODEL_FLAGS, "--checkpoint-dir", str(ckpt)]
    cli.main(["caption", "--image", *paths, *common], device="cpu")
    offline = capsys.readouterr().out.splitlines()
    assert len(offline) == 3

    remote = {}

    def serve_forever(self):  # drive the running server from inside serve
        host, port = self.serve_background()
        cli.main(["caption", "--server", f"{host}:{port}", "--image", *paths])
        remote["lines"] = capsys.readouterr().out.splitlines()

    monkeypatch.setattr(CaptionHTTPServer, "serve_forever", serve_forever)
    cli.main(["serve", *common, "--port", "0", "--no-warmup"], device="cpu")
    assert remote["lines"] == offline
    assert "drained; bye" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="cannot reach 127.0.0.1:9"):
        cli.main(["caption", "--server", "127.0.0.1:9", "--image", paths[0]])


def test_serve_sigterm_drains_and_exits_zero(servers, tmp_path):
    """``serve`` in its own process: it announces its address, answers, and
    on SIGTERM drains and exits 0."""
    _, pipe, _ = servers["port"]
    bundle = tmp_path / "bundle"
    pipe.save(str(bundle))
    code = (
        "from tpucap_torch.cli.main import main; "
        f"main(['serve', '--model-dir', {str(bundle)!r}, '--port', '0', '--method', 'greedy', "
        "'--max-batch', '2'], device='cpu')"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    try:
        addr = None
        for _ in range(200):
            m = re.search(r"http://([\d.]+):(\d+)", proc.stderr.readline() or "")
            if m:
                addr = (m.group(1), int(m.group(2)))
                break
        assert addr, "the server never announced its address"
        c = CaptionClient(*addr, timeout=60)
        assert c.healthz() == {"ok": True, "backend": "cpu"}
        assert c.caption_features(_rows(1, seed=18)[0]) == pipe.generate(_rows(1, seed=18), method="greedy")[0]
        proc.send_signal(signal.SIGTERM)
        rest = proc.stderr.read()
        assert proc.wait(timeout=60) == 0, rest[-500:]
        assert "SIGTERM: draining" in rest and "drained; bye" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
