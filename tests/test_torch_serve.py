"""The port's micro-batching ``CaptionServer`` (``tpucap_torch/serve.py``)
against tpucap's (``tpucap/serve.py``) on the CPU, after tpucap's
``tests/test_serve.py``: tiny_cnn features (128-d) and images (32 x 32),
lstm1 embed 16 / hidden 32, max_len 10, f32, tpucap's random weights
carried across by ``convert.params_from_jax``, seeded numpy rows.

Tolerance: none. At f32 the captions must be tpucap's token for token
(tpucap's ``generate``, tpucap's server and the port's server, from
concurrent submitters, at pipeline depth 1 and 2, in features and images
mode). Also: the bucket ladder and its padding, ``generate_submit``,
``max_queue`` / ``Overloaded`` with ``submit_many`` atomic, close draining
and failing a wedged batcher's futures, ``reload`` between batches and
``reload_together`` swapping once for a pair of servers, the
dials (``prefix``, ``include_words``) after tpucap's checks, and
``parallelism`` refused by name; and the
two repairs that serving from several threads needed: ``precision_flags``
held across threads, and the bf16 cache never keeping a cast of a tree
that a reload replaced.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.serve import CaptionServer as JaxServer
from tpucap.serve import _buckets as jax_buckets
from tpucap_torch import config as tcfg
from tpucap_torch import pipeline as tpipeline
from tpucap_torch.convert import params_from_jax
from tpucap_torch.core import apply_precision, precision_flags
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.serve import CaptionServer, Overloaded, _buckets, reload_together
from tpucap_torch.text import Tokenizer

from ports_init import build_on_ports_init

torch.set_num_threads(2)

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


def _port_pipe(jpipe, precision="f32"):
    pipe = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.encoder_config("tiny_cnn"),
            decoder=tcfg.DecoderConfig(**DEC),
            decode=tcfg.DecodeConfig(max_len=10),
            precision=precision,
        ),
        tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()),
        device="cpu",
    )
    pipe.build(init_params=False)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    return pipe


@pytest.fixture(scope="module")
def pipes():
    """(tpucap's pipeline, the port's on the same weights)."""
    jpipe = JaxPipeline(
        jcfg.Config(
            encoder=jcfg.encoder_config("tiny_cnn"),
            decoder=jcfg.DecoderConfig(**DEC),
            decode=jcfg.DecodeConfig(max_len=10),
            precision="f32",
        )
    )
    jpipe.fit_tokenizer(CORPUS)
    jpipe.params = _jax_params(jpipe, 0)
    return jpipe, _port_pipe(jpipe)


def _jax_params(jpipe, seed):
    """tpucap's random init from ``seed`` with a sharper head tilted toward
    endseq, so that captions differ from row to row and some end early."""
    build_on_ports_init(jpipe, seed)
    dec = jpipe.params["decoder"]
    dec["out"]["kernel"] = dec["out"]["kernel"] * 4
    dec["out"]["bias"] = dec["out"]["bias"].at[jpipe.tokenizer.word_index["endseq"]].add(0.5)
    return jpipe.params


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 128)).astype(np.float32)


def _hold(pipe, monkeypatch):
    """Park the port's batcher inside its next dispatch until the returned
    event is set."""
    release = threading.Event()
    real = pipe.generate_submit

    def held(*a, **kw):
        release.wait(30)
        return real(*a, **kw)

    monkeypatch.setattr(pipe, "generate_submit", held)
    return release


def test_bucket_ladder_and_padding_match_tpucap(pipes):
    jpipe, pipe = pipes
    for m in (1, 2, 3, 6, 8, 64, 65):
        assert _buckets(m) == jax_buckets(m)
    feats = _rows(11, seed=1)
    got = {}
    for name, cls, p in (("tpucap", JaxServer, jpipe), ("port", CaptionServer, pipe)):
        with cls(p, max_batch=8, max_delay_ms=200, method="greedy") as srv:
            caps = [f.result(timeout=120) for f in srv.submit_many(feats[:3])]
            caps += [f.result(timeout=120) for f in srv.submit_many(feats[3:])]
            got[name] = (caps, srv.stats()["padded_rows"], srv.stats()["batches"])
    # 3 rows pad to 4, 8 rows fill a batch: one pad row, two batches.
    assert got["port"] == got["tpucap"] and got["port"][1:] == (1, 2)


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_concurrent_submitters_match_tpucap(pipes, method):
    """Captions of the port's server from 4 submitting threads equal
    tpucap's ``generate`` and tpucap's server on the same rows."""
    jpipe, pipe = pipes
    feats = _rows(12, seed=2)
    ref = jpipe.generate(feats, method=method, beam_width=3)
    with JaxServer(jpipe, max_batch=16, max_delay_ms=100, method=method, beam_width=3) as srv:
        jax_served = [f.result(timeout=120) for f in [srv.submit(f) for f in feats]]
    results = [None] * len(feats)
    with CaptionServer(pipe, max_batch=16, max_delay_ms=100, method=method, beam_width=3) as srv:

        def client(k):
            for i in range(k, len(feats), 4):
                results[i] = srv.caption(feats[i], timeout=120)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        stats = srv.stats()
    assert results == ref == jax_served
    assert stats["requests"] == len(feats) and stats["batches"] < len(feats)  # coalesced
    assert len(set(ref)) > 1  # the rows' captions differ


def test_generate_submit_matches_generate(pipes):
    jpipe, pipe = pipes
    feats = _rows(5, seed=3)
    for method in ("greedy", "beam"):
        fin = pipe.generate_submit(feats, method=method)
        assert callable(fin)
        assert fin() == pipe.generate(feats, method=method) == jpipe.generate_submit(feats, method=method)()
    with pytest.raises(ValueError) as jerr:
        jpipe.generate_submit(feats, method="sample")
    with pytest.raises(ValueError) as err:
        pipe.generate_submit(feats, method="sample")
    assert str(err.value) == str(jerr.value)


def test_pipeline_depth_two_matches_depth_one(pipes):
    _, pipe = pipes
    feats = _rows(9, seed=4)
    got = {}
    for depth in (1, 2):
        with CaptionServer(pipe, max_batch=2, max_delay_ms=1, method="beam", pipeline_depth=depth) as srv:
            got[depth] = [f.result(timeout=120) for f in [srv.submit(f) for f in feats]]
    assert got[2] == got[1] == pipe.generate(feats, method="beam")


def test_images_mode_matches_tpucap(pipes):
    """mode='images' runs the encoder, then the decode, on one snapshot of
    the params; tpucap's images server gives the same captions."""
    jpipe, pipe = pipes
    imgs = np.random.default_rng(5).normal(size=(3, 32, 32, 3)).astype(np.float32)
    with JaxServer(jpipe, mode="images", max_batch=4, max_delay_ms=100, method="greedy") as srv:
        want = [f.result(timeout=120) for f in srv.submit_many(imgs)]
    with CaptionServer(pipe, mode="images", max_batch=4, max_delay_ms=100, method="greedy") as srv:
        with pytest.raises(ValueError, match="request shape"):
            srv.submit(np.zeros((128,), np.float32))
        got = [f.result(timeout=120) for f in srv.submit_many(imgs)]
    assert got == want == jpipe.generate(jpipe.encode_images(imgs), method="greedy")


def test_max_queue_overloaded_and_submit_many_atomic(pipes, monkeypatch):
    """A full queue rejects with tpucap's Overloaded text; a multi-row
    submit over capacity enqueues nothing; admitted requests complete."""
    _, pipe = pipes
    feats = _rows(8, seed=6)
    release = _hold(pipe, monkeypatch)
    srv = CaptionServer(pipe, max_batch=1, max_delay_ms=1, method="greedy", max_queue=3)
    try:
        first = srv.submit(feats[0])  # the batcher parks dispatching this
        deadline = time.time() + 10
        while srv._queue.qsize() and time.time() < deadline:
            time.sleep(0.01)
        held = srv.submit_many(feats[1:3])  # 2 of 3
        before = srv._queue.qsize()
        with pytest.raises(Overloaded, match=r"^request queue at max_queue=3$"):
            srv.submit_many(feats[3:5])  # 2 rows > 1 slot left
        assert srv._queue.qsize() == before == 2  # nothing half-admitted
        held.append(srv.submit(feats[3]))  # the last slot
        with pytest.raises(Overloaded, match="max_queue"):
            srv.submit(feats[4])
        release.set()
        got = [f.result(timeout=120) for f in [first, *held]]
    finally:
        release.set()
        srv.close()
    assert got == pipe.generate(feats[:4], method="greedy")


def test_close_drains_backlog(pipes, monkeypatch):
    _, pipe = pipes
    feats = _rows(6, seed=7)
    release = _hold(pipe, monkeypatch)
    srv = CaptionServer(pipe, max_batch=2, max_delay_ms=1, method="greedy")
    futs = [srv.submit(f) for f in feats]
    threading.Timer(0.2, release.set).start()
    srv.close()
    assert [f.result(timeout=0) for f in futs] == pipe.generate(feats, method="greedy")
    with pytest.raises(RuntimeError, match="server is closed"):
        srv.submit(feats[0])
    srv.close()  # idempotent


def test_close_fails_wedged_futures(pipes, monkeypatch):
    """A batcher wedged in dispatch past close()'s timeout: every pending
    future fails with tpucap's TimeoutError; the unparked batcher still
    sees the shutdown sentinel and ends."""
    _, pipe = pipes
    release = threading.Event()

    def wedged(*a, **kw):
        release.wait(30)
        raise RuntimeError("unparked")

    srv = CaptionServer(pipe, max_batch=2, max_delay_ms=1, method="greedy")
    monkeypatch.setattr(pipe, "generate_submit", wedged)
    futs = [srv.submit(f) for f in _rows(3, seed=8)]
    srv.close(timeout=0.5)
    for f in futs:
        with pytest.raises(TimeoutError, match="did not drain within 0.5s at close"):
            f.result(timeout=10)
    release.set()
    srv._thread.join(timeout=30)
    assert not srv._thread.is_alive()


def test_reload_between_batches_matches_tpucap(pipes):
    """Requests before a reload resolve under the old weights, requests
    after it under the new, on both servers; a tree of another layout
    fails the reload's future and the old weights keep serving."""
    jpipe, _ = pipes
    # A pipeline of its own: the reload must not touch the fixture's.
    p = JaxPipeline(jpipe.config, jpipe.tokenizer)
    new_jax = jax.tree.map(np.asarray, _jax_params(p, 1))
    p.params = jpipe.params
    feats = _rows(4, seed=9)
    got = {}
    for name in ("tpucap", "port"):
        if name == "tpucap":
            srv_cls, new = JaxServer, new_jax
        else:
            p, srv_cls, new = _port_pipe(jpipe), CaptionServer, params_from_jax(new_jax)
        with srv_cls(p, max_batch=8, max_delay_ms=200, method="greedy") as srv:
            old = srv.submit_many(feats)
            done = srv.reload(new)
            later = srv.submit_many(feats)
            assert done.result(timeout=120) is True
            caps = ([f.result(timeout=120) for f in old], [f.result(timeout=120) for f in later])
            if name == "port":
                bad = srv.reload({"decoder": {}})
                with pytest.raises(ValueError, match="structure differs"):
                    bad.result(timeout=120)
                assert [f.result(timeout=120) for f in srv.submit_many(feats)] == caps[1]
        got[name] = caps
    assert got["port"] == got["tpucap"]
    assert got["port"][0] == jpipe.generate(feats, method="greedy")
    assert got["port"][0] != got["port"][1]


def test_reload_together_swaps_once_or_gives_up(pipes):
    """``reload_together`` over a features and an images server of one
    pipeline swaps once for both; when one of them is closed it raises,
    the other's reload fails at once instead of waiting, and the old
    weights keep serving."""
    jpipe, _ = pipes
    new = params_from_jax(jax.tree.map(np.asarray, _jax_params(JaxPipeline(jpipe.config, jpipe.tokenizer), 1)))
    p = _port_pipe(jpipe)
    feats = _rows(4, seed=9)
    old_caps, swaps = p.generate(feats, method="greedy"), []
    real = p.reload_params
    p.reload_params = lambda src: (swaps.append(1), real(src))
    kw = dict(max_batch=8, max_delay_ms=5, method="greedy")
    with CaptionServer(p, **kw) as fsrv, CaptionServer(p, mode="images", **kw) as isrv:
        for f in reload_together([fsrv, isrv], new):
            assert f.result(timeout=120) is True
        assert swaps == [1]
        new_caps = [f.result(timeout=120) for f in fsrv.submit_many(feats)]
        assert new_caps == p.generate(feats, method="greedy") != old_caps
        back = params_from_jax(jax.tree.map(np.asarray, jpipe.params))
        isrv.close()
        with pytest.raises(RuntimeError, match="server is closed"):
            reload_together([fsrv, isrv], back)
        # fsrv's batcher drops the abandoned reload at once (it would
        # otherwise wait SWAP_TIMEOUT_S) and serves the weights it had.
        assert [f.result(timeout=120) for f in fsrv.submit_many(feats)] == new_caps
        assert swaps == [1]


def test_dials_and_parallelism_refused_by_name(pipes):
    """The dials are served (the name is kept from when the port refused
    them): tpucap's admission checks with its texts, then prefixed and
    constrained requests, shared and per row, resolve to tpucap's server's
    captions; parallelism other than none raises at construction; a
    sampling server refuses both dials with tpucap's texts."""
    jpipe, pipe = pipes
    x = _rows(2, seed=10)
    word = next(w for w in pipe.tokenizer.word_index if w not in ("startseq", "endseq"))
    bad = [
        dict(prefix="zzznotaword"),
        dict(include_words="dog"),
        dict(prefix=word, include_words=[word]),
    ]
    with JaxServer(jpipe, max_batch=2, method="greedy") as jsrv, CaptionServer(
        pipe, max_batch=2, method="greedy"
    ) as srv:
        for kw in bad:
            with pytest.raises(ValueError) as jerr:
                jsrv.submit(x[0], **kw)
            with pytest.raises(ValueError) as err:
                srv.submit(x[0], **kw)
            assert str(err.value) == str(jerr.value), kw
        for kw in (dict(include_words=[word]),):  # greedy server: tpucap's text
            with pytest.raises(ValueError) as jerr:
                jsrv.submit(x[0], **kw)
            with pytest.raises(ValueError) as err:
                srv.submit(x[0], **kw)
            assert str(err.value) == str(jerr.value)
        for kw in (dict(prefixes=["", "zzznotaword"]), dict(prefixes="a", include_words_rows=None)):
            with pytest.raises(ValueError) as jerr:
                jsrv.submit_many(x, **kw)
            with pytest.raises(ValueError) as err:
                srv.submit_many(x, **kw)
            assert str(err.value) == str(jerr.value), kw
        assert srv._queue.qsize() == 0
        assert srv.submit(x[0], prefix=word).result(60) == jsrv.submit(x[0], prefix=word).result(60)
        got = [f.result(60) for f in srv.submit_many(x, prefixes=["", word])]
        assert got == [f.result(60) for f in jsrv.submit_many(x, prefixes=["", word])]
        assert got[1].startswith(word)
    with JaxServer(jpipe, max_batch=2, method="beam") as jsrv, CaptionServer(
        pipe, max_batch=2, method="beam"
    ) as srv:
        for kw in (dict(include_words=["zzznotaword"]), dict(include_words=[word, word])):
            with pytest.raises(ValueError) as jerr:
                jsrv.submit(x[0], **kw)
            with pytest.raises(ValueError) as err:
                srv.submit(x[0], **kw)
            assert str(err.value) == str(jerr.value), kw
        got = srv.submit(x[0], include_words=[word]).result(60)
        assert got == jsrv.submit(x[0], include_words=[word]).result(60)
        assert word in got.split()
        rows = [f.result(60) for f in srv.submit_many(x, include_words_rows=[[], [word]])]
        assert rows == [f.result(60) for f in jsrv.submit_many(x, include_words_rows=[[], [word]])]
    with pytest.raises(NotImplementedError, match="parallelism='dp' is not ported"):
        CaptionServer(pipe, parallelism="dp")
    # Sampling is served too: neither dial, with tpucap's texts; a request
    # is the synchronous generate(method="sample") of its batch (seed 0).
    with JaxServer(jpipe, max_batch=2, method="sample") as jsrv, CaptionServer(
        pipe, max_batch=2, method="sample"
    ) as srv:
        for kw in (dict(prefix=word), dict(include_words=[word])):
            with pytest.raises(ValueError) as jerr:
                jsrv.submit(x[0], **kw)
            with pytest.raises(ValueError) as err:
                srv.submit(x[0], **kw)
            assert str(err.value) == str(jerr.value), kw
        assert srv.submit(x[0]).result(60) == pipe.generate(x[:1], method="sample")[0]
    with pytest.raises(NotImplementedError, match="'diverse' is not served"):
        CaptionServer(pipe, method="diverse")


def test_warmup_runs_every_bucket(pipes, monkeypatch):
    _, pipe = pipes
    seen = []
    real = pipe.generate_submit

    def spy(feats, **kw):
        seen.append(len(feats))
        return real(feats, **kw)

    monkeypatch.setattr(pipe, "generate_submit", spy)
    with CaptionServer(pipe, max_batch=6, method="greedy") as srv:
        srv.warmup()
    assert seen == [1, 2, 4, 6]


def test_precision_flags_hold_across_threads():
    """Fault 1: a bf16 block on one thread and an f32 block on another.
    The f32 thread must see TF32 off for its whole block, also after the
    bf16 thread leaves its block and restores the flags it found."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, c.allow_tf32)
    apply_precision("bf16")  # TF32 on outside any block
    a_inside, b_starting = threading.Event(), threading.Event()
    seen = []

    def bf16_thread():
        with precision_flags("bf16"):
            a_inside.set()
            b_starting.wait(10)
            time.sleep(0.2)  # the f32 thread is entering (or waiting) now

    def f32_thread():
        a_inside.wait(10)
        b_starting.set()
        with precision_flags("f32"):
            for _ in range(40):
                seen.append((m.allow_tf32, c.allow_tf32))
                time.sleep(0.01)

    try:
        threads = [threading.Thread(target=bf16_thread), threading.Thread(target=f32_thread)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert len(seen) == 40 and set(seen) == {(False, False)}
        assert (m.allow_tf32, c.allow_tf32) == (True, True)  # restored after both
    finally:
        m.allow_tf32, c.allow_tf32 = saved


def test_training_steps_hold_their_flags_against_a_serving_thread(monkeypatch):
    """Fault 3.31: an f32 ``fit`` on one thread while another runs bf16
    blocks in a loop. Every read of the flags inside a training step (the
    loss, wrapped) finds TF32 off, and after fit returns the flags are
    those the other thread's blocks left: training changes none."""
    from tpucap_torch.train import loop as tloop

    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, c.allow_tf32)
    pipe = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.encoder_config("tiny_cnn"),
            decoder=tcfg.DecoderConfig(**DEC),
            decode=tcfg.DecodeConfig(max_len=10),
            train=tcfg.TrainConfig(precision="f32", epochs=3, batch_size=2),
            precision="f32",
        ),
        device="cpu",
    )
    pipe.fit_tokenizer(CORPUS)
    pipe.build(seed=0)
    feats = {k: np.random.default_rng(i).normal(size=128).astype(np.float32) for i, k in enumerate(CORPUS)}
    seen, real_loss = [], tloop.caption_loss_sums

    def loss(*args, **kw):
        seen.append((m.allow_tf32, c.allow_tf32))
        time.sleep(0.002)  # the serving thread is waiting for the lock now
        return real_loss(*args, **kw)

    monkeypatch.setattr(tloop, "caption_loss_sums", loss)
    stop, blocks = threading.Event(), []

    def serving():
        while not stop.is_set():
            with precision_flags("bf16"):
                blocks.append((m.allow_tf32, c.allow_tf32))
                time.sleep(0.001)

    apply_precision("bf16")  # TF32 on outside any block
    server = threading.Thread(target=serving)
    try:
        server.start()
        while not blocks:
            time.sleep(0.001)
        history = pipe.fit(CORPUS, feats, log=None)
        stop.set()
        server.join(timeout=30)
        assert not server.is_alive()
        assert len(history) == 3 and len(seen) == 3 * 4
        assert set(seen) == {(False, False)}
        assert set(blocks) == {(True, True)} and len(blocks) > len(seen)
        assert (m.allow_tf32, c.allow_tf32) == (True, True)  # not reset by training
    finally:
        stop.set()
        m.allow_tf32, c.allow_tf32 = saved


def test_bf16_cache_never_keeps_a_replaced_tree(pipes, monkeypatch):
    """Fault 2: a reload lands while a bf16 cast of the old tree is in
    progress (forced inside the cast). The caller that began before the
    reload gets the old tree's cast; every later call the new tree's."""
    jpipe, _ = pipes
    pipe = _port_pipe(jpipe, precision="bf16")
    new = params_from_jax(jax.tree.map(lambda a: np.asarray(a) * 2.0, jpipe.params))
    real_map = tpipeline.tree_map
    fired = []

    def reload_mid_cast(fn, tree, *rest):
        out = real_map(fn, tree, *rest)
        if fn.__name__ == "cast" and not fired:
            fired.append(True)
            pipe.reload_params(new)
        return out

    monkeypatch.setattr(tpipeline, "tree_map", reload_mid_cast)
    old_cast = pipe._inference_params()
    assert fired
    kernel = ("decoder", "out", "kernel")

    def leaf(tree):
        return tree[kernel[0]][kernel[1]][kernel[2]]

    assert torch.equal(leaf(old_cast), leaf(new).mul(0.5).to(torch.bfloat16))
    now = pipe._inference_params()
    assert now is pipe._inference_params()  # cached from here on
    assert torch.equal(leaf(now), leaf(new).to(torch.bfloat16))
