"""The port's continuous engines (``tpucap_torch/decode/continuous.py``,
``continuous_beam.py``) against tpucap's, on the CPU: a 1-layer merge
decoder and the soft-attention decoder (vocabulary 29, embed 8, hidden 16,
12-d features or a 9 x 12 grid), tpucap's random weights carried across by
``convert.params_from_jax`` with the head tilted toward endseq so that
lengths differ, 4 slots, max_len 8, seeded numpy features; the GRU (2
layers) and adaptive decoders run through both engines unchanged (the
adaptive decoder's greedy engine, like the attention decoder's, is held to
``greedy_decode`` only).

Both engines are driven by one host schedule: requests arrive at different
sync groups, more of them than there are slots, so lanes and groups are
recycled; every sync group fetches the flags and ``progress`` of both
engines (the attention decoder's greedy engine, one lane a request so no
grid is shared, is held to ``greedy_decode`` only). Tolerance: tokens, lengths, flags and ``progress`` exact; f32
scores within rtol 1e-5 of tpucap's (its XLA and the port's ATen reduce
the softmax normalizer in another order). Each request's row also equals
the port's own ``greedy_decode`` / ``beam_decode`` of its features: tokens
and lengths exact, scores within rtol 1e-6 (the same arithmetic at another
row count). Pad rows (index == slots) are dropped by admission and
collection alike.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tpucap.decode.continuous import ContinuousDecodeEngine as JaxGreedyEngine
from tpucap.decode.continuous_beam import ContinuousBeamEngine as JaxBeamEngine
from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap_torch.convert import params_from_jax
from tpucap_torch.decode import (
    ContinuousBeamEngine,
    ContinuousDecodeEngine,
    beam_decode,
    greedy_decode,
)
from tpucap_torch.decode.beam import NEG_INF, min_len_mask
from tpucap_torch.models.decoders import build_decoder

torch.set_num_threads(2)

V, D, GRID = 29, 12, 9
START, END, MAX_LEN, SLOTS, K = 1, 2, 8, 4, 2
DIMS = dict(vocab_size=V, feature_dim=D, embed_dim=8, hidden_dim=16, dropout_rate=0.0)
SCORE_RTOL = 1e-5
# (sync group of arrival, seed of the features) for 7 requests over 4 slots.
ARRIVALS = ((0, 0), (0, 1), (0, 2), (1, 3), (1, 4), (2, 5), (4, 6))
TICKS = 2
CASES = {
    "merge": dict(name="lstm1", dials={}),
    "merge_dials": dict(name="lstm1", dials=dict(min_len=3, banned_ids=(5, 7), no_repeat_ngram_size=2)),
    "attention": dict(name="attention", dials={}),
    # A random GRU or adaptive decoder repeats one word to max_len; the
    # bigram ban lets the endseq tilt end some requests early.
    "gru2": dict(name="gru2", dials=dict(no_repeat_ngram_size=2)),
    "adaptive": dict(name="adaptive", dials=dict(no_repeat_ngram_size=2)),
}
#: The families whose features are a spatial grid.
GRIDDED = ("attention", "adaptive")


@functools.cache
def _bridged(name, seed=0):
    """tpucap's decoder and random params and the port's on the same
    weights, built once a module (the cases only read them)."""
    jdec = jax_build_decoder(name, **DIMS)
    tdec = build_decoder(name, **DIMS)
    jp = jax.jit(jdec.init)(jax.random.key(seed))  # one program, not an op at a time
    jp["out"]["kernel"] = jp["out"]["kernel"] * 3
    jp["out"]["bias"] = jp["out"]["bias"].at[END].add(0.4)
    return jdec, jp, tdec, params_from_jax(jax.tree.map(np.asarray, jp))


def _feature(name, seed):
    shape = (GRID, D) if name in GRIDDED else (D,)
    return np.random.default_rng(100 + seed).normal(size=shape).astype(np.float32)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _drive(eng, arrivals, name):
    """Admit ``arrivals`` as lanes free up (padded to the admission ladder,
    as the server does), TICKS steps a sync group. -> (each request's
    (tokens, length, score), each sync group's host view: flags and
    progress)."""
    state = eng.init_state()
    free = list(range(eng.slots))
    owner, results, views = {}, {}, []
    waiting = list(enumerate(arrivals))
    sync = 0
    while waiting or owner:
        due = [w for w in waiting if w[1][0] <= sync][: len(free)]
        if due:
            ids = [free.pop() for _ in due]
            for slot, (req, _) in zip(ids, due):
                owner[slot] = req
            waiting = [w for w in waiting if w not in due]
            idx, feats = eng.pad_admission(ids, [_feature(name, a[1]) for _, a in due])
            state = eng.admit(state, idx, feats)
        state = eng.tick(state, TICKS)
        fin, act, lens = (_host(x) for x in eng.flags(state))
        tokens, stable = (_host(x) for x in eng.progress(state))
        views.append((fin, act, lens, tokens, stable))
        ids = [int(i) for i in np.where(fin)[0]]
        if ids:
            # Collected at the whole pool's bucket: pad rows in most
            # collects, one jit compile of tpucap's collect an engine.
            idx = np.full((eng.slots,), eng.slots)
            idx[: len(ids)] = ids
            (tok, lengths, scores), state = eng.collect(state, idx)
            tok, lengths, scores = _host(tok), _host(lengths), _host(scores)
            for row, slot in enumerate(ids):
                results[owner.pop(slot)] = (tok[row], int(lengths[row]), float(scores[row]))
                free.append(slot)
        sync += 1
        assert sync < 100
    return results, views


def _engines(case, beam, **extra):
    spec = CASES[case]
    jdec, jp, tdec, tp = _bridged(spec["name"])
    kw = dict(slots=SLOTS, start_id=START, end_id=END, max_len=MAX_LEN, **spec["dials"], **extra)
    if spec["name"] in GRIDDED:
        kw["feature_shape"] = (GRID, D)
    if beam:
        kw["beam_width"] = K
        return (JaxBeamEngine(jdec, jp, matmul_precision="highest", **kw),
                ContinuousBeamEngine(tdec, tp, **kw), tdec, tp)
    return (JaxGreedyEngine(jdec, jp, matmul_precision="highest", **kw),
            ContinuousDecodeEngine(tdec, tp, **kw), tdec, tp)


def _offline(tdec, tp, name, beam, dials, **extra):
    feats = torch.from_numpy(np.stack([_feature(name, a[1]) for a in ARRIVALS]))
    state = tdec.init_state(tp, feats)
    kw = dict(start_id=START, end_id=END, max_len=MAX_LEN, **dials, **extra)
    if beam:
        return beam_decode(tdec.step, tp, state, beam_width=K, decoder=tdec, **kw)
    return greedy_decode(tdec.step, tp, state, **kw)


def _check(case, beam, against_tpucap=True, **extra):
    jeng, teng, tdec, tp = _engines(case, beam, **extra)
    name = CASES[case]["name"]
    got, got_views = _drive(teng, ARRIVALS, name)
    assert sorted(got) == list(range(len(ARRIVALS)))
    if against_tpucap:
        want, want_views = _drive(jeng, ARRIVALS, name)
        assert len(got_views) == len(want_views)
        for s, (g, w) in enumerate(zip(got_views, want_views)):
            for a, b, what in zip(g, w, ("finished", "active", "lengths", "progress", "stable")):
                np.testing.assert_array_equal(a, b, err_msg=f"sync {s}: {what}")
        assert sorted(want) == sorted(got)
        for req in want:
            np.testing.assert_array_equal(got[req][0], want[req][0], err_msg=f"request {req}")
            assert got[req][1] == want[req][1]
            np.testing.assert_allclose(got[req][2], want[req][2], rtol=SCORE_RTOL)
    # Each request as the port's batch engine decodes it, all at once.
    off = _offline(tdec, tp, name, beam, CASES[case]["dials"], **extra)
    for req in got:
        np.testing.assert_array_equal(got[req][0], off.tokens[req].numpy(), err_msg=f"request {req}")
        assert got[req][1] == int(off.lengths[req])
        np.testing.assert_allclose(got[req][2], float(off.scores[req]), rtol=1e-6)
    return got, got_views


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_engine_matches_tpucap(case):
    # The attention decoder's grids are shared by a beam's lanes only: at
    # one lane a request its greedy engine is held to greedy_decode (itself
    # held to tpucap's in test_torch_attention.py), saving a jit compile of
    # tpucap's engine.
    got, views = _check(case, beam=False, against_tpucap=case not in GRIDDED)
    lengths = {int(r[1]) for r in got.values()}
    assert len(lengths) > 1, "every request ran to the same length: no recycling was shown"
    if case == "merge_dials":
        assert min(lengths) >= 3  # min_len
        for tok, n, _ in got.values():
            assert not set(tok[:n].tolist()) & {5, 7}  # banned_ids


@pytest.mark.parametrize("case,extra", [
    ("merge", {}),
    ("merge_dials", dict(length_penalty="gnmt", alpha=0.7)),
    ("attention", {}),
    ("gru2", {}),
    ("adaptive", {}),
], ids=["merge", "merge_dials_gnmt", "attention", "gru2", "adaptive"])
def test_beam_engine_matches_tpucap(case, extra):
    got, views = _check(case, beam=True, **extra)
    # The stable prefix never shrinks while a group runs, and is a prefix
    # of the caption the group retires with.
    assert any(v[4].any() for v in views)


def test_beam_engine_keeps_shared_keys_one_row_a_group():
    _, teng, tdec, _ = _engines("attention", beam=True)
    state = teng.init_state()
    assert state.dec["features"].shape == (SLOTS, GRID, D)
    assert state.dec["att_feat"].shape[0] == SLOTS
    assert state.dec["h"].shape[0] == SLOTS * K


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam"])
def test_pad_rows_are_dropped(beam):
    """Admission of 3 requests at bucket 4 and collections padded with
    index == slots: the pad rows touch no lane, as XLA's scatter drops them
    in tpucap (whose engines the schedules above hold the port to, pads
    included); a pad row's clamped gather is garbage the host discards."""
    _, teng, _, _ = _engines("merge", beam)
    idx, feats = teng.pad_admission([0, 2, 3], [_feature("lstm1", s) for s in range(3)])
    assert idx.tolist() == [0, 2, 3, SLOTS]
    before = teng.init_state()
    after = teng.admit(before, idx, feats)
    lane1 = slice(K, 2 * K) if beam else slice(1, 2)
    for key in ("h", "c", "fe"):
        torch.testing.assert_close(after.dec[key][lane1], before.dec[key][lane1], rtol=0, atol=0)
    assert after.active.tolist() == [True, False, True, True]
    state = teng.tick(after, MAX_LEN)
    assert state.finished.tolist() == [True, False, True, True]
    _, cleared = teng.collect(state, teng.pad_ids([0, 2, 3]))
    assert cleared.finished.tolist() == [False] * SLOTS
    rows3, cleared = teng.collect(state, np.array([3, SLOTS, SLOTS, SLOTS]))
    assert cleared.finished.tolist() == [True, False, True, False]
    alone, _ = teng.collect(state, np.array([3]))
    for padded, single in zip(rows3, alone):
        torch.testing.assert_close(padded[:1], single, rtol=0, atol=0)


def test_min_len_mask_tensor_form():
    """The scalar form is unchanged; the (rows,) form masks each row at its
    own step, as the scalar form does at that step."""
    logits = torch.randn(4, V, generator=torch.Generator().manual_seed(0))
    for t in range(4):
        got = min_len_mask(logits.clone(), t, 2, END)
        want = logits.clone()
        if t < 2:
            want[:, END] = NEG_INF
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    steps = torch.tensor([0, 1, 2, 5])
    got = min_len_mask(logits.clone(), steps, 2, END)
    for r, t in enumerate(steps.tolist()):
        torch.testing.assert_close(got[r], min_len_mask(logits[r:r + 1].clone(), t, 2, END)[0], rtol=0, atol=0)
    torch.testing.assert_close(min_len_mask(logits.clone(), steps, 0, END), logits, rtol=0, atol=0)
    bf = logits.to(torch.bfloat16)
    assert min_len_mask(bf.clone(), steps, 2, END).dtype == torch.bfloat16
