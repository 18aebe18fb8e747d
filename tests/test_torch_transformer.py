"""tpucap_torch's transformer decoder (``models/decoders/transformer.py``),
dense and mixture-of-experts, against tpucap's on the CPU: vocabulary 29,
12-d features (pooled, or a 5-cell grid), hidden 16, 4 heads, MLP 32, 2
layers, max_positions 12, 4 experts at top-1 and top-2, dropout off, f32,
tpucap's random params (one jit) carried across by ``convert.params_from_jax``
with the head sharpened and tilted toward endseq.

Tolerance, and what holds:

- the init tree's structure and shapes are tpucap's (``jax.eval_shape``),
  and so are the dataclass's validation errors;
- ``init_state``, ``step`` and ``step_chunk`` within 1e-5 absolute of
  tpucap's (states and logits of O(1); the packages' products and softmax
  sums round in another order), and the port's ``step_chunk`` within 1e-6
  of C successive ``step`` calls;
- ``forward_train`` and ``forward_hidden_with_alphas`` within 1e-5, the
  maps' rows summing to 1 within 1e-6, ``forward_train_with_moe_aux``'s aux
  within 1e-6; a zeroed router (every expert tied) picks tpucap's experts;
- greedy and beam-3 tokens, lengths and both continuous engines' captions
  exact, scores within 1e-5, the cross-attention memory at B rows in every
  beam step; diverse search, must-include words, an ensemble with lstm1,
  MBR and ``score_captions`` as tpucap's, the sampler at top_k = 1 greedy,
  the batch server ``generate``'s;
- ``prime_prefix`` on a ``step_chunk`` decoder is tpucap's ``_prime_chunked``
  (``pos`` and ``last`` exact, ``logp`` and the caches within 1e-5) for
  lengths 0 ... P, and ``generate_continuation`` gives tpucap's captions,
  greedy and beam;
- one SGD step's loss within 1e-6 relative and its update within 1e-5
  (``test_torch_gru.sgd_step_matches``), dense and MoE; ``fit`` on the MoE
  model under plain SGD gives tpucap's per-epoch losses within 1e-5
  relative at ``moe_aux_weight`` 0.0 and 0.5 alike (no single-device step
  reads it);
- ``lora_targets`` of the MoE tree is tpucap's (the router adapted, the 3-D
  expert stacks not); the bundle round-trips both models bit for bit;
- the CLI: ``train --decoder transformer --num-experts 4``, ``caption
  --prefix`` and ``--dump-attention`` print the restored pipeline's
  captions, ``export`` refuses with tpucap's text;
- bf16 greedy captions from the same bf16 features are tpucap's
  (``tests/test_torch_bf16.py``'s bound).
"""

import contextlib
import dataclasses
import functools
import importlib
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_continuous import ARRIVALS, SCORE_RTOL, SLOTS, _drive
from test_torch_continuous import K as CK
from test_torch_continuous import MAX_LEN as CMAX
from test_torch_gru import sgd_step_matches
from tpucap import config as jcfg
from tpucap.decode import beam_decode as jax_beam_decode
from tpucap.decode import greedy_decode as jax_greedy_decode
from tpucap.decode.continuous import ContinuousDecodeEngine as JaxGreedyEngine
from tpucap.decode.continuous_beam import ContinuousBeamEngine as JaxBeamEngine
from tpucap.decode.prefix import prime_prefix as jax_prime_prefix
from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.text import Tokenizer as JaxTokenizer
from tpucap.train.lora import lora_targets as jax_lora_targets
from tpucap_torch import config as tcfg
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.decode import (
    ContinuousBeamEngine,
    ContinuousDecodeEngine,
    beam_decode,
    greedy_decode,
    prime_prefix,
)
from tpucap_torch.models.decoders import TransformerDecoder, build_decoder
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.train.lora import lora_targets

from ports_init import jit_init

torch.set_num_threads(2)

V, D, GRID, B = 29, 12, 5, 4
START, END, MAXLEN = 1, 2, 10
DIMS = dict(vocab_size=V, feature_dim=D, hidden_dim=16, num_layers=2, num_heads=4, mlp_dim=32,
            max_positions=12, dropout_rate=0.0)
CASES = {"dense": {}, "moe1": dict(num_experts=4, moe_top_k=1), "moe2": dict(num_experts=4, moe_top_k=2)}
ATOL = 1e-5
CORPUS = {f"img{i}": [f"startseq w{a} w{b} endseq" for a in "abcd" for b in "xyz"][i::3] for i in range(3)}


@functools.cache
def _bridged(case, seed=0, tilt=0.3):
    """tpucap's decoder and random params and the port's on the same
    weights, built once a module (the tests only read them); the head
    sharpened and tilted toward endseq by ``tilt``."""
    jdec = jax_build_decoder("transformer", **DIMS, **CASES[case])
    tdec = build_decoder("transformer", **DIMS, **CASES[case])
    jp = jax.tree.map(np.asarray, jit_init(jdec, jax.random.key(seed)))
    jp["out"]["kernel"] = jp["out"]["kernel"] * 3
    jp["out"]["bias"] = jp["out"]["bias"] + np.eye(V, dtype=np.float32)[END] * tilt
    return jdec, jax.tree.map(jnp.asarray, jp), tdec, params_from_jax(jp)


@functools.cache
def _jit(case, name):
    return jax.jit(getattr(_bridged(case)[0], name))


def _feats(seed, batch=B, grid=False):
    shape = (batch, GRID, D) if grid else (batch, D)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=0,
                               err_msg=what)


# -- the decoder ------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_init_tree_and_validation_match_tpucap(case):
    jdec, _, tdec, _ = _bridged(case)
    want = jax.eval_shape(jdec.init, jax.random.key(0))
    got = params_to_numpy(tdec.init(torch.Generator().manual_seed(0)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    layer = got["layers"][0]
    if case == "dense":
        assert layer["mlp_in"]["kernel"].shape == (16, 32) and "router" not in layer
    else:
        assert layer["router"]["kernel"].shape == (16, 4)
        assert layer["moe_in"]["kernel"].shape == (4, 16, 32) and layer["moe_out"]["bias"].shape == (4, 16)
    assert got["pos_embedding"].shape == (12, 16) and tdec.beam_shared_keys == {"mem_k", "mem_v"}
    for bad in (dict(num_layers=0), dict(num_heads=5), dict(num_experts=4, moe_top_k=5),
                dict(num_experts=4, moe_top_k=0)):
        kw = {**DIMS, **CASES[case], **bad}
        with pytest.raises(ValueError) as jerr:
            jax_build_decoder("transformer", **kw)
        with pytest.raises(ValueError) as err:
            build_decoder("transformer", **kw)
        assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("case,grid", [("dense", False), ("moe2", True)], ids=["dense_pooled", "moe2_grid"])
def test_steps_and_chunk_match_tpucap(case, grid):
    """Three steps, then a chunk of 3 per lane; lanes at different
    positions (the continuous engines' case) for the chunk's mask. The
    port's chunk equals its own three steps."""
    _, jp, tdec, tp = _bridged(case)
    feats = _feats(1, grid=grid)
    js = _jit(case, "init_state")(jp, jnp.asarray(feats))
    ts = tdec.init_state(tp, torch.from_numpy(feats))
    assert sorted(ts) == sorted(js) == ["cache_k", "cache_v", "mem_k", "mem_v", "pos"]
    assert tuple(ts["cache_k"].shape) == (B, 2, 12, 4, 4) and ts["pos"].dtype == torch.int32
    rng = np.random.default_rng(2)
    for t in range(3):
        tok = rng.integers(1, V, size=(B,))
        jl, js = _jit(case, "step")(jp, js, jnp.asarray(tok, jnp.int32))
        tl, ts = tdec.step(tp, ts, torch.from_numpy(tok))
        _close(tl, jl, what=f"step {t}")
        for key in js:
            _close(ts[key], js[key], what=key)
    # Lanes at positions 3, 4, 5, 6.
    js = dict(js, pos=js["pos"] + jnp.arange(B, dtype=jnp.int32))
    ts = dict(ts, pos=ts["pos"] + torch.arange(B, dtype=torch.int32))
    chunk = rng.integers(1, V, size=(B, 3))
    jl, jc = _jit(case, "step_chunk")(jp, js, jnp.asarray(chunk, jnp.int32))
    tl, tc = tdec.step_chunk(tp, ts, torch.from_numpy(chunk))
    _close(tl, jl, what="chunk logits")
    for key in jc:
        _close(tc[key], jc[key], what=f"chunk {key}")
    stepped, logits = ts, []
    for c in range(3):
        out, stepped = tdec.step(tp, stepped, torch.from_numpy(chunk[:, c]))
        logits.append(out)
    _close(tl, torch.stack(logits, dim=1), atol=1e-6, what="chunk against steps")
    for key in tc:
        _close(tc[key], stepped[key], atol=1e-6, what=f"chunk against steps: {key}")


def test_lane_past_capacity_writes_the_last_slot_and_sees_every_key():
    """A lane at pos >= max_positions (a retired continuous lane still
    ticking): the clipped slot is written, every key visible, as tpucap's."""
    _, jp, tdec, tp = _bridged("dense")
    feats = _feats(3)
    js = _jit("dense", "init_state")(jp, jnp.asarray(feats))
    ts = tdec.init_state(tp, torch.from_numpy(feats))
    pos = np.array([0, 11, 12, 20], np.int32)
    js, ts = dict(js, pos=jnp.asarray(pos)), dict(ts, pos=torch.from_numpy(pos))
    tok = np.array([3, 4, 5, 6])
    jl, js = _jit("dense", "step")(jp, js, jnp.asarray(tok, jnp.int32))
    tl, ts = tdec.step(tp, ts, torch.from_numpy(tok))
    _close(tl, jl)
    _close(ts["cache_k"], js["cache_k"])
    assert ts["pos"].tolist() == [1, 12, 13, 21]


def _forwards(jdec, p, x, toks):
    hidden, alphas = jdec.forward_hidden_with_alphas(p, x, toks)
    logits, aux = jdec.forward_train_with_moe_aux(p, x, toks)
    return jdec.forward_train(p, x, toks), hidden, alphas, logits, aux


@functools.cache
def _jit_forwards(case):
    return jax.jit(functools.partial(_forwards, _bridged(case)[0]))


def _port_forwards(tdec, tp, x, toks):
    hidden, alphas = tdec.forward_hidden_with_alphas(tp, x, toks)
    logits, aux = tdec.forward_train_with_moe_aux(tp, x, toks)
    return tdec.forward_train(tp, x, toks), hidden, alphas, logits, aux


@pytest.mark.parametrize("case", list(CASES))
def test_teacher_forced_forwards_match_tpucap(case):
    _, jp, tdec, tp = _bridged(case)
    feats = _feats(4, grid=True)
    toks = np.random.default_rng(5).integers(1, V, size=(B, 7))
    want = _jit_forwards(case)(jp, jnp.asarray(feats), jnp.asarray(toks, jnp.int32))
    got = _port_forwards(tdec, tp, torch.from_numpy(feats), torch.from_numpy(toks))
    for g, w, what in zip(got[:4], want[:4], ("logits", "hidden", "alphas", "logits with aux")):
        _close(g, w, what=what)
    alphas = got[2]
    assert alphas.dtype == torch.float32 and tuple(alphas.shape) == (B, 7, GRID)
    np.testing.assert_allclose(alphas.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(float(got[4]), float(want[4]), atol=1e-6, rtol=0)
    assert (float(got[4]) > 0) == (case != "dense")
    with pytest.raises(ValueError) as jerr:
        _bridged(case)[0].forward_train(jp, jnp.asarray(feats), jnp.ones((B, 13), jnp.int32))
    with pytest.raises(ValueError) as err:
        tdec.forward_train(tp, torch.from_numpy(feats), torch.ones((B, 13), dtype=torch.long))
    assert str(err.value) == str(jerr.value) == "sequence length 13 exceeds max_positions 12"


@pytest.mark.parametrize("case", ["moe1", "moe2"])
def test_router_ties_pick_tpucaps_experts(case):
    """A zeroed router: every expert's probability 1/E, the top-k in index
    order on both sides, so the same experts mix the same way."""
    _, jp, tdec, _ = _bridged(case)
    jp = jax.tree.map(np.array, jp)
    for layer in jp["layers"]:
        layer["router"]["kernel"][:] = 0.0
        layer["router"]["bias"][:] = 0.0
        # Experts that differ, so the pick shows in the output.
        layer["moe_out"]["bias"] += np.arange(4, dtype=np.float32)[:, None]
    tp = params_from_jax(jp)
    feats = _feats(6)
    toks = np.random.default_rng(7).integers(1, V, size=(B, 5))
    want = _jit_forwards(case)(jp, jnp.asarray(feats), jnp.asarray(toks, jnp.int32))
    got = _port_forwards(tdec, tp, torch.from_numpy(feats), torch.from_numpy(toks))
    _close(got[0], want[0])
    np.testing.assert_allclose(float(got[4]), float(want[4]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_engines_match_tpucap(method):
    """MoE top-2; the beam keeps mem_k / mem_v at B rows in every step."""
    jdec, jp, tdec, tp = _bridged("moe2", seed=5)
    feats = _feats(8, batch=5)
    js = _jit("moe2", "init_state")(jp, jnp.asarray(feats))
    ts = tdec.init_state(tp, torch.from_numpy(feats))
    kw = dict(start_id=START, end_id=END, max_len=MAXLEN, no_repeat_ngram_size=2)
    if method == "beam":
        rows = set()

        def step(p, state, token):
            rows.add((state["mem_k"].shape[0], state["cache_k"].shape[0], token.shape[0]))
            return tdec.step(p, state, token)

        ref = jax_beam_decode(jdec.step, jp, js, beam_width=3, decoder=jdec, **kw)
        got = beam_decode(step, tp, ts, beam_width=3, decoder=tdec, **kw)
        assert rows == {(5, 15, 15)}
        np.testing.assert_array_equal(got.beam_tokens.numpy(), np.asarray(ref.beam_tokens))
        np.testing.assert_allclose(got.beam_scores.numpy(), np.asarray(ref.beam_scores), atol=ATOL)
    else:
        ref = jax_greedy_decode(jdec.step, jp, js, **kw)
        got = greedy_decode(tdec.step, tp, ts, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=ATOL)
    assert len({tuple(r) for r in got.tokens.numpy()}) > 1


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam"])
def test_continuous_engines_match_tpucap(beam):
    """Requests admitted at different sync groups into lanes at other
    depths (per-lane positions), lanes recycled: tokens, lengths, flags and
    progress exact, scores within SCORE_RTOL (``test_torch_continuous``'s
    schedule), each request also the port's batch engine's."""
    jdec, jp, tdec, tp = _bridged("dense", seed=2, tilt=0.8)
    kw = dict(slots=SLOTS, start_id=START, end_id=END, max_len=CMAX, no_repeat_ngram_size=2)
    if beam:
        jeng = JaxBeamEngine(jdec, jp, matmul_precision="highest", beam_width=CK, **kw)
        teng = ContinuousBeamEngine(tdec, tp, beam_width=CK, **kw)
    else:
        jeng = JaxGreedyEngine(jdec, jp, matmul_precision="highest", **kw)
        teng = ContinuousDecodeEngine(tdec, tp, **kw)
    got, got_views = _drive(teng, ARRIVALS, "transformer")
    want, want_views = _drive(jeng, ARRIVALS, "transformer")
    assert len(got_views) == len(want_views)
    for g, w in zip(got_views, want_views):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for req in want:
        np.testing.assert_array_equal(got[req][0], want[req][0], err_msg=f"request {req}")
        assert got[req][1] == want[req][1]
        np.testing.assert_allclose(got[req][2], want[req][2], rtol=SCORE_RTOL)
    assert len({r[1] for r in got.values()}) > 1
    from test_torch_continuous import _feature

    feats = torch.from_numpy(np.stack([_feature("transformer", a[1]) for a in ARRIVALS]))
    dkw = dict(start_id=START, end_id=END, max_len=CMAX, no_repeat_ngram_size=2)
    state = tdec.init_state(tp, feats)
    off = (beam_decode(tdec.step, tp, state, beam_width=CK, decoder=tdec, **dkw) if beam
           else greedy_decode(tdec.step, tp, state, **dkw))
    for req in got:
        np.testing.assert_array_equal(got[req][0], off.tokens[req].numpy())


def test_chunked_prime_matches_tpucap_and_the_step_loop():
    """lengths 0 ... P in one padded batch: tpucap's ``_prime_chunked``
    (``pos`` overwritten by the lengths, a short row's stale K/V kept), and
    the continuations from the chunk-primed state are those from the step
    loop's, greedy and beam."""
    jdec, jp, tdec, tp = _bridged("moe2", seed=3)
    P = 4
    feats = _feats(9, batch=P + 1)
    prefix = np.random.default_rng(10).integers(3, V, size=(P + 1, P))
    lengths = np.arange(P + 1)
    prime = jax.jit(lambda p, s, pre, n: jax_prime_prefix(None, p, s, pre, n, start_id=START, decoder=jdec))
    js, jlast, jlp = prime(jp, jdec.init_state(jp, jnp.asarray(feats)), jnp.asarray(prefix, jnp.int32),
                           jnp.asarray(lengths, jnp.int32))
    state = tdec.init_state(tp, torch.from_numpy(feats))
    ts, last, lp = prime_prefix(tdec.step, tp, state, prefix, lengths, start_id=START, decoder=tdec)
    assert ts["pos"].tolist() == lengths.tolist() == np.asarray(js["pos"]).tolist()
    assert last.tolist() == np.asarray(jlast).tolist()
    assert last.tolist() == [START] + [int(prefix[i, i - 1]) for i in range(1, P + 1)]
    _close(lp, jlp)
    for key in ("cache_k", "cache_v"):
        _close(ts[key], js[key], what=key)
    ss, slast, slp = prime_prefix(tdec.step, tp, state, prefix, lengths, start_id=START)
    assert slast.tolist() == last.tolist() and ss["pos"].tolist() == lengths.tolist()
    _close(lp, slp.numpy(), atol=1e-6)
    for method in ("greedy", "beam"):
        runs = []
        for st, la, sc in ((ts, last, lp), (ss, slast, slp)):
            kw = dict(start_id=la, end_id=END, max_len=MAXLEN - P, init_scores=sc)
            runs.append(beam_decode(tdec.step, tp, st, beam_width=3, decoder=tdec, **kw) if method == "beam"
                        else greedy_decode(tdec.step, tp, st, **kw))
        np.testing.assert_array_equal(runs[0].tokens.numpy(), runs[1].tokens.numpy())
        np.testing.assert_allclose(runs[0].scores.numpy(), runs[1].scores.numpy(), atol=1e-5)


# -- the pipeline -------------------------------------------------------------------


def make_pipes(experts=4, decode=None, train=None, precision="f32", seed=0, tilt=1.0):
    """(tpucap's pipeline, the port's) on tiny_cnn's pooled 128-d features
    into the transformer (hidden 16, 4 heads, MLP 32, 2 layers,
    max_positions 24, ``experts`` experts top-2), the port's random init
    from ``seed`` with the head sharpened and tilted toward endseq, carried
    to tpucap."""
    decode = {"max_len": 10, "no_repeat_ngram_size": 2, **(decode or {})}
    parts = lambda m: dict(  # noqa: E731
        encoder=m.encoder_config("tiny_cnn"),
        decoder=m.DecoderConfig(name="transformer", hidden_dim=16, num_layers=2, num_heads=4, mlp_dim=32,
                                max_positions=24, num_experts=experts, dropout_rate=0.0),
        decode=m.DecodeConfig(**decode), train=m.TrainConfig(**(train or {})), precision=precision,
    )
    pipe = CaptioningPipeline(tcfg.Config(**parts(tcfg)), device="cpu")
    pipe.fit_tokenizer(CORPUS)
    pipe.build(seed=seed)
    dec = pipe.params["decoder"]
    dec["out"]["kernel"].mul_(4)
    dec["out"]["bias"][pipe.tokenizer.word_index["endseq"]] += tilt
    jpipe = JaxPipeline(jcfg.Config(**parts(jcfg)), tokenizer=JaxTokenizer.from_json(pipe.tokenizer.to_json()))
    jpipe.build(init_params=False)
    jpipe.params = jax.tree.map(jnp.asarray, params_to_numpy(pipe.params))
    return jpipe, pipe


@pytest.fixture(scope="module")
def pipes():
    return make_pipes()


def _rows(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 128)).astype(np.float32)


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_continuation_and_generate_match_tpucap(pipes, method):
    """Prefixes of 0-3 words (P padded to 4, primed in one step_chunk),
    then ``generate`` and the maps of ``generate_with_attention``."""
    jpipe, pipe = pipes
    x = _rows(4, seed=11)
    prefixes = ["wa wx wd", "", "wb", "wc wy"]
    got = pipe.generate_continuation(x, prefixes, method=method)
    assert got == jpipe.generate_continuation(x, prefixes, method=method)
    assert [c.startswith(p) for c, p in zip(got, prefixes)] == [True] * 4
    assert got[1] == pipe.generate(x, method=method)[1]
    caps = pipe.generate(x, method=method)
    assert caps == jpipe.generate(x, method=method) and len(set(caps)) > 1
    if method == "greedy":
        c, alphas, lengths = pipe.generate_with_attention(x)
        jc, jalphas, jlengths = jpipe.generate_with_attention(x)
        assert c == jc and lengths.tolist() == np.asarray(jlengths).tolist()
        assert alphas.shape == (4, 10, 1) and np.allclose(alphas, 1.0, atol=1e-6)
        np.testing.assert_allclose(alphas, np.asarray(jalphas), atol=1e-6)


def test_capacity_refusals_match_tpucap(pipes):
    """The pipeline's build rule and the continuation's rule on a real
    max_positions (24): the true prefix length, not the padded one."""
    jpipe, pipe = pipes
    x = _rows(2, seed=12)
    for words in (15, 9):
        prefix = " ".join(["wa"] * words)
        if words == 15:
            with pytest.raises(ValueError) as jerr:
                jpipe.generate_continuation(x, prefix)
            with pytest.raises(ValueError) as err:
                pipe.generate_continuation(x, prefix)
            assert str(err.value) == str(jerr.value) and "max_positions 24" in str(err.value)
        else:  # 9 words pad to 16, but 9 + 10 <= 24: accepted
            assert pipe.generate_continuation(x, prefix) == jpipe.generate_continuation(x, prefix)
    bad = lambda m: m.Config(  # noqa: E731
        encoder=m.encoder_config("tiny_cnn"), decoder=m.DecoderConfig(name="transformer", max_positions=34),
        decode=m.DecodeConfig(max_len=34))
    with pytest.raises(ValueError) as jerr:
        JaxPipeline(bad(jcfg), tokenizer=jpipe.tokenizer).build(init_params=False)
    with pytest.raises(ValueError) as err:
        CaptioningPipeline(bad(tcfg), tokenizer=pipe.tokenizer, device="cpu").build(init_params=False)
    assert str(err.value) == str(jerr.value)


def test_score_and_server_drive_the_transformer(pipes):
    """``score_captions`` within 1e-5 of tpucap's; the batch server's
    captions and a prefix request are ``generate``'s and
    ``generate_continuation``'s; a prefix past the capacity is refused at
    admission."""
    from tpucap_torch.serve import CaptionServer

    jpipe, pipe = pipes
    x = _rows(3, seed=13)
    caps = ["wa wx", "wb wy wc", "wd"]
    for g, w in zip(pipe.score_captions(x, caps), jpipe.score_captions(x, caps)):
        assert g["tokens"] == w["tokens"]
        np.testing.assert_allclose(g["logp"], w["logp"], atol=1e-5)
    with CaptionServer(pipe, max_batch=4, max_prefix_tokens=16) as srv:
        assert [f.result(60) for f in srv.submit_many(x)] == pipe.generate(x)
        assert srv.submit(x[0], prefix="wa").result(60) == pipe.generate_continuation(x[:1], "wa")[0]
        with pytest.raises(ValueError, match="max_positions 24"):
            srv.submit(x[0], prefix=" ".join(["wa"] * 15))


def test_decode_toolkit_drives_the_transformer():
    """Diverse search (captions exact, scores within 1e-5), must-include
    words, an ensemble with an lstm1 member and MBR over beam pools give
    tpucap's captions on the MoE model; the sampler at top_k = 1 is
    greedy."""
    jpipe, pipe = make_pipes(decode={"no_repeat_ngram_size": 0}, seed=2, tilt=2.0)
    x = _rows(4, seed=16)
    got = pipe.generate_diverse(x, num_groups=2, group_width=2)
    want = jpipe.generate_diverse(x, num_groups=2, group_width=2)
    assert [[c for c, _ in row] for row in got] == [[c for c, _ in row] for row in want]
    np.testing.assert_allclose([s for row in got for _, s in row], [s for row in want for _, s in row], atol=1e-5)
    assert pipe.generate_constrained(x, ["wy"]) == jpipe.generate_constrained(x, ["wy"])
    from test_torch_gru import make_pipes as gru_pipes

    jl, pl = gru_pipes("lstm1", seed=5, tilt=1.0)
    assert pipe.generate_ensemble(x, [pl]) == jpipe.generate_ensemble(x, [jl])
    mbr = dict(candidates="beam", n_candidates=3)
    assert pipe.generate_mbr(x, **mbr) == jpipe.generate_mbr(x, **mbr)
    greedy = pipe.generate(x, method="greedy")
    assert pipe.generate(x, method="sample", top_k=1, seed=3) == greedy and len(set(greedy)) > 1


@pytest.mark.parametrize("experts", [0, 4], ids=["dense", "moe"])
def test_sgd_step_matches_tpucap(experts):
    case = "moe2" if experts else "dense"
    jdec, jp, tdec, _ = _bridged(case, seed=11)
    rng = np.random.default_rng(12)
    feats = rng.normal(size=(6, D)).astype(np.float32)
    toks = rng.integers(3, V, size=(6, 8)).astype(np.int32)
    toks[:, 0] = START
    for i, n in enumerate(rng.integers(3, 9, size=6)):
        toks[i, n:] = 0
    sgd_step_matches(jdec, tdec, jp, feats, toks)


def test_fit_on_moe_reads_no_aux_weight():
    """tpucap's single-device fit never reads moe_aux_weight: the port's
    per-epoch losses at 0.0 and 0.5 are equal and are tpucap's, with
    scheduled sampling at a constant 1.0 (every input the model's own
    prediction: no coin to draw, so both sides mix alike). Plain SGD:
    the gradient of a router column no token chose is zero in theory (the
    top-k gates depend on the chosen logits' differences alone), and Adam's
    first steps would turn each side's rounding noise there into a move of
    the learning rate, routing later tokens apart."""
    train = dict(batch_size=2, epochs=2, learning_rate=0.5, optimizer="sgd", seed=3, scheduled_sampling=1.0,
                 ss_schedule="constant")
    feats = {k: _rows(1, seed=20 + i)[0] for i, k in enumerate(CORPUS)}
    hist = {}
    for w in (0.0, 0.5):
        jpipe, pipe = make_pipes(train={**train, "moe_aux_weight": w})
        assert pipe.config.train.moe_aux_weight == w
        hist[w] = pipe.fit(CORPUS, feats, log=None)
    want = jpipe.fit(CORPUS, feats, log=None)
    assert [h["loss"] for h in hist[0.0]] == [h["loss"] for h in hist[0.5]]
    for g, w in zip(hist[0.5], want):
        assert g["ss_eps"] == w["ss_eps"] == 1.0
        for k in ("loss", "accuracy", "tokens"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    assert hist[0.5][-1]["loss"] < hist[0.5][0]["loss"]


def test_lora_targets_of_the_moe_tree_match_tpucap():
    _, jp, _, tp = _bridged("moe2")
    got = lora_targets({"decoder": tp})
    assert got == jax_lora_targets({"decoder": jp})
    assert "['decoder']['layers'][0]['router']['kernel']" in got
    assert not any("moe_" in k for k in got)


@pytest.mark.parametrize("experts", [0, 4], ids=["dense", "moe"])
def test_bundle_round_trips(tmp_path, experts):
    """save / load / reload_params: the layers list, the (E, ...) stacks,
    pos_embedding and the config's transformer fields."""
    _, pipe = make_pipes(experts=experts, train={"moe_aux_weight": 0.25})
    pipe.save(tmp_path / "b")
    d = json.loads((tmp_path / "b" / "config.json").read_text())
    assert d["decoder"]["num_experts"] == experts and d["decoder"]["max_positions"] == 24
    assert d["train"]["moe_aux_weight"] == 0.25
    back = CaptioningPipeline.load(tmp_path / "b", device="cpu")
    assert back.config == pipe.config and isinstance(back.decoder, TransformerDecoder)
    want = params_to_numpy(pipe.params)
    got = params_to_numpy(back.params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    x = _rows(3, seed=14)
    assert back.generate(x) == pipe.generate(x)
    back.params["decoder"]["out"]["bias"].add_(1.0)
    back._params_changed()
    back.reload_params(tmp_path / "b")
    assert back.generate(x) == pipe.generate(x)


def test_bf16_greedy_captions_match_tpucap():
    """bf16 on both sides, the same bf16 features: greedy captions
    token-identical (``tests/test_torch_bf16.py``'s bound)."""
    jpipe, pipe = make_pipes(precision="bf16", seed=4)
    x = _rows(6, seed=15)
    x = np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())
    got = pipe.generate(x, method="greedy")
    assert got == jpipe.generate(x, method="greedy") and len(set(got)) > 1


# -- the CLI --------------------------------------------------------------------------


def test_cli_trains_captions_and_refuses_export(tmp_path):
    """The port's CLI alone on a fixture dataset: ``train --decoder
    transformer --num-experts 4``, then ``caption --prefix`` and
    ``caption --dump-attention`` (the restored pipeline's captions), and
    ``export`` refusing with tpucap's text."""
    from tpucap.data import generate_fixture_dataset

    cli = importlib.import_module("tpucap_torch.cli.main")
    img_dir, tokens, train, _ = generate_fixture_dataset(tmp_path / "data", n_images=4, image_size=32, seed=6)
    model = ["--encoder", "tiny_cnn", "--decoder", "transformer", "--num-experts", "4", "--hidden-dim", "16",
             "--num-heads", "2", "--mlp-dim", "32", "--max-len", "8"]
    feats, ckpt, dump = str(tmp_path / "f.npz"), str(tmp_path / "ckpt"), str(tmp_path / "att.npz")
    images = sorted(str(p) for p in Path(img_dir).glob("*.jpg"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), contextlib.redirect_stderr(io.StringIO()):
        cli.main(["extract", *model, "--images", str(img_dir), "--out", feats, "--batch-size", "4"], device="cpu")
        cli.main(["train", *model, "--tokens", tokens, "--split", train, "--features", feats,
                  "--checkpoint-dir", ckpt, "--epochs", "1", "--batch-size", "4"], device="cpu")
        args = cli.build_parser()[0].parse_args(["caption", *model, "--image", *images, "--checkpoint-dir", ckpt])
        pipe = cli._restore_pipeline(args, torch.device("cpu"))
        word = next(w for w in pipe.tokenizer.word_index if w not in ("startseq", "endseq"))
        start = len(printed.getvalue().splitlines())
        cli.main(["caption", *model, "--image", *images, "--checkpoint-dir", ckpt, "--method", "greedy",
                  "--prefix", word], device="cpu")
        prefixed = printed.getvalue().splitlines()[start:]
        start = len(printed.getvalue().splitlines())
        cli.main(["caption", *model, "--image", *images, "--checkpoint-dir", ckpt, "--method", "greedy",
                  "--dump-attention", dump], device="cpu")
        dumped = printed.getvalue().splitlines()[start:]
        with pytest.raises(ValueError) as err:
            cli.main(["export", *model, "--checkpoint-dir", ckpt, "--out", str(tmp_path / "t.h5")], device="cpu")
    assert str(err.value) == ("no Keras topology for TransformerDecoder; have ['AttentionDecoder', "
                              "'GruMergeDecoder', 'InjectDecoder', 'MergeDecoder']")
    dec = pipe.decoder
    assert isinstance(dec, TransformerDecoder)
    assert (dec.num_experts, dec.moe_top_k, dec.num_heads, dec.mlp_dim, dec.num_layers, dec.max_positions) == (
        4, 2, 2, 32, 2, 40)
    x = pipe.extract_features(images)
    assert prefixed == [f"{p}\t{c}" for p, c in zip(images, pipe.generate_continuation(x, word, method="greedy"))]
    caps, alphas, lengths = pipe.generate_with_attention(x, method="greedy")
    assert dumped[: len(images)] == [f"{p}\t{c}" for p, c in zip(images, caps)]
    npz = np.load(dump)
    np.testing.assert_array_equal(npz["alphas"], alphas)
    assert npz["alphas"].shape == (len(images), 8, 1) and list(npz["captions"]) == caps
