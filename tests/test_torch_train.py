"""tpucap_torch's decoder training against tpucap's, on the CPU, same
weights (bridged), small sizes: lstm1 and lstm2 with embed 16, hidden 32,
vocab 50, 24-d features, batch 6, T = 8.

Text and batches (``pad_sequences``, ``texts_to_sequences``,
``build_training_tokens`` with its endseq-kept truncation,
``batch_iterator``'s shuffled order) are identical. Dropout draws its mask
from a ``torch.Generator``, whose bits cannot be jax's: its keep rate and
its scaling are checked, not its mask; every comparison below has dropout
off.

Tolerances, f32: the loss within 1e-6 relative, every gradient within
1e-5 of its tensor's scale (max |ref|; measured at most 4e-7: sums in
another order). Adam's first step is a sign function (lr g / (|g| + eps)),
so an entry whose gradient is near zero may move by +-lr on either side
for a last-bit difference: updated params are compared (within 1e-6)
where |g| is above 1e-3 of its tensor's scale and above 1e-7, a hundred
times the gradient comparison's noise, and the embedding rows that no
input token uses (gradient exactly zero on both sides) must stay exactly
put on both sides. A second step runs from tpucap's state after the first
(params and Adam's moments carried by ``convert.train_state_from_jax``)
under the same rules, except that those rows now move by the carried
moments alone, compared within 1e-6.

Mixed bf16 (``compute_dtype=bfloat16``, f32 masters): the loss within
1e-3 relative (measured 1.2e-7), each gradient within 5 % of its tensor's
scale (measured 1.3 %): both sides run the forward and backward in bf16
but round at other places (torch's bf16 matmul backward against XLA's).

``fit`` against tpucap's ``fit`` on a seeded corpus, dropout off: the
per-epoch loss, accuracy and perplexity within 1e-5 relative; with
dropout on, the port's loss still descends.

The inject and soft-attention decoders (CONFIG_4, 3x3 grids of 24-d
features): the loss with ``attention_reg`` 0 and 1.0, its
``attention_reg`` metric and the gradients, and ``fit``'s per-epoch
losses and reg metric, under the same bounds (the reg within 1e-6
relative); a merge decoder with ``attention_reg`` > 0 warns, as tpucap's
does, and trains without it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpucap import config as jcfg
from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap.models.decoders.lstm import MergeDecoder as JaxDecoder
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.text import Tokenizer as JaxTokenizer
from tpucap.text.padding import pad_sequences as jax_pad_sequences
from tpucap.train import loop as jloop
from tpucap.train import loss as jloss
from tpucap.train import sequences as jseq
from tpucap_torch import config as tcfg
from tpucap_torch.convert import params_from_jax, params_to_numpy, train_state_from_jax
from tpucap_torch.core import tree_leaves, tree_map
from tpucap_torch.models.decoders import build_decoder
from tpucap_torch.models.decoders.lstm import MergeDecoder
from tpucap_torch.models.layers import dropout
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer
from tpucap_torch.text.padding import pad_sequences
from tpucap_torch.train import (
    TrainState,
    batch_iterator,
    build_optimizer,
    build_training_batch,
    build_training_tokens,
    caption_loss_sums,
    cast_floats,
    loss_from_sums,
    make_eval_step,
    make_train_step,
    masked_cross_entropy_sums,
)
from tpucap_torch.train.loop import grads_of, trainable

from ports_init import build_on_ports_init, jit_init

torch.set_num_threads(2)

V, FD, B, T = 50, 24, 6, 8
DIMS = dict(vocab_size=V, feature_dim=FD, embed_dim=16, hidden_dim=32)
CAPTIONS = {
    f"img{i}": [
        "startseq " + " ".join(f"w{(i * 7 + j * 3 + k) % 13}" for k in range(3 + (i + j) % 6)) + " endseq"
        for j in range(2)
    ]
    for i in range(7)
}


def _decoders(layers, rate=0.0):
    return (
        JaxDecoder(num_layers=layers, dropout_rate=rate, **DIMS),
        MergeDecoder(num_layers=layers, dropout_rate=rate, **DIMS),
    )


def _batch(seed):
    """Features (B, FD) and tokens (B, T + 1): startseq, random ids, post
    padding of varied length, and one all-pad row."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, FD)).astype(np.float32)
    toks = rng.integers(2, V, size=(B, T + 1)).astype(np.int32)
    toks[:, 0] = 1
    for i, n in enumerate(rng.integers(3, T + 1, size=B)):
        toks[i, n:] = 0
    toks[-1, 1:] = 0
    return feats, toks


def _init(jdec, seed):
    return jax.tree.map(np.asarray, jit_init(jdec, jax.random.key(seed)))


def _t(feats, toks):
    return torch.from_numpy(feats), torch.from_numpy(toks).long()


def _close_to_scale(got, want, share, what=""):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0, atol=share * np.abs(w).max(), err_msg=what)


def _check_update(before, after_t, after_j, grads, tgrads, toks, first):
    """Updated params (tpucap layout, numpy) under the Adam rule of the
    module docstring: entries with a clear gradient alike; embedding rows
    that no input token uses (zero gradient on both sides) exactly put on
    the first step, moved by the carried moments alone after it."""
    for pt, pj, g in zip(*(jax.tree.leaves(x) for x in (after_t, after_j, grads))):
        g, pj = np.asarray(g), np.asarray(pj)
        big = np.abs(g) > max(1e-3 * np.abs(g).max(), 1e-7)
        assert big.any()
        np.testing.assert_allclose(pt[big], pj[big], rtol=0, atol=1e-6)
    unused = np.setdiff1d(np.arange(V), toks[:, :-1])
    assert len(unused)
    assert not np.asarray(grads["embedding"]["table"])[unused].any()
    assert not tgrads["embedding"]["table"][unused].any()
    rows = [np.asarray(x["embedding"]["table"])[unused] for x in (before, after_t, after_j)]
    if first:
        np.testing.assert_array_equal(rows[1], rows[0])
        np.testing.assert_array_equal(rows[2], rows[0])
    else:
        np.testing.assert_allclose(rows[1], rows[2], rtol=0, atol=1e-6)


# -- text and batches --------------------------------------------------------


@pytest.mark.parametrize("padding", ["pre", "post"])
@pytest.mark.parametrize("truncating", ["pre", "post"])
@pytest.mark.parametrize("maxlen", [None, 3, 7])
def test_pad_sequences_matches_tpucap(padding, truncating, maxlen):
    seqs = [[1, 2, 3, 4, 5], [], [7], [8, 9, 10]]
    np.testing.assert_array_equal(
        pad_sequences(seqs, maxlen=maxlen, padding=padding, truncating=truncating),
        jax_pad_sequences(seqs, maxlen=maxlen, padding=padding, truncating=truncating),
    )


@pytest.mark.parametrize("num_words,oov", [(None, None), (8, None), (8, "<unk>")])
def test_texts_to_sequences_matches_tpucap(num_words, oov):
    texts = [c for caps in CAPTIONS.values() for c in caps] + ["startseq never seen w3 endseq"]
    ours, theirs = Tokenizer(num_words=num_words, oov_token=oov), JaxTokenizer(num_words=num_words, oov_token=oov)
    ours.fit_on_texts(texts[:-1])
    theirs.fit_on_texts(texts[:-1])
    assert ours.texts_to_sequences(texts) == theirs.texts_to_sequences(texts)


@pytest.mark.parametrize("max_len", [4, 20])
def test_build_training_tokens_and_batch_match_tpucap(max_len):
    """max_len 4 truncates most captions, keeping endseq as the last token."""
    tok, jtok = Tokenizer(), JaxTokenizer()
    texts = [c for caps in CAPTIONS.values() for c in caps] + ["startseq"]
    tok.fit_on_texts(texts)
    jtok.fit_on_texts(texts)
    desc = {**CAPTIONS, "short": ["startseq"]}
    ids, toks = build_training_tokens(tok, desc, max_len)
    jids, jtoks = jseq.build_training_tokens(jtok, desc, max_len)
    assert ids == jids and "short" not in ids
    np.testing.assert_array_equal(toks, jtoks)
    end = tok.word_index["endseq"]
    if max_len == 4:
        assert (toks[:, -1] == end).sum() > 0
    feats = {k: np.full(3, i, np.float32) for i, k in enumerate(desc)}
    f, t = build_training_batch(tok, desc, feats, max_len)
    jf, jt = jseq.build_training_batch(jtok, desc, feats, max_len)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(t, jt)


def test_batch_iterator_draws_tpucap_order():
    arrays = (np.arange(23), np.arange(23) * 10)
    got = list(batch_iterator(arrays, 5, rng=np.random.default_rng(3)))
    want = list(jseq.batch_iterator(arrays, 5, rng=np.random.default_rng(3)))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert sum(len(b[0]) for b in batch_iterator(arrays, 5, drop_remainder=False)) == 23


# -- dropout and the teacher-forced decoder ----------------------------------


def test_dropout_keep_rate_and_scaling():
    x = torch.ones(200_000) * 3.0
    gen = torch.Generator().manual_seed(0)
    y = dropout(gen, x, 0.3, False)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 3.0 / 0.7))
    assert dropout(gen, x, 0.3, True) is x and dropout(gen, x, 0.0, False) is x
    assert not torch.equal(dropout(gen, x, 0.3, False), y)  # the generator moves on


@pytest.mark.parametrize("layers", [1, 2])
def test_forward_train_matches_tpucap(layers):
    jdec, tdec = _decoders(layers, rate=0.5)
    jp = _init(jdec, layers)
    feats, toks = _batch(10 + layers)
    want = jdec.forward_train(jp, jnp.asarray(feats), jnp.asarray(toks[:, :-1]))
    got = tdec.forward_train(params_from_jax(jp), *_t(feats, toks[:, :-1]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5 * np.abs(want).max())
    # Dropout on: the feature and embedding masks move the logits.
    gen = torch.Generator().manual_seed(1)
    on = tdec.forward_train(params_from_jax(jp), *_t(feats, toks[:, :-1]), rng=gen, deterministic=False)
    assert on.shape == got.shape and not torch.allclose(on, got)


# -- the loss -----------------------------------------------------------------


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_masked_cross_entropy_sums_matches_tpucap(label_smoothing):
    rng = np.random.default_rng(30)
    logits = rng.normal(size=(B, T, V)).astype(np.float32) * 3
    _, toks = _batch(31)
    targets = toks[:, 1:]
    want = jloss.masked_cross_entropy_sums(
        jnp.asarray(logits), jnp.asarray(targets), label_smoothing=label_smoothing
    )
    got = masked_cross_entropy_sums(
        torch.from_numpy(logits), torch.from_numpy(targets).long(), label_smoothing=label_smoothing
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)


def test_caption_loss_sums_and_loss_from_sums_match_tpucap():
    jdec, tdec = _decoders(1)
    jp = _init(jdec, 3)
    feats, toks = _batch(32)
    want = jloss.caption_loss_sums(jdec, jp, jnp.asarray(feats), jnp.asarray(toks), label_smoothing=0.1)
    got = caption_loss_sums(tdec, params_from_jax(jp), *_t(feats, toks), label_smoothing=0.1)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)
    assert got["batch"].item() == B - 1  # the all-pad row counts for nothing
    jl, jm = jloss.loss_from_sums(want)
    tl, tm = loss_from_sums(got)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-6, err_msg=k)


def test_cast_floats_casts_floats_only():
    tree = {"a": torch.ones(2), "b": [torch.arange(3), torch.zeros(1, dtype=torch.float64)]}
    out = cast_floats(tree, torch.bfloat16)
    assert out["a"].dtype == out["b"][1].dtype == torch.bfloat16
    assert out["b"][0].dtype == torch.int64
    assert cast_floats(tree, None) is tree


# -- one step ------------------------------------------------------------------


def _loss_and_grads(jdec, tdec, jp, feats, toks, jdt=None, tdt=None):
    (jl, _), jg = jax.value_and_grad(
        lambda p: jloss.caption_loss(jdec, p, jnp.asarray(feats), jnp.asarray(toks), compute_dtype=jdt),
        has_aux=True,
    )(jax.tree.map(jnp.asarray, jp))
    tp = trainable(params_from_jax(jp))
    tl, _ = loss_from_sums(caption_loss_sums(tdec, tp, *_t(feats, toks), compute_dtype=tdt))
    return float(jl), jg, tl.item(), params_to_numpy(grads_of(tl, tp))


@pytest.mark.parametrize("layers", [1, 2])
def test_train_step_matches_tpucap_over_two_steps(layers):
    jdec, tdec = _decoders(layers)
    jopt, topt = jloop.build_optimizer(jcfg.TrainConfig()), build_optimizer(tcfg.TrainConfig())
    jstep = jloop.make_train_step(jdec, jopt, deterministic=True)
    tstep = make_train_step(tdec, topt, deterministic=True)
    jstate = jloop.TrainState.create(jax.tree.map(jnp.asarray, _init(jdec, 20 + layers)), jopt, jax.random.key(0))
    tstate = TrainState.create(params_from_jax(jstate.params), topt, None)
    for step in range(2):
        feats, toks = _batch(40 + step)
        before = jax.tree.map(np.asarray, jstate.params)
        jl, jg, tl, tg = _loss_and_grads(jdec, tdec, before, feats, toks)
        np.testing.assert_allclose(tl, jl, rtol=1e-6)
        _close_to_scale(tg, jg, 1e-5, "grads")
        jstate, jm = jstep(jstate, jnp.asarray(feats), jnp.asarray(toks))
        tstate, tm = tstep(tstate, *_t(feats, toks))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-6)
        assert tstate.step == int(jstate.step) == step + 1
        _check_update(
            before, params_to_numpy(tstate.params), jax.tree.map(np.asarray, jstate.params), jg, tg, toks,
            step == 0,
        )
        carried = train_state_from_jax(jstate)
        _close_to_scale(params_to_numpy(carried.opt_state["mu"]), params_to_numpy(tstate.opt_state["mu"]), 1e-5, "mu")
        assert int(carried.opt_state["count"]) == int(tstate.opt_state["count"]) == step + 1
        tstate = carried


@pytest.mark.parametrize("layers", [1, 2])
def test_bf16_train_step_within_bounds(layers):
    jdec, tdec = _decoders(layers)
    jp = _init(jdec, 50 + layers)
    feats, toks = _batch(51)
    jl, jg, tl, tg = _loss_and_grads(jdec, tdec, jp, feats, toks, jnp.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    _close_to_scale(tg, jg, 0.05, "bf16 grads")
    for g in tree_leaves(tg):
        assert g.dtype == np.float32  # through the cast: f32 master gradients
    # The step itself runs and keeps f32 masters.
    topt = build_optimizer(tcfg.TrainConfig())
    state, m = make_train_step(tdec, topt, deterministic=True, compute_dtype=torch.bfloat16)(
        TrainState.create(params_from_jax(jp), topt, None), *_t(feats, toks)
    )
    np.testing.assert_allclose(m["loss"].item(), jl, rtol=1e-3)
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.params))


@pytest.mark.parametrize(
    "kind", [dict(), dict(optimizer="adamw", weight_decay=0.01), dict(grad_clip_norm=0.05)]
)
def test_optimizer_updates_match_optax(kind):
    rng = np.random.default_rng(60)
    params = {"a": rng.normal(size=(5, 4)).astype(np.float32), "b": [rng.normal(size=3).astype(np.float32)]}
    jopt = jloop.build_optimizer(jcfg.TrainConfig(**kind))
    topt = build_optimizer(tcfg.TrainConfig(**kind))
    jstate, tstate = jopt.init(params), topt.init(params_from_jax(params))
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_jax(params)
    for i in range(3):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32) * 0.1, params)
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        tu, tstate = topt.update(params_from_jax(g), tstate, tp)
        _close_to_scale(params_to_numpy(tu), ju, 1e-6, f"updates {i}")
        jp, tp = optax.apply_updates(jp, ju), tree_map(torch.add, tp, tu)


def test_eval_step_matches_tpucap():
    jdec, tdec = _decoders(2)
    jp = _init(jdec, 70)
    feats, toks = _batch(71)
    want = jloop.make_eval_step(jdec, label_smoothing=0.1)(jp, jnp.asarray(feats), jnp.asarray(toks))
    got = make_eval_step(tdec, label_smoothing=0.1)(params_from_jax(jp), *_t(feats, toks))
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)


def test_unported_knobs_raise():
    tdec = _decoders(1)[1]
    opt = build_optimizer(tcfg.TrainConfig())
    for kw in (dict(compute_dtype=torch.float16), dict(compute_dtype=torch.float64)):
        with pytest.raises(NotImplementedError):
            make_train_step(tdec, opt, **kw)
    # Scheduled sampling and multi-step dispatch build steps
    # (tests/test_torch_scheduled.py holds them to tpucap's).
    for kw in (dict(scheduled_sampling=True), dict(multi_steps=2)):
        assert callable(make_train_step(tdec, opt, **kw))
    # tpucap's other optimizers build and make a step (tests/test_torch_optim.py
    # holds their updates to tpucap's).
    for name in ("sgd", "rmsprop", "adagrad"):
        assert callable(make_train_step(tdec, build_optimizer(tcfg.TrainConfig(optimizer=name))))
    with pytest.raises(ValueError):
        build_optimizer(tcfg.TrainConfig(optimizer="lion"))


def test_train_config_defaults_match_tpucap():
    ours = {f.name: f.default for f in dataclasses.fields(tcfg.TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jcfg.TrainConfig)}
    assert set(ours) <= set(theirs)
    assert {k: theirs[k] for k in ours} == ours


# -- fit ------------------------------------------------------------------------


def _fit_pipelines(rate, epochs=3, batch_size=4):
    train = dict(batch_size=batch_size, learning_rate=1e-2, seed=3)
    dec = dict(embed_dim=16, hidden_dim=32, dropout_rate=rate)
    jpipe = JaxPipeline(
        jcfg.Config(
            encoder=jcfg.encoder_config("vit_tiny"), decoder=jcfg.DecoderConfig(**dec),
            decode=jcfg.DecodeConfig(max_len=8), train=jcfg.TrainConfig(**train), precision="f32",
        )
    )
    jpipe.fit_tokenizer(CAPTIONS)
    build_on_ports_init(jpipe, 4)
    pipe = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.encoder_config("vit_tiny"), decoder=tcfg.DecoderConfig(**dec),
            decode=tcfg.DecodeConfig(max_len=8), train=tcfg.TrainConfig(**train), precision="f32",
        ),
        tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()),
        device="cpu",
    )
    pipe.build(init_params=False)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    rng = np.random.default_rng(80)
    feats = {k: rng.normal(size=64).astype(np.float32) for k in CAPTIONS}
    return jpipe, pipe, feats


def test_fit_matches_tpucap_per_epoch():
    jpipe, pipe, feats = _fit_pipelines(0.0)
    want = jpipe.fit(CAPTIONS, feats, epochs=3, log=None)
    got = pipe.fit(CAPTIONS, feats, epochs=3, log=None)
    assert [sorted(e) for e in got] == [sorted(e) for e in want]
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"]
        for k in ("loss", "accuracy", "perplexity", "tokens"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    assert got[-1]["loss"] < got[0]["loss"]
    _close_to_scale(params_to_numpy(pipe.params["decoder"]), jpipe.params["decoder"], 1e-3, "params after fit")


def test_fit_with_dropout_descends_and_refuses_unported_dials():
    _, pipe, feats = _fit_pipelines(0.5)
    before = params_to_numpy(pipe.params["decoder"])
    hist = pipe.fit(CAPTIONS, feats, epochs=4, log=None)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert not np.array_equal(params_to_numpy(pipe.params["decoder"])["out"]["kernel"], before["out"]["kernel"])
    for kw in (
        dict(parallelism="dp"), dict(data_parallel=True), dict(parallelism="fsdp"),
        dict(sharded_checkpoints=True),
    ):
        with pytest.raises(NotImplementedError):
            pipe.fit(CAPTIONS, feats, epochs=1, log=None, **kw)
    assert pipe.fit(CAPTIONS, feats, epochs=1, parallelism="none", log=None)[0]["epoch"] == 0


# -- inject and attention decoders, attention_reg --------------------------------

GRID = 9  # a 3 x 3 spatial grid of FD-d features


def _grid_batch(name, seed):
    feats, toks = _batch(seed)
    if name == "attention":
        feats = np.random.default_rng(seed).normal(size=(B, GRID, FD)).astype(np.float32)
    return feats, toks


@pytest.mark.parametrize("name,reg", [("inject", 0.0), ("attention", 0.0), ("attention", 1.0)])
def test_loss_and_grads_of_inject_and_attention_match_tpucap(name, reg):
    jdec, tdec = jax_build_decoder(name, **DIMS, dropout_rate=0.0), build_decoder(name, **DIMS, dropout_rate=0.0)
    jp = _init(jdec, 60)
    feats, toks = _grid_batch(name, 61)
    jf, jt = jnp.asarray(feats), jnp.asarray(toks)
    sums = jloss.caption_loss_sums(jdec, jp, jf, jt, attention_reg=reg)
    got = caption_loss_sums(tdec, params_from_jax(jp), *_t(feats, toks), attention_reg=reg)
    for k in sums:
        np.testing.assert_allclose(got[k].item(), float(sums[k]), rtol=1e-6, err_msg=k)
    jl, jm = jloss.loss_from_sums(sums, attention_reg=reg)
    tl, tm = loss_from_sums(got, attention_reg=reg)
    assert sorted(tm) == sorted(jm) and ("attention_reg" in tm) == (reg > 0)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-6, err_msg=k)
    if reg:
        assert got["reg_sum"].item() > 0 and tl.item() > tm["perplexity"].log().item()
    (_, _), jg = jax.value_and_grad(
        lambda p: jloss.caption_loss(jdec, p, jf, jt, attention_reg=reg), has_aux=True
    )(jax.tree.map(jnp.asarray, jp))
    tp = trainable(params_from_jax(jp))
    loss, _ = loss_from_sums(caption_loss_sums(tdec, tp, *_t(feats, toks), attention_reg=reg), attention_reg=reg)
    tg = params_to_numpy(grads_of(loss, tp))
    if name == "attention":
        # The score bias shifts every logit of the softmax alike: its
        # gradient is zero in theory, rounding noise on both sides.
        scale = max(np.abs(np.asarray(g)).max() for g in jax.tree.leaves(jg))
        for g in (tg["att_score"].pop("bias"), jg["att_score"].pop("bias")):
            assert np.abs(np.asarray(g)).max() < 1e-6 * scale
    _close_to_scale(tg, jg, 1e-5, "grads")


def test_attention_reg_on_a_merge_decoder_warns_and_does_nothing():
    jdec, tdec = _decoders(1)
    topt = build_optimizer(tcfg.TrainConfig())
    with pytest.warns(UserWarning, match="no attention maps"):
        jloop.make_train_step(jdec, jloop.build_optimizer(jcfg.TrainConfig()), attention_reg=0.5)
    with pytest.warns(UserWarning, match="no attention maps"):
        step = make_train_step(tdec, topt, deterministic=True, attention_reg=0.5)
    jp = _init(jdec, 62)
    feats, toks = _batch(63)
    _, m = step(TrainState.create(params_from_jax(jp), topt, None), *_t(feats, toks))
    want = jloss.caption_loss(jdec, jp, jnp.asarray(feats), jnp.asarray(toks))[0]
    np.testing.assert_allclose(m["loss"].item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(m["attention_reg"].item(), 0.0)


def _grid_pipelines(name, reg, epochs=3):
    train = dict(batch_size=4, learning_rate=1e-2, seed=3, attention_reg=reg)
    dec = dict(name=name, embed_dim=16, hidden_dim=32, dropout_rate=0.0)
    features = "spatial" if name == "attention" else "pooled"
    jpipe = JaxPipeline(
        jcfg.Config(
            encoder=jcfg.encoder_config("vit_tiny", features), decoder=jcfg.DecoderConfig(**dec),
            decode=jcfg.DecodeConfig(max_len=8), train=jcfg.TrainConfig(**train), precision="f32",
        )
    )
    jpipe.fit_tokenizer(CAPTIONS)
    build_on_ports_init(jpipe, 5)
    pipe = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.encoder_config("vit_tiny", features), decoder=tcfg.DecoderConfig(**dec),
            decode=tcfg.DecodeConfig(max_len=8), train=tcfg.TrainConfig(**train), precision="f32",
        ),
        tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()),
        device="cpu",
    )
    pipe.build(init_params=False)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    rng = np.random.default_rng(81)
    shape = (GRID, 64) if name == "attention" else (64,)
    feats = {k: rng.normal(size=shape).astype(np.float32) for k in CAPTIONS}
    return jpipe, pipe, feats


@pytest.mark.parametrize("name,reg", [("inject", 0.0), ("attention", 0.0), ("attention", 1.0)])
def test_fit_of_inject_and_attention_matches_tpucap_per_epoch(name, reg):
    jpipe, pipe, feats = _grid_pipelines(name, reg)
    val = (dict(list(CAPTIONS.items())[:3]), feats)
    want = jpipe.fit(CAPTIONS, feats, epochs=3, val_data=val, log=None)
    got = pipe.fit(CAPTIONS, feats, epochs=3, val_data=val, log=None)
    assert [sorted(e) for e in got] == [sorted(e) for e in want]
    assert ("attention_reg" in got[0]) == (reg > 0)
    for g, w in zip(got, want):
        for k in ("loss", "accuracy", "perplexity", "val_loss", "val_accuracy", "attention_reg"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    # The cross-entropy descends; with fewer live steps than grid cells the
    # coverage term cannot reach 0 and grows as the maps sharpen.
    assert got[-1]["perplexity"] < got[0]["perplexity"]
