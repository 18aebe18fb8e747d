"""tpucap_torch's joint encoder + decoder training against tpucap's, on the
CPU, same weights (the port's seeded init carried to tpucap by
``convert.params_to_numpy``, then back): ``vit_tiny`` (32 px, 2 x 64, 4 heads) and
lstm1 (embed 16, hidden 32), vocab 50, batch 4, T = 8. The port runs
``attention_impl="flash"``: K5's ``FlashAttentionQKV``, whose forward and
two backward kernels take their plain versions on the CPU. tpucap runs
``"xla"``: its stock flash kernel lowers on a TPU only.

Tolerances are those of ``tests/test_torch_train.py``, for the same
reasons, except the gradients': f32 loss within 1e-6 relative, each
gradient within 1e-4 of its tensor's scale (measured at most 3e-6 in a
process of its own; up to 2.1e-5, on a layer norm's bias, in one of five
runs of these files under pytest-xdist: that gradient sums over every
token with heavy cancellation, and the CPU kernels the process picks set
its summation order), updated params within 1e-6 where
|g| is above 1e-3 of its tensor's scale and 1e-7 (Adam's first step is a
sign function), and the embedding rows that no input token uses, whose
gradient is exactly zero on both sides, exactly put on the first step and
moved by the carried moments alone on the second; a second step from
tpucap's carried state (params and Adam's moments). (The key projection's
bias has an exact gradient of zero, softmax ignoring a shift shared by a
row's scores: each side's value there is rounding noise, sometimes
exactly 0 on one side only, and it falls under the |g| rule, not the zero
rule.) ``encoder_lr_scale`` scales the encoder's updates after
Adam; ``freeze_encoder`` leaves the encoder exactly where it was and the
decoder's update equal to ``make_train_step``'s on the extracted
features. Mixed bf16: the loss within 1e-3 relative (measured 1.1e-4),
each gradient within 15 % of its tensor's scale (measured 13.5 % on the
qkv bias, whose key part is the rounding noise above, and at most 9.9 %
elsewhere): bf16 rounds at other places in the two frameworks, tpucap's
xla attention takes its scores in bf16 where K5 keeps them in f32, and
the differences compound backward through two transformer layers and the
decoder. ``fit_finetune`` reproduces tpucap's per-epoch losses within
1e-5 relative (its params are not compared after several steps: the
noise-level entries above move by +-lr a step on either side).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpucap import config as jcfg
from tpucap.models.decoders.lstm import MergeDecoder as JaxDecoder
from tpucap.models.encoders import vit_tiny as jax_vit_tiny
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap.train import finetune as jft
from tpucap.train import loop as jloop
from tpucap.train import loss as jloss
from tpucap_torch import config as tcfg
from tpucap_torch import ops
from tpucap_torch.convert import (
    adam_state_from_jax,
    params_from_jax,
    params_to_numpy,
    train_state_from_jax,
)
from tpucap_torch.core import tree_leaves
from tpucap_torch.models.decoders.lstm import MergeDecoder
from tpucap_torch.models.encoders import vit_tiny
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer
from tpucap_torch.train import (
    TrainState,
    build_optimizer,
    caption_loss_sums,
    cast_floats,
    encode_for_decoder,
    encoder_learning_rate_optimizer,
    loss_from_sums,
    make_joint_train_step,
    make_train_step,
)
from tpucap_torch.train.loop import grads_of, trainable

torch.set_num_threads(2)

V, B, T = 50, 4, 8
DEC = dict(vocab_size=V, feature_dim=64, embed_dim=16, hidden_dim=32, dropout_rate=0.0)
FLASH = dataclasses.replace(vit_tiny(), attention_impl="flash")


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, size=(B, 32, 32, 3)).astype(np.float32)
    toks = rng.integers(2, V, size=(B, T + 1)).astype(np.int32)
    toks[:, 0] = 1
    for i, n in enumerate(rng.integers(3, T + 1, size=B)):
        toks[i, n:] = 0
    return images, toks


def _params(seed):
    """The port's seeded init in tpucap's layout (numpy leaves): torch's
    init is quick where tpucap's eager one compiles op by op."""
    gen = torch.Generator().manual_seed(seed)
    return params_to_numpy({"encoder": vit_tiny().init(gen), "decoder": MergeDecoder(**DEC).init(gen)})


def _t(images, toks):
    return torch.from_numpy(images), torch.from_numpy(toks).long()


def _close_to_scale(got, want, share, what=""):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0, atol=share * np.abs(w).max(), err_msg=what)


_VALUE_AND_GRAD = {}


def _jax_value_and_grad(jdt):
    """tpucap's joint loss and its gradients, one jit a compute dtype."""
    if jdt not in _VALUE_AND_GRAD:
        jenc, jdec = jax_vit_tiny(), JaxDecoder(**DEC)

        def jfn(p, images, toks):
            feats = jft.encode_for_decoder(
                jenc, jloss.cast_floats(p["encoder"], jdt), jloss.cast_floats(images, jdt)
            )
            return jloss.caption_loss(jdec, p["decoder"], feats, toks, compute_dtype=jdt)[0]

        _VALUE_AND_GRAD[jdt] = jax.jit(jax.value_and_grad(jfn))
    return _VALUE_AND_GRAD[jdt]


def _loss_and_grads(jp, images, toks, jdt=None, tdt=None):
    jl, jg = _jax_value_and_grad(jdt)(jax.tree.map(jnp.asarray, jp), jnp.asarray(images), jnp.asarray(toks))
    tp = trainable(params_from_jax(jp))
    x, tk = _t(images, toks)
    feats = encode_for_decoder(FLASH, cast_floats(tp["encoder"], tdt), cast_floats(x, tdt))
    tl, _ = loss_from_sums(caption_loss_sums(MergeDecoder(**DEC), tp["decoder"], feats, tk, compute_dtype=tdt))
    return float(jl), jg, tl.item(), params_to_numpy(grads_of(tl, tp))


def _optimizers(scale, freeze):
    jopt, topt = jloop.build_optimizer(jcfg.TrainConfig()), build_optimizer(tcfg.TrainConfig())
    if scale != 1.0 and not freeze:
        jopt = jft.encoder_learning_rate_optimizer(jopt, encoder_lr_scale=scale)
        topt = encoder_learning_rate_optimizer(topt, encoder_lr_scale=scale)
    return jopt, topt


@pytest.mark.parametrize("scale,freeze", [(0.1, False), (1.0, False), (1.0, True)])
def test_joint_step_matches_tpucap_over_two_steps(scale, freeze):
    jopt, topt = _optimizers(scale, freeze)
    jstep = jft.make_joint_train_step(jax_vit_tiny(), JaxDecoder(**DEC), jopt, deterministic=True, freeze_encoder=freeze)
    tstep = make_joint_train_step(FLASH, MergeDecoder(**DEC), topt, deterministic=True, freeze_encoder=freeze)
    jstate = jloop.TrainState.create(jax.tree.map(jnp.asarray, _params(3)), jopt, jax.random.key(0))
    tstate = TrainState.create(params_from_jax(jstate.params), topt, None)
    for step in range(2):
        images, toks = _batch(10 + step)
        before = jax.tree.map(np.asarray, jstate.params)
        jl, jg, tl, tg = _loss_and_grads(before, images, toks)
        np.testing.assert_allclose(tl, jl, rtol=1e-6)
        _close_to_scale(tg, jg, 1e-4, "grads")
        ops.reset_launch_counts()
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(toks))
        tstate, tm = tstep(tstate, *_t(images, toks))
        assert all(n == 0 for n in ops.launch_counts().values())  # CPU: plain versions
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-6)
        after_t, after_j = params_to_numpy(tstate.params), jax.tree.map(np.asarray, jstate.params)
        if freeze:
            for a, b, c in zip(*(jax.tree.leaves(x["encoder"]) for x in (before, after_t, after_j))):
                np.testing.assert_array_equal(b, a)
                np.testing.assert_array_equal(c, a)
        for p0, pt, pj, g in zip(*(jax.tree.leaves(x) for x in (before, after_t, after_j, jg))):
            g = np.asarray(g)
            big = np.abs(g) > max(1e-3 * np.abs(g).max(), 1e-7)
            np.testing.assert_allclose(pt[big], pj[big], rtol=0, atol=1e-6)
        unused = np.setdiff1d(np.arange(V), toks[:, :-1])
        rows = [x["decoder"]["embedding"]["table"][unused] for x in (before, after_t, after_j)]
        assert len(unused) and not np.asarray(jg["decoder"]["embedding"]["table"])[unused].any()
        assert not tg["decoder"]["embedding"]["table"][unused].any()
        if step == 0:  # zero gradient and zero moments: exactly put
            np.testing.assert_array_equal(rows[1], rows[0])
            np.testing.assert_array_equal(np.asarray(rows[2]), rows[0])
        else:  # moved by the carried moments alone
            np.testing.assert_allclose(rows[1], np.asarray(rows[2]), rtol=0, atol=1e-6)
        if not freeze:
            # The encoder moved by scale x Adam's step (about lr where |g| is large).
            moved = np.abs(after_t["encoder"]["blocks"][0]["qkv"]["kernel"] - before["encoder"]["blocks"][0]["qkv"]["kernel"])
            assert 0.5e-3 * scale < moved.max() <= 1.05e-3 * scale * (2 if step else 1)
        tstate = train_state_from_jax(jstate)


def test_frozen_joint_step_updates_the_decoder_as_the_feature_step_does():
    p = params_from_jax(_params(5))
    images, toks = _batch(12)
    opt = build_optimizer(tcfg.TrainConfig())
    joint, jm = make_joint_train_step(FLASH, MergeDecoder(**DEC), opt, deterministic=True, freeze_encoder=True)(
        TrainState.create(p, opt, None), *_t(images, toks)
    )
    with torch.no_grad():
        feats = encode_for_decoder(FLASH, p["encoder"], torch.from_numpy(images))
    alone, m = make_train_step(MergeDecoder(**DEC), opt, deterministic=True)(
        TrainState.create(p["decoder"], opt, None), feats, torch.from_numpy(toks).long()
    )
    assert jm["loss"].item() == m["loss"].item()
    for a, b in zip(tree_leaves(joint.params["decoder"]), tree_leaves(alone.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(joint.params["encoder"]), tree_leaves(p["encoder"])):
        assert torch.equal(a, b)


def test_bf16_joint_step_within_bounds():
    jp = _params(7)
    images, toks = _batch(13)
    jl, jg, tl, tg = _loss_and_grads(jp, images, toks, jnp.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    _close_to_scale(tg, jg, 0.15, "bf16 grads")
    opt = build_optimizer(tcfg.TrainConfig())
    state, m = make_joint_train_step(FLASH, MergeDecoder(**DEC), opt, deterministic=True, compute_dtype=torch.bfloat16)(
        TrainState.create(params_from_jax(jp), opt, None), *_t(images, toks)
    )
    np.testing.assert_allclose(m["loss"].item(), jl, rtol=1e-3)
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.params))


def test_encoder_learning_rate_optimizer_scales_updates_after_adam():
    g = {"encoder": {"w": torch.tensor([1e-3, -2.0])}, "decoder": {"w": torch.tensor([3.0])}}
    params = {"encoder": {"w": torch.zeros(2)}, "decoder": {"w": torch.zeros(1)}}
    base = build_optimizer(tcfg.TrainConfig())
    opt = encoder_learning_rate_optimizer(base, encoder_lr_scale=0.1)
    u, s = opt.update(g, opt.init(params), params)
    ub, sb = base.update(g, base.init(params), params)
    torch.testing.assert_close(u["encoder"]["w"], 0.1 * ub["encoder"]["w"])
    assert torch.equal(u["decoder"]["w"], ub["decoder"]["w"])
    # Adam's moments see the unscaled gradient: scaling it would change nothing.
    assert torch.equal(s["mu"]["encoder"]["w"], sb["mu"]["encoder"]["w"])
    torch.testing.assert_close(u["encoder"]["w"].abs(), torch.full((2,), 1e-4), rtol=1e-4, atol=0)


def test_train_state_from_jax_carries_params_and_adam_moments():
    jp = _params(9)
    jopt = jft.encoder_learning_rate_optimizer(
        optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3)), encoder_lr_scale=0.1
    )
    step = jft.make_joint_train_step(jax_vit_tiny(), JaxDecoder(**DEC), jopt, deterministic=True)
    jstate, _ = step(jloop.TrainState.create(jax.tree.map(jnp.asarray, jp), jopt, jax.random.key(1)), *map(jnp.asarray, _batch(14)))
    gen = torch.Generator()
    st = train_state_from_jax(jstate, gen)
    assert st.step == 1 and st.rng is gen and int(st.opt_state["count"]) == 1
    back = params_to_numpy(st.params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tuple(st.params["encoder"]["patch_embed"]["kernel"].shape) == (64, 3, 4, 4)  # OIHW
    adam = adam_state_from_jax(jstate.opt_state)
    np.testing.assert_array_equal(
        params_to_numpy(adam["nu"])["decoder"]["out"]["kernel"],
        np.asarray(jstate.opt_state[0][1][0].nu["decoder"]["out"]["kernel"]),
    )
    with pytest.raises(ValueError):
        adam_state_from_jax(optax.EmptyState())


def test_encode_for_decoder_spatial_rows():
    p = params_from_jax(_params(11)["encoder"])
    x = torch.from_numpy(_batch(15)[0])
    with torch.no_grad():
        rows = encode_for_decoder(dataclasses.replace(FLASH, features="spatial"), p, x)
        pooled = encode_for_decoder(FLASH, p, x)
    assert tuple(rows.shape) == (B, 64, 64) and tuple(pooled.shape) == (B, 64)
    torch.testing.assert_close(rows.mean(dim=1), pooled, rtol=1e-5, atol=1e-6)


def test_unported_knobs_raise():
    opt = build_optimizer(tcfg.TrainConfig())
    for kw in (
        dict(mesh=object()), dict(axis="model"), dict(fsdp_state_template=object()),
        dict(grad_clip_norm=1.0), dict(fsdp_min_size=1), dict(compute_dtype=torch.float16),
    ):
        with pytest.raises(NotImplementedError):
            make_joint_train_step(FLASH, MergeDecoder(**DEC), opt, **kw)


# -- fit_finetune ----------------------------------------------------------------

CAPTIONS = {
    f"img{i}": [
        "startseq " + " ".join(f"w{(i * 5 + j + k) % 11}" for k in range(2 + (i + j) % 5)) + " endseq"
        for j in range(2)
    ]
    for i in range(5)
}


def _finetune_pipelines(rate):
    train = dict(batch_size=4, learning_rate=3e-3, seed=2)
    dec = dict(embed_dim=16, hidden_dim=32, dropout_rate=rate)
    jpipe = JaxPipeline(
        jcfg.Config(
            encoder=jcfg.encoder_config("vit_tiny"), decoder=jcfg.DecoderConfig(**dec),
            decode=jcfg.DecodeConfig(max_len=8), train=jcfg.TrainConfig(**train), precision="f32",
        )
    )
    jpipe.fit_tokenizer(CAPTIONS)
    jpipe.build(init_params=False)
    pipe = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.encoder_config("vit_tiny"), decoder=tcfg.DecoderConfig(**dec),
            decode=tcfg.DecodeConfig(max_len=8), train=tcfg.TrainConfig(**train), precision="f32",
        ),
        tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()),
        device="cpu",
    )
    pipe.encoder = dataclasses.replace(pipe.encoder, attention_impl="flash")
    pipe.build(seed=6)  # the port's init, carried to tpucap
    jpipe.params = jax.tree.map(jnp.asarray, params_to_numpy(pipe.params))
    rng = np.random.default_rng(90)
    images = {k: rng.uniform(-1, 1, size=(32, 32, 3)).astype(np.float32) for k in CAPTIONS}
    return jpipe, pipe, images


@pytest.mark.parametrize("freeze", [False, True])
def test_fit_finetune_matches_tpucap_per_epoch(freeze):
    jpipe, pipe, images = _finetune_pipelines(0.0)
    before = jax.tree.map(np.asarray, jpipe.params["encoder"])
    want = jpipe.fit_finetune(CAPTIONS, images, epochs=2, freeze_encoder=freeze, log=None)
    got = pipe.fit_finetune(CAPTIONS, images, epochs=2, freeze_encoder=freeze, log=None)
    assert [sorted(e) for e in got] == [sorted(e) for e in want]
    for g, w in zip(got, want):
        for k in ("loss", "accuracy", "perplexity", "tokens"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    moved = [
        not np.array_equal(a, np.asarray(b))
        for a, b in zip(jax.tree.leaves(params_to_numpy(pipe.params["encoder"])), jax.tree.leaves(before))
    ]
    assert not any(moved) if freeze else all(moved)


def test_fit_finetune_with_dropout_descends_and_refuses_unported_dials():
    _, pipe, images = _finetune_pipelines(0.5)
    hist = pipe.fit_finetune(CAPTIONS, images, epochs=3, log=None)
    assert hist[-1]["loss"] < hist[0]["loss"]
    for kw in (
        dict(parallelism="dp"), dict(parallelism="fsdp"), dict(lora_rank=4, parallelism="dp"),
        dict(lora_rank=4, remat_encoder=True), dict(sharded_checkpoints=True),
    ):
        with pytest.raises(NotImplementedError):
            pipe.fit_finetune(CAPTIONS, images, epochs=1, log=None, **kw)


# -- remat_encoder and attention_reg in the joint step -----------------------------


def test_remat_update_equals_the_plain_update_bit_for_bit():
    """``remat_encoder=True`` recomputes the encoder (K5's
    ``FlashAttentionQKV`` forward, its row statistics with it) in the
    backward: on the same inputs the same arithmetic, so the update and
    the metrics are the plain step's exactly (tolerance 0)."""
    p = params_from_jax(_params(17))
    images, toks = _batch(18)
    opt = encoder_learning_rate_optimizer(build_optimizer(tcfg.TrainConfig()), encoder_lr_scale=0.1)
    got = [
        make_joint_train_step(FLASH, MergeDecoder(**DEC), opt, deterministic=True, remat_encoder=remat)(
            TrainState.create(p, opt, None), *_t(images, toks)
        )
        for remat in (False, True)
    ]
    for k in got[0][1]:
        assert torch.equal(got[0][1][k], got[1][1][k]), k
    for a, b in zip(tree_leaves(got[0][0].params), tree_leaves(got[1][0].params)):
        assert torch.equal(a, b)
    assert not torch.equal(got[1][0].params["encoder"]["blocks"][0]["qkv"]["kernel"], p["encoder"]["blocks"][0]["qkv"]["kernel"])


def test_joint_step_with_attention_reg_matches_tpucap():
    """The soft-attention decoder on ``tiny_cnn``'s 4 x 4 grid of 128-d
    features, ``attention_reg`` 1.0: one step of each package under plain
    SGD at lr 1e6 from the same params, the gradient read back as (params -
    updated params) / lr. The metrics (the regularizer's among them) within
    1e-6 relative (the perplexity, their exponential, within 1e-5), each gradient within 1e-5 of its tensor's scale, but
    those the regularizer reaches directly (the attention MLP's
    ``att_feat``, ``att_hidden``, ``att_score`` and the initial state's
    ``init_h``, ``init_c``): within 1e-5 of the largest gradient (measured
    7.8e-7 on tpucap's own init). They sum the regularizer's cancelling terms: against an f64
    evaluation of the same step tpucap's f32 values are off by up to
    1.2e-4 of their tensor's scale and the port's by 1.7e-5. The score bias, zero in
    theory, is rounding noise below 1e-5 of the largest gradient on each
    side (measured 1.8e-6)."""
    from tpucap.models.decoders import build_decoder as jax_build_decoder
    from tpucap.models.encoders import TinyCNN as JaxTinyCNN
    from tpucap_torch.models.decoders import build_decoder
    from tpucap_torch.models.encoders import TinyCNN
    from tpucap_torch.train.loop import chain, scale_by_learning_rate

    lr, kw = 1e6, dict(vocab_size=V, feature_dim=128, embed_dim=16, hidden_dim=32, dropout_rate=0.0)
    jenc, tenc = JaxTinyCNN(features="spatial"), TinyCNN(features="spatial")
    jdec, tdec = jax_build_decoder("attention", **kw), build_decoder("attention", **kw)
    gen = torch.Generator().manual_seed(19)  # the port's init, carried to tpucap
    jp = jax.tree.map(jnp.asarray, params_to_numpy({"encoder": tenc.init(gen), "decoder": tdec.init(gen)}))
    images, toks = _batch(21)
    jopt, topt = optax.sgd(lr), chain(scale_by_learning_rate(lr))
    jstate, jm = jft.make_joint_train_step(jenc, jdec, jopt, deterministic=True, attention_reg=1.0)(
        jloop.TrainState.create(jp, jopt, jax.random.key(0)), *map(jnp.asarray, (images, toks))
    )
    start = params_from_jax(jax.tree.map(np.asarray, jp))
    tstate, tm = make_joint_train_step(tenc, tdec, topt, deterministic=True, attention_reg=1.0)(
        TrainState.create(start, topt, None), *_t(images, toks)
    )
    assert sorted(tm) == sorted(jm) and "attention_reg" in tm
    for k in jm:
        rtol = 1e-5 if k == "perplexity" else 1e-6  # exp(loss): |loss| x the loss's 1e-6
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=rtol, err_msg=k)
    jg = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / lr, jp, jstate.params)
    tg = jax.tree.map(lambda a, b: (a - b) / lr, params_to_numpy(start), params_to_numpy(tstate.params))
    scale = max(np.abs(g).max() for g in jax.tree.leaves(jg))
    for g in (tg["decoder"]["att_score"].pop("bias"), jg["decoder"]["att_score"].pop("bias")):
        assert np.abs(g).max() < 1e-5 * scale
    for name in ("att_feat", "att_hidden", "att_score", "init_h", "init_c"):
        for a, b in zip(jax.tree.leaves(tg["decoder"].pop(name)), jax.tree.leaves(jg["decoder"].pop(name))):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale, err_msg=name)
    _close_to_scale(tg, jg, 1e-5, "joint grads with attention_reg")
