"""tpucap_torch's adaptive attention decoder (visual sentinel) against
tpucap's, on the CPU, params bridged through ``convert.params_from_jax``,
dropout off, f32:

- ``init_state``, ``step``, ``step_hidden`` within 1e-5 absolute of
  tpucap's on O(1) states and logits (sums in another order); ``_attend``
  with k = 3 hypotheses on one (B, L, .) grid gives tpucap's context and
  maps, and the same step on a grid tiled k times;
- ``forward_train_with_alphas``: logits within 1e-5, the alphas tpucap's
  (B, T, L+1) within 1e-5, each row summing to 1 within 1e-6, beta (the
  last column) in [0, 1];
- beam 3 with ``decoder=`` keeps ``val`` and ``att_feat`` at (B, L, .)
  inside every step and gives tpucap's tokens, lengths and scores (within
  1e-5); greedy gives tpucap's tokens;
- one training step with ``attention_reg=1.0`` under plain SGD gives
  tpucap's loss (1e-6 relative) and update (1e-5); the regularizer is
  taken over the L+1 columns, the sentinel's included, as tpucap documents;
- ``generate_with_attention`` returns tpucap's (B, T, L+1) maps within
  1e-5, on tiny_cnn's 4 x 4 block grid;
- the port's CLI alone: ``train --decoder adaptive`` then ``caption
  --dump-attention`` writes (B, T, L+1) maps, the restored pipeline's
  ``generate_with_attention``, and ``export`` refuses with tpucap's text.
"""

import contextlib
import importlib
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gru import make_pipes, sgd_step_matches
from tpucap.decode import beam_decode as jax_beam_decode
from tpucap.decode import greedy_decode as jax_greedy_decode
from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap.train import loss as jloss
from tpucap_torch.convert import params_from_jax
from tpucap_torch.decode import beam_decode, greedy_decode
from tpucap_torch.models.decoders import build_decoder
from tpucap_torch.train import caption_loss_sums

from ports_init import jit_init

torch.set_num_threads(2)

V, D, L, B, T = 29, 12, 9, 4, 6
H, A = 16, 10
START, END, MAXLEN = 1, 2, 10
DIMS = dict(vocab_size=V, feature_dim=D, embed_dim=8, hidden_dim=H, attention_dim=A, dropout_rate=0.0)
ATOL = 1e-5


def _bridged(seed=0, tilt=0.12):
    jdec, tdec = jax_build_decoder("adaptive", **DIMS), build_decoder("adaptive", **DIMS)
    jp = jax.tree.map(np.asarray, jit_init(jdec, jax.random.key(seed)))
    # Tilt the head toward END, so that some captions end early.
    jp["out"]["bias"] = jp["out"]["bias"] + np.eye(V, dtype=np.float32)[END] * tilt
    return jdec, jp, tdec, params_from_jax(jp)


def _grid(seed=0, batch=B):
    return np.random.default_rng(seed).normal(size=(batch, L, D)).astype(np.float32)


def test_steps_match_tpucap():
    jdec, jp, tdec, tp = _bridged()
    feats = _grid()
    jinit, jstep = jax.jit(jdec.init_state), jax.jit(jdec.step)
    js = jinit(jp, jnp.asarray(feats))
    ts = tdec.init_state(tp, torch.from_numpy(feats))
    assert list(ts) == ["val", "att_feat", "glob", "h", "c"] and sorted(js) == sorted(ts)
    assert tuple(ts["val"].shape) == (B, L, H) and tuple(ts["att_feat"].shape) == (B, L, A)
    for key in js:
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), atol=ATOL, err_msg=key)
    rng = np.random.default_rng(1)
    for t in range(4):
        tok = rng.integers(1, V, size=(B,))
        jl, js = jstep(jp, js, jnp.asarray(tok, jnp.int32))
        tl, ts = tdec.step(tp, ts, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, err_msg=f"step {t}")
        for key in js:
            np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), atol=ATOL, err_msg=key)
    jh, _ = jax.jit(jdec.step_hidden)(jp, js, jnp.asarray(tok, jnp.int32))
    th, _ = tdec.step_hidden(tp, ts, torch.from_numpy(tok))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)

    # k = 3 hypotheses an image over the untiled grid (b-major rows).
    hs = np.random.default_rng(2).normal(size=(2, 3 * B, H)).astype(np.float32)
    jctx, jalpha = jax.jit(jdec._attend)(jp, js, jnp.asarray(hs[0]), jnp.asarray(hs[1]))
    tctx, talpha = tdec._attend(tp, ts, torch.from_numpy(hs[0]), torch.from_numpy(hs[1]))
    assert tuple(talpha.shape) == (3 * B, L + 1)
    np.testing.assert_allclose(talpha.numpy(), np.asarray(jalpha), atol=ATOL)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), atol=ATOL)
    tiled = {k: v.repeat_interleave(3, dim=0) for k, v in ts.items()}
    ctx1, alpha1 = tdec._attend(tp, tiled, torch.from_numpy(hs[0]), torch.from_numpy(hs[1]))
    torch.testing.assert_close(alpha1, talpha, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(ctx1, tctx, rtol=1e-6, atol=1e-6)


def test_forward_train_with_alphas_matches_tpucap():
    jdec, jp, tdec, tp = _bridged()
    feats = _grid()
    toks = np.random.default_rng(3).integers(1, V, size=(B, T))
    wl, wa = jax.jit(jdec.forward_train_with_alphas)(jp, jnp.asarray(feats), jnp.asarray(toks, jnp.int32))
    gl, ga = tdec.forward_train_with_alphas(tp, torch.from_numpy(feats), torch.from_numpy(toks))
    assert tuple(ga.shape) == (B, T, L + 1)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=ATOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), atol=ATOL)
    np.testing.assert_allclose(ga.sum(-1).numpy(), 1.0, atol=1e-6)
    assert ((ga[..., L] >= 0) & (ga[..., L] <= 1)).all()
    torch.testing.assert_close(tdec.forward_train(tp, torch.from_numpy(feats), torch.from_numpy(toks)), gl)


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_engines_match_tpucap(method):
    """With the bigram ban and an endseq tilt, so that captions and their
    lengths differ."""
    jdec, jp, tdec, tp = _bridged(seed=6)
    feats = _grid(seed=5, batch=5)
    js = jax.jit(jdec.init_state)(jp, jnp.asarray(feats))
    ts = tdec.init_state(tp, torch.from_numpy(feats))
    kw = dict(start_id=START, end_id=END, max_len=MAXLEN, no_repeat_ngram_size=2)
    if method == "beam":
        seen = []

        def step(params, state, token):
            seen.append({k: tuple(state[k].shape) for k in tdec.beam_shared_keys})
            return tdec.step(params, state, token)

        ref = jax_beam_decode(jdec.step, jp, js, beam_width=3, decoder=jdec, **kw)
        got = beam_decode(step, tp, ts, beam_width=3, decoder=tdec, **kw)
        assert seen and all(s == {"val": (5, L, H), "att_feat": (5, L, A)} for s in seen)
        np.testing.assert_array_equal(got.beam_tokens.numpy(), np.asarray(ref.beam_tokens))
        np.testing.assert_allclose(got.beam_scores.numpy(), np.asarray(ref.beam_scores), atol=ATOL)
    else:
        ref = jax_greedy_decode(jdec.step, jp, js, **kw)
        got = greedy_decode(tdec.step, tp, ts, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=ATOL)
    assert len({tuple(r) for r in got.tokens.numpy()}) > 1
    assert (got.lengths.numpy() < MAXLEN).any()


def test_train_step_with_attention_reg_matches_tpucap():
    jdec, jp, tdec, tp = _bridged(seed=11)
    rng = np.random.default_rng(12)
    feats = rng.normal(size=(6, L, D)).astype(np.float32)
    toks = rng.integers(3, V, size=(6, T + 1)).astype(np.int32)
    toks[:, 0] = START
    for i, n in enumerate(rng.integers(3, T + 2, size=6)):
        toks[i, n:] = 0
    jm, tm = sgd_step_matches(jdec, tdec, jp, feats, toks, attention_reg=1.0)
    np.testing.assert_allclose(tm["attention_reg"].item(), float(jm["attention_reg"]), rtol=1e-6)
    # The regularizer sums each of the L+1 columns over a row's live input
    # steps (the sentinel's column too): sum_b sum_j (1 - sum_t a_btj)^2.
    inputs = toks[:, :-1]
    _, alphas = tdec.forward_train_with_alphas(tp, torch.from_numpy(feats), torch.from_numpy(inputs).long())
    live = torch.from_numpy(inputs != 0).float()[..., None]
    by_hand = ((1.0 - (alphas * live).sum(1)) ** 2).sum()
    sums = caption_loss_sums(tdec, tp, torch.from_numpy(feats), torch.from_numpy(toks).long(), attention_reg=1.0)
    torch.testing.assert_close(sums["reg_sum"], by_hand, rtol=1e-6, atol=0)
    grid_only = ((1.0 - (alphas[..., :L] * live).sum(1)) ** 2).sum()
    assert not torch.isclose(grid_only, by_hand, rtol=1e-3)
    jsums = jax.jit(lambda p, f, t: jloss.caption_loss_sums(jdec, p, f, t, attention_reg=1.0))(
        jp, jnp.asarray(feats), jnp.asarray(toks))
    np.testing.assert_allclose(sums["reg_sum"].item(), float(jsums["reg_sum"]), rtol=1e-6)


@pytest.fixture(scope="module")
def pipes():
    return make_pipes("adaptive", seed=2, decode={"max_len": 8, "no_repeat_ngram_size": 2}, tilt=1.0)


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_generate_with_attention_matches_tpucap(pipes, method):
    jpipe, pipe = pipes
    grid = np.random.default_rng(6).normal(size=(4, 16, 128)).astype(np.float32)
    caps, alphas, lengths = pipe.generate_with_attention(grid, method=method, beam_width=2)
    jcaps, jalphas, jlengths = jpipe.generate_with_attention(grid, method=method, beam_width=2)
    assert caps == jcaps == pipe.generate(grid, method=method, beam_width=2)
    assert len(set(caps)) > 1
    np.testing.assert_array_equal(lengths, np.asarray(jlengths))
    assert alphas.dtype == np.float32 and alphas.shape == (4, 8, 17)
    np.testing.assert_allclose(alphas, np.asarray(jalphas), atol=1e-5, rtol=0)
    np.testing.assert_allclose(alphas.sum(-1), 1.0, atol=1e-5)


def test_cli_adaptive_dumps_extended_maps(tmp_path):
    """``train --decoder adaptive`` (the CLI picks the spatial grid), then
    ``caption --dump-attention``: maps (B, T, L+1), the restored pipeline's
    ``generate_with_attention`` on the images' features; ``export``
    refuses with tpucap's text."""
    from tpucap.checkpoint.keras_export import decoder_to_keras as jax_decoder_to_keras
    from tpucap.data import generate_fixture_dataset

    cli = importlib.import_module("tpucap_torch.cli.main")
    img_dir, tokens, train, _ = generate_fixture_dataset(tmp_path / "data", n_images=4, image_size=32, seed=7)
    model = ["--encoder", "tiny_cnn", "--decoder", "adaptive", "--embed-dim", "16", "--hidden-dim", "32",
             "--max-len", "8"]
    feats, ckpt, out = str(tmp_path / "f.npz"), str(tmp_path / "ckpt"), str(tmp_path / "att.npz")
    images = sorted(str(p) for p in Path(img_dir).glob("*.jpg"))
    stderr = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(stderr):
        cli.main(["extract", *model, "--images", str(img_dir), "--out", feats, "--batch-size", "4"], device="cpu")
        cli.main(["train", *model, "--tokens", tokens, "--split", train, "--features", feats,
                  "--checkpoint-dir", ckpt, "--epochs", "1", "--batch-size", "4"], device="cpu")
        cli.main(["caption", *model, "--image", *images, "--checkpoint-dir", ckpt,
                  "--method", "beam", "--dump-attention", out], device="cpu")
    assert stderr.getvalue().splitlines()[-1] == f"wrote attention maps (4, 8, 17) to {out}"
    got = np.load(out)
    assert int(got["spatial_positions"]) == 16
    args = cli.build_parser()[0].parse_args(["caption", *model, "--image", *images, "--checkpoint-dir", ckpt])
    pipe = cli._restore_pipeline(args, torch.device("cpu"))
    assert type(pipe.decoder).__name__ == "AdaptiveAttentionDecoder"
    caps, alphas, lengths = pipe.generate_with_attention(pipe.extract_features(images), method="beam")
    assert list(got["captions"]) == caps
    np.testing.assert_array_equal(got["lengths"], lengths)
    np.testing.assert_array_equal(got["alphas"], alphas)
    with pytest.raises(ValueError) as jerr:
        jax_decoder_to_keras(jax_build_decoder("adaptive", **DIMS), {}, max_len=8)
    with pytest.raises(ValueError) as err:
        cli.main(["export", *model, "--checkpoint-dir", ckpt, "--out", str(tmp_path / "a.h5")], device="cpu")
    assert str(err.value) == str(jerr.value)
    assert str(err.value).startswith("no Keras topology for AdaptiveAttentionDecoder; have [")
