"""tpucap_torch's InceptionV3 (CONFIG_2 and CONFIG_5's encoder) and its
``avg_pool_same`` against tpucap's, on the CPU, on the same params: the
port's seeded init carried to tpucap by ``convert.params_to_numpy`` (the
BatchNorm statistics drawn away from their init, so that every BN does
something), then back through ``convert.params_from_jax``.

Tolerances:
- features, pooled (2048) and spatial (mixed7, 768), f32 both ways: 94
  convolutions summed in another order, within 1e-5 of the features'
  largest magnitude (measured: about 1e-6);
- folded against unfolded, on either side: the same bound;
- ``avg_pool_same``: f32 within one ulp of the values' scale (a library
  pool sums in its own order); bf16 bit for bit (the window summed in bf16
  in tpucap's row-major order);
- the slice (uint8 batch -> K1's plain version in tf mode -> InceptionV3 ->
  lstm1 -> beam 3): captions identical to tpucap's ``caption_dataset``
  body. The slice runs at input 75, the encoder check also once at 299;
- bf16 (params cast to bf16 on both sides), input 75, BN folded: within
  1.5 % of the features' scale, about two bf16 ulps (measured 0.6 %
  pooled, spatial bit-identical at this size); the bf16 bound of
  ``tests/test_torch_bf16.py``, kept in this file beside the f32 checks
  on the same carried params.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap.config import Config, DecodeConfig, DecoderConfig
from tpucap.config import encoder_config as jax_encoder_config
from tpucap.decode import beam_decode, ids_to_captions
from tpucap.models.encoders.common import avg_pool_same as jax_avg_pool_same
from tpucap.models.encoders.fold_bn import fold_batch_norms as jax_fold
from tpucap.models.encoders.inception_v3 import InceptionV3 as JaxInceptionV3
from tpucap.ops.preprocess import fused_preprocess
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap_torch import config as tcfg
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.core import tree_map
from tpucap_torch.models.encoders import InceptionV3, build_encoder, fold_batch_norms
from tpucap_torch.models.encoders.common import avg_pool_same
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer

torch.set_num_threads(2)

RTOL_SCALE = 1e-5


def _params(features, seed):
    """The port's seeded init (torch's, where tpucap's eager one costs tens
    of seconds) in tpucap's layout, BatchNorm statistics drawn (numpy
    leaves)."""
    params = params_to_numpy(InceptionV3(features=features).init(torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    for p in params.values():
        c = p["bn"]["beta"].shape[0]
        p["bn"] = {
            "beta": rng.normal(size=c).astype(np.float32) * 0.2,
            "mean": rng.normal(size=c).astype(np.float32) * 0.2,
            "var": rng.uniform(0.3, 1.5, size=c).astype(np.float32),
        }
    return params


_APPLY = {}


def _jax_apply(enc):
    if enc not in _APPLY:
        _APPLY[enc] = jax.jit(enc.apply)
    return _APPLY[enc]


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0, atol=RTOL_SCALE * np.abs(want).max(), err_msg=what
    )


CASES = [(75, "pooled", s, 2) for s in (0, 1, 2)] + [(75, "spatial", s, 2) for s in (0, 1)] + [
    (299, "pooled", 3, 1)
]


@pytest.mark.parametrize("size,features,seed,batch", CASES)
def test_features_match_tpucap(size, features, seed, batch):
    jenc = JaxInceptionV3(features=features, input_size=size)
    enc = InceptionV3(features=features, input_size=size)
    jp = _params(features, seed)
    x = np.random.default_rng(seed).uniform(-1, 1, size=(batch, size, size, 3)).astype(np.float32)
    want = _jax_apply(jenc)(jp, jnp.asarray(x))
    tp = params_from_jax(jp)
    got = enc.apply(tp, torch.from_numpy(x))
    side = (size - 3) // 2 - 1
    side = ((((side - 3) // 2 + 1) - 2 - 3) // 2 + 1 - 3) // 2 + 1
    shape = (batch, 2048) if features == "pooled" else (batch, side, side, 768)
    assert tuple(got.shape) == np.asarray(want).shape == shape
    assert enc.spatial_positions == jenc.spatial_positions == side * side
    _close(got.numpy(), want, "features")
    # Folded against unfolded: tpucap's folded tree carried across (its
    # None BatchNorms dropped) and the port's own fold.
    want_folded = _jax_apply(jenc)(jax_fold("inception_v3", jp), jnp.asarray(x))
    folded = fold_batch_norms("inception_v3", tp)
    assert all("bn" not in p for p in folded.values())
    carried = params_from_jax(jax_fold("inception_v3", jp))
    for name, p in carried.items():
        for k in ("kernel", "bias"):
            torch.testing.assert_close(p["conv"][k], folded[name]["conv"][k], rtol=1e-6, atol=1e-6)
    _close(enc.apply(folded, torch.from_numpy(x)).numpy(), want_folded, "folded")
    _close(enc.apply(folded, torch.from_numpy(x)).numpy(), want, "folded against unfolded")
    assert fold_batch_norms("inception_v3", folded) == folded  # idempotent


@pytest.mark.parametrize("features", ["pooled", "spatial"])
def test_bf16_inception_v3_within_share_of_scale(features):
    jenc = JaxInceptionV3(features=features, input_size=75)
    jp = jax_fold("inception_v3", _params(features, 26))
    x = np.random.default_rng(27).uniform(-1, 1, size=(2, 75, 75, 3)).astype(np.float32)
    jpb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    want = np.asarray(jax.jit(jenc.apply)(jpb, jnp.asarray(x, jnp.bfloat16)), np.float32)
    tp = tree_map(lambda t: t.to(torch.bfloat16), params_from_jax(jp))
    got = InceptionV3(features=features, input_size=75).apply(tp, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=0.015 * np.abs(want).max())


@pytest.mark.parametrize("features", ["pooled", "spatial"])
def test_param_layout_and_registry_match_tpucap(features):
    jenc = JaxInceptionV3(features=features)
    enc = build_encoder("inception_v3", features)
    assert enc == InceptionV3(features=features)
    assert (enc.input_size, enc.preprocess_mode, enc.feature_dim) == (
        299, "tf", jenc.feature_dim
    )
    assert enc._conv_shapes() == jenc._conv_shapes()
    tp = enc.init(torch.Generator().manual_seed(0))
    shapes = jenc._conv_shapes()
    assert list(tp) == [f"conv_{i}" for i in range(len(shapes))]
    assert len(shapes) == (94 if features == "pooled" else 70)
    for (cin, cout, kh, kw), p in zip(shapes, tp.values()):
        assert tuple(p["conv"]["kernel"].shape) == (cout, cin, kh, kw) and "bias" not in p["conv"]
        assert sorted(p["bn"]) == ["beta", "mean", "var"]
    assert tcfg.encoder_config("inception_v3", features).feature_dim == jenc.feature_dim


@pytest.mark.parametrize("hw", [(1, 1), (1, 4), (2, 3), (5, 5), (8, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_avg_pool_same_matches_tpucap_at_the_edges(hw, dtype):
    x = np.random.default_rng(sum(hw)).normal(size=(2, *hw, 6)).astype(np.float32) * 3
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax_avg_pool_same(jnp.asarray(x).astype(jdt), 3).astype(jnp.float32))
    got = avg_pool_same(torch.from_numpy(x).to(dtype), 3)
    assert got.dtype == dtype and tuple(got.shape) == x.shape
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-7 * np.abs(x).max())
    # A corner's window holds the valid elements only.
    if hw[0] > 1 and hw[1] > 1:
        np.testing.assert_allclose(got[:, 0, 0].float().numpy(), x[:, :2, :2].mean(axis=(1, 2)),
                                   rtol=1e-2 if dtype == torch.bfloat16 else 1e-6, atol=1e-2)


WORDS = [f"w{a}{b}" for a in "abcdefg" for b in "xyz"]
CORPUS = {"img": ["startseq " + " ".join(WORDS[i : i + 5]) + " endseq" for i in range(0, len(WORDS), 3)]}
SIZE = 75


def test_caption_batch_matches_tpucaps_body():
    """CONFIG_2's serving path at input 75 (InceptionV3 pooled + lstm1,
    beam 3, embed 16 hidden 32), f32, BN folded on both sides. Random
    InceptionV3 features of these images differ by about 3e-4 around a
    mean of 0.17, so the image branch is centred on their mean and scaled
    up: the captions then differ between images."""
    dec = dict(embed_dim=16, hidden_dim=32, dropout_rate=0.0)
    decode = dict(method="beam", beam_width=3, max_len=10)
    jpipe = JaxPipeline(Config(encoder=jax_encoder_config("inception_v3"), decoder=DecoderConfig(**dec),
                               decode=DecodeConfig(**decode), precision="f32"))
    jpipe.encoder = dataclasses.replace(jpipe.encoder, input_size=SIZE)
    jpipe.fit_tokenizer(CORPUS)
    jpipe.build(init_params=False)
    pipe = CaptioningPipeline(
        tcfg.Config(encoder=tcfg.encoder_config("inception_v3"), decoder=tcfg.DecoderConfig(**dec),
                    decode=tcfg.DecodeConfig(**decode), precision="f32"),
        tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()),
        device="cpu",
    )
    pipe.encoder = dataclasses.replace(pipe.encoder, input_size=SIZE)
    pipe.build(seed=0)  # the port's decoder init, carried to tpucap
    jpipe.params = {"encoder": _params("pooled", 5),
                    "decoder": jax.tree.map(jnp.asarray, params_to_numpy(pipe.params["decoder"]))}
    jpipe.fold_bn()
    rng = np.random.default_rng(12)
    images = (rng.integers(0, 256, size=(4, 1, 1, 3)) * np.ones((1, 90, 80, 1))).astype(np.uint8)
    images[:, ::2] = 255 - images[:, ::2]
    x = fused_preprocess(jnp.asarray(images), SIZE, "tf", out_dtype=jnp.float32)
    feats = np.asarray(jpipe._apply_encoder(jpipe.params["encoder"], x))
    d = jpipe.params["decoder"]
    d["feat_proj"]["kernel"] = d["feat_proj"]["kernel"] * 300
    d["feat_proj"]["bias"] = -feats.mean(axis=0) @ np.asarray(d["feat_proj"]["kernel"]) + 0.5
    d["out"]["kernel"] = d["out"]["kernel"] * 4
    d["out"]["bias"] = d["out"]["bias"].at[jpipe.tokenizer.word_index["endseq"]].add(0.5)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))

    start_id, end_id = jpipe._token_ids()
    p = jpipe._inference_params()
    state = jpipe.decoder.init_state(p["decoder"], jnp.asarray(feats))
    res = beam_decode(jpipe.decoder.step, p["decoder"], state, start_id=start_id, end_id=end_id,
                      max_len=10, beam_width=3, decoder=jpipe.decoder)
    want = ids_to_captions(jpipe.tokenizer, res.tokens, res.lengths, end_id=end_id)
    assert pipe.caption_batch(images) == want
    assert len(set(want)) > 1
