"""int8 param trees, which tpucap's quantizers write, are refused by the
port by name.

tpucap's ``quantize_vocab_projection`` and ``quantize_encoder`` replace a
dense or conv kernel with an int8 ``kernel`` and an f32 per-channel
``kernel_scale`` (``tpucap/models/encoders/quantize.py``), which tpucap's
``dense`` and ``conv`` dequantize. The port has no int8 branch yet. Its
``params_from_jax`` used to cast every leaf to f32 and carry
``kernel_scale`` along unread, so ``dense`` multiplied by the
integer-valued kernel: the first test rebuilds that carry-over and shows
its logits off from tpucap's by orders of magnitude. Now every door a
quantized tree can come through (``params_from_jax``, ``set_params``,
``load``, ``reload_params``) and the primitives themselves (``dense``,
``conv``) raise NotImplementedError naming int8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap.config import Config, DecodeConfig, DecoderConfig
from tpucap.config import encoder_config as jax_encoder_config
from tpucap.models.encoders.quantize import quantize_encoder_params
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap_torch import config as tcfg
from tpucap_torch.convert import params_from_jax, save_npz
from tpucap_torch.models.encoders.common import conv
from tpucap_torch.models.layers import dense
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer

from ports_init import build_on_ports_init

torch.set_num_threads(2)

CORPUS = {"img": [f"startseq w{a} w{b} endseq" for a in "abcd" for b in "xyz"]}
DEC = dict(embed_dim=16, hidden_dim=32, dropout_rate=0.0)


def _jax_pipeline():
    jpipe = JaxPipeline(
        Config(encoder=jax_encoder_config("tiny_cnn"), decoder=DecoderConfig(**DEC),
               decode=DecodeConfig(max_len=6), precision="f32")
    )
    jpipe.fit_tokenizer(CORPUS)
    build_on_ports_init(jpipe, 0)
    return jpipe


def _port_pipeline(jpipe):
    pipe = CaptioningPipeline(
        tcfg.Config(encoder=tcfg.encoder_config("tiny_cnn"), decoder=tcfg.DecoderConfig(**DEC),
                    decode=tcfg.DecodeConfig(max_len=6), precision="f32"),
        tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()),
        device="cpu",
    )
    pipe.build(init_params=False)
    return pipe


def _f32_carry_over(tree):
    """The carry-over as it was: every leaf cast to f32, kernel_scale kept."""
    if isinstance(tree, dict):
        return {k: _f32_carry_over(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_f32_carry_over(v) for v in tree]
    return torch.from_numpy(np.asarray(tree, np.float32).copy())


def test_f32_carry_over_of_an_int8_head_gave_wrong_logits():
    """A quantized vocab projection carried as f32: the port's first-step
    logits are about 1 / kernel_scale times tpucap's."""
    jpipe = _jax_pipeline()
    jpipe.quantize_vocab_projection()
    jdec = jpipe.params["decoder"]
    assert np.asarray(jdec["out"]["kernel"]).dtype == np.int8
    feats = np.random.default_rng(0).normal(size=(3, 128)).astype(np.float32)
    start = jpipe.tokenizer.word_index["startseq"]
    want, _ = jpipe.decoder.step(jdec, jpipe.decoder.init_state(jdec, jnp.asarray(feats)),
                                 jnp.full((3,), start, jnp.int32))
    pipe = _port_pipeline(jpipe)
    old = _f32_carry_over(jax.tree.map(np.asarray, jdec))
    got, _ = pipe.decoder.step(old, pipe.decoder.init_state(old, torch.from_numpy(feats)),
                               torch.full((3,), start))
    ratio = float(got.abs().max()) / float(np.abs(np.asarray(want)).max())
    scale = np.asarray(jdec["out"]["kernel_scale"])
    assert ratio > 100, ratio
    np.testing.assert_allclose(ratio, 1 / scale.mean(), rtol=0.5)
    with pytest.raises(NotImplementedError, match="int8"):
        params_from_jax(jax.tree.map(np.asarray, jdec))


def _vgg16_layout():
    """VGG16's own param names (a conv, fc1, fc2) at narrow widths."""
    rng = np.random.default_rng(1)
    return {
        "block1_conv1": {"kernel": rng.normal(size=(3, 3, 3, 8)).astype(np.float32),
                         "bias": np.zeros(8, np.float32)},
        "fc1": {"kernel": rng.normal(size=(32, 16)).astype(np.float32), "bias": np.zeros(16, np.float32)},
        "fc2": {"kernel": rng.normal(size=(16, 16)).astype(np.float32), "bias": np.zeros(16, np.float32)},
    }


def _quantized(kind):
    jpipe = _jax_pipeline()
    if kind == "vocab_projection":
        jpipe.quantize_vocab_projection()
    elif kind == "encoder":
        jpipe.quantize_encoder()
    else:
        return jpipe, {"encoder": quantize_encoder_params(_vgg16_layout())}
    return jpipe, jax.tree.map(np.asarray, jpipe.params)


@pytest.mark.parametrize("kind", ["vocab_projection", "encoder", "vgg16_fc_and_conv"])
def test_params_from_jax_refuses_int8(kind):
    _, tree = _quantized(kind)
    with pytest.raises(NotImplementedError, match="int8"):
        params_from_jax(tree)


def test_params_from_jax_refuses_a_kernel_scale_leaf():
    tree = {"out": {"kernel": np.ones((4, 5), np.float32), "kernel_scale": np.ones(5, np.float32)}}
    with pytest.raises(NotImplementedError, match="int8"):
        params_from_jax(tree)


def _int8_tree(pipe):
    """The port's live tree with its vocab projection as an int8 kernel and
    its scale, as an int8 carry-over would have it."""
    params = {"encoder": pipe.params["encoder"], "decoder": dict(pipe.params["decoder"])}
    out = params["decoder"]["out"]
    params["decoder"]["out"] = {
        "kernel": out["kernel"].round().to(torch.int8), "bias": out["bias"],
        "kernel_scale": torch.ones(out["kernel"].shape[1]),
    }
    return params


def test_set_params_load_and_reload_refuse_int8(tmp_path):
    jpipe = _jax_pipeline()
    pipe = _port_pipeline(jpipe)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    live = pipe.params["decoder"]["out"]["kernel"].clone()
    bad = _int8_tree(pipe)
    with pytest.raises(NotImplementedError, match="int8"):
        pipe.set_params(bad)
    with pytest.raises(NotImplementedError, match="int8"):
        pipe.reload_params(bad)
    pipe.save(tmp_path / "bundle")
    save_npz(tmp_path / "bundle" / "params.npz", bad)
    with pytest.raises(NotImplementedError, match="int8"):
        CaptioningPipeline.load(tmp_path / "bundle", device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        pipe.reload_params(tmp_path / "bundle")
    assert torch.equal(pipe.params["decoder"]["out"]["kernel"], live)


def test_dense_and_conv_refuse_an_int8_kernel():
    x = torch.ones(2, 4)
    with pytest.raises(NotImplementedError, match="int8"):
        dense({"kernel": torch.ones(4, 3, dtype=torch.int8), "bias": torch.zeros(3)}, x)
    img = torch.ones(1, 5, 5, 3)
    with pytest.raises(NotImplementedError, match="int8"):
        conv({"kernel": torch.ones(2, 3, 3, 3, dtype=torch.int8), "bias": torch.zeros(2)}, img)
