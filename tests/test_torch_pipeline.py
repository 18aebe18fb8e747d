"""The slice as a whole: a uint8 batch through tpucap_torch's
``caption_batch`` (preprocess -> encoder -> merge LSTM -> beam or greedy)
against the body of tpucap's ``caption_dataset`` on the CPU, same weights
(bridged), f32. Encoders: ResNet-50 at input 64 with BN folded, unfused and
with fused identity blocks (kernel K4's plain version on the CPU, tpucap's
Pallas kernel in interpret mode); and ``vit_tiny`` with ``xla`` and
``flash`` attention (kernel K5's plain version on the CPU). The batch
arrives at another size, so both sides resize nearest (tpucap through
``fused_preprocess``, which is the host loader's resize + the body's
normalize). Captions must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap.config import Config, DecodeConfig, DecoderConfig, EncoderConfig
from tpucap.config import encoder_config as jax_encoder_config
from tpucap.decode import beam_decode, greedy_decode, ids_to_captions
from tpucap.ops.preprocess import fused_preprocess
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap_torch import config as tcfg
from tpucap.text import Tokenizer as JaxTokenizer
from tpucap_torch.convert import load_npz, params_from_jax, params_to_numpy, save_npz
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer

from ports_init import build_on_ports_init

torch.set_num_threads(2)

SIZE = 64
WORDS = [f"w{a}{b}" for a in "abcdefg" for b in "xyz"]
CORPUS = {
    "img": [
        "startseq " + " ".join(WORDS[i : i + 5]) + " endseq"
        for i in range(0, len(WORDS), 3)
    ]
}
DEC = dict(embed_dim=16, hidden_dim=32, dropout_rate=0.0)
DECODE = dict(max_len=10, beam_width=3)


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """The port's seeded ResNet-50 + lstm1 init (torch's takes a second
    where tpucap's eager one takes tens), carried to tpucap by
    ``convert.params_to_numpy`` and to the port itself through the .npz
    bridge the card side uses (no jax, no orbax there)."""
    seeded = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.encoder_config("resnet50"),
            decoder=tcfg.DecoderConfig(**DEC),
            decode=tcfg.DecodeConfig(**DECODE),
            precision="f32",
        ),
        device="cpu",
    )
    seeded.fit_tokenizer(CORPUS)
    seeded.build(seed=1)
    # Random ResNet-50 features are large enough to fix every step's
    # argmax, so shrink the image branch, sharpen the head and tilt it
    # toward endseq: captions then differ and end after 0 to 10 words, on
    # these noise images and on test_torch_dataset.py's JPEGs (at 0.2
    # nearly none ends early, at 0.3 every one ends at once).
    dec = seeded.params["decoder"]
    dec["feat_proj"]["kernel"].mul_(0.01)
    dec["out"]["kernel"].mul_(4)
    dec["out"]["bias"][seeded.tokenizer.word_index["endseq"]] += 0.25
    params = params_to_numpy(seeded.params)

    jpipe = JaxPipeline(
        Config(
            encoder=EncoderConfig(name="resnet50", feature_dim=2048),
            decoder=DecoderConfig(**DEC),
            decode=DecodeConfig(**DECODE),
            precision="f32",
        ),
        tokenizer=JaxTokenizer.from_json(seeded.tokenizer.to_json()),
    )
    jpipe.encoder = dataclasses.replace(jpipe.encoder, input_size=SIZE)
    jpipe.build(init_params=False)
    jpipe.params = jax.tree.map(jnp.asarray, params)

    pipe = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.encoder_config("resnet50"),
            decoder=tcfg.DecoderConfig(**DEC),
            decode=tcfg.DecodeConfig(**DECODE),
            precision="f32",
        ),
        tokenizer=Tokenizer.from_json(seeded.tokenizer.to_json()),
        device="cpu",
    )
    pipe.encoder = dataclasses.replace(pipe.encoder, input_size=SIZE)
    pipe.build(init_params=False)
    path = tmp_path_factory.mktemp("w") / "params.npz"
    save_npz(path, params_from_jax(params))
    pipe.set_params(load_npz(path))
    jpipe.fold_bn()
    pipe.fold_bn()
    return jpipe, pipe


def _jax_body(jpipe, images_u8, method):
    """tpucap's caption_dataset body (pipeline.py:491-525) after the host
    loader's nearest resize, with its ids_to_captions drain."""
    start_id, end_id = jpipe._token_ids()
    dcfg = jpipe.config.decode
    p = jpipe._inference_params()
    enc = jpipe.encoder
    x = fused_preprocess(
        jnp.asarray(images_u8), enc.input_size, enc.preprocess_mode, out_dtype=jnp.float32
    )
    feats = jpipe._apply_encoder(p["encoder"], x)
    state = jpipe.decoder.init_state(p["decoder"], feats)
    kw = dict(start_id=start_id, end_id=end_id, max_len=dcfg.max_len)
    if method == "greedy":
        res = greedy_decode(jpipe.decoder.step, p["decoder"], state, **kw)
    else:
        res = beam_decode(
            jpipe.decoder.step, p["decoder"], state, beam_width=dcfg.beam_width,
            decoder=jpipe.decoder, **kw,
        )
    return ids_to_captions(jpipe.tokenizer, res.tokens, res.lengths, end_id=end_id), res


@pytest.mark.parametrize("method", ["beam", "greedy"])
def test_caption_batch_matches_jax_body(pipelines, method):
    jpipe, pipe = pipelines
    images = np.random.default_rng(7).integers(0, 256, size=(4, 80, 72, 3), dtype=np.uint8)
    want, res = _jax_body(jpipe, images, method)
    got = pipe.caption_batch(images, method=method)
    assert got == want
    assert len(set(want)) > 1 and (np.asarray(res.lengths) < DECODE["max_len"]).any()


def test_caption_batch_with_fused_blocks_matches_jax_body(pipelines):
    """Both sides with fused identity blocks; the port's fused captions
    also equal its unfused ones (the plain K4 rounds as the unfused f32
    path does)."""
    jpipe, pipe = pipelines
    images = np.random.default_rng(9).integers(0, 256, size=(4, 80, 72, 3), dtype=np.uint8)
    unfused = pipe.caption_batch(images, method="beam")
    encoders = jpipe.encoder, pipe.encoder
    try:
        jpipe.encoder = dataclasses.replace(jpipe.encoder, fused_blocks=True)
        pipe.encoder = dataclasses.replace(pipe.encoder, fused_blocks=True)
        want, res = _jax_body(jpipe, images, "beam")
        got = pipe.caption_batch(images, method="beam")
    finally:
        jpipe.encoder, pipe.encoder = encoders
    assert got == want == unfused
    assert len(set(want)) > 1


@pytest.fixture(scope="module")
def vit_pipelines():
    """vit_tiny (32 px, tf mode) + lstm1 on both sides, params bridged
    (``ports_init.build_on_ports_init``)."""
    jpipe = JaxPipeline(
        Config(
            encoder=jax_encoder_config("vit_tiny"),
            decoder=DecoderConfig(**DEC),
            decode=DecodeConfig(**DECODE),
            precision="f32",
        )
    )
    jpipe.fit_tokenizer(CORPUS)
    # The port's init from seed 3: under these scalings its beam captions
    # differ and some end early (seed 0's never end, seed 1's all end at
    # once).
    build_on_ports_init(jpipe, 3)
    dec = jpipe.params["decoder"]
    dec["feat_proj"]["kernel"] = dec["feat_proj"]["kernel"] * 0.1
    dec["out"]["kernel"] = dec["out"]["kernel"] * 4
    dec["out"]["bias"] = dec["out"]["bias"].at[jpipe.tokenizer.word_index["endseq"]].add(0.3)
    pipe = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.encoder_config("vit_tiny"),
            decoder=tcfg.DecoderConfig(**DEC),
            decode=tcfg.DecodeConfig(**DECODE),
            precision="f32",
        ),
        tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()),
        device="cpu",
    )
    pipe.build(init_params=False)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    jpipe.fold_bn()
    pipe.fold_bn()  # no BatchNorm: a no-op on both sides
    return jpipe, pipe


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_caption_batch_vit_matches_jax_body(vit_pipelines, impl):
    jpipe, pipe = vit_pipelines
    images = np.random.default_rng(11).integers(0, 256, size=(6, 40, 36, 3), dtype=np.uint8)
    want, res = _jax_body(jpipe, images, "beam")
    encoder = pipe.encoder
    try:
        pipe.encoder = dataclasses.replace(pipe.encoder, attention_impl=impl)
        got = pipe.caption_batch(images, method="beam")
    finally:
        pipe.encoder = encoder
    assert got == want
    assert len(set(want)) > 1 and (np.asarray(res.lengths) < DECODE["max_len"]).any()


def test_encode_images_matches_jax(pipelines):
    """Preprocessed batch -> pooled features; f32 convolutions summed in
    another order through 53 layers: 1e-4 of the output's scale."""
    jpipe, pipe = pipelines
    images = np.random.default_rng(8).integers(0, 256, size=(2, SIZE, SIZE, 3), dtype=np.uint8)
    x = np.array(fused_preprocess(jnp.asarray(images), SIZE, "caffe", out_dtype=jnp.float32))
    want = np.asarray(jpipe.encode_images(x))
    got = pipe.encode_images(x)
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_npz_round_trip_keeps_tree(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"cells": [{"kernel": torch.randn(3, 4, generator=gen)}], "out": {"bias": torch.zeros(2)}}
    save_npz(tmp_path / "p.npz", tree)
    back = load_npz(tmp_path / "p.npz")
    assert isinstance(back["cells"], list)
    torch.testing.assert_close(back["cells"][0]["kernel"], tree["cells"][0]["kernel"])
    torch.testing.assert_close(back["out"]["bias"], tree["out"]["bias"])
