"""The inference bundle of tpucap_torch (``save``, ``load``,
``reload_params``) on the CPU: vit_tiny features (64-d), lstm1 with embed 16
and hidden 32, f32.

- the port's ``save`` -> ``load`` round trip gives back every param leaf
  bit for bit with its dtype (bf16 leaves too) and the same captions;
- a bundle that tpucap's ``save`` wrote (config.json, tokenizer.json and an
  orbax ``params/``), with its params also written as params.npz through
  ``convert.params_from_jax``, loads in the port and gives tpucap's
  captions token for token at precision f32; with only orbax's params it
  raises, saying so;
- config.json in either package's layout reads in the other; a field the
  port lacks raises unless it holds tpucap's default; a BPE tokenizer raises;
- each refusal of ``reload_params`` leaves the live weights serving, and an
  accepted reload swaps them.
"""

import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap_torch import config as tcfg
from tpucap_torch.convert import load_npz, params_from_jax, save_npz
from tpucap_torch.core import tree_leaves, tree_map
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer

from ports_init import build_on_ports_init

torch.set_num_threads(2)

CORPUS = {
    f"img{i}": [f"startseq a w{i % 5} w{(i * 3) % 7} plays on w{i} endseq", "startseq a dog runs endseq"]
    for i in range(8)
}
DEC = dict(embed_dim=16, hidden_dim=32, dropout_rate=0.0)
DECODE = dict(max_len=8, beam_width=3, method="beam")


def _features(n=6, seed=7):
    return np.random.default_rng(seed).normal(size=(n, 64)).astype(np.float32)


def _pipe(seed=0, corpus=CORPUS, **decoder):
    pipe = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.encoder_config("vit_tiny"),
            decoder=tcfg.DecoderConfig(**{**DEC, **decoder}),
            decode=tcfg.DecodeConfig(**DECODE),
            precision="f32",
        ),
        device="cpu",
    )
    pipe.fit_tokenizer(corpus)
    pipe.build(seed=seed)
    # A sharper head so captions differ between images and between weights.
    pipe.params["decoder"]["out"]["kernel"].mul_(8)
    return pipe


def _json(d):
    """The dict as config.json holds it."""
    return json.loads(json.dumps(d))


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_same_params(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


# -- save / load ----------------------------------------------------------------------


def test_save_load_round_trip(tmp_path):
    pipe = _pipe()
    feats = _features()
    want = pipe.generate(feats)
    assert len(set(want)) > 1
    pipe.save(tmp_path / "bundle")
    assert sorted(p.name for p in (tmp_path / "bundle").iterdir()) == [
        "config.json", "params.npz", "tokenizer.json"
    ]
    if not torch.cuda.is_available():  # load runs on the card unless asked
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CaptioningPipeline.load(tmp_path / "bundle")
    back = CaptioningPipeline.load(tmp_path / "bundle", device="cpu")
    assert back.config == pipe.config
    assert back.tokenizer.to_json() == pipe.tokenizer.to_json()
    _assert_same_params(back.params, pipe.params)
    assert back.generate(feats) == want


def test_npz_keeps_every_dtype(tmp_path):
    gen = torch.Generator().manual_seed(1)
    tree = {
        "a": [torch.randn(3, 5, generator=gen).bfloat16(), torch.randn(4, generator=gen)],
        "b": {"c": torch.arange(6, dtype=torch.int32).reshape(2, 3),
              "d": torch.randn(2, 2, generator=gen).double(),
              "e": torch.randn(3, 2, generator=gen).half().t()},
    }
    save_npz(tmp_path / "p.npz", tree)
    back = load_npz(tmp_path / "p.npz")
    assert isinstance(back["a"], list)
    _assert_same_params(back, tree)


def test_bf16_params_round_trip(tmp_path):
    """A tree with bf16 leaves (as a bf16 cast of the weights would be)
    comes back bf16, bit for bit."""
    pipe = _pipe()
    pipe.set_params(tree_map(lambda t: t.bfloat16(), pipe.params))
    pipe.save(tmp_path / "b")
    back = CaptioningPipeline.load(tmp_path / "b", device="cpu")
    assert {t.dtype for t in tree_leaves(back.params)} == {torch.bfloat16}
    _assert_same_params(back.params, pipe.params)


@pytest.fixture(scope="module")
def tpucap_bundle(tmp_path_factory):
    """tpucap's save of a built pipeline (orbax params/), f32."""
    jpipe = JaxPipeline(
        jcfg.Config(
            encoder=jcfg.encoder_config("vit_tiny"),
            decoder=jcfg.DecoderConfig(**DEC),
            decode=jcfg.DecodeConfig(**DECODE),
            precision="f32",
        )
    )
    jpipe.fit_tokenizer(CORPUS)
    build_on_ports_init(jpipe, 3)
    dec = jpipe.params["decoder"]
    dec["out"]["kernel"] = dec["out"]["kernel"] * 8
    path = tmp_path_factory.mktemp("tpucap") / "bundle"
    jpipe.save(str(path))
    return jpipe, path


def test_tpucap_bundle_loads_with_its_captions(tpucap_bundle, tmp_path):
    jpipe, orbax_only = tpucap_bundle
    path = tmp_path / "bundle"
    shutil.copytree(orbax_only, path)
    with pytest.raises(ValueError, match="orbax"):
        CaptioningPipeline.load(path, device="cpu")
    save_npz(path / "params.npz", params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    pipe = CaptioningPipeline.load(path, device="cpu")
    assert pipe.config.encoder.name == "vit_tiny" and pipe.config.precision == "f32"
    assert pipe.tokenizer.to_json() == jpipe.tokenizer.to_json()
    feats = _features()
    for method in ("beam", "greedy"):
        want = jpipe.generate(feats, method=method)
        assert len(set(want)) > 1
        assert pipe.generate(feats, method=method) == want
    # The port's save of it reads back in tpucap's config_from_dict.
    pipe.save(tmp_path / "again")
    d = json.loads((tmp_path / "again" / "config.json").read_text())
    assert jcfg.config_from_dict(d) == jcfg.config_from_dict(
        json.loads((orbax_only / "config.json").read_text())
    )


def test_config_json_layouts(tpucap_bundle):
    _, path = tpucap_bundle
    theirs = json.loads((path / "config.json").read_text())
    assert _json(tcfg.config_to_dict(tcfg.config_from_dict(theirs))) == theirs
    for preset in jcfg.PRESETS.values():
        d = _json(dataclasses.asdict(preset))
        assert _json(tcfg.config_to_dict(tcfg.config_from_dict(d))) == d
    ours = tcfg.Config(decode=tcfg.DecodeConfig(bad_words=("dog",)))
    assert tcfg.config_from_dict(_json(tcfg.config_to_dict(ours))) == ours


@pytest.mark.parametrize(
    "section, field, value",
    [
        ("train", "max_to_keep", 5),
        ("train", "checkpoint_dir", "elsewhere"),
        ("mesh", "model_devices", 2),
        ("mesh", "axis_name", "batch"),
        ("mesh", "n_devices", 4),
    ],
)
def test_unported_config_field_away_from_default_raises(tpucap_bundle, section, field, value):
    _, path = tpucap_bundle
    d = json.loads((path / "config.json").read_text())
    tcfg.config_from_dict(d)
    d[section][field] = value
    with pytest.raises(NotImplementedError, match=f"{section}.{field}"):
        tcfg.config_from_dict(d)


def test_transformer_config_fields_round_trip(tpucap_bundle):
    """The transformer's five DecoderConfig fields and
    TrainConfig.moe_aux_weight, away from their defaults, read from
    tpucap's layout and written back unchanged."""
    _, path = tpucap_bundle
    d = json.loads((path / "config.json").read_text())
    d["decoder"].update(name="transformer", num_heads=8, mlp_dim=512, max_positions=48, num_experts=4,
                        moe_top_k=1)
    d["train"]["moe_aux_weight"] = 0.5
    cfg = tcfg.config_from_dict(d)
    assert (cfg.decoder.num_heads, cfg.decoder.mlp_dim, cfg.decoder.max_positions, cfg.decoder.num_experts,
            cfg.decoder.moe_top_k, cfg.train.moe_aux_weight) == (8, 512, 48, 4, 1, 0.5)
    assert _json(tcfg.config_to_dict(cfg)) == d
    assert jcfg.config_from_dict(_json(tcfg.config_to_dict(cfg))) == jcfg.config_from_dict(d)


def test_unknown_config_field_and_bpe_tokenizer_raise(tmp_path):
    pipe = _pipe()
    pipe.save(tmp_path / "b")
    d = json.loads((tmp_path / "b" / "config.json").read_text())
    d["train"]["frobnicate"] = 1
    with pytest.raises(ValueError, match="frobnicate"):
        tcfg.config_from_dict(d)
    tok = tmp_path / "b" / "tokenizer.json"
    tok.write_text(json.dumps({"kind": "bpe", "merges": []}))
    with pytest.raises(NotImplementedError, match="BPE"):
        CaptioningPipeline.load(tmp_path / "b", device="cpu")


# -- reload_params -----------------------------------------------------------------------


def _refusals(tmp_path, live):
    """(label, source) pairs reload_params must refuse."""
    other_vocab = _pipe(seed=1, corpus={"x": ["startseq another vocabulary entirely endseq"]})
    other_vocab.save(tmp_path / "vocab")
    wider = _pipe(seed=1, hidden_dim=48)
    wider.save(tmp_path / "wider")
    same = _pipe(seed=1)
    same.save(tmp_path / "orbax_only")
    (tmp_path / "orbax_only" / "params.npz").unlink()
    (tmp_path / "orbax_only" / "params").mkdir()
    dropped = tree_map(torch.clone, live)
    del dropped["decoder"]["pre_out"]
    reshaped = tree_map(torch.clone, live)
    reshaped["decoder"]["out"]["bias"] = torch.zeros(3)
    recast = tree_map(torch.clone, live)
    recast["decoder"]["out"]["kernel"] = recast["decoder"]["out"]["kernel"].double()
    shorter = tree_map(torch.clone, live)
    shorter["decoder"]["cells"] = []
    return [
        ("vocabulary", tmp_path / "vocab", ValueError, "tokenizer|decoder config"),
        ("topology", tmp_path / "wider", ValueError, "decoder config"),
        ("orbax only", str(tmp_path / "orbax_only"), ValueError, "orbax"),
        ("missing subtree", dropped, ValueError, "structure"),
        ("shape", reshaped, ValueError, "out/bias changed"),
        ("dtype", recast, ValueError, "out/kernel changed"),
        ("list length", shorter, ValueError, "structure"),
    ]


def test_reload_params_refusals_keep_the_live_weights(tmp_path):
    pipe = _pipe()
    feats = _features()
    want = pipe.generate(feats)
    live = pipe.params
    snapshot = tree_map(torch.clone, live)
    for label, source, exc, match in _refusals(tmp_path, live):
        with pytest.raises(exc, match=match):
            pipe.reload_params(source)
        assert pipe.params is live, label
        _assert_same_params(pipe.params, snapshot)
        assert pipe.generate(feats) == want, label


def test_reload_params_swaps_weights(tmp_path):
    pipe = _pipe()
    pipe.config = dataclasses.replace(pipe.config, precision="bf16")
    feats = _features()
    pipe.generate(feats)
    assert pipe._bf16_params is not None
    retrained = _pipe(seed=5)
    retrained.save(tmp_path / "new")
    pipe.reload_params(tmp_path / "new")
    assert pipe._bf16_params is None
    _assert_same_params(pipe.params, retrained.params)
    pipe.config = retrained.config
    assert pipe.generate(feats) == retrained.generate(feats)
    # A tree of numpy arrays in the live layout is accepted too.
    tree = tree_map(lambda t: t.numpy().copy(), _pipe(seed=6).params)
    pipe.reload_params(tree)
    assert torch.equal(pipe.params["decoder"]["out"]["bias"],
                       torch.from_numpy(tree["decoder"]["out"]["bias"]))
