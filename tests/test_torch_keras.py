"""Keras ``.h5`` import and export in the port (``tpucap_torch.checkpoint``:
its own HDF5 code, ``params_from_keras`` and the decoder importers,
``export_h5``) against tpucap's (``tf_keras`` load and save), and the CLI's
``--keras-h5`` and ``export`` against tpucap's CLI, on the CPU. The only
port test file that imports tf_keras.

- Encoder import: ``tf_keras.applications`` VGG16 (its conv base at 32 x 32
  with narrow fc1 / fc2 Dense layers of the application's names), ResNet-50
  at 32 x 32 and InceptionV3 at 75 x 75, the smallest inputs they take,
  ``weights=None``, every BatchNormalization given seeded statistics; saved
  by tf_keras. The port's ``params_from_keras(path, arch)`` gives
  tpucap's tree bit for bit (``assert_array_equal`` on every leaf, equal
  dtypes); refusals raise tpucap's texts.
- Decoder import: the files tpucap's ``export_h5`` writes (merge 1 and 2
  layers, GRU merge 1 and 2, inject 1 and 2, attention) and inline Keras topologies with
  auto-names (tests/test_keras_bridge_families.py's inject and
  Show-Attend-Tell, the reference ``define_model``): trees bit for bit, then
  greedy and beam tokens of the port's decode on the imported params equal
  tpucap's at f32, scores within 1e-5.
- Export: the port's ``.h5`` loads in ``tf_keras.models.load_model``; its
  predictions equal those of tpucap's exported model bit for bit; tpucap's
  importer on it returns the params bit for bit; its parsed
  ``model_config`` and every attribute equal tpucap's file written after
  ``clear_session()``; the adaptive decoder's export is refused with
  tpucap's text.
- CLI on one fixture dataset (4 JPEGs) with the ResNet-50 file:
  ``extract --keras-h5`` features within atol 1e-5 (the CLI tests' bound)
  plus rtol 2e-6 (ResNet-50 rows reach 20), ``caption --keras-h5`` lines
  equal, ``score --keras-h5`` lines on tpucap's trained decoder and
  features equal but for logp within the f32 bound of its sum
  (``logp_bound``) and ppl within what that gives,
  ``train --finetune-encoder --keras-h5`` starts from
  the imported encoder in both packages (the tree handed to
  ``fit_finetune``, bit for bit), ``export`` files import in either package
  bit for bit, and ``--format aot`` is refused by name.
"""

import contextlib
import dataclasses
import importlib
import io
import json
import os
import re
import warnings
from pathlib import Path

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import h5py  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import tpucap.checkpoint as jcheckpoint  # noqa: E402
from test_torch_cli import _build_with_ports_weights  # noqa: E402
from tpucap.checkpoint import keras_export as jexport  # noqa: E402
from tpucap.checkpoint import keras_import as jimport  # noqa: E402
from tpucap.data import (  # noqa: E402
    generate_fixture_dataset,
    load_descriptions,
    load_split,
    prepare_descriptions,
)
from tpucap.decode import beam_decode as jax_beam_decode  # noqa: E402
from tpucap.decode import greedy_decode as jax_greedy_decode  # noqa: E402
from tpucap.models.decoders import build_decoder as jax_build_decoder  # noqa: E402
from tpucap.pipeline import CaptioningPipeline as JaxPipeline  # noqa: E402
from tpucap_torch.checkpoint import keras_export as texport  # noqa: E402
from tpucap_torch.checkpoint import keras_import as timport  # noqa: E402
from tpucap_torch.convert import params_from_jax  # noqa: E402
from tpucap_torch.decode import beam_decode, greedy_decode  # noqa: E402
from tpucap_torch.models.decoders import build_decoder  # noqa: E402
from tpucap_torch.pipeline import CaptioningPipeline  # noqa: E402
from tpucap_torch.text import load_tokenizer  # noqa: E402

from ports_init import jit_init

tf = pytest.importorskip("tensorflow")
tf_keras = pytest.importorskip("tf_keras")

torch.set_num_threads(2)

jcli = importlib.import_module("tpucap.cli.main")
tcli = importlib.import_module("tpucap_torch.cli.main")

VOCAB, FEAT, EMB, HID, MAXLEN = 23, 12, 10, 16, 7
ATT, POS, ATT_LEN = 6, 5, 4
START, END = 1, 2
SCORE_ATOL = 1e-5
# ResNet-50 rows reach |x| ~ 20, where XLA's and torch's summation orders
# differ by ~1e-6 relative: the CLI tests' atol 1e-5 plus this.
FEATURE_RTOL = 2e-6
U32 = 2.0**-24  # f32 unit roundoff


def logp_bound(logp: float, n: int, vocab: int) -> float:
    """How far two f32 evaluations of one teacher-forced logp may differ:
    logp = sum over the caption's n tokens of a_t = z_t - L_t (the target's
    logit minus its row's logsumexp over ``vocab`` logits), in f32 in both
    packages. Per package, to first order in u = 2**-24:
    - the sum of n terms of one sign, in any order: (n - 1) u sum |a_t|
      = (n - 1) u |logp|;
    - each term's log-softmax (z_t - m) - log(sum exp(z_i - m)): the first
      subtraction rounds by u |z_t - m| <= u |a_t|; the normalizer, a sum
      of ``vocab`` terms in (0, 1] that is >= 1, each exp within an ulp,
      has a log off by (vocab + 1) u; the last subtraction rounds by
      u |a_t|: 2 u |a_t| + (vocab + 1) u a term.
    Together u ((n + 1) |logp| + n (vocab + 1)); two packages differ by at
    most twice that. The logits feeding them also carry their forward
    pass's rounding: on identical inputs the packages' logits differed by
    at most 4.5 ulps of the largest, which stayed inside this bound on
    every draw measured (logp from -22 to -481)."""
    return 2 * U32 * ((n + 1) * abs(logp) + n * (vocab + 1))


def _leaves(tree, path="params"):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _tree_equal(got, want):
    """Same keys, dtypes, shapes and bits."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _keras_load(path):
    return tf_keras.models.load_model(str(path), compile=False)


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------


def _seeded_batch_norms(model, seed):
    rng = np.random.default_rng(seed)
    for layer in model.layers:
        if type(layer).__name__ == "BatchNormalization":
            layer.set_weights([
                (rng.uniform(0.5, 1.5, w.shape) if "variance" in v.name or "gamma" in v.name
                 else rng.normal(0, 0.1, w.shape)).astype(np.float32)
                for w, v in zip(layer.get_weights(), layer.weights)
            ])


@pytest.fixture(scope="module")
def encoder_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("encoders")
    apps, L = tf_keras.applications, tf_keras.layers
    base = apps.VGG16(include_top=False, weights=None, input_shape=(32, 32, 3))
    x = L.Flatten(name="flatten")(base.output)
    x = L.Dense(8, activation="relu", name="fc1")(x)
    x = L.Dense(8, activation="relu", name="fc2")(x)
    models = {
        "vgg16": tf_keras.Model(base.input, x, name="vgg16"),
        "resnet50": apps.ResNet50(include_top=False, weights=None, input_shape=(32, 32, 3)),
        "inception_v3": apps.InceptionV3(include_top=False, weights=None, input_shape=(75, 75, 3)),
    }
    paths = {}
    for i, (arch, model) in enumerate(models.items()):
        _seeded_batch_norms(model, i)
        paths[arch] = root / f"{arch}.h5"
        model.save(paths[arch], save_format="h5")
    weights_only = root / "weights_only.h5"
    models["resnet50"].save_weights(weights_only)
    paths["weights_only"] = weights_only
    tf_keras.backend.clear_session()
    return paths


@pytest.mark.parametrize("arch,kw", [
    ("vgg16", {}), ("vgg16", {"features": "spatial"}), ("resnet50", {}), ("inception_v3", {}),
], ids=["vgg16_fc2", "vgg16_spatial", "resnet50", "inception_v3"])
def test_encoder_import_matches_tpucap(encoder_files, arch, kw):
    path = encoder_files[arch]
    model = _keras_load(path)  # what tpucap's params_from_keras(path) loads
    want = jimport.params_from_keras(model, arch, **kw)
    got = timport.params_from_keras(str(path), arch, **kw)
    _tree_equal(got, want)
    view = timport.KerasH5Model(path)
    _tree_equal(timport.params_from_keras(view, arch, **kw), want)
    # The view keeps model.layers order and each layer's class.
    assert [(l.name, l.class_name) for l in view.layers] == [
        (l.name, type(l).__name__) for l in model.layers]
    if arch == "inception_v3":
        convs = [l.name for l in view.layers if l.class_name == "Conv2D"]
        assert convs != sorted(convs, key=lambda n: int(n.rsplit("_", 1)[-1]) if "_" in n else 0)
    tf_keras.backend.clear_session()


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("arch", ["vit_b16", "tiny_cnn"])
def test_encoder_import_refuses_an_unknown_arch(encoder_files, arch):
    path = str(encoder_files["vgg16"])
    want = _error(lambda: jimport.params_from_keras(path, arch))
    assert want.startswith("unknown arch")
    assert _error(lambda: timport.params_from_keras(path, arch)) == want
    tf_keras.backend.clear_session()


def test_import_refuses_a_weights_only_file(encoder_files):
    path = str(encoder_files["weights_only"])
    # tf_keras names the file by its GFile object; the port by its path.
    stem = "No model config found in the file at "
    assert _error(lambda: jimport.params_from_keras(path, "resnet50")).startswith(stem)
    assert _error(lambda: timport.params_from_keras(path, "resnet50")) == f"{stem}{path}."


# ---------------------------------------------------------------------------
# Decoders
# ---------------------------------------------------------------------------

FAMILIES = {
    "merge1": ("lstm1", {}, {}),
    "merge2": ("lstm2", {}, {}),
    "gru1": ("gru1", {}, {}),
    "gru2": ("gru2", {}, {}),
    "inject1": ("inject", {}, {}),
    "inject2": ("inject", {"num_layers": 2}, {}),
    "attention": ("attention", {"attention_dim": ATT}, {"positions": POS}),
    "attention_len1": ("attention", {"attention_dim": ATT}, {"positions": POS}),
}
IMPORTERS = {
    "lstm1": "merge_decoder_params_from_keras",
    "lstm2": "merge_decoder_params_from_keras",
    "gru1": "gru_merge_decoder_params_from_keras",
    "gru2": "gru_merge_decoder_params_from_keras",
    "inject": "inject_decoder_params_from_keras",
    "attention": "attention_decoder_params_from_keras",
}


def _decoders(case, seed=0):
    name, extra, _ = FAMILIES[case]
    dims = dict(vocab_size=VOCAB, feature_dim=FEAT, embed_dim=EMB, hidden_dim=HID, **extra)
    jdec, tdec = jax_build_decoder(name, **dims), build_decoder(name, **dims)
    jp = jax.tree.map(np.asarray, jit_init(jdec, jax.random.key(seed)))
    jp["out"]["bias"] = jp["out"]["bias"] + np.eye(VOCAB, dtype=np.float32)[END] * 0.15
    return name, jdec, jp, tdec


def _max_len(case):
    """The exported model's token length (the attention graph unrolls it)."""
    return {"attention": ATT_LEN, "attention_len1": 1}.get(case, MAXLEN)


def _features(name, batch, seed):
    shape = (batch, POS, FEAT) if name == "attention" else (batch, FEAT)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _inputs(case):
    name = FAMILIES[case][0]
    toks = np.random.default_rng(4).integers(1, VOCAB, size=(3, _max_len(case)))
    return [tf.constant(_features(name, 3, 4)), tf.constant(toks.astype(np.float32))]


@pytest.fixture(scope="module")
def tpucap_exports(tmp_path_factory):
    """Each family's file as tpucap's ``export_h5`` writes it (the model
    built after ``clear_session()`` and saved), with the model's outputs on
    ``_inputs(case)`` and tpucap's importer on the model."""
    root = tmp_path_factory.mktemp("exports")
    out = {}
    for case in FAMILIES:
        name, jdec, jp, _ = _decoders(case, seed=3)
        tf_keras.backend.clear_session()
        model = jexport.decoder_to_keras(jdec, jp, max_len=_max_len(case), **FAMILIES[case][2])
        path = root / f"{case}.h5"
        model.save(str(path), save_format="h5")
        out[case] = {
            "path": path,
            "probs": model(_inputs(case), training=False).numpy(),
            "tree": getattr(jimport, IMPORTERS[name])(model),
        }
    tf_keras.backend.clear_session()
    return out


def _decodes_equal(name, jdec, tdec, params, seed):
    """Greedy and beam tokens of the port on ``params`` (tpucap layout)
    equal tpucap's, at f32."""
    feats = _features(name, 5, seed)
    tp = params_from_jax(params)
    js = jdec.init_state(params, jnp.asarray(feats))
    ts = tdec.init_state(tp, torch.from_numpy(feats))
    kw = dict(start_id=START, end_id=END, max_len=MAXLEN)
    pairs = [
        (jax_greedy_decode(jdec.step, params, js, **kw), greedy_decode(tdec.step, tp, ts, **kw)),
        (jax_beam_decode(jdec.step, params, js, beam_width=3, decoder=jdec, **kw),
         beam_decode(tdec.step, tp, ts, beam_width=3, decoder=tdec, **kw)),
    ]
    for ref, got in pairs:
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
        np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=SCORE_ATOL)


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_decoder_import_of_tpucaps_export(tpucap_exports, case):
    name, jdec, jp, tdec = _decoders(case, seed=3)
    ref = tpucap_exports[case]
    got = getattr(timport, IMPORTERS[name])(timport.KerasH5Model(ref["path"]))
    _tree_equal(got, ref["tree"])
    _tree_equal(got, jp)
    _decodes_equal(name, jdec, tdec, got, seed=1)


def _merge_auto(L, feat=FEAT):
    """The reference define_model with Keras auto-names."""
    inputs1 = L.Input(shape=(feat,))
    fe = L.Dense(HID, activation="relu")(L.Dropout(0.5)(inputs1))
    inputs2 = L.Input(shape=(MAXLEN,))
    se = L.Dropout(0.5)(L.Embedding(VOCAB, EMB, mask_zero=True)(inputs2))
    se = L.LSTM(HID)(se)
    d = L.Dense(HID, activation="relu")(L.add([fe, se]))
    return tf_keras.Model([inputs1, inputs2], L.Dense(VOCAB, activation="softmax")(d))


def _inject_auto(L):
    """tests/test_keras_bridge_families.py's keras_inject_model."""
    inputs1 = L.Input(shape=(FEAT,))
    h0 = L.Dense(HID, activation="tanh")(inputs1)
    c0 = L.Dense(HID, activation="tanh")(inputs1)
    inputs2 = L.Input(shape=(MAXLEN,))
    se = L.Embedding(VOCAB, EMB, mask_zero=True)(inputs2)
    se = L.Dropout(0.5)(se)
    x = L.LSTM(HID)(se, initial_state=[h0, c0])
    d = L.Dense(HID, activation="relu")(x)
    return tf_keras.Model([inputs1, inputs2], L.Dense(VOCAB, activation="softmax")(d))


def _sat_auto(L):
    """tests/test_keras_bridge_families.py's keras_sat_model."""
    feats_in = L.Input(shape=(POS, FEAT))
    toks_in = L.Input(shape=(ATT_LEN,))
    att_feat, att_hidden, att_score = L.Dense(ATT), L.Dense(ATT), L.Dense(1)
    gate = L.Dense(FEAT, activation="sigmoid")
    init_h = L.Dense(HID, activation="tanh")
    init_c = L.Dense(HID, activation="tanh")
    embedding = L.Embedding(VOCAB, EMB)
    step_rnn = L.RNN(tf_keras.layers.LSTMCell(HID), return_state=True)
    pre_out = L.Dense(HID, activation="relu")
    out = L.Dense(VOCAB, activation="softmax")
    mean_feat = L.GlobalAveragePooling1D()(feats_in)
    h, c = init_h(mean_feat), init_c(mean_feat)
    pfeat = att_feat(feats_in)
    se = embedding(toks_in)
    probs = []
    for t in range(ATT_LEN):
        wh = L.RepeatVector(POS)(att_hidden(h))
        e = att_score(L.Activation("tanh")(L.Add()([pfeat, wh])))
        alpha = L.Softmax(axis=1)(e)
        ctx = L.Reshape((FEAT,))(L.Dot(axes=1)([alpha, feats_in]))
        ctx = L.Multiply()([gate(h), ctx])
        x_t = L.Reshape((EMB,))(L.Cropping1D((t, ATT_LEN - t - 1))(se))
        step_in = L.Reshape((1, EMB + FEAT))(L.Concatenate()([x_t, ctx]))
        _, h, c = step_rnn(step_in, initial_state=[h, c])
        merged = pre_out(L.Concatenate()([h, ctx]))
        probs.append(L.Reshape((1, VOCAB))(out(merged)))
    return tf_keras.Model([feats_in, toks_in], L.Concatenate(axis=1)(probs))


AUTO = {
    "merge_auto": ("lstm1", {}, lambda L: _merge_auto(L)),
    "merge_auto_square": ("lstm1", {}, lambda L: _merge_auto(L, feat=HID)),
    "inject_auto": ("inject", {}, _inject_auto),
    "attention_auto": ("attention", {"attention_dim": ATT}, _sat_auto),
}


@pytest.mark.parametrize("case", sorted(AUTO))
def test_decoder_import_of_auto_named_topologies(tmp_path, case):
    name, extra, make = AUTO[case]
    model = make(tf_keras.layers)
    path = tmp_path / f"{case}.h5"
    model.save(str(path), save_format="h5")
    importer = IMPORTERS[name]
    want = getattr(jimport, importer)(_keras_load(path))
    got = getattr(timport, importer)(timport.KerasH5Model(path))
    _tree_equal(got, want)
    feat = HID if case == "merge_auto_square" else FEAT
    dims = dict(vocab_size=VOCAB, feature_dim=feat, embed_dim=EMB, hidden_dim=HID, **extra)
    jdec, tdec = jax_build_decoder(name, **dims), build_decoder(name, **dims)
    if case != "merge_auto_square":
        _decodes_equal(name, jdec, tdec, got, seed=2)
    tf_keras.backend.clear_session()


def test_attention_import_refuses_ambiguous_dims(tmp_path):
    """H == A with the canonical names stripped: both packages refuse with
    the same words."""
    dims = dict(vocab_size=VOCAB, feature_dim=FEAT, embed_dim=EMB, hidden_dim=HID,
                attention_dim=HID)
    jdec = jax_build_decoder("attention", **dims)
    model = jexport.attention_decoder_to_keras(
        jdec, jit_init(jdec, jax.random.key(6)), max_len=3, positions=POS)
    for i, layer in enumerate(model.layers):
        if type(layer).__name__ == "Dense":
            layer._name = f"anon_{i}"
    path = tmp_path / "ambiguous.h5"
    model.save(str(path), save_format="h5")
    # (tf_keras's load of a model renamed after its build does not finish.)
    want = _error(lambda: jimport.attention_decoder_params_from_keras(model))
    assert "ambiguous dims" in want
    assert _error(lambda: timport.attention_decoder_params_from_keras(
        timport.KerasH5Model(path))) == want
    tf_keras.backend.clear_session()


def _attrs(path):
    """Every attribute of the file but model_config, and the parsed config."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            for k, v in obj.attrs.items():
                out[f"{name}@{k}"] = v.tolist() if isinstance(v, np.ndarray) else v
        visit("/", f)
        f.visititems(visit)
        config = json.loads(out.pop("/@model_config"))
    return out, config


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_export_matches_tpucaps(tmp_path, tpucap_exports, case):
    name, jdec, jp, tdec = _decoders(case, seed=3)
    ext = FAMILIES[case][2]
    theirs = tpucap_exports[case]["path"]
    ours = tmp_path / f"{case}_port.h5"
    texport.export_h5(tdec, params_from_jax(jp), str(ours), max_len=_max_len(case), **ext)
    got_attrs, got_config = _attrs(ours)
    want_attrs, want_config = _attrs(theirs)
    assert got_config == want_config
    assert got_attrs == want_attrs
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        names = []
        a.visit(names.append)
        want_names = []
        b.visit(want_names.append)
        assert sorted(names) == sorted(want_names)
        for n in names:
            if isinstance(b[n], h5py.Dataset):
                assert a[n].dtype == b[n].dtype
                np.testing.assert_array_equal(a[n][()], b[n][()])
    tf_keras.backend.clear_session()
    loaded = _keras_load(ours)
    np.testing.assert_array_equal(
        loaded(_inputs(case), training=False).numpy(), tpucap_exports[case]["probs"])
    _tree_equal(getattr(jimport, IMPORTERS[name])(loaded), jp)
    tf_keras.backend.clear_session()


def test_export_refuses_other_families():
    dec = build_decoder("lstm1", vocab_size=VOCAB, feature_dim=FEAT)
    params = dec.init(torch.Generator().manual_seed(0))
    for fn, want in [
        (texport.inject_decoder_to_keras, "inject export needs an InjectDecoder; got MergeDecoder"),
        (texport.attention_decoder_to_keras, "attention export needs an AttentionDecoder"),
        (texport.gru_merge_decoder_to_keras, "gru export needs a GruMergeDecoder; got MergeDecoder"),
    ]:
        with pytest.raises(ValueError, match=want):
            fn(dec, params, max_len=3)

    class TransformerDecoder:
        pass

    with pytest.raises(ValueError, match="no Keras topology for TransformerDecoder"):
        texport.export_h5(TransformerDecoder(), params, "x.h5", max_len=3)
    # The adaptive family has no Keras topology: tpucap's text.
    dims = dict(vocab_size=VOCAB, feature_dim=FEAT, attention_dim=ATT)
    with pytest.raises(ValueError) as jerr:
        jexport.decoder_to_keras(jax_build_decoder("adaptive", **dims), {}, max_len=3)
    adaptive = build_decoder("adaptive", **dims)
    with pytest.raises(ValueError) as err:
        texport.export_h5(adaptive, adaptive.init(torch.Generator().manual_seed(0)), "x.h5", max_len=3)
    assert str(err.value) == str(jerr.value)
    assert str(err.value).startswith("no Keras topology for AdaptiveAttentionDecoder; have [")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

MODEL = ["--encoder", "resnet50", "--embed-dim", "16", "--hidden-dim", "16", "--max-len", "12"]


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, encoder_files):
    """Both CLIs on one dataset with the ResNet-50 file. tpucap's ``build``
    installs the port's seeded weights (``_build_with_ports_weights``), so
    both trainings start from one decoder, and both train with dropout 0 on
    tpucap's extracted features, so the checkpoints agree; tpucap's Keras
    read is made once a file; ``fit_finetune`` is replaced in both packages
    by a recorder of the encoder it is handed."""
    root = tmp_path_factory.mktemp("cli_keras")
    img_dir, tokens, train, _ = generate_fixture_dataset(
        root / "data", n_images=4, image_size=32, seed=5)
    images = sorted(str(p) for p in Path(img_dir).glob("*.jpg"))
    # Cleaned training captions: every word in the vocabulary.
    scored = [c.removeprefix("startseq ").removesuffix(" endseq") for caps in prepare_descriptions(
        load_descriptions(tokens), load_split(train)).values() for c in caps][: len(images)]
    h5 = str(encoder_files["resnet50"])
    feats = str(root / "tpucap" / "features.npz")
    recorded, started, phase = {}, {}, {"score": False}

    def no_dropout(build_config):
        def build(args):
            cfg = build_config(args)
            return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, dropout_rate=0.0))
        return build

    # tpucap's Keras read, once a file and arch (each command reads it
    # again: tf_keras's load of the ResNet-50 file takes seconds).
    keras_reads = {}

    def cached_keras_read(orig):
        def read(path, arch, **kw):
            key = (str(path), arch, tuple(sorted(kw.items())))
            if key not in keras_reads:
                keras_reads[key] = orig(path, arch, **kw)
            return jax.tree.map(jnp.array, keras_reads[key])
        return read

    # score: the port's command scores tpucap's trained decoder on tpucap's
    # features, so that its lines differ from tpucap's by the score path's
    # rounding only. Each CLI trains its own decoder (6 Adam steps at lr
    # 0.01 from one start): the trees differ by up to 2.2e-6, which moved
    # logp by up to 2e-4 at |logp| ~ 130 on a measured draw. The port's own
    # features are kept for the extract tolerance check.
    def score_recorder(orig):
        def score_captions(self, features, captions):
            if phase["score"]:
                recorded["score"] = (np.asarray(features), jax.tree.map(np.array, self.params["decoder"]))
            return orig(self, features, captions)
        return score_captions

    def score_installer(orig):
        def score_captions(self, features, captions):
            if not phase["score"]:
                return orig(self, features, captions)
            feats, dec = recorded["score"]
            recorded["port_score_features"] = np.asarray(features)
            self.set_params({**self.params, "decoder": params_from_jax(dec)})
            return orig(self, feats, captions)
        return score_captions

    def fit_finetune_recorder(pkg):
        def fit_finetune(self, *a, **k):
            started[pkg] = jax.tree.map(np.array, self.params["encoder"])
            raise _Stop
        return fit_finetune

    def commands(out):
        ckpt = f"{out}/ckpt"
        return {
            "extract": ["extract", *MODEL, "--images", str(img_dir), "--out", f"{out}/features.npz",
                        "--batch-size", "4", "--keras-h5", h5],
            "train": ["train", *MODEL, "--tokens", tokens, "--split", train, "--features", feats,
                      "--checkpoint-dir", ckpt, "--epochs", "2", "--batch-size", "4", "--lr", "0.01",
                      "--keras-h5", h5],
            "caption": ["caption", *MODEL, "--image", *images, "--checkpoint-dir", ckpt,
                        "--keras-h5", h5],
            "score": ["score", *MODEL, "--image", *images, "--checkpoint-dir", ckpt,
                      "--keras-h5", h5, *[a for c in scored for a in ("--caption", c)]],
            "export": ["export", *MODEL, "--checkpoint-dir", ckpt, "--out", f"{out}/decoder.h5",
                       "--method", "beam", "--beam-width", "2"],
            "finetune": ["train", *MODEL, "--tokens", tokens, "--split", train,
                         "--finetune-encoder", "--images", str(img_dir), "--checkpoint-dir",
                         f"{out}/ft", "--epochs", "1", "--batch-size", "4", "--keras-h5", h5],
        }

    mains = {"tpucap": jcli.main, "port": lambda argv: tcli.main(argv, device="cpu")}
    result = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "_build_config", no_dropout(jcli._build_config))
        mp.setattr(tcli, "_build_config", no_dropout(tcli._build_config))
        # Both packages build the port's seeded weights (its decoder is the
        # start of both trainings).
        mp.setattr(JaxPipeline, "build", _build_with_ports_weights(JaxPipeline.build))
        mp.setattr(jcheckpoint, "params_from_keras", cached_keras_read(jcheckpoint.params_from_keras))
        mp.setattr(JaxPipeline, "fit_finetune", fit_finetune_recorder("tpucap"))
        mp.setattr(CaptioningPipeline, "fit_finetune", fit_finetune_recorder("port"))
        mp.setattr(JaxPipeline, "score_captions", score_recorder(JaxPipeline.score_captions))
        mp.setattr(CaptioningPipeline, "score_captions", score_installer(CaptioningPipeline.score_captions))
        for pkg, main in mains.items():
            out = root / pkg
            out.mkdir(exist_ok=True)
            result[pkg] = {"out": out}
            for name, argv in commands(out).items():
                phase["score"] = name == "score"
                stdout, stderr = io.StringIO(), io.StringIO()
                with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr), \
                        warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    try:
                        main(argv)
                    except _Stop:
                        pass
                result[pkg][name] = tuple(
                    [ln.replace(str(out), "<out>") for ln in s.getvalue().splitlines()
                     if "absl" not in ln and "UserWarning" not in ln]
                    for s in (stdout, stderr))
    result["finetune"] = started
    result["score_features"] = (recorded["score"][0], recorded["port_score_features"])
    tf_keras.backend.clear_session()
    return result


def test_cli_extract_with_keras_h5_matches_tpucap(cli_runs, encoder_files):
    ours, theirs = cli_runs["port"], cli_runs["tpucap"]
    assert ours["extract"][0] == theirs["extract"][0] == ["wrote 4 features to <out>/features.npz"]
    got = np.load(ours["out"] / "features.npz")
    want = np.load(theirs["out"] / "features.npz")
    assert got.files == want.files
    for k in want.files:
        assert got[k].dtype == np.float32 and got[k].shape == (2048,)
        np.testing.assert_allclose(got[k], want[k], rtol=FEATURE_RTOL, atol=1e-5)
        assert np.abs(want[k]).max() > 1e-3


def test_cli_caption_with_keras_h5_matches_tpucap(cli_runs):
    ours, theirs = cli_runs["port"], cli_runs["tpucap"]
    assert ours["caption"][0] == theirs["caption"][0] and len(ours["caption"][0]) == 4
    assert not [ln for ln in ours["caption"][1] + theirs["caption"][1] if "no --keras-h5" in ln]


_NUMBER = re.compile(r"-?\d+\.(\d+)")


_SCORED = re.compile(r"\tlogp=(-?\d+\.\d{4})\tppl=(\d+\.\d{3})\ttokens=(\d+)\t")


def test_cli_score_with_keras_h5_matches_tpucap(cli_runs):
    """The lines on tpucap's trained decoder and features: logp within
    ``logp_bound`` plus the print's rounding (4 decimals, half a unit
    each side), ppl = exp(-logp / n) within what that logp tolerance
    gives plus its own print's rounding. The port's own features within
    the extract test's tolerance."""
    got, want = cli_runs["port"]["score"][0], cli_runs["tpucap"]["score"][0]
    assert len(got) == len(want) == 4
    vocab = load_tokenizer(str(cli_runs["port"]["out"] / "ckpt" / "tokenizer.json")).vocab_size
    for g, w in zip(got, want):
        assert _NUMBER.sub("#", g) == _NUMBER.sub("#", w), (g, w)
        (lp, ppl, n), (wlp, wppl, wn) = (_SCORED.search(x).groups() for x in (g, w))
        assert n == wn
        n, wlp, wppl = int(n), float(wlp), float(wppl)
        tol = logp_bound(wlp, n, vocab) + 1e-4
        assert abs(float(lp) - wlp) <= tol, (g, w, tol)
        assert abs(float(ppl) - wppl) <= wppl * np.expm1(tol / n) + 1e-3, (g, w)
    theirs, ours = cli_runs["score_features"]
    np.testing.assert_allclose(ours, theirs, rtol=FEATURE_RTOL, atol=1e-5)


def test_cli_finetune_starts_from_the_keras_encoder(cli_runs, encoder_files):
    started = cli_runs["finetune"]
    want = jimport.params_from_keras(str(encoder_files["resnet50"]), "resnet50")
    _tree_equal(started["tpucap"], want)
    _tree_equal(started["port"], jax.tree.map(lambda t: t.numpy(), params_from_jax(want)))
    tf_keras.backend.clear_session()


def test_cli_export_files_import_in_either_package(cli_runs):
    for pkg in ("port", "tpucap"):
        lines = cli_runs[pkg]["export"][0]
        assert lines == ["wrote Keras h5 decoder to <out>/decoder.h5"]
        path = cli_runs[pkg]["out"] / "decoder.h5"
        want = jimport.merge_decoder_params_from_keras(_keras_load(path))
        _tree_equal(timport.merge_decoder_params_from_keras(timport.KerasH5Model(path)), want)
    a, b = (_attrs(cli_runs[p]["out"] / "decoder.h5") for p in ("port", "tpucap"))
    assert a == b
    tf_keras.backend.clear_session()


def test_cli_export_refuses_aot_by_name(tmp_path):
    with pytest.raises(SystemExit, match="^--format aot: not ported"):
        tcli.main(["export", "--checkpoint-dir", str(tmp_path / "absent"), "--out",
                   str(tmp_path / "x"), "--format", "aot"], device="cpu")
    assert not (tmp_path / "absent").exists()
