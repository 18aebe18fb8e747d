"""Import Keras ``.h5`` weights into tpucap-layout numpy param trees,
without h5py, TensorFlow or Keras: the port's copy of
``tpucap.checkpoint.keras_import``.

``KerasH5Model(path)`` opens a full-model ``.h5`` file (what Keras's
``model.save(..., save_format="h5")`` writes) with the port's own HDF5
reader (``hdf5.py``) as a light view of the Keras model: ``layers`` in
``model.layers`` order (the file's ``layer_names``), each with its
``name``, its class (``class_name``, from ``model_config``), its config
(the keys the importers read: ``use_bias``, BatchNormalization's
``scale`` and ``center``, an ``RNN``'s ``cell``) and ``get_weights()`` in
the file's ``weight_names`` order. A weights-only file (no
``model_config``) is refused, as Keras's ``load_model`` refuses it.

The importers below are tpucap's, rule for rule, on that view:

- VGG16 / ResNet-50: matched by Keras layer *names* (stable in the Keras
  source; the param keys are identical).
- InceptionV3: matched by layer *order* (Keras auto-names those layers with
  process-global counters, so names aren't reproducible; creation order is —
  the ``conv_{i}`` keys follow the same source order).
- The merge (LSTM and GRU), inject and attention decoders: by topology and
  kernel shape.

Kernel layouts need no transposition: Keras stores Conv2D kernels HWIO and
Dense kernels (in, out), tpucap's layouts; ``convert.params_from_jax`` turns
such a tree into the port's tensors (conv kernels OIHW).
"""

from __future__ import annotations

import json
import os

import numpy as np

from tpucap_torch.checkpoint import hdf5


def _attr_list(group, name: str) -> list[str]:
    """A string-list attribute as Keras reads it: ``name``, or its chunks
    ``name0``, ``name1``, ... (Keras splits a list larger than an object
    header message holds)."""
    if name in group.attrs:
        chunks = [group.attrs[name]]
    else:
        chunks, i = [], 0
        while f"{name}{i}" in group.attrs:
            chunks.append(group.attrs[f"{name}{i}"])
            i += 1
    # An empty list reads back as an empty float array.
    return [
        n.decode("utf8") if hasattr(n, "decode") else n
        for chunk in chunks
        for n in np.atleast_1d(chunk)
    ]


class _KerasCell:
    """An RNN layer's cell, from its config: only its class is read."""

    def __init__(self, config: dict):
        self.class_name = config.get("class_name")


class KerasLayer:
    """One layer of a ``KerasH5Model``: ``name``, ``class_name``,
    ``config`` and ``get_weights()``; a config key reads as an attribute
    (``layer.use_bias``, ``layer.scale``, ``layer.cell``)."""

    def __init__(self, name: str, class_name: str, config: dict, weights: list):
        self.name = name
        self.class_name = class_name
        self.config = config
        self._weights = weights

    def get_weights(self) -> list:
        return list(self._weights)

    def __getattr__(self, key):
        config = self.__dict__.get("config", {})
        if key not in config:
            raise AttributeError(key)
        if key == "cell" and isinstance(config[key], dict):
            return _KerasCell(config[key])
        return config[key]


class KerasH5Model:
    """A Keras full-model ``.h5`` file read as a light model: ``layers``
    (``KerasLayer``s in ``model.layers`` order) and ``model_config`` (the
    parsed JSON). Every weight is read when the file is opened, each in one
    read at its offset."""

    def __init__(self, path):
        path = os.fspath(path)
        with hdf5.File(path) as f:
            raw = f.attrs.get("model_config")
            if raw is None:
                raise ValueError(f"No model config found in the file at {path}.")
            if hasattr(raw, "decode"):
                raw = raw.decode("utf-8")
            self.model_config = json.loads(raw)
            if "model_weights" not in f:
                raise ValueError(f"no model_weights group in {path}")
            mw = f["model_weights"]
            cfg = self.model_config.get("config", {})
            entries = cfg.get("layers", []) if isinstance(cfg, dict) else cfg
            by_name = {e.get("name") or e.get("config", {}).get("name"): e for e in entries}
            self.layers = []
            for name in _attr_list(mw, "layer_names"):
                if name not in by_name:
                    raise ValueError(f"layer {name!r} of {path} is not in its model_config")
                entry = by_name[name]
                g = mw[name]
                weights = [g[w].read() for w in _attr_list(g, "weight_names")]
                self.layers.append(
                    KerasLayer(name, entry["class_name"], entry.get("config", {}), weights)
                )


def _conv_params(layer):
    w = layer.get_weights()
    p = {"kernel": np.asarray(w[0])}
    if getattr(layer, "use_bias", True) and len(w) > 1:
        p["bias"] = np.asarray(w[1])
    return p


def _dense_params(layer):
    w = layer.get_weights()
    return {"kernel": np.asarray(w[0]), "bias": np.asarray(w[1])}


def _bn_params(layer):
    w = [np.asarray(x) for x in layer.get_weights()]
    scale = getattr(layer, "scale", True)
    center = getattr(layer, "center", True)
    out = {}
    i = 0
    if scale:
        out["gamma"] = w[i]
        i += 1
    if center:
        out["beta"] = w[i]
        i += 1
    else:
        out["beta"] = np.zeros_like(w[i])
    out["mean"] = w[i]
    out["var"] = w[i + 1]
    return out


def _layer_type(layer) -> str:
    return getattr(layer, "class_name", None) or type(layer).__name__


def vgg16_params_from_keras(model, features: str = "fc2") -> dict:
    by_name = {l.name: l for l in model.layers}
    params = {}
    for name, layer in by_name.items():
        if _layer_type(layer) == "Conv2D":
            params[name] = _conv_params(layer)
    if features == "fc2":
        for name in ("fc1", "fc2"):
            params[name] = _dense_params(by_name[name])
    return params


def resnet50_params_from_keras(model) -> dict:
    params = {}
    for layer in model.layers:
        t = _layer_type(layer)
        if t == "Conv2D":
            params[layer.name] = _conv_params(layer)
        elif t == "BatchNormalization":
            params[layer.name] = _bn_params(layer)
    return params


def _creation_index(layer) -> int:
    """Creation order encoded in Keras auto-names ('conv2d', 'conv2d_7', ...).

    model.layers is *topologically* sorted (branches interleaved), but the
    auto-name counter increments at layer construction, i.e. source statement
    order — which is the order tpucap's InceptionV3 uses for conv_{i} keys.
    """
    suffix = layer.name.rsplit("_", 1)[-1]
    return int(suffix) if suffix.isdigit() else 0


def inception_v3_params_from_keras(model) -> dict:
    convs = sorted(
        (l for l in model.layers if _layer_type(l) == "Conv2D"),
        key=_creation_index,
    )
    bns = sorted(
        (
            l
            for l in model.layers
            if _layer_type(l) == "BatchNormalization"
        ),
        key=_creation_index,
    )
    if len(convs) != len(bns):
        raise ValueError(
            f"conv/bn count mismatch: {len(convs)} vs {len(bns)}"
        )
    params = {}
    for i, (c, b) in enumerate(zip(convs, bns)):
        params[f"conv_{i}"] = {
            "conv": _conv_params(c),
            "bn": _bn_params(b),
        }
    return params


def _merge_params(model, rnn_class: str, check_cell=None) -> dict:
    """The merge topology's params, its recurrent layers those of class
    ``rnn_class`` in model.layers order (``check_cell`` sees each one's
    weights first). Dense layers are told apart by kernel shape: the
    vocab-wide one is ``out``; of the other two, the one whose input is not
    the hidden width is the image branch's, else model.layers order (depth
    order: the image branch first)."""
    embeddings = [l for l in model.layers if _layer_type(l) == "Embedding"]
    rnns = [l for l in model.layers if _layer_type(l) == rnn_class]
    denses = [l for l in model.layers if _layer_type(l) == "Dense"]
    if len(embeddings) != 1 or not rnns:
        raise ValueError(
            f"unexpected topology: {len(embeddings)} embeddings, "
            f"{len(rnns)} {rnn_class.lower()}s"
        )
    table = np.asarray(embeddings[0].get_weights()[0])
    vocab = table.shape[0]
    hidden = rnns[0].get_weights()[1].shape[0]  # recurrent kernel (U, gU)

    out = None
    hidden_denses = []
    for l in denses:
        dout = l.get_weights()[0].shape[1]
        if dout == vocab and out is None:
            out = _dense_params(l)
        else:
            hidden_denses.append(l)
    if out is None or len(hidden_denses) != 2:
        raise ValueError("could not identify the three Dense layers")
    a, b = hidden_denses
    if a.get_weights()[0].shape[0] != hidden:
        feat_proj, pre_out = _dense_params(a), _dense_params(b)
    elif b.get_weights()[0].shape[0] != hidden:
        feat_proj, pre_out = _dense_params(b), _dense_params(a)
    else:
        feat_proj, pre_out = _dense_params(a), _dense_params(b)

    cells = []
    for l in rnns:
        w = l.get_weights()
        if check_cell is not None:
            check_cell(w)
        cells.append(
            {
                "kernel": np.asarray(w[0]),
                "recurrent": np.asarray(w[1]),
                "bias": np.asarray(w[2]),
            }
        )
    return {
        "feat_proj": feat_proj,
        "embedding": {"table": table},
        "cells": cells,
        "pre_out": pre_out,
        "out": out,
    }


def merge_decoder_params_from_keras(model) -> dict:
    """Import a reference-style Keras merge caption model into MergeDecoder
    params (SURVEY.md §2.1 #6; §5.4 '.h5->orbax import tool for parity
    testing against reference checkpoints').

    Expected topology (the genre-standard `define_model`):
        Dense(feature_dim -> hidden, relu)   image branch ('feat_proj')
        Embedding(vocab, embed)              token branch
        LSTM(hidden) (x1 or x2 stacked)      token branch
        Dense(hidden -> hidden, relu)        after add ('pre_out')
        Dense(hidden -> vocab, softmax)      output ('out')

    Dense layers are disambiguated by kernel shape; LSTMs by model.layers
    (topological) order, which for a stack equals depth order.
    """
    return _merge_params(model, "LSTM")


def _reset_after_weights(w) -> None:
    if len(w) != 3 or np.asarray(w[2]).ndim != 2:
        raise ValueError(
            "expected reset_after=True GRU weights [kernel, "
            f"recurrent, bias (2, 3U)]; got {[x.shape for x in w]} — "
            "reset_after=False checkpoints use different cell math "
            "and cannot import weight-for-weight"
        )


def gru_merge_decoder_params_from_keras(model) -> dict:
    """Import a merge-topology Keras GRU caption model into GruMergeDecoder
    params: :func:`merge_decoder_params_from_keras` with GRU(h) in place of
    LSTM(h). Keras GRU-v2 weights are [kernel (E, 3U), recurrent (U, 3U),
    bias (2, 3U)] with reset_after=True, the port's own layout
    (``models/layers.py::init_gru_cell``); the GRU layers are taken in
    model.layers order and the hidden width from the recurrent kernel."""
    return _merge_params(model, "GRU", _reset_after_weights)


def _lstm_weight_layers(model):
    """LSTM-bearing layers in topological order: plain LSTM layers and
    RNN(LSTMCell) wrappers (the stepwise attention topology)."""
    out = []
    for l in model.layers:
        t = _layer_type(l)
        if t == "LSTM" or (
            t == "RNN" and _layer_type(getattr(l, "cell", None)) == "LSTMCell"
        ):
            out.append(l)
    return out


def inject_decoder_params_from_keras(model) -> dict:
    """Import a genre-standard init-inject Keras caption model into
    InjectDecoder params (SURVEY.md §2.1 #7).

    Expected topology (keras_export.inject_decoder_to_keras builds the
    same one):
        Dense(feature_dim -> hidden, tanh) x2    'init_h'/'init_c'
        Embedding(vocab, embed)                  token branch
        LSTM(hidden) stack, each layer taking initial_state=[h0, c0]
        Dense(hidden -> hidden, relu)            'pre_out'
        Dense(hidden -> vocab, softmax)          'out'

    The two init Denses are taken by name when present; otherwise by
    topological order (model.layers places the initial_state producers
    before the LSTM that consumes them, and Keras preserves their
    creation order h-before-c — the convention this module's exporter
    and the genre's init-inject scripts share).
    """
    embeddings = [l for l in model.layers if _layer_type(l) == "Embedding"]
    lstms = _lstm_weight_layers(model)
    denses = [l for l in model.layers if _layer_type(l) == "Dense"]
    if len(embeddings) != 1 or not lstms:
        raise ValueError(
            f"unexpected topology: {len(embeddings)} embeddings, "
            f"{len(lstms)} lstms"
        )
    table = np.asarray(embeddings[0].get_weights()[0])
    vocab = table.shape[0]

    by_name = {l.name: l for l in denses}
    if {"init_h", "init_c", "pre_out", "out"} <= set(by_name):
        init_h = _dense_params(by_name["init_h"])
        init_c = _dense_params(by_name["init_c"])
        pre = _dense_params(by_name["pre_out"])
        out = _dense_params(by_name["out"])
    else:
        # Topological order (NOT shape — hidden_dim can equal vocab):
        # both state producers precede the first LSTM; after it come
        # pre_out then out, in dependency order.
        first_lstm = model.layers.index(lstms[0])
        pre_lstm = [l for l in denses if model.layers.index(l) < first_lstm]
        post = [l for l in denses if model.layers.index(l) > first_lstm]
        if len(pre_lstm) != 2 or len(post) != 2:
            raise ValueError(
                f"could not split the four Dense layers by topology "
                f"(found {len(pre_lstm)} before / {len(post)} after the "
                f"LSTM) — name them 'init_h'/'init_c'/'pre_out'/'out'"
            )
        if post[1].get_weights()[0].shape[1] != vocab:
            raise ValueError(
                f"last Dense outputs {post[1].get_weights()[0].shape[1]}"
                f" != vocab {vocab}: not an init-inject caption model"
            )
        init_h, init_c = (_dense_params(l) for l in pre_lstm)
        pre = _dense_params(post[0])
        out = _dense_params(post[1])

    cells = []
    for l in lstms:
        w = l.get_weights()
        cells.append(
            {
                "kernel": np.asarray(w[0]),
                "recurrent": np.asarray(w[1]),
                "bias": np.asarray(w[2]),
            }
        )
    return {
        "init_h": init_h,
        "init_c": init_c,
        "embedding": {"table": table},
        "cells": cells,
        "pre_out": pre,
        "out": out,
    }


def attention_decoder_params_from_keras(model) -> dict:
    """Import a Show-Attend-Tell-style Keras model into
    AttentionDecoder params (SURVEY.md §2.1 #8; config 4's family).

    Expected weight-bearing layers (keras_export.attention_decoder_to_
    keras builds the same stepwise topology): Dense att_feat (D->A),
    att_hidden (H->A), att_score (A->1), gate (H->D, sigmoid), init_h /
    init_c (D->H, tanh), Embedding, ONE shared LSTM/LSTMCell taking
    [embed; context] (E+D -> H), Dense pre_out (H+D -> H) and out
    (H -> V).

    Layers are matched by the canonical names above when present;
    otherwise classified by kernel shape (unambiguous whenever
    D/H/A/E+D/H+D are pairwise distinct — when your dims collide, name
    the layers). Dims are inferred from the Embedding and LSTM weights.
    """
    embeddings = [l for l in model.layers if _layer_type(l) == "Embedding"]
    lstms = _lstm_weight_layers(model)
    denses = [l for l in model.layers if _layer_type(l) == "Dense"]
    if len(embeddings) != 1 or len(lstms) != 1:
        raise ValueError(
            f"unexpected topology: {len(embeddings)} embeddings, "
            f"{len(lstms)} lstm layers (attention uses ONE shared cell)"
        )
    table = np.asarray(embeddings[0].get_weights()[0])
    vocab, E = table.shape
    w = lstms[0].get_weights()
    cell = {
        "kernel": np.asarray(w[0]),
        "recurrent": np.asarray(w[1]),
        "bias": np.asarray(w[2]),
    }
    H = cell["recurrent"].shape[0]
    D = cell["kernel"].shape[0] - E  # input is [embed; context]
    if D <= 0:
        raise ValueError(
            f"LSTM input dim {cell['kernel'].shape[0]} <= embed dim {E}: "
            "not an [embed; context] attention cell"
        )

    names = (
        "att_feat",
        "att_hidden",
        "att_score",
        "gate",
        "init_h",
        "init_c",
        "pre_out",
        "out",
    )
    by_name = {l.name: l for l in denses}
    if set(names) <= set(by_name):
        params = {n: _dense_params(by_name[n]) for n in names}
    else:
        # Shape-based classification: (in, out) of each Dense kernel.
        A = None
        for l in denses:  # att_score is the unique A -> 1 projection
            kin, kout = l.get_weights()[0].shape
            if kout == 1:
                A = kin
        if A is None:
            raise ValueError("no A->1 att_score Dense found")
        want = {
            "att_feat": (D, A),
            "att_hidden": (H, A),
            "att_score": (A, 1),
            "gate": (H, D),
            "init_h": (D, H),
            "init_c": (D, H),
            "pre_out": (H + D, H),
            "out": (H, vocab),
        }
        # Refuse silent misassignment: distinct roles sharing a kernel
        # shape (beyond the intentional init_h/init_c pair) cannot be
        # told apart without names.
        shapes = list(want.values())
        if len(set(shapes)) != len(shapes) - 1:  # the init pair only
            raise ValueError(
                f"ambiguous dims (D={D}, H={H}, A={A}, V={vocab}): "
                "multiple attention roles share a kernel shape — name "
                "the layers canonically (att_feat/att_hidden/att_score/"
                "gate/init_h/init_c/pre_out/out) to import"
            )
        params: dict = {}
        for l in denses:
            shape = l.get_weights()[0].shape
            hits = [n for n, s in want.items() if s == shape and n not in params]
            if not hits:
                raise ValueError(
                    f"Dense kernel {shape} matches no attention role "
                    f"(D={D}, H={H}, A={A}, V={vocab})"
                )
            # init_h/init_c share a shape: taken in topological order
            # (h before c, the exporter's and genre's convention).
            params[hits[0]] = _dense_params(l)
        missing = [n for n in names if n not in params]
        if missing:
            raise ValueError(
                f"unmatched attention roles {missing} — name the layers "
                f"canonically to disambiguate"
            )
    return {
        **{n: params[n] for n in names},
        "embedding": {"table": table},
        "cell": cell,
    }


_IMPORTERS = {
    "vgg16": vgg16_params_from_keras,
    "resnet50": resnet50_params_from_keras,
    "inception_v3": inception_v3_params_from_keras,
}


def params_from_keras(model, arch: str, **kwargs) -> dict:
    """Convert a Keras ``.h5`` file (its path) or a ``KerasH5Model`` to
    tpucap-layout encoder params (a numpy tree)."""
    if isinstance(model, (str, bytes, os.PathLike)):
        model = KerasH5Model(os.fsdecode(model))
    if arch not in _IMPORTERS:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(_IMPORTERS)}")
    return _IMPORTERS[arch](model, **kwargs)
