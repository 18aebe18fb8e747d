"""Export trained decoders to reference-style Keras ``.h5`` files, without
TensorFlow, Keras or h5py: the port's copy of
``tpucap.checkpoint.keras_export``.

tpucap builds each topology as a ``tf_keras`` model and saves it. Here the
same graph is built from plain records (``_Graph``: layers, their calls
and the tensors between them), and two things come out of it, as tf_keras
2.21 writes them for tpucap's model in a fresh session
(``tf_keras.backend.clear_session()``):

- the Functional ``model_config``: every layer's config with tf_keras's
  defaults, its ``inbound_nodes`` (a shared layer called once per step
  has a node per call), the layers in ``model.layers`` order (tf_keras's
  ``_map_graph_network``: by depth from the outputs, then by first visit),
  ``input_layers`` and ``output_layers``; auto-names (``dropout_1``,
  ``add``, ``repeat_vector_3``) come from per-class counters starting at
  zero, as a fresh session's do;
- the ``model_weights`` tree: a group per layer with its ``weight_names``
  and one f32 dataset per weight at ``<layer>/<weight name>``, the empty
  ``top_level_model_weights``, and the root's and ``model_weights``'
  ``backend`` / ``keras_version`` attributes tpucap's file has (they make
  Keras load the weights unchanged).

Topologies: merge (1/2-layer, the reference ``define_model``), GRU merge
(the same over GRU(h), reset_after=True), inject (image feature ->
Dense(tanh) x2 -> the LSTM stack's ``initial_state``) and attention
(Show-Attend-Tell unrolled over ``max_len`` steps with shared layers, built
only from standard layers). The adaptive and transformer families (the
MoE transformer too) have no Keras topology, in tpucap as here: their
export raises tpucap's ``no Keras topology for <class>; have [...]``. Weight layouts need no transposition:
Keras stores Dense kernels (in, out), LSTM weights [kernel (E,4U),
recurrent (U,4U), bias (4U,)] in i, f, c, o gate order and GRU weights
[kernel (E,3U), recurrent (U,3U), bias (2,3U)] in z, r, h order, tpucap's
formats.
The port's tensors go back to that layout with ``convert.params_to_numpy``.
"""

from __future__ import annotations

import json
import re

import numpy as np

from tpucap_torch.checkpoint import hdf5

#: The values tpucap's files carry (tf_keras 2.21 on TensorFlow).
KERAS_VERSION = "2.21.0"
BACKEND = "tensorflow"


def _snake(name: str) -> str:
    """tf_keras's ``to_snake_case``, which makes auto-names' stems."""
    s = re.sub("(.)([A-Z][a-z0-9]+)", r"\1_\2", name)
    s = re.sub("([a-z])([A-Z])", r"\1_\2", s).lower()
    return s if s[0] != "_" else "private" + s


def _initializer(name: str, **config) -> dict:
    return {
        "module": "keras.initializers",
        "class_name": name,
        "config": config,
        "registered_name": None,
    }


class _Tensor:
    def __init__(self, layer, node: int, index: int):
        self.layer, self.node, self.index = layer, node, index


class _Node:
    def __init__(self, layer, inputs: list, is_input: bool = False):
        self.layer, self.inputs, self.is_input = layer, inputs, is_input

    @property
    def parents(self) -> list:
        return [t.layer.nodes[t.node] for t in self.inputs]


class _Layer:
    def __init__(self, graph, class_name: str, name: str | None, outputs: int):
        self.class_name = class_name
        if name is None:
            stem = _snake(class_name)
            n = graph.counters.get(stem, 0)
            graph.counters[stem] = n + 1
            name = stem if n == 0 else f"{stem}_{n}"
        self.name = name
        self.config: dict = {}
        self.outputs = outputs
        self.nodes: list[_Node] = []
        self.weights: list[tuple[str, np.ndarray]] = []

    def __call__(self, inputs):
        """Call on a tensor or a list of them -> the output tensor (a tuple
        of them for a layer with several outputs)."""
        flat = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        self.nodes.append(_Node(self, flat))
        outs = tuple(_Tensor(self, len(self.nodes) - 1, i) for i in range(self.outputs))
        return outs if self.outputs > 1 else outs[0]


class _Graph:
    """tf_keras's functional API in records, for one fresh session."""

    def __init__(self):
        self.counters: dict[str, int] = {}

    def layer(self, class_name: str, name: str | None = None, outputs: int = 1, **config):
        layer = _Layer(self, class_name, name, outputs)
        layer.config = {"name": layer.name, "trainable": True, "dtype": "float32", **config}
        return layer

    def input(self, shape, name: str) -> _Tensor:
        layer = _Layer(self, "InputLayer", name, 1)
        layer.config = {
            "batch_input_shape": [None, *shape],
            "dtype": "float32",
            "sparse": False,
            "ragged": False,
            "name": name,
            "optional": False,
        }
        layer.nodes.append(_Node(layer, [], is_input=True))
        return _Tensor(layer, 0, 0)

    # The standard layers tpucap's topologies use, with tf_keras's defaults.
    def dense(self, units: int, activation: str = "linear", name: str | None = None):
        return self.layer(
            "Dense",
            name,
            units=units,
            activation=activation,
            use_bias=True,
            kernel_initializer=_initializer("GlorotUniform", seed=None),
            bias_initializer=_initializer("Zeros"),
            kernel_regularizer=None,
            bias_regularizer=None,
            activity_regularizer=None,
            kernel_constraint=None,
            bias_constraint=None,
        )

    def embedding(self, vocab: int, dim: int, mask_zero: bool, name: str):
        return self.layer(
            "Embedding",
            name,
            batch_input_shape=[None, None],
            input_dim=vocab,
            output_dim=dim,
            embeddings_initializer=_initializer("RandomUniform", minval=-0.05, maxval=0.05, seed=None),
            embeddings_regularizer=None,
            activity_regularizer=None,
            embeddings_constraint=None,
            mask_zero=mask_zero,
            input_length=None,
        )

    def dropout(self, rate: float):
        return self.layer("Dropout", rate=rate, noise_shape=None, seed=None)

    def lstm(self, units: int, name: str, return_sequences: bool):
        return self.layer(
            "LSTM",
            name,
            **_rnn_flags(return_sequences, False),
            **_lstm_cell_fields(units, layer=True),
        )

    def gru(self, units: int, name: str, return_sequences: bool):
        return self.layer(
            "GRU",
            name,
            **_rnn_flags(return_sequences, False),
            **_gru_fields(units),
        )

    def rnn_lstm_cell(self, units: int, input_dim: int, name: str):
        """``RNN(LSTMCell(units), return_state=True)``: outputs (y, h, c)."""
        cell = self.layer("LSTMCell", **_lstm_cell_fields(units, layer=False))
        rnn = self.layer(
            "RNN",
            name,
            outputs=3,
            **_rnn_flags(False, True),
            cell={
                "module": "keras.layers",
                "class_name": "LSTMCell",
                "config": cell.config,
                "registered_name": None,
                "build_config": {"input_shape": [None, input_dim]},
            },
        )
        rnn.cell_name = cell.name
        return rnn

    def model(self, inputs: list[_Tensor], outputs: list[_Tensor]) -> KerasModel:
        """The Functional model from ``inputs`` to ``outputs``: its config
        and its layers' weights in ``model.layers`` order."""
        layers, network_nodes = _map_graph(outputs)
        conversion = {}
        for layer in layers:
            kept = 0
            for node in layer.nodes:
                if node in network_nodes:
                    conversion[node] = kept
                    kept += 1

        def ref(t: _Tensor, extra):
            return [t.layer.name, conversion.get(t.layer.nodes[t.node], 0), t.index, *extra]

        entries = []
        for layer in layers:
            inbound = [
                [ref(t, [{}]) for t in node.inputs]
                for node in layer.nodes
                if node in network_nodes and not node.is_input
            ]
            entries.append(
                {
                    "class_name": layer.class_name,
                    "config": layer.config,
                    "name": layer.name,
                    "inbound_nodes": inbound,
                }
            )
        config = {
            "class_name": "Functional",
            "config": {
                "name": "model",
                "trainable": True,
                "layers": entries,
                "input_layers": [ref(t, []) for t in inputs],
                "output_layers": [ref(t, []) for t in outputs],
            },
        }
        return KerasModel(config, [(layer.name, layer.weights) for layer in layers])


def _rnn_flags(return_sequences: bool, return_state: bool) -> dict:
    return {
        "return_sequences": return_sequences,
        "return_state": return_state,
        "go_backwards": False,
        "stateful": False,
        "unroll": False,
        "time_major": False,
    }


def _lstm_cell_fields(units: int, *, layer: bool) -> dict:
    """An LSTM's (``layer``) or an LSTMCell's own config keys."""
    fields = {
        "units": units,
        "activation": "tanh",
        "recurrent_activation": "sigmoid",
        "use_bias": True,
        "kernel_initializer": _initializer("GlorotUniform", seed=None),
        "recurrent_initializer": _initializer("Orthogonal", gain=1.0, seed=None),
        "bias_initializer": _initializer("Zeros"),
        "unit_forget_bias": True,
        "kernel_regularizer": None,
        "recurrent_regularizer": None,
        "bias_regularizer": None,
    }
    if layer:
        fields["activity_regularizer"] = None
    fields.update(
        kernel_constraint=None,
        recurrent_constraint=None,
        bias_constraint=None,
        dropout=0.0,
        recurrent_dropout=0.0,
        implementation=2,
    )
    return fields


def _gru_fields(units: int) -> dict:
    """A GRU layer's own config keys (GRU-v2, reset_after=True)."""
    return {
        "units": units,
        "activation": "tanh",
        "recurrent_activation": "sigmoid",
        "use_bias": True,
        "kernel_initializer": _initializer("GlorotUniform", seed=None),
        "recurrent_initializer": _initializer("Orthogonal", gain=1.0, seed=None),
        "bias_initializer": _initializer("Zeros"),
        "kernel_regularizer": None,
        "recurrent_regularizer": None,
        "bias_regularizer": None,
        "activity_regularizer": None,
        "kernel_constraint": None,
        "recurrent_constraint": None,
        "bias_constraint": None,
        "dropout": 0.0,
        "recurrent_dropout": 0.0,
        "implementation": 2,
        "reset_after": True,
    }


def _map_graph(outputs: list[_Tensor]) -> tuple[list[_Layer], set]:
    """tf_keras's ``_build_map`` and ``_map_graph_network``: a depth-first
    walk from the outputs (inputs in call order), node depths from the
    outputs, layers by decreasing depth and then by first visit. -> (the
    layers, the set of nodes in the network)."""
    finished: set = set()
    order: list[_Node] = []
    first_visit: dict = {}
    for out in outputs:
        stack = [[out, None]]
        while stack:
            top = stack[-1]
            node = top[0].layer.nodes[top[0].node]
            if top[1] is None:
                if node in finished:
                    stack.pop()
                    continue
                first_visit.setdefault(top[0].layer, len(first_visit))
                top[1] = iter([] if node.is_input else node.inputs)
            nxt = next(top[1], None)
            if nxt is None:
                finished.add(node)
                order.append(node)
                stack.pop()
            else:
                stack.append([nxt, None])
    node_depth: dict = {}
    layer_depth: dict = {}
    for node in reversed(order):
        depth = max(node_depth.setdefault(node, 0), layer_depth.get(node.layer, 0))
        layer_depth[node.layer] = depth
        node_depth[node] = depth
        for parent in node.parents:
            node_depth[parent] = max(depth + 1, node_depth.get(parent, 0))
    by_depth: dict[int, list] = {}
    for layer, depth in layer_depth.items():
        by_depth.setdefault(depth, []).append(layer)
    layers = []
    for depth in sorted(by_depth, reverse=True):
        layers += sorted(by_depth[depth], key=lambda l: first_visit[l])
    return layers, set(order)


class KerasModel:
    """A Keras model as records: ``model_config`` (the parsed JSON tf_keras
    writes), ``layers`` in ``model.layers`` order as ``(name, [(weight
    name, array), ...])`` and ``save(path)``, which writes the full-model
    ``.h5`` file."""

    def __init__(self, model_config: dict, layers: list[tuple[str, list]]):
        self.model_config = model_config
        self.layers = [(name, list(weights)) for name, weights in layers]

    def save(self, path) -> None:
        mw = hdf5.WGroup(
            attrs={
                "layer_names": [name.encode("utf8") for name, _ in self.layers],
                "backend": BACKEND.encode("utf8"),
                "keras_version": KERAS_VERSION.encode("utf8"),
            }
        )
        for name, weights in self.layers:
            g = mw.members[name] = hdf5.WGroup(
                attrs={"weight_names": [w.encode("utf8") for w, _ in weights]}
            )
            for wname, value in weights:
                *dirs, leaf = wname.split("/")
                node = g
                for d in dirs:
                    node = node.members.setdefault(d, hdf5.WGroup())
                node.members[leaf] = np.asarray(value, dtype=np.float32)
        mw.members["top_level_model_weights"] = hdf5.WGroup(attrs={"weight_names": []})
        root = hdf5.WGroup(
            members={"model_weights": mw},
            attrs={
                "keras_version": KERAS_VERSION,
                "backend": BACKEND,
                "model_config": json.dumps(self.model_config).encode("utf8"),
            },
        )
        hdf5.write(path, root)


def _numpy_tree(params):
    """The port's tensors (or a numpy tree) -> tpucap-layout numpy."""
    from tpucap_torch.convert import params_to_numpy

    def has_tensor(node):
        if isinstance(node, dict):
            return any(has_tensor(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return any(has_tensor(v) for v in node)
        return hasattr(node, "detach")

    return params_to_numpy(params) if has_tensor(params) else params


def _dense_w(layer: _Layer, p) -> None:
    layer.weights = [
        (f"{layer.name}/kernel:0", np.asarray(p["kernel"])),
        (f"{layer.name}/bias:0", np.asarray(p["bias"])),
    ]


def _lstm_w(layer: _Layer, cell, cell_name: str = "lstm_cell") -> None:
    stem = f"{layer.name}/{cell_name}"
    layer.weights = [
        (f"{stem}/kernel:0", np.asarray(cell["kernel"])),
        (f"{stem}/recurrent_kernel:0", np.asarray(cell["recurrent"])),
        (f"{stem}/bias:0", np.asarray(cell["bias"])),
    ]


def _gru_w(layer: _Layer, cell) -> None:
    stem = f"{layer.name}/gru_cell"
    layer.weights = [
        (f"{stem}/kernel:0", np.asarray(cell["kernel"])),
        (f"{stem}/recurrent_kernel:0", np.asarray(cell["recurrent"])),
        (f"{stem}/bias:0", np.asarray(cell["bias"])),
    ]


def _embedding_w(layer: _Layer, p) -> None:
    layer.weights = [(f"{layer.name}/embeddings:0", np.asarray(p["table"]))]


def _merge_model(decoder, params, max_len: int, rnn: str) -> KerasModel:
    """The reference ``define_model`` topology over a stack of ``rnn``
    ("lstm" or "gru") layers named ``{rnn}_{i}``, carrying ``params``."""
    params = _numpy_tree(params)
    g = _Graph()
    hid = decoder.hidden_dim
    n_layers = len(params["cells"])
    make, carry = (g.lstm, _lstm_w) if rnn == "lstm" else (g.gru, _gru_w)

    inputs1 = g.input((decoder.feature_dim,), "image_features")
    fe1 = g.dropout(decoder.dropout_rate)(inputs1)
    feat_proj = g.dense(hid, "relu", name="feat_proj")
    fe2 = feat_proj(fe1)
    inputs2 = g.input((max_len,), "token_ids")
    embedding = g.embedding(decoder.vocab_size, decoder.embed_dim, True, "embedding")
    se = embedding(inputs2)
    se = g.dropout(decoder.dropout_rate)(se)
    rnns = []
    for i in range(n_layers):
        rnns.append(make(hid, f"{rnn}_{i}", return_sequences=i != n_layers - 1))
        se = rnns[-1](se)
    d1 = g.layer("Add")([fe2, se])
    pre_out = g.dense(hid, "relu", name="pre_out")
    out = g.dense(decoder.vocab_size, "softmax", name="out")
    outputs = out(pre_out(d1))

    _dense_w(feat_proj, params["feat_proj"])
    _embedding_w(embedding, params["embedding"])
    for layer, cell in zip(rnns, params["cells"]):
        carry(layer, cell)
    _dense_w(pre_out, params["pre_out"])
    _dense_w(out, params["out"])
    return g.model([inputs1, inputs2], [outputs])


def merge_decoder_to_keras(decoder, params, *, max_len: int) -> KerasModel:
    """The reference ``define_model`` topology carrying ``params``.

    decoder: a ``MergeDecoder`` (1- or 2-layer).
    max_len: the padded caption length the Keras model's token input
    expects (the reference bakes it into the Input shape).
    """
    if type(decoder).__name__ != "MergeDecoder":
        raise ValueError(
            "only MergeDecoder exports to the reference define_model "
            f"topology; got {type(decoder).__name__}"
        )
    return _merge_model(decoder, params, max_len, "lstm")


def gru_merge_decoder_to_keras(decoder, params, *, max_len: int) -> KerasModel:
    """The merge topology over GRU(h) carrying ``params``: the GRU analog
    of :func:`merge_decoder_to_keras`, its GRU layers named ``gru_{i}``
    (Keras's GRU defaults to reset_after=True, whose weights are the
    port's layout)."""
    if type(decoder).__name__ != "GruMergeDecoder":
        raise ValueError(
            "gru export needs a GruMergeDecoder; got "
            f"{type(decoder).__name__}"
        )
    return _merge_model(decoder, params, max_len, "gru")


def inject_decoder_to_keras(decoder, params, *, max_len: int) -> KerasModel:
    """The genre's init-inject caption model carrying ``params``: image
    feature -> Dense(hidden, tanh) x2 ('init_h'/'init_c') feed the LSTM
    stack's ``initial_state``; tokens -> Embedding(mask_zero) -> LSTM stack
    -> Dense(hidden, relu) -> Dense(vocab, softmax). Every layer of a
    2-layer stack receives the same injected state, matching
    ``InjectDecoder.init_state``."""
    if type(decoder).__name__ != "InjectDecoder":
        raise ValueError(
            "inject export needs an InjectDecoder; got "
            f"{type(decoder).__name__}"
        )
    params = _numpy_tree(params)
    g = _Graph()
    hid = decoder.hidden_dim
    n_layers = len(params["cells"])

    inputs1 = g.input((decoder.feature_dim,), "image_features")
    fe = g.dropout(decoder.dropout_rate)(inputs1)
    init_h = g.dense(hid, "tanh", name="init_h")
    h0 = init_h(fe)
    init_c = g.dense(hid, "tanh", name="init_c")
    c0 = init_c(fe)
    inputs2 = g.input((max_len,), "token_ids")
    embedding = g.embedding(decoder.vocab_size, decoder.embed_dim, True, "embedding")
    se = embedding(inputs2)
    se = g.dropout(decoder.dropout_rate)(se)
    lstms = []
    for i in range(n_layers):
        lstms.append(g.lstm(hid, f"lstm_{i}", return_sequences=i != n_layers - 1))
        se = lstms[-1]([se, h0, c0])
    pre_out = g.dense(hid, "relu", name="pre_out")
    out = g.dense(decoder.vocab_size, "softmax", name="out")
    outputs = out(pre_out(se))

    _dense_w(init_h, params["init_h"])
    _dense_w(init_c, params["init_c"])
    _embedding_w(embedding, params["embedding"])
    for layer, cell in zip(lstms, params["cells"]):
        _lstm_w(layer, cell)
    _dense_w(pre_out, params["pre_out"])
    _dense_w(out, params["out"])
    return g.model([inputs1, inputs2], [outputs])


_ATTENTION_DENSES = (
    "att_feat",
    "att_hidden",
    "att_score",
    "gate",
    "init_h",
    "init_c",
    "pre_out",
    "out",
)


def attention_decoder_to_keras(
    decoder, params, *, max_len: int, positions: int = 196
) -> KerasModel:
    """The Show-Attend-Tell model carrying ``params``: teacher-forced over a
    fixed ``positions``-cell grid, unrolled ``max_len`` steps with SHARED
    layers (one set of weights, ``max_len`` call nodes). Per step t:

        wh     = att_hidden(h)                    (B, A)
        e      = att_score(tanh(att_feat(F) + wh))  additive MLP
        alpha  = softmax_L(e)                     (B, L)
        ctx    = sum_l alpha_l F_l                (B, D)   [Dot axes=1]
        ctx    = sigmoid(gate(h)) * ctx           (gated context)
        h, c   = LSTMCell([embed(w_t); ctx], h, c)
        prob_t = softmax(out(pre_out([h; ctx])))

    Broadcast, slice and reduce are RepeatVector / Cropping1D / Dot /
    Multiply, so the file loads without custom objects. Outputs
    (B, max_len, vocab) stepwise probabilities."""
    if type(decoder).__name__ != "AttentionDecoder":
        raise ValueError(
            "attention export needs an AttentionDecoder; got "
            f"{type(decoder).__name__}"
        )
    params = _numpy_tree(params)
    g = _Graph()
    vocab = decoder.vocab_size
    D, E, H = decoder.feature_dim, decoder.embed_dim, decoder.hidden_dim
    A = decoder.attention_dim

    feats_in = g.input((positions, D), "image_features")
    toks_in = g.input((max_len,), "token_ids")

    att_feat = g.dense(A, name="att_feat")
    att_hidden = g.dense(A, name="att_hidden")
    att_score = g.dense(1, name="att_score")
    gate = g.dense(D, "sigmoid", name="gate")
    init_h = g.dense(H, "tanh", name="init_h")
    init_c = g.dense(H, "tanh", name="init_c")
    embedding = g.embedding(vocab, E, False, "embedding")
    step_rnn = g.rnn_lstm_cell(H, E + D, "lstm")
    pre_out = g.dense(H, "relu", name="pre_out")
    out = g.dense(vocab, "softmax", name="out")

    mean = g.layer("GlobalAveragePooling1D", "mean_feat", data_format="channels_last", keepdims=False)
    mean_feat = mean(feats_in)
    h, c = init_h(mean_feat), init_c(mean_feat)
    pfeat = att_feat(feats_in)
    se = embedding(toks_in)

    step_probs = []
    for t in range(max_len):
        repeat = g.layer("RepeatVector", n=positions)
        wh = repeat(att_hidden(h))
        add = g.layer("Add")
        tanh = g.layer("Activation", activation="tanh")
        e = att_score(tanh(add([pfeat, wh])))
        alpha = g.layer("Softmax", axis=1)(e)
        reshape = g.layer("Reshape", target_shape=[D])
        ctx = reshape(g.layer("Dot", axes=1, normalize=False)([alpha, feats_in]))
        ctx = g.layer("Multiply")([gate(h), ctx])
        reshape = g.layer("Reshape", target_shape=[E])
        x_t = reshape(g.layer("Cropping1D", cropping=[t, max_len - t - 1])(se))
        reshape = g.layer("Reshape", target_shape=[1, E + D])
        step_in = reshape(g.layer("Concatenate", axis=-1)([x_t, ctx]))
        _, h, c = step_rnn([step_in, h, c])
        merged = pre_out(g.layer("Concatenate", axis=-1)([h, ctx]))
        reshape = g.layer("Reshape", target_shape=[1, vocab])
        step_probs.append(reshape(out(merged)))
    outputs = (
        g.layer("Concatenate", axis=1)(step_probs) if max_len > 1 else step_probs[0]
    )

    for name, layer in zip(
        _ATTENTION_DENSES,
        (att_feat, att_hidden, att_score, gate, init_h, init_c, pre_out, out),
    ):
        _dense_w(layer, params[name])
    _embedding_w(embedding, params["embedding"])
    _lstm_w(step_rnn, params["cell"], step_rnn.cell_name)
    return g.model([feats_in, toks_in], [outputs])


def decoder_to_keras(decoder, params, *, max_len: int, **kwargs) -> KerasModel:
    """Dispatch to the family's builder."""
    builders = {
        "MergeDecoder": merge_decoder_to_keras,
        "GruMergeDecoder": gru_merge_decoder_to_keras,
        "InjectDecoder": inject_decoder_to_keras,
        "AttentionDecoder": attention_decoder_to_keras,
    }
    name = type(decoder).__name__
    if name not in builders:
        raise ValueError(
            f"no Keras topology for {name}; have {sorted(builders)}"
        )
    return builders[name](decoder, params, max_len=max_len, **kwargs)


def export_h5(decoder, params, path, *, max_len: int, **kwargs) -> None:
    """Write a reference-loadable ``.h5`` full-model file (the reference's
    checkpoint format). Dispatches on the decoder family: merge, GRU merge,
    inject and attention export; attention also takes ``positions`` (the spatial grid
    size, default 196)."""
    decoder_to_keras(decoder, params, max_len=max_len, **kwargs).save(path)
