"""Merge and inject LSTM caption decoders (port of
``tpucap.models.decoders.lstm``).

MergeDecoder:

    image feat -> Dense(hidden, relu)                  (fe branch)
    tokens     -> Embedding -> LSTM stack              (se branch)
    add(fe, se) -> Dense(hidden, relu) -> Dense(vocab) (logits)

InjectDecoder maps the image feature to the stack's initial h and c (a
tanh dense each, the same for every layer) and decodes from the tokens
alone: top -> Dense(hidden, relu) -> Dense(vocab).

as an incremental step function for the decode engines, and as a
teacher-forced pass over whole token rows for training (``forward_train``),
with dropout on the image feature and on the embedded tokens. The 2-layer
variant stacks cells; layer l consumes layer l-1's hidden state. Training
runs the plain cell (``layers.lstm_cell_step``) under autograd, as tpucap
trains with its plain scan: kernel K2 is forward-only.
"""

from __future__ import annotations

import dataclasses

import torch

from tpucap_torch.models.layers import (
    dense,
    dropout,
    embed,
    init_dense,
    init_embedding,
    init_lstm_cell,
    lstm_cell_step,
)


def _stacked_step(cells, x, h, c):
    """Run the cell stack one step. h, c: (B, L, U)."""
    new_h, new_c = [], []
    for l, cell in enumerate(cells):
        hl, cl = lstm_cell_step(cell, x, h[:, l], c[:, l])
        new_h.append(hl)
        new_c.append(cl)
        x = hl
    return x, torch.stack(new_h, dim=1), torch.stack(new_c, dim=1)


@dataclasses.dataclass(frozen=True)
class MergeDecoder:
    vocab_size: int
    feature_dim: int
    embed_dim: int = 256
    hidden_dim: int = 256
    num_layers: int = 1
    dropout_rate: float = 0.5

    def init(self, gen: torch.Generator):
        cells = []
        in_dim = self.embed_dim
        for _ in range(self.num_layers):
            cells.append(init_lstm_cell(gen, in_dim, self.hidden_dim))
            in_dim = self.hidden_dim
        return {
            "feat_proj": init_dense(gen, self.feature_dim, self.hidden_dim),
            "embedding": init_embedding(gen, self.vocab_size, self.embed_dim),
            "cells": cells,
            "pre_out": init_dense(gen, self.hidden_dim, self.hidden_dim),
            "out": init_dense(gen, self.hidden_dim, self.vocab_size),
        }

    def init_state(self, params, features, rng=None, deterministic=True):
        if rng is not None and not deterministic:
            features = dropout(rng, features, self.dropout_rate, False)
        fe = dense(params["feat_proj"], features, torch.relu)
        B = fe.shape[0]
        zeros = torch.zeros(
            (B, self.num_layers, self.hidden_dim), dtype=fe.dtype, device=fe.device
        )
        return {"fe": fe, "h": zeros, "c": zeros}

    def step_hidden(self, params, state, token):
        """Step up to (but excluding) the output projection."""
        x = embed(params["embedding"], token)
        top, h, c = _stacked_step(params["cells"], x, state["h"], state["c"])
        merged = dense(params["pre_out"], state["fe"] + top, torch.relu)
        return merged, {"fe": state["fe"], "h": h, "c": c}

    def step(self, params, state, token):
        hidden, new_state = self.step_hidden(params, state, token)
        return dense(params["out"], hidden), new_state

    # -- training ------------------------------------------------------------

    def forward_hidden(self, params, features, tokens, rng=None, deterministic=True):
        """Teacher-forced hidden states before the output projection:
        tokens (B, T) -> (B, T, H). ``rng`` (a ``torch.Generator``) draws
        the feature dropout, then the embedding dropout."""
        state = self.init_state(params, features, rng=rng, deterministic=deterministic)
        xs = embed(params["embedding"], tokens)  # (B, T, E)
        if rng is not None and not deterministic:
            xs = dropout(rng, xs, self.dropout_rate, False)
        h, c = state["h"], state["c"]
        tops = []
        for t in range(xs.shape[1]):
            top, h, c = _stacked_step(params["cells"], xs[:, t], h, c)
            tops.append(top)
        tops = torch.stack(tops, dim=1)  # (B, T, U)
        return dense(params["pre_out"], state["fe"][:, None, :] + tops, torch.relu)

    def forward_train(self, params, features, tokens, rng=None, deterministic=True):
        """tokens (B, T) post-padded input ids -> logits (B, T, V)."""
        hidden = self.forward_hidden(
            params, features, tokens, rng=rng, deterministic=deterministic
        )
        return dense(params["out"], hidden)


@dataclasses.dataclass(frozen=True)
class InjectDecoder:
    vocab_size: int
    feature_dim: int
    embed_dim: int = 256
    hidden_dim: int = 256
    num_layers: int = 1
    dropout_rate: float = 0.5

    def init(self, gen: torch.Generator):
        cells = []
        in_dim = self.embed_dim
        for _ in range(self.num_layers):
            cells.append(init_lstm_cell(gen, in_dim, self.hidden_dim))
            in_dim = self.hidden_dim
        return {
            "init_h": init_dense(gen, self.feature_dim, self.hidden_dim),
            "init_c": init_dense(gen, self.feature_dim, self.hidden_dim),
            "embedding": init_embedding(gen, self.vocab_size, self.embed_dim),
            "cells": cells,
            "pre_out": init_dense(gen, self.hidden_dim, self.hidden_dim),
            "out": init_dense(gen, self.hidden_dim, self.vocab_size),
        }

    def init_state(self, params, features, rng=None, deterministic=True):
        if rng is not None and not deterministic:
            features = dropout(rng, features, self.dropout_rate, False)
        h0 = dense(params["init_h"], features, torch.tanh)
        c0 = dense(params["init_c"], features, torch.tanh)
        # The same injected state for every layer of the stack.
        h = h0[:, None, :].repeat(1, self.num_layers, 1)
        c = c0[:, None, :].repeat(1, self.num_layers, 1)
        return {"h": h, "c": c}

    def step_hidden(self, params, state, token):
        x = embed(params["embedding"], token)
        top, h, c = _stacked_step(params["cells"], x, state["h"], state["c"])
        return dense(params["pre_out"], top, torch.relu), {"h": h, "c": c}

    def step(self, params, state, token):
        hidden, new_state = self.step_hidden(params, state, token)
        return dense(params["out"], hidden), new_state

    def forward_hidden(self, params, features, tokens, rng=None, deterministic=True):
        """Teacher-forced (B, T) -> (B, T, H); ``rng`` draws the feature
        dropout, then the embedding dropout."""
        state = self.init_state(params, features, rng=rng, deterministic=deterministic)
        xs = embed(params["embedding"], tokens)
        if rng is not None and not deterministic:
            xs = dropout(rng, xs, self.dropout_rate, False)
        h, c = state["h"], state["c"]
        tops = []
        for t in range(xs.shape[1]):
            top, h, c = _stacked_step(params["cells"], xs[:, t], h, c)
            tops.append(top)
        return dense(params["pre_out"], torch.stack(tops, dim=1), torch.relu)

    def forward_train(self, params, features, tokens, rng=None, deterministic=True):
        hidden = self.forward_hidden(
            params, features, tokens, rng=rng, deterministic=deterministic
        )
        return dense(params["out"], hidden)
