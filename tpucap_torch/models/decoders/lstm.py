"""Merge LSTM caption decoder (port of ``tpucap.models.decoders.lstm``).

    image feat -> Dense(hidden, relu)                  (fe branch)
    tokens     -> Embedding -> LSTM stack              (se branch)
    add(fe, se) -> Dense(hidden, relu) -> Dense(vocab) (logits)

as an incremental step function for the decode engines. The 2-layer
variant stacks cells; layer l consumes layer l-1's hidden state. Dropout
acts only in training, which the port does not have yet.
"""

from __future__ import annotations

import dataclasses

import torch

from tpucap_torch.models.layers import (
    dense,
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

    def init_state(self, params, features):
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
