"""Merge-topology GRU caption decoder (port of
``tpucap.models.decoders.gru``): the merge LSTM's topology over a stack of 1
(gru1) or 2 (gru2) Keras GRU-v2 cells,

    image feat -> Dropout -> Dense(hidden, relu)            (fe branch)
    tokens     -> Embedding -> Dropout -> GRU stack         (se branch)
    add(fe, se) -> Dense(hidden, relu) -> Dense(vocab)      (logits)

with the state ``{"fe", "h"}``, h (B, L, U) and no cell vector. The cell is
``layers.gru_cell_step`` (reset_after=True, gate order z, r, h), whose
weights are Keras's layout, so a Keras GRU model imports weight for weight
(``checkpoint.keras_import.gru_merge_decoder_params_from_keras``). The
decode interface is MergeDecoder's, so every decode engine and the training
stack drive it unchanged; the step is plain PyTorch on the card too, as the
JAX package runs it as plain XLA.
"""

from __future__ import annotations

import dataclasses

import torch

from tpucap_torch.models.layers import (
    dense,
    dropout,
    embed,
    gru_cell_step,
    init_dense,
    init_embedding,
    init_gru_cell,
)


def _stacked_gru_step(cells, x, h):
    """Run the GRU stack one step. h: (B, L, U)."""
    new_h = []
    for l, cell in enumerate(cells):
        x = gru_cell_step(cell, x, h[:, l])
        new_h.append(x)
    return x, torch.stack(new_h, dim=1)


@dataclasses.dataclass(frozen=True)
class GruMergeDecoder:
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
            cells.append(init_gru_cell(gen, in_dim, self.hidden_dim))
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
        h = torch.zeros(
            (fe.shape[0], self.num_layers, self.hidden_dim), dtype=fe.dtype, device=fe.device
        )
        return {"fe": fe, "h": h}

    def step_hidden(self, params, state, token):
        """Step up to (but excluding) the output projection."""
        x = embed(params["embedding"], token)
        top, h = _stacked_gru_step(params["cells"], x, state["h"])
        merged = dense(params["pre_out"], state["fe"] + top, torch.relu)
        return merged, {"fe": state["fe"], "h": h}

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
        h = state["h"]
        tops = []
        for t in range(xs.shape[1]):
            top, h = _stacked_gru_step(params["cells"], xs[:, t], h)
            tops.append(top)
        tops = torch.stack(tops, dim=1)  # (B, T, U)
        return dense(params["pre_out"], state["fe"][:, None, :] + tops, torch.relu)

    def forward_train(self, params, features, tokens, rng=None, deterministic=True):
        """tokens (B, T) post-padded input ids -> logits (B, T, V)."""
        hidden = self.forward_hidden(
            params, features, tokens, rng=rng, deterministic=deterministic
        )
        return dense(params["out"], hidden)
