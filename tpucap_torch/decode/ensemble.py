"""Product-of-experts ensemble decoding (port of ``tpucap.decode.ensemble``).

At every decode step each model scores the next token, and the ensemble
distribution is the weighted geometric mean of the per-model softmaxes: a
weighted sum of f32 log-probs, in member order. The composed step keeps
the decode engines' step_fn contract, so greedy and beam bookkeeping,
min_len masking, backpointers and length penalties apply unchanged; the
engines' lazy logsumexp renormalizes the sum, and selection does not
depend on that per-row shift.

Heterogeneous ensembles work (a merge LSTM beside the soft-attention
decoder): each model's state lives under an ``m{i}/`` prefix in one flat
dict, which keeps each member's ``beam_shared_keys`` (the attention
decoder's feature grids) untiled through the beam.

Each member steps with its own step function: ``steps`` (the pipeline
passes ``decode_step_fn(decoder, device)`` for each, so on the card a
1-layer merge member runs kernels K2 + K3 with its own K-major weight
copies), or the decoder's plain ``step``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


class EnsembleDecoder:
    """M decoders (the init_state / step interface of
    ``models/decoders``) as one decoder-shaped object whose ``step``
    returns weighted-mean log-probs. ``params`` and ``features`` flow
    through as M-tuples; state is one flat dict keyed ``m{i}/{key}``
    (a non-dict per-model state is stored whole under ``m{i}``)."""

    def __init__(self, decoders: Sequence, weights=None, steps: Sequence[Callable] | None = None):
        if not decoders:
            raise ValueError("ensemble needs at least one decoder")
        if weights is None:
            weights = [1.0] * len(decoders)
        if len(weights) != len(decoders):
            raise ValueError(
                f"{len(weights)} weights for {len(decoders)} decoders"
            )
        total = float(sum(weights))
        if total <= 0.0:
            raise ValueError("ensemble weights must sum to > 0")
        self.decoders = tuple(decoders)
        self.weights = tuple(float(w) / total for w in weights)
        self.steps = tuple(steps) if steps is not None else tuple(d.step for d in self.decoders)
        if len(self.steps) != len(self.decoders):
            raise ValueError(f"{len(self.steps)} step functions for {len(self.decoders)} decoders")
        self.beam_shared_keys = frozenset(
            f"m{i}/{key}"
            for i, d in enumerate(self.decoders)
            for key in getattr(d, "beam_shared_keys", frozenset())
        )

    def init_state(self, params, features):
        """params/features: M-tuples (one per model) -> flat state dict."""
        flat = {}
        for i, (d, p, f) in enumerate(zip(self.decoders, params, features)):
            st = d.init_state(p, f)
            if isinstance(st, dict):
                for k, v in st.items():
                    flat[f"m{i}/{k}"] = v
            else:
                flat[f"m{i}"] = st
        return flat

    def step(self, params, state, token):
        """The engines' step_fn contract: (params, state, token) ->
        (weighted-mean log-probs (B, V) f32, new state)."""
        logp_sum = None
        new_flat = {}
        for i, (step, p) in enumerate(zip(self.steps, params)):
            prefix = f"m{i}/"
            if f"m{i}" in state:
                sub = state[f"m{i}"]
            else:
                sub = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
            logits, ns = step(p, sub, token)
            logp = self.weights[i] * torch.log_softmax(logits.float(), dim=-1)
            logp_sum = logp if logp_sum is None else logp_sum + logp
            if isinstance(ns, dict):
                for k, v in ns.items():
                    new_flat[prefix + k] = v
            else:
                new_flat[f"m{i}"] = ns
        return logp_sum, new_flat
