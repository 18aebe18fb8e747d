"""Soft-attention caption decoder, Show, Attend and Tell (port of
``tpucap.models.decoders.attention``). Over a spatial feature grid f
(B, L, D), each step:

    e_i   = v^T tanh(W_f f_i + W_h h_{t-1})        additive attention
    alpha = softmax(e)                              (B, L)
    ctx   = sigmoid(W_b h_{t-1}) * sum_i alpha_i f_i
    h_t, c_t = LSTM([embed(w_t); ctx], h, c)
    logits = W_o relu(W_p [h_t; ctx])

W_f f is computed once per image in ``init_state`` (``att_feat``). The
grids are the same for a beam's hypotheses, so ``beam_shared_keys`` keeps
them (B, L, ...) through the beam, and ``_attend`` infers the hypothesis
count k from h's rows. The softmax and the gate's sigmoid run in the
activation dtype, written as XLA computes them (exp, sum, divide; 1 / (1 +
exp(-x))), so a bf16 step is bit for bit the JAX package's on the CPU,
where torch's fused softmax and sigmoid would round once, in other places.
The attention MLP and the cell are torch ops (XLA ops there), not kernel
K2. ``forward_train_with_alphas`` also returns the attention
maps, for the doubly-stochastic regularizer of ``train.loss``.
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


def _softmax(e):
    """``jax.nn.softmax`` over the last axis, in e's dtype: the max held
    out of the gradient, then exp, sum and divide, each rounded there."""
    u = torch.exp(e - e.amax(dim=-1, keepdim=True).detach())
    return u / u.sum(dim=-1, keepdim=True)


def _sigmoid(x):
    """``jax.nn.sigmoid`` as XLA expands it, 1 / (1 + exp(-x)), in x's dtype."""
    return 1.0 / (1.0 + torch.exp(-x))


@dataclasses.dataclass(frozen=True)
class AttentionDecoder:
    vocab_size: int
    feature_dim: int  # channels D of the spatial grid (e.g. 512)
    embed_dim: int = 256
    hidden_dim: int = 256
    attention_dim: int = 256
    dropout_rate: float = 0.5

    # Per-image state the beam engine leaves untiled.
    beam_shared_keys = frozenset({"features", "att_feat"})

    def init(self, gen: torch.Generator):
        D, H, A = self.feature_dim, self.hidden_dim, self.attention_dim
        return {
            "att_feat": init_dense(gen, D, A),
            "att_hidden": init_dense(gen, H, A),
            "att_score": init_dense(gen, A, 1),
            "gate": init_dense(gen, H, D),
            "init_h": init_dense(gen, D, H),
            "init_c": init_dense(gen, D, H),
            "embedding": init_embedding(gen, self.vocab_size, self.embed_dim),
            "cell": init_lstm_cell(gen, self.embed_dim + D, H),
            "pre_out": init_dense(gen, H + D, H),
            "out": init_dense(gen, H, self.vocab_size),
        }

    # -- decode interface ----------------------------------------------------

    def init_state(self, params, features, rng=None, deterministic=True):
        """features: (B, L, D) spatial grid (L = 14 * 14 = 196 for VGG16)."""
        if rng is not None and not deterministic:
            features = dropout(rng, features, self.dropout_rate, False)
        mean_feat = features.mean(dim=1)
        h = dense(params["init_h"], mean_feat, torch.tanh)
        c = dense(params["init_c"], mean_feat, torch.tanh)
        att_feat = dense(params["att_feat"], features)  # (B, L, A)
        return {"features": features, "att_feat": att_feat, "h": h, "c": c}

    def _attend(self, params, state):
        """-> (gated context (B*k, D), alpha (B*k, L)). With h (B*k, H) and
        the grids (B, L, .), each image's grid serves its k hypotheses."""
        h = state["h"]
        att_feat = state["att_feat"]  # (B, L, A)
        features = state["features"]  # (B, L, D)
        B = att_feat.shape[0]
        k = h.shape[0] // B
        wh = dense(params["att_hidden"], h)  # (B*k, A)
        if k == 1:
            e = dense(params["att_score"], torch.tanh(att_feat + wh[:, None, :]))[..., 0]
            alpha = _softmax(e)  # (B, L)
            ctx = torch.einsum("bl,bld->bd", alpha, features)
        else:
            wh = wh.reshape(B, k, 1, -1)
            e = dense(params["att_score"], torch.tanh(att_feat[:, None] + wh))[..., 0]
            alpha_bk = _softmax(e)  # (B, k, L)
            ctx = torch.einsum("bkl,bld->bkd", alpha_bk, features).reshape(B * k, -1)
            alpha = alpha_bk.reshape(B * k, -1)
        beta = _sigmoid(dense(params["gate"], h))
        return beta * ctx, alpha

    def _step_full(self, params, state, token):
        ctx, alpha = self._attend(params, state)
        x = torch.cat([embed(params["embedding"], token), ctx], dim=-1)
        h, c = lstm_cell_step(params["cell"], x, state["h"], state["c"])
        merged = dense(params["pre_out"], torch.cat([h, ctx], dim=-1), torch.relu)
        new_state = {
            "features": state["features"],
            "att_feat": state["att_feat"],
            "h": h,
            "c": c,
        }
        return merged, new_state, alpha

    def step_hidden(self, params, state, token):
        hidden, new_state, _ = self._step_full(params, state, token)
        return hidden, new_state

    def step(self, params, state, token):
        hidden, new_state, _ = self._step_full(params, state, token)
        return dense(params["out"], hidden), new_state

    # -- training --------------------------------------------------------------

    def forward_hidden_with_alphas(
        self, params, features, tokens, rng=None, deterministic=True
    ):
        """Teacher-forced -> (hidden (B, T, H), alphas (B, T, L)); ``rng``
        draws the feature dropout, then the embedding dropout."""
        state = self.init_state(params, features, rng=rng, deterministic=deterministic)
        xs = embed(params["embedding"], tokens)  # (B, T, E)
        if rng is not None and not deterministic:
            xs = dropout(rng, xs, self.dropout_rate, False)
        h, c = state["h"], state["c"]
        hidden, alphas = [], []
        for t in range(xs.shape[1]):
            ctx, alpha = self._attend(params, dict(state, h=h, c=c))
            h, c = lstm_cell_step(params["cell"], torch.cat([xs[:, t], ctx], dim=-1), h, c)
            hidden.append(dense(params["pre_out"], torch.cat([h, ctx], dim=-1), torch.relu))
            alphas.append(alpha)
        return torch.stack(hidden, dim=1), torch.stack(alphas, dim=1)

    def forward_hidden(self, params, features, tokens, rng=None, deterministic=True):
        hidden, _ = self.forward_hidden_with_alphas(
            params, features, tokens, rng=rng, deterministic=deterministic
        )
        return hidden

    def forward_train_with_alphas(
        self, params, features, tokens, rng=None, deterministic=True
    ):
        """-> (logits (B, T, V), alphas (B, T, L))."""
        hidden, alphas = self.forward_hidden_with_alphas(
            params, features, tokens, rng=rng, deterministic=deterministic
        )
        return dense(params["out"], hidden), alphas

    def forward_train(self, params, features, tokens, rng=None, deterministic=True):
        logits, _ = self.forward_train_with_alphas(
            params, features, tokens, rng=rng, deterministic=deterministic
        )
        return logits
