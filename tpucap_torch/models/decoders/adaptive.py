"""Adaptive attention caption decoder with a visual sentinel, Lu et al. 2017,
"Knowing When to Look" (port of ``tpucap.models.decoders.adaptive``). Over
a spatial grid V (B, L, D), each step:

    x_t      = [embed(w_t); v_g]               v_g = relu(W_b mean(V))
    g_t      = sigmoid(W_x x_t + W_h h_{t-1})   (sentinel gate)
    h_t, c_t = LSTM(x_t, h_{t-1}, c_{t-1})
    s_t      = g_t * tanh(c_t)                  (visual sentinel)
    z_l      = w^T tanh(W_v v_l + W_g h_t)      (L grid scores)
    z_s      = w^T tanh(W_s s_t + W_g h_t)      (sentinel score)
    a        = softmax([z_1 .. z_L, z_s])       beta = a[L]
    ctx      = sum_l a_l v_l + beta * s_t
    logits   = W_o relu(W_p (ctx + h_t))

The grid is projected to hidden_dim once per image (``val``) and on to the
attention space (``att_feat``) in ``init_state``. Both are the same for a
beam's hypotheses, so ``beam_shared_keys`` keeps them (B, L, .) through the
beam and ``_attend`` infers the hypothesis count k from h's rows (b-major,
as ``AttentionDecoder``); ``glob`` (B, E) is tiled per hypothesis on
purpose. The softmax and the gate's sigmoid run in the activation dtype,
written as XLA computes them (``attention._softmax`` / ``_sigmoid``); the
cell is ``layers.lstm_cell_step``. Everything is plain PyTorch on the card
too, as the JAX package runs it as plain XLA.

The alphas surfaces return the EXTENDED distribution (B, T, L+1): columns
[:L] are the grid weights (summing to 1 - beta), column L is beta. With
``TrainConfig.attention_reg`` the doubly-stochastic regularizer runs over
that extended distribution, the sentinel column included, as the JAX
package documents (a divergence from Show-Attend-Tell, where it covers the
grid alone).
"""

from __future__ import annotations

import dataclasses

import torch

from tpucap_torch.models.decoders.attention import _sigmoid, _softmax
from tpucap_torch.models.layers import (
    dense,
    dropout,
    embed,
    init_dense,
    init_embedding,
    init_lstm_cell,
    lstm_cell_step,
)


@dataclasses.dataclass(frozen=True)
class AdaptiveAttentionDecoder:
    vocab_size: int
    feature_dim: int  # channels D of the spatial grid (e.g. 512)
    embed_dim: int = 256
    hidden_dim: int = 256
    attention_dim: int = 256
    dropout_rate: float = 0.5

    # Per-image state the beam engine leaves untiled.
    beam_shared_keys = frozenset({"val", "att_feat"})

    def init(self, gen: torch.Generator):
        D, E, H, A = self.feature_dim, self.embed_dim, self.hidden_dim, self.attention_dim
        return {
            "val": init_dense(gen, D, H),
            "att_feat": init_dense(gen, H, A),
            "att_hidden": init_dense(gen, H, A),
            "att_sent": init_dense(gen, H, A),
            "att_score": init_dense(gen, A, 1),
            "global": init_dense(gen, D, E),
            "sent_x": init_dense(gen, 2 * E, H),  # [embed(w); v_g]
            "sent_h": init_dense(gen, H, H),
            "init_h": init_dense(gen, D, H),
            "init_c": init_dense(gen, D, H),
            "embedding": init_embedding(gen, self.vocab_size, E),
            "cell": init_lstm_cell(gen, 2 * E, H),
            "pre_out": init_dense(gen, H, H),
            "out": init_dense(gen, H, self.vocab_size),
        }

    # -- decode interface ----------------------------------------------------

    def init_state(self, params, features, rng=None, deterministic=True):
        """features: (B, L, D) spatial grid (L = 14 * 14 = 196 for VGG16)."""
        if rng is not None and not deterministic:
            features = dropout(rng, features, self.dropout_rate, False)
        mean_feat = features.mean(dim=1)
        val = dense(params["val"], features)  # (B, L, H) value space
        return {
            "val": val,
            "att_feat": dense(params["att_feat"], val),  # (B, L, A) keys
            "glob": dense(params["global"], mean_feat, torch.relu),  # (B, E)
            "h": dense(params["init_h"], mean_feat, torch.tanh),
            "c": dense(params["init_c"], mean_feat, torch.tanh),
        }

    def _attend(self, params, state, h, s):
        """Attention over [grid; sentinel] -> (context (B*k, H), extended
        alpha (B*k, L+1)). With h and s (B*k, H) and the grids (B, L, .),
        each image's grid serves its k hypotheses."""
        att_feat = state["att_feat"]  # (B, L, A)
        val = state["val"]  # (B, L, H)
        B = att_feat.shape[0]
        k = h.shape[0] // B
        wh = dense(params["att_hidden"], h)  # (B*k, A)
        z_s = dense(params["att_score"], torch.tanh(dense(params["att_sent"], s) + wh))[..., 0]
        if k == 1:
            e = dense(params["att_score"], torch.tanh(att_feat + wh[:, None, :]))[..., 0]
            alpha = _softmax(torch.cat([e, z_s[:, None]], dim=-1))  # (B, L+1)
            ctx = torch.einsum("bl,bld->bd", alpha[:, :-1], val)
        else:
            wh = wh.reshape(B, k, 1, -1)
            e = dense(params["att_score"], torch.tanh(att_feat[:, None] + wh))[..., 0]
            alpha_bk = _softmax(torch.cat([e, z_s.reshape(B, k, 1)], dim=-1))  # (B, k, L+1)
            ctx = torch.einsum("bkl,bld->bkd", alpha_bk[..., :-1], val).reshape(B * k, -1)
            alpha = alpha_bk.reshape(B * k, -1)
        return ctx + alpha[:, -1:] * s, alpha

    def _cell(self, params, glob, x_t, h, c):
        """The sentinel gate and the cell on [x_t; glob] -> (h', c', s)."""
        x = torch.cat([x_t, glob], dim=-1)
        gate = _sigmoid(dense(params["sent_x"], x) + dense(params["sent_h"], h))
        h, c = lstm_cell_step(params["cell"], x, h, c)
        return h, c, gate * torch.tanh(c)

    def _step_full(self, params, state, token):
        h, c, s = self._cell(
            params, state["glob"], embed(params["embedding"], token), state["h"], state["c"]
        )
        ctx, alpha = self._attend(params, state, h, s)
        merged = dense(params["pre_out"], ctx + h, torch.relu)
        return merged, dict(state, h=h, c=c), alpha

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
        """Teacher-forced -> (hidden (B, T, H), alphas (B, T, L+1), the
        extended distribution with beta last); ``rng`` draws the feature
        dropout, then the embedding dropout."""
        state = self.init_state(params, features, rng=rng, deterministic=deterministic)
        xs = embed(params["embedding"], tokens)  # (B, T, E)
        if rng is not None and not deterministic:
            xs = dropout(rng, xs, self.dropout_rate, False)
        h, c = state["h"], state["c"]
        hidden, alphas = [], []
        for t in range(xs.shape[1]):
            h, c, s = self._cell(params, state["glob"], xs[:, t], h, c)
            ctx, alpha = self._attend(params, state, h, s)
            hidden.append(dense(params["pre_out"], ctx + h, torch.relu))
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
        """-> (logits (B, T, V), alphas (B, T, L+1))."""
        hidden, alphas = self.forward_hidden_with_alphas(
            params, features, tokens, rng=rng, deterministic=deterministic
        )
        return dense(params["out"], hidden), alphas

    def forward_train(self, params, features, tokens, rng=None, deterministic=True):
        logits, _ = self.forward_train_with_alphas(
            params, features, tokens, rng=rng, deterministic=deterministic
        )
        return logits
