"""Pre-LN causal Transformer caption decoder with an incremental KV cache
and an optional mixture-of-experts MLP (port of
``tpucap.models.decoders.transformer``). Each layer is causal
self-attention, cross-attention over the projected image features, then a
dense or MoE MLP, each a residual branch behind its own LayerNorm.

The decode state is

- ``mem_k`` / ``mem_v`` (B, L, Lm, heads, head_dim): every layer's
  cross-attention K/V, made once in ``init_state``; ``beam_shared_keys``
  keeps them (B, ...) through the beam, and ``_cross_attend`` lets each
  image's memory serve its k hypotheses (Bq = Bm k) without tiling it;
- ``cache_k`` / ``cache_v`` (B, L, max_positions, heads, head_dim): the
  self-attention KV cache, written at each lane's own position;
- ``pos`` (B,) int: the per-lane write position, so the continuous engines
  host lanes of different depths in one state.

A lane writes slot ``clip(pos, 0, max_positions - 1)`` and sees the keys
at positions <= its unclipped ``pos``, as the JAX package does: a lane past
capacity (a retired continuous lane still ticking) writes the last slot
and sees every key. ``step_chunk`` runs C tokens a lane in one forward
against the cache (the chunked prefix priming of ``decode/prefix.py``),
with the same values as C successive ``step`` calls: the chunk's K/V are
written before the attention, and a query at position q sees the keys at
positions <= q, history and chunk alike.

The MoE MLP is dense dispatch: every expert runs on every token as one
stacked product over the (E, H, M) weights, and the router's top-k gates,
renormalized, zero the others. The router's top-k breaks ties in index
order (``jax.lax.top_k``'s, here ``topk_stable``). ``forward_train_with_moe_aux``
also returns the summed Switch load-balance loss; no single-device
training step reads it, as in the JAX package, whose expert-parallel step
alone does. Everything is plain PyTorch on the card too, as the JAX package
runs it as plain XLA.
"""

from __future__ import annotations

import dataclasses

import torch

from tpucap_torch.decode.beam import topk_stable
from tpucap_torch.models.layers import (
    dense,
    dropout,
    embed,
    gelu,
    init_dense,
    init_embedding,
    init_layer_norm,
    layer_norm,
    merge_heads,
    sdpa,
    split_heads,
)


def _stack(trees):
    """A list of dense param dicts -> one dict of stacked (E, ...) tensors."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


@dataclasses.dataclass(frozen=True)
class TransformerDecoder:
    vocab_size: int
    feature_dim: int
    hidden_dim: int = 256  # d_model, also the embedding width
    num_layers: int = 2
    num_heads: int = 4
    mlp_dim: int = 1024
    max_positions: int = 40  # positional table and KV-cache capacity
    dropout_rate: float = 0.1
    # 0 = the dense MLP; > 0 = that many experts a layer, top-k routed.
    num_experts: int = 0
    moe_top_k: int = 2

    # Per-image state the beam engine leaves untiled.
    beam_shared_keys = frozenset({"mem_k", "mem_v"})

    def __post_init__(self):
        if self.num_layers < 1:
            raise ValueError(f"num_layers must be >= 1, got {self.num_layers}")
        if self.hidden_dim % self.num_heads:
            raise ValueError(
                f"hidden_dim {self.hidden_dim} not divisible by "
                f"num_heads {self.num_heads}"
            )
        if self.num_experts and not (1 <= self.moe_top_k <= self.num_experts):
            raise ValueError(
                f"moe_top_k {self.moe_top_k} must be in "
                f"[1, num_experts={self.num_experts}]"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def _scale(self) -> float:
        return 1.0 / float(self.head_dim) ** 0.5

    # -- params ----------------------------------------------------------------

    def init(self, gen: torch.Generator):
        H, M, E = self.hidden_dim, self.mlp_dim, self.num_experts
        params = {
            "embedding": init_embedding(gen, self.vocab_size, H),
            "pos_embedding": 0.02 * torch.randn((self.max_positions, H), generator=gen),
            "mem_proj": init_dense(gen, self.feature_dim, H),
        }
        layers = []
        for _ in range(self.num_layers):
            layer = {
                "ln1": init_layer_norm(H),
                "qkv": init_dense(gen, H, 3 * H),  # one fused H -> 3H projection
                "o": init_dense(gen, H, H),
                "ln2": init_layer_norm(H),
                "xq": init_dense(gen, H, H),
                "xk": init_dense(gen, H, H),
                "xv": init_dense(gen, H, H),
                "xo": init_dense(gen, H, H),
                "ln3": init_layer_norm(H),
            }
            if E:
                layer["router"] = init_dense(gen, H, E)
                layer["moe_in"] = _stack([init_dense(gen, H, M) for _ in range(E)])
                layer["moe_out"] = _stack([init_dense(gen, M, H) for _ in range(E)])
            else:
                layer["mlp_in"] = init_dense(gen, H, M)
                layer["mlp_out"] = init_dense(gen, M, H)
            layers.append(layer)
        params["layers"] = layers
        params["ln_f"] = init_layer_norm(H)
        params["out"] = init_dense(gen, H, self.vocab_size)
        return params

    # -- shared pieces -----------------------------------------------------------

    def project_memory(self, params, features):
        """features (B, D) pooled or (B, Lm, D) spatial -> (B, Lm, H)."""
        if features.ndim == 2:
            features = features[:, None, :]
        return dense(params["mem_proj"], features)

    def layer_memory(self, layer, mem):
        """One layer's cross-attention K/V: mem (B, Lm, H) -> two
        (B, Lm, heads, head_dim)."""
        return (
            split_heads(dense(layer["xk"], mem), self.num_heads),
            split_heads(dense(layer["xv"], mem), self.num_heads),
        )

    def _memory(self, params, features):
        """-> mem_k, mem_v (B, L, Lm, heads, head_dim)."""
        mem = self.project_memory(params, features)
        kv = [self.layer_memory(layer, mem) for layer in params["layers"]]
        return torch.stack([k for k, _ in kv], dim=1), torch.stack([v for _, v in kv], dim=1)

    def _cross_attend(self, layer, x, mem_k_l, mem_v_l):
        """x (Bq, Q, H) over the memory (Bm, Lm, h, d), Bq = Bm k: an image's
        k query rows attend to its one memory, as k Q queries of one row
        (each query's softmax is its own). -> (x', alpha (Bq, Q, Lm) f32,
        the head-averaged cross-attention)."""
        h2 = layer_norm(layer["ln2"], x)
        qx = split_heads(dense(layer["xq"], h2), self.num_heads)  # (Bq, Q, h, d)
        Bq, Q = qx.shape[:2]
        Bm, Lm = mem_k_l.shape[:2]
        ctx, w = sdpa(qx.reshape((Bm, -1) + qx.shape[2:]), mem_k_l, mem_v_l, None, self._scale)
        ctx = ctx.reshape(qx.shape)
        out = x + dense(layer["xo"], merge_heads(ctx))
        return out, w.mean(dim=-3).reshape(Bq, Q, Lm)

    def _mlp_block(self, layer, h):
        """-> (y, aux): the dense or MoE MLP and the scalar load-balance
        loss (0.0 for the dense MLP)."""
        if not self.num_experts:
            y = dense(layer["mlp_out"], dense(layer["mlp_in"], h, gelu))
            return y, torch.zeros((), dtype=torch.float32, device=h.device)
        return self._moe_mlp(layer, h)

    def _moe_mlp(self, layer, h):
        """Top-k-routed mixture of experts, dense dispatch. The three
        products are taken in h's dtype, the biases added in it, the gates
        cast to it. aux = E sum_e f_e P_e, f_e the share of top-k routings
        to expert e and P_e its mean router probability."""
        E, K = self.num_experts, self.moe_top_k
        probs = torch.softmax(dense(layer["router"], h).float(), dim=-1)  # (..., E)
        _, top_idx = topk_stable(probs, K)
        sel = torch.nn.functional.one_hot(top_idx, E).to(probs.dtype).sum(dim=-2)
        kept = probs * sel
        gates = kept / kept.sum(dim=-1, keepdim=True)
        lead = tuple(range(probs.ndim - 1))
        f = (sel / K).mean(dim=lead)
        P = probs.mean(dim=lead)
        aux = E * torch.sum(f * P)
        w_in, b_in = layer["moe_in"]["kernel"].to(h.dtype), layer["moe_in"]["bias"].to(h.dtype)
        w_out, b_out = layer["moe_out"]["kernel"].to(h.dtype), layer["moe_out"]["bias"].to(h.dtype)
        act = gelu(torch.einsum("...h,ehm->...em", h, w_in) + b_in)
        out_e = torch.einsum("...em,emh->...eh", act, w_out) + b_out
        y = torch.einsum("...eh,...e->...h", out_e, gates.to(h.dtype))
        return y, aux

    def layer_train(self, layer, x, mem_k_l, mem_v_l, causal, rng=None):
        """One teacher-forced layer: x (B, T, H) -> (x', alpha (B, T, Lm),
        moe_aux). ``rng`` draws the attention branch's dropout, then the
        MLP branch's."""
        H = self.hidden_dim
        qkv = dense(layer["qkv"], layer_norm(layer["ln1"], x))
        q, k, v = (split_heads(qkv[..., i * H : (i + 1) * H], self.num_heads) for i in range(3))
        ctx, _ = sdpa(q, k, v, causal, self._scale)
        attn = dense(layer["o"], merge_heads(ctx))
        if rng is not None:
            attn = dropout(rng, attn, self.dropout_rate, False)
        x = x + attn
        x, alpha = self._cross_attend(layer, x, mem_k_l, mem_v_l)
        mlp, aux = self._mlp_block(layer, layer_norm(layer["ln3"], x))
        if rng is not None:
            mlp = dropout(rng, mlp, self.dropout_rate, False)
        return x + mlp, alpha, aux

    # -- decode interface ----------------------------------------------------------

    def init_state(self, params, features, rng=None, deterministic=True):
        if rng is not None and not deterministic:
            features = dropout(rng, features, self.dropout_rate, False)
        mem_k, mem_v = self._memory(params, features)
        B = mem_k.shape[0]
        shape = (B, self.num_layers, self.max_positions, self.num_heads, self.head_dim)
        return {
            "mem_k": mem_k,
            "mem_v": mem_v,
            "cache_k": torch.zeros(shape, dtype=mem_k.dtype, device=mem_k.device),
            "cache_v": torch.zeros(shape, dtype=mem_k.dtype, device=mem_k.device),
            "pos": torch.zeros((B,), dtype=torch.int32, device=mem_k.device),
        }

    def _cached_layers(self, params, state, tokens):
        """tokens (B, C) at positions pos .. pos + C - 1 of each lane, through
        every layer against the cache -> (hidden (B, C, H) after ln_f, the
        new state). The caches are copied once; each layer writes its chunk
        K/V into the copy at the clipped positions, then attends to keys at
        positions <= the query's own (unclipped) position. Under the
        capacity contract a chunk's slots never collide (the JAX package's
        one-hot placement would sum them)."""
        pos = state["pos"].long()
        B, C = tokens.shape
        qpos = pos[:, None] + torch.arange(C, device=pos.device)[None, :]  # (B, C)
        qpos_c = torch.clamp(qpos, 0, self.max_positions - 1)
        dtype = state["mem_k"].dtype
        x = embed(params["embedding"], tokens) + params["pos_embedding"].to(dtype)[qpos_c]
        positions = torch.arange(self.max_positions, device=pos.device)
        vis = positions[None, None, :] <= qpos[:, :, None]  # (B, C, T)
        rows = torch.arange(B, device=pos.device)[:, None].expand(B, C)
        cache_k, cache_v = state["cache_k"].clone(), state["cache_v"].clone()
        H = self.hidden_dim
        for l, layer in enumerate(params["layers"]):
            qkv = dense(layer["qkv"], layer_norm(layer["ln1"], x))  # (B, C, 3H)
            q, k_new, v_new = (split_heads(qkv[..., i * H : (i + 1) * H], self.num_heads) for i in range(3))
            ck, cv = cache_k[:, l], cache_v[:, l]
            ck[rows, qpos_c] = k_new
            cv[rows, qpos_c] = v_new
            ctx, _ = sdpa(q, ck, cv, vis, self._scale)
            x = x + dense(layer["o"], merge_heads(ctx))
            x, _ = self._cross_attend(layer, x, state["mem_k"][:, l], state["mem_v"][:, l])
            mlp, _ = self._mlp_block(layer, layer_norm(layer["ln3"], x))
            x = x + mlp
        new_state = {
            "mem_k": state["mem_k"],
            "mem_v": state["mem_v"],
            "cache_k": cache_k,
            "cache_v": cache_v,
            "pos": state["pos"] + C,
        }
        return layer_norm(params["ln_f"], x), new_state

    def step_hidden(self, params, state, token):
        """token (B,) -> (hidden (B, H) before the vocabulary product, state)."""
        hidden, new_state = self._cached_layers(params, state, token[:, None])
        return hidden[:, 0], new_state

    def step(self, params, state, token):
        hidden, new_state = self.step_hidden(params, state, token)
        return dense(params["out"], hidden), new_state

    def step_chunk(self, params, state, tokens):
        """C tokens a lane in one forward against the cache: tokens (B, C) ->
        (logits (B, C, V), state with each lane's ``pos`` advanced by C).
        Capacity contract: ``pos + C <= max_positions`` in every lane."""
        hidden, new_state = self._cached_layers(params, state, tokens)
        return dense(params["out"], hidden), new_state

    # -- training ------------------------------------------------------------

    def _forward_with_alpha(self, params, features, tokens, rng=None, deterministic=True):
        """The teacher-forced body -> (hidden (B, T, H), the last layer's
        alpha, the summed MoE aux). ``rng`` draws the feature dropout, the
        embedding dropout, then each layer's two."""
        B, T = tokens.shape
        if T > self.max_positions:
            raise ValueError(
                f"sequence length {T} exceeds max_positions "
                f"{self.max_positions}"
            )
        drop = rng if rng is not None and not deterministic else None
        if drop is not None:
            features = dropout(drop, features, self.dropout_rate, False)
        mem_k, mem_v = self._memory(params, features)
        x = embed(params["embedding"], tokens) + params["pos_embedding"][:T].to(mem_k.dtype)
        if drop is not None:
            x = dropout(drop, x, self.dropout_rate, False)
        causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))[None]
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for l, layer in enumerate(params["layers"]):
            x, alpha, aux = self.layer_train(layer, x, mem_k[:, l], mem_v[:, l], causal, drop)
            aux_total = aux_total + aux
        return layer_norm(params["ln_f"], x), alpha, aux_total

    def forward_hidden(self, params, features, tokens, rng=None, deterministic=True):
        """Teacher-forced hidden states (B, T, H) before the vocabulary
        product; causal masking only (inputs are post-padded)."""
        hidden, _, _ = self._forward_with_alpha(params, features, tokens, rng, deterministic)
        return hidden

    def forward_hidden_with_alphas(self, params, features, tokens, rng=None, deterministic=True):
        """-> (hidden (B, T, H), alphas (B, T, Lm) f32): the last layer's
        head-averaged cross-attention, each row summing to 1 over Lm."""
        hidden, alpha, _ = self._forward_with_alpha(params, features, tokens, rng, deterministic)
        return hidden, alpha.float()

    def forward_train(self, params, features, tokens, rng=None, deterministic=True):
        """tokens (B, T) post-padded input ids -> logits (B, T, V)."""
        return dense(params["out"], self.forward_hidden(params, features, tokens, rng, deterministic))

    def forward_train_with_moe_aux(self, params, features, tokens, rng=None, deterministic=True):
        """-> (logits (B, T, V), the summed MoE load-balance aux)."""
        hidden, _, aux = self._forward_with_alpha(params, features, tokens, rng, deterministic)
        return dense(params["out"], hidden), aux
