"""Vision Transformer encoder (port of ``tpucap.models.encoders.vit``).

Pre-LN ViT over a (g x g) patch grid with no CLS token: a P-stride PxP
patchify conv, learned 2-D position embeddings (g*g, H), ``num_layers``
blocks of LayerNorm -> fused qkv dense -> attention -> output dense, and
LayerNorm -> dense -> gelu (tanh) -> dense, each with a residual, then a
final LayerNorm. 'pooled' features are the mean over tokens (B, H);
'spatial' is the token grid (B, g, g, H). Input is NHWC, preprocessed in
'tf' mode (x/127.5 - 1).

``attention_impl="xla"`` runs ``layers.sdpa`` (library matmuls, as the JAX
package leaves them to XLA); ``"flash"`` runs kernel K5
(``ops.attention.flash_attention_qkv``) on the card, straight on the views
of the qkv projection, and when the projection needs a gradient K5's
backward kernels too. Every other op is plain PyTorch, so ``apply`` is
differentiable as it stands. BatchNorm folding is a no-op (the family has
none).
"""

from __future__ import annotations

import dataclasses

import torch

from tpucap_torch.models.encoders.common import conv, init_conv
from tpucap_torch.models.layers import (
    dense,
    gelu,
    init_dense,
    init_layer_norm,
    layer_norm,
    merge_heads,
    sdpa,
    split_heads,
)
from tpucap_torch.ops.attention import flash_attention_qkv


@dataclasses.dataclass(frozen=True)
class ViT:
    """Pre-LN ViT. Defaults are ViT-B/16 (224 input, 12x768, 12 heads)."""

    features: str = "pooled"  # 'pooled' (hidden_dim) | 'spatial' (g x g grid)
    input_size: int = 224
    patch_size: int = 16
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    preprocess_mode: str = "tf"
    attention_impl: str = "xla"  # 'xla' | 'flash' (kernel K5)

    def __post_init__(self):
        if self.input_size % self.patch_size:
            raise ValueError(
                f"input_size {self.input_size} not divisible by "
                f"patch_size {self.patch_size}"
            )
        if self.hidden_dim % self.num_heads:
            raise ValueError(
                f"hidden_dim {self.hidden_dim} not divisible by "
                f"num_heads {self.num_heads}"
            )
        if self.attention_impl not in ("xla", "flash"):
            raise ValueError(
                f"attention_impl must be 'xla' or 'flash', got "
                f"{self.attention_impl!r}"
            )

    @property
    def feature_dim(self) -> int:
        return self.hidden_dim

    @property
    def grid(self) -> int:
        return self.input_size // self.patch_size

    @property
    def spatial_positions(self) -> int:
        return self.grid**2

    def init(self, gen: torch.Generator):
        H, M, P = self.hidden_dim, self.mlp_dim, self.patch_size
        blocks = [
            {
                "ln1": init_layer_norm(H),
                "qkv": init_dense(gen, H, 3 * H),
                "o": init_dense(gen, H, H),
                "ln2": init_layer_norm(H),
                "mlp_in": init_dense(gen, H, M),
                "mlp_out": init_dense(gen, M, H),
            }
            for _ in range(self.num_layers)
        ]
        return {
            "patch_embed": init_conv(gen, P, P, 3, H),
            "pos_embedding": 0.02
            * torch.randn((self.spatial_positions, H), generator=gen),
            "blocks": blocks,
            "ln_f": init_layer_norm(H),
        }

    def apply(self, params, x):
        """x (B, S, S, 3) preprocessed -> pooled (B, H) or spatial
        (B, g, g, H) token grid."""
        P, H, g = self.patch_size, self.hidden_dim, self.grid
        t = conv(params["patch_embed"], x, stride=(P, P), padding="VALID")
        B = t.shape[0]
        t = t.reshape(B, g * g, H)
        t = t + params["pos_embedding"].to(t.dtype)

        scale = 1.0 / float(H // self.num_heads) ** 0.5
        for block in params["blocks"]:
            h1 = layer_norm(block["ln1"], t)
            qkv = dense(block["qkv"], h1)  # (B, L, 3H)
            if self.attention_impl == "flash":
                # tpucap's _flash_ctx pads L to a multiple of 128 and
                # masks with segment ids; K5 masks keys past L itself,
                # so nothing is padded or sliced here.
                ctx = flash_attention_qkv(qkv, self.num_heads, scale)
            else:
                q = split_heads(qkv[..., :H], self.num_heads)
                k = split_heads(qkv[..., H : 2 * H], self.num_heads)
                v = split_heads(qkv[..., 2 * H :], self.num_heads)
                ctx, _ = sdpa(q, k, v, None, scale)
            t = t + dense(block["o"], merge_heads(ctx))
            h2 = layer_norm(block["ln2"], t)
            t = t + dense(block["mlp_out"], dense(block["mlp_in"], h2, gelu))

        t = layer_norm(params["ln_f"], t)
        if self.features == "spatial":
            return t.reshape(B, g, g, H)
        return t.mean(dim=1)


def vit_tiny(features: str = "pooled") -> ViT:
    """Test-scale ViT (32px, 4x4 patches -> 8x8 grid, 2x64, 4 heads)."""
    return ViT(
        features=features,
        input_size=32,
        patch_size=4,
        hidden_dim=64,
        num_layers=2,
        num_heads=4,
        mlp_dim=128,
    )
