"""Caption decoders of the port (``tpucap.models.decoders``):

- ``lstm.MergeDecoder``: the merge LSTM, 1 or 2 layers;
- ``lstm.InjectDecoder``: the image feature as the LSTM's initial state;
- ``gru.GruMergeDecoder``: the merge topology over 1 (gru1) or 2 (gru2)
  Keras GRU-v2 cells;
- ``attention.AttentionDecoder``: Show-Attend-Tell soft attention over a
  spatial feature grid;
- ``adaptive.AdaptiveAttentionDecoder``: attention over the grid and a
  visual sentinel (Lu et al. 2017), maps (B, T, L+1);
- ``transformer.TransformerDecoder``: a pre-LN causal Transformer with
  cross-attention, an incremental KV cache and an optional
  mixture-of-experts MLP.
"""

from tpucap_torch.models.decoders.adaptive import AdaptiveAttentionDecoder
from tpucap_torch.models.decoders.attention import AttentionDecoder
from tpucap_torch.models.decoders.gru import GruMergeDecoder
from tpucap_torch.models.decoders.lstm import InjectDecoder, MergeDecoder
from tpucap_torch.models.decoders.transformer import TransformerDecoder

#: tpucap's decoder families the port does not have.
UNPORTED = ()


def build_decoder(
    name: str,
    vocab_size: int,
    feature_dim: int,
    embed_dim: int = 256,
    hidden_dim: int = 256,
    num_layers: int = 1,
    dropout_rate: float = 0.5,
    attention_dim: int = 256,
    num_heads: int = 4,
    mlp_dim: int = 1024,
    max_positions: int = 40,
    num_experts: int = 0,
    moe_top_k: int = 2,
):
    """Factory keyed by config.DecoderConfig.name, with tpucap's arguments."""
    if name in ("lstm1", "lstm2"):
        return MergeDecoder(
            vocab_size=vocab_size,
            feature_dim=feature_dim,
            embed_dim=embed_dim,
            hidden_dim=hidden_dim,
            num_layers=2 if name == "lstm2" else num_layers,
            dropout_rate=dropout_rate,
        )
    if name in ("gru1", "gru2"):
        return GruMergeDecoder(
            vocab_size=vocab_size,
            feature_dim=feature_dim,
            embed_dim=embed_dim,
            hidden_dim=hidden_dim,
            num_layers=2 if name == "gru2" else num_layers,
            dropout_rate=dropout_rate,
        )
    if name == "inject":
        return InjectDecoder(
            vocab_size=vocab_size,
            feature_dim=feature_dim,
            embed_dim=embed_dim,
            hidden_dim=hidden_dim,
            num_layers=num_layers,
            dropout_rate=dropout_rate,
        )
    if name == "attention":
        return AttentionDecoder(
            vocab_size=vocab_size,
            feature_dim=feature_dim,
            embed_dim=embed_dim,
            hidden_dim=hidden_dim,
            attention_dim=attention_dim,
            dropout_rate=dropout_rate,
        )
    if name == "adaptive":
        return AdaptiveAttentionDecoder(
            vocab_size=vocab_size,
            feature_dim=feature_dim,
            embed_dim=embed_dim,
            hidden_dim=hidden_dim,
            attention_dim=attention_dim,
            dropout_rate=dropout_rate,
        )
    if name == "transformer":
        return TransformerDecoder(
            vocab_size=vocab_size,
            feature_dim=feature_dim,
            hidden_dim=hidden_dim,
            num_layers=num_layers,
            num_heads=num_heads,
            mlp_dim=mlp_dim,
            max_positions=max_positions,
            dropout_rate=dropout_rate,
            num_experts=num_experts,
            moe_top_k=moe_top_k,
        )
    raise ValueError(f"unknown decoder {name!r}")


__all__ = [
    "AdaptiveAttentionDecoder",
    "AttentionDecoder",
    "GruMergeDecoder",
    "InjectDecoder",
    "MergeDecoder",
    "TransformerDecoder",
    "build_decoder",
]
