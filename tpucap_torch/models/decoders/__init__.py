"""Caption decoders of the port (``tpucap.models.decoders``):

- ``lstm.MergeDecoder``: the merge LSTM, 1 or 2 layers;
- ``lstm.InjectDecoder``: the image feature as the LSTM's initial state;
- ``gru.GruMergeDecoder``: the merge topology over 1 (gru1) or 2 (gru2)
  Keras GRU-v2 cells;
- ``attention.AttentionDecoder``: Show-Attend-Tell soft attention over a
  spatial feature grid;
- ``adaptive.AdaptiveAttentionDecoder``: attention over the grid and a
  visual sentinel (Lu et al. 2017), maps (B, T, L+1).

The transformer family is not ported yet.
"""

from tpucap_torch.models.decoders.adaptive import AdaptiveAttentionDecoder
from tpucap_torch.models.decoders.attention import AttentionDecoder
from tpucap_torch.models.decoders.gru import GruMergeDecoder
from tpucap_torch.models.decoders.lstm import InjectDecoder, MergeDecoder

#: tpucap's decoder families the port does not have.
UNPORTED = ("transformer",)


def build_decoder(
    name: str,
    vocab_size: int,
    feature_dim: int,
    embed_dim: int = 256,
    hidden_dim: int = 256,
    num_layers: int = 1,
    dropout_rate: float = 0.5,
    attention_dim: int = 256,
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
    if name in UNPORTED:
        raise NotImplementedError(
            f"decoder {name!r} is not ported; tpucap_torch has lstm1, lstm2, "
            "gru1, gru2, inject, attention and adaptive"
        )
    raise ValueError(f"unknown decoder {name!r}")


__all__ = [
    "AdaptiveAttentionDecoder",
    "AttentionDecoder",
    "GruMergeDecoder",
    "InjectDecoder",
    "MergeDecoder",
    "build_decoder",
]
