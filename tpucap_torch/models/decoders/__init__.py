"""Caption decoders of the port (``tpucap.models.decoders``):

- ``lstm.MergeDecoder``: the merge LSTM, 1 or 2 layers;
- ``lstm.InjectDecoder``: the image feature as the LSTM's initial state;
- ``attention.AttentionDecoder``: Show-Attend-Tell soft attention over a
  spatial feature grid.

The GRU, adaptive and transformer families are not ported yet.
"""

from tpucap_torch.models.decoders.attention import AttentionDecoder
from tpucap_torch.models.decoders.lstm import InjectDecoder, MergeDecoder

#: tpucap's decoder families the port does not have.
UNPORTED = ("gru1", "gru2", "adaptive", "transformer")


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
    if name in UNPORTED:
        raise NotImplementedError(
            f"decoder {name!r} is not ported; tpucap_torch has lstm1, lstm2, "
            "inject and attention"
        )
    raise ValueError(f"unknown decoder {name!r}")


__all__ = ["AttentionDecoder", "InjectDecoder", "MergeDecoder", "build_decoder"]
