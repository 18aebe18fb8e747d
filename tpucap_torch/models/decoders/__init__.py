"""Caption decoders of the port: the merge LSTM (1 or 2 layers). The other
families of ``tpucap.models.decoders`` are not ported yet."""

from tpucap_torch.models.decoders.lstm import MergeDecoder


def build_decoder(
    name: str,
    vocab_size: int,
    feature_dim: int,
    embed_dim: int = 256,
    hidden_dim: int = 256,
    num_layers: int = 1,
    dropout_rate: float = 0.5,
) -> MergeDecoder:
    """Factory keyed by config.DecoderConfig.name."""
    if name in ("lstm1", "lstm2"):
        return MergeDecoder(
            vocab_size=vocab_size,
            feature_dim=feature_dim,
            embed_dim=embed_dim,
            hidden_dim=hidden_dim,
            num_layers=2 if name == "lstm2" else num_layers,
            dropout_rate=dropout_rate,
        )
    raise NotImplementedError(
        f"decoder {name!r} is not ported; tpucap_torch has lstm1 and lstm2"
    )


__all__ = ["MergeDecoder", "build_decoder"]
