"""Encoder factory (the ported subset of
``tpucap.models.encoders.registry``)."""

from __future__ import annotations

from tpucap_torch.models.encoders.resnet50 import ResNet50
from tpucap_torch.models.encoders.vit import ViT, vit_tiny

ENCODERS = {
    "resnet50": ResNet50,
    "vit_b16": ViT,
    "vit_tiny": vit_tiny,
}


def build_encoder(name: str, features: str = "pooled"):
    if name not in ENCODERS:
        raise NotImplementedError(
            f"encoder {name!r} is not ported; tpucap_torch has {sorted(ENCODERS)}"
        )
    return ENCODERS[name](features=features)
