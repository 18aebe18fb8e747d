"""Encoder factory (the ported subset of
``tpucap.models.encoders.registry``). Each encoder carries its input size
and preprocess mode, tpucap's ``PREPROCESS_MODES`` entry."""

from __future__ import annotations

from tpucap_torch.models.encoders.resnet50 import ResNet50
from tpucap_torch.models.encoders.tiny import TinyCNN
from tpucap_torch.models.encoders.vgg16 import VGG16
from tpucap_torch.models.encoders.vit import ViT, vit_tiny

ENCODERS = {
    "vgg16": VGG16,
    "resnet50": ResNet50,
    "tiny_cnn": TinyCNN,
    "vit_b16": ViT,
    "vit_tiny": vit_tiny,
}


def build_encoder(name: str, features: str = "pooled"):
    """features: 'pooled' | 'spatial'; VGG16's 'pooled' is its fc2 vector,
    as in tpucap."""
    if name not in ENCODERS:
        raise NotImplementedError(
            f"encoder {name!r} is not ported; tpucap_torch has {sorted(ENCODERS)}"
        )
    if name == "vgg16":
        return VGG16(features="spatial" if features == "spatial" else "fc2")
    return ENCODERS[name](features=features)
