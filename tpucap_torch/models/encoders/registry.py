"""Encoder factory (port of ``tpucap.models.encoders.registry``: every
encoder of its table). Each encoder carries its input size and preprocess
mode, tpucap's ``PREPROCESS_MODES`` entry: caffe at 224 for VGG16 and
ResNet-50, tf at 299 for InceptionV3, tf for the ViT family and tiny_cnn."""

from __future__ import annotations

from tpucap_torch.models.encoders.inception_v3 import InceptionV3
from tpucap_torch.models.encoders.resnet50 import ResNet50
from tpucap_torch.models.encoders.tiny import TinyCNN
from tpucap_torch.models.encoders.vgg16 import VGG16
from tpucap_torch.models.encoders.vit import ViT, vit_tiny

ENCODERS = {
    "vgg16": VGG16,
    "inception_v3": InceptionV3,
    "resnet50": ResNet50,
    "tiny_cnn": TinyCNN,
    "vit_b16": ViT,
    "vit_tiny": vit_tiny,
}


def build_encoder(name: str, features: str = "pooled"):
    """features: 'pooled' | 'spatial'; VGG16's 'pooled' is its fc2 vector,
    as in tpucap."""
    if name not in ENCODERS:
        raise ValueError(f"unknown encoder {name!r}; have {sorted(ENCODERS)}")
    if name == "vgg16":
        return VGG16(features="spatial" if features == "spatial" else "fc2")
    return ENCODERS[name](features=features)
