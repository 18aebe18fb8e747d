"""Image encoders of the port: ResNet-50 (pooled and conv4 spatial)."""

from tpucap_torch.models.encoders.fold_bn import fold_batch_norms
from tpucap_torch.models.encoders.registry import ENCODERS, build_encoder
from tpucap_torch.models.encoders.resnet50 import ResNet50

__all__ = [
    "ENCODERS",
    "ResNet50",
    "build_encoder",
    "fold_batch_norms",
]
