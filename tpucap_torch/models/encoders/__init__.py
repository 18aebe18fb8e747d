"""Image encoders of the port: VGG16 (fc2 and block5 spatial), InceptionV3
(pooled and mixed7 spatial), ResNet-50 (pooled and conv4 spatial), the ViT
family (ViT-B/16, vit_tiny) and tiny_cnn."""

from tpucap_torch.models.encoders.fold_bn import fold_batch_norms
from tpucap_torch.models.encoders.inception_v3 import InceptionV3
from tpucap_torch.models.encoders.registry import ENCODERS, build_encoder
from tpucap_torch.models.encoders.resnet50 import ResNet50
from tpucap_torch.models.encoders.tiny import TinyCNN
from tpucap_torch.models.encoders.vgg16 import VGG16
from tpucap_torch.models.encoders.vit import ViT, vit_tiny

__all__ = [
    "ENCODERS",
    "InceptionV3",
    "ResNet50",
    "TinyCNN",
    "VGG16",
    "ViT",
    "build_encoder",
    "fold_batch_norms",
    "vit_tiny",
]
