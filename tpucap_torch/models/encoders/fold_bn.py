"""Fold inference BatchNorm into the preceding conv's weights (port of
``tpucap.models.encoders.fold_bn`` for ResNet-50 and InceptionV3; an
encoder without BatchNorm, such as VGG16 or the ViT family, keeps its
params unchanged):

    scale   = gamma / sqrt(var + eps)        (gamma = 1 when scale=False)
    kernel' = kernel * scale                 (per output channel: OIHW dim 0)
    bias'   = beta + (bias - mean) * scale

computed in f32, so every BN leaves the inference graph. Where the JAX
package leaves an InceptionV3 conv's ``bn`` entry as None, the port drops
the key (``convert.params_from_jax`` drops tpucap's None entries too).
"""

from __future__ import annotations

import torch

from tpucap_torch.models.encoders.inception_v3 import BN_EPS as INCEPTION_EPS
from tpucap_torch.models.encoders.resnet50 import BN_EPS as RESNET_EPS


def _fold(conv_p: dict, bn_p: dict, eps: float) -> dict:
    kernel = conv_p["kernel"].float()
    scale = 1.0 / torch.sqrt(bn_p["var"].float() + eps)
    if "gamma" in bn_p:
        scale = scale * bn_p["gamma"].float()
    bias = conv_p["bias"].float() if "bias" in conv_p else 0.0
    return {
        "kernel": kernel * scale[:, None, None, None],
        "bias": bn_p["beta"].float() + (bias - bn_p["mean"].float()) * scale,
    }


def fold_inception_v3(params: dict) -> dict:
    """conv_i: {conv, bn} -> {conv (with bias)}. Idempotent: a folded entry
    (no bn) passes through."""
    return {
        name: {"conv": _fold(p["conv"], p["bn"], INCEPTION_EPS)}
        if p.get("bn") is not None
        else p
        for name, p in params.items()
    }


def fold_resnet50(params: dict) -> dict:
    """name_conv / name_bn pairs -> folded name_conv, name_bn dropped."""
    out = {}
    for name, p in params.items():
        if name.endswith("_bn"):
            continue
        if name.endswith("_conv"):
            bn_name = name[: -len("_conv")] + "_bn"
            if bn_name in params:
                out[name] = _fold(p, params[bn_name], RESNET_EPS)
                continue
        out[name] = p
    return out


def fold_batch_norms(encoder_name: str, params: dict) -> dict:
    if encoder_name == "inception_v3":
        return fold_inception_v3(params)
    if encoder_name == "resnet50":
        return fold_resnet50(params)
    return params  # no BatchNorm (vgg16, tiny_cnn, the ViT family)
