"""Tiny CNN encoder (port of ``tpucap.models.encoders.tiny``): three SAME
3x3 convs of width/4, width/2 and width channels, each with relu and a
2x2 max pool, then the global average (pooled, 128-d) or the 4x4 grid
(spatial) at 32. tpucap's CLI tests run it; it is no reference model."""

from __future__ import annotations

import dataclasses

import torch

from tpucap_torch.models.encoders.common import conv, global_avg_pool, init_conv, max_pool


@dataclasses.dataclass(frozen=True)
class TinyCNN:
    features: str = "pooled"  # 'pooled' (128) | 'spatial' (4x4x128)
    input_size: int = 32
    preprocess_mode: str = "tf"
    width: int = 128

    @property
    def feature_dim(self) -> int:
        return self.width

    @property
    def spatial_positions(self) -> int:
        """Three stride-2 pools: (input_size // 8)^2."""
        return (self.input_size // 8) ** 2

    def init(self, gen: torch.Generator):
        w = self.width
        return {
            "conv1": init_conv(gen, 3, 3, 3, w // 4),
            "conv2": init_conv(gen, 3, 3, w // 4, w // 2),
            "conv3": init_conv(gen, 3, 3, w // 2, w),
        }

    def apply(self, params, x):
        for name in ("conv1", "conv2", "conv3"):
            x = max_pool(torch.relu(conv(params[name], x)), 2, 2)
        if self.features == "spatial":
            return x  # (B, 4, 4, width)
        return global_avg_pool(x)
