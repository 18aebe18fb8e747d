"""VGG16 encoder (port of ``tpucap.models.encoders.vgg16``), Keras
applications' topology: five blocks of [2, 2, 3, 3, 3] SAME 3x3 convs with
relu, each followed by a 2x2 max pool, then fc1 and fc2 (4096, relu). The
image feature is fc2's 4096-d activation ('fc2', the reference's); 'spatial'
returns block5_conv3 before its pool (14x14x512 at 224); 'pooled' the
block5 pool's global average (512).

Keras' ``Flatten`` before fc1 is row-major over NHWC, the layout the
activations already have here; flattening NCHW would permute fc1's 25088
inputs. Param names are the Keras layer names, as in tpucap.
"""

from __future__ import annotations

import dataclasses

import torch

from tpucap_torch.models.encoders.common import conv, init_conv, max_pool
from tpucap_torch.models.layers import dense, init_dense

BLOCKS = [(64, 2, "block1"), (128, 2, "block2"), (256, 3, "block3"),
          (512, 3, "block4"), (512, 3, "block5")]


@dataclasses.dataclass(frozen=True)
class VGG16:
    features: str = "fc2"  # 'fc2' (4096) | 'pooled' (512) | 'spatial'
    input_size: int = 224
    preprocess_mode: str = "caffe"

    @property
    def feature_dim(self) -> int:
        return 4096 if self.features == "fc2" else 512

    @property
    def spatial_positions(self) -> int:
        """block5_conv3 sits after four stride-2 pools: (input_size // 16)^2."""
        return (self.input_size // 16) ** 2

    def init(self, gen: torch.Generator):
        params = {}
        cin = 3
        for ch, n, blk in BLOCKS:
            for i in range(n):
                params[f"{blk}_conv{i + 1}"] = init_conv(gen, 3, 3, cin, ch)
                cin = ch
        if self.features == "fc2":
            params["fc1"] = init_dense(gen, 7 * 7 * 512, 4096)
            params["fc2"] = init_dense(gen, 4096, 4096)
        return params

    def apply(self, params, x):
        """x: (B, 224, 224, 3) preprocessed (caffe mode: BGR, mean-subtracted)."""
        for ch, n, blk in BLOCKS:
            for i in range(n):
                x = torch.relu(conv(params[f"{blk}_conv{i + 1}"], x))
                if self.features == "spatial" and blk == "block5" and i == n - 1:
                    return x  # block5_conv3 before its pool
            x = max_pool(x, 2, 2)
        if self.features == "fc2":
            x = x.reshape(x.shape[0], -1)  # Keras Flatten: row-major NHWC
            x = dense(params["fc1"], x, torch.relu)
            return dense(params["fc2"], x, torch.relu)
        return x.mean(dim=(1, 2))
