"""ResNet-50 v1 encoder, Keras-applications-compatible (port of
``tpucap.models.encoders.resnet50``).

Zero-pad 3 + 7x7/2 conv + BN/relu + maxpool, then bottleneck stacks
conv2..conv5 of [3, 4, 6, 3] blocks, stride 2 in each stack's first block
except conv2, placed in the block's first 1x1 conv (v1, not v1.5); BN eps
1.001e-5; global average pool -> 2048-d feature. 'spatial' mode returns the
conv4 output (14x14x1024 at 224). Param names are the Keras layer names.

``fused_blocks=True`` routes the stride-1 identity blocks of the stages in
``fused_stages`` through kernel K4 (``ops.bottleneck``) once BN is folded:
12 blocks with all four stages (each stack's first block has a conv
shortcut). On unfolded params the flag does nothing, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from tpucap_torch.models.encoders.common import (
    batch_norm,
    conv,
    global_avg_pool,
    init_bn,
    init_conv,
    max_pool,
    zero_pad,
)
from tpucap_torch.ops.bottleneck import fused_identity_block

BN_EPS = 1.001e-5
STACKS = [  # (name, filters, blocks, stride1)
    ("conv2", 64, 3, 1),
    ("conv3", 128, 4, 2),
    ("conv4", 256, 6, 2),
    ("conv5", 512, 3, 2),
]


@dataclasses.dataclass(frozen=True)
class ResNet50:
    features: str = "pooled"  # 'pooled' (2048) | 'spatial' (14x14x1024)
    input_size: int = 224
    preprocess_mode: str = "caffe"
    # Inference-only opt-in: stride-1 identity blocks of fused_stages run
    # as kernel K4 once BN is folded (a no-op on unfolded params).
    fused_blocks: bool = False
    fused_stages: tuple = ("conv2", "conv3", "conv4", "conv5")

    @property
    def feature_dim(self) -> int:
        return 2048 if self.features == "pooled" else 1024

    @property
    def spatial_positions(self) -> int:
        """Flattened spatial-grid length in 'spatial' mode."""
        s = (self.input_size + 6 - 7) // 2 + 1  # pad3 + 7x7/2 VALID
        s = (s + 2 - 3) // 2 + 1  # pad1 + maxpool3/2
        s = (s - 1) // 2 + 1  # conv3 stride-2 1x1 VALID
        s = (s - 1) // 2 + 1  # conv4 stride-2 1x1 VALID
        return s * s

    def init(self, gen: torch.Generator):
        p = {
            "conv1_conv": init_conv(gen, 7, 7, 3, 64),
            "conv1_bn": init_bn(64),
        }
        cin = 64
        for name, filters, blocks, _ in STACKS:
            for b in range(1, blocks + 1):
                blk = f"{name}_block{b}"
                if b == 1:
                    p[f"{blk}_0_conv"] = init_conv(gen, 1, 1, cin, 4 * filters)
                    p[f"{blk}_0_bn"] = init_bn(4 * filters)
                p[f"{blk}_1_conv"] = init_conv(gen, 1, 1, cin, filters)
                p[f"{blk}_1_bn"] = init_bn(filters)
                p[f"{blk}_2_conv"] = init_conv(gen, 3, 3, filters, filters)
                p[f"{blk}_2_bn"] = init_bn(filters)
                p[f"{blk}_3_conv"] = init_conv(gen, 1, 1, filters, 4 * filters)
                p[f"{blk}_3_bn"] = init_bn(4 * filters)
                cin = 4 * filters
        return p

    @staticmethod
    def _bn(p, name, y):
        # name_bn keys are dropped after fold_batch_norms.
        if name in p:
            return batch_norm(p[name], y, BN_EPS)
        return y

    def _block(self, p, x, blk, stride, conv_shortcut):
        if (
            self.fused_blocks
            and stride == 1
            and not conv_shortcut
            and blk.split("_")[0] in self.fused_stages
            and f"{blk}_1_bn" not in p  # BN folded -> kernel+bias convs
        ):
            return fused_identity_block(
                p[f"{blk}_1_conv"], p[f"{blk}_2_conv"], p[f"{blk}_3_conv"], x
            )
        if conv_shortcut:
            shortcut = conv(
                p[f"{blk}_0_conv"], x, stride=(stride, stride), padding="VALID"
            )
            shortcut = self._bn(p, f"{blk}_0_bn", shortcut)
        else:
            shortcut = x
        y = conv(p[f"{blk}_1_conv"], x, stride=(stride, stride), padding="VALID")
        y = torch.relu(self._bn(p, f"{blk}_1_bn", y))
        y = conv(p[f"{blk}_2_conv"], y, padding="SAME")
        y = torch.relu(self._bn(p, f"{blk}_2_bn", y))
        y = conv(p[f"{blk}_3_conv"], y, padding="VALID")
        y = self._bn(p, f"{blk}_3_bn", y)
        return torch.relu(shortcut + y)

    def apply(self, params, x):
        """x: (B, H, W, 3) preprocessed (caffe mode), NHWC."""
        x = zero_pad(x, ((3, 3), (3, 3)))
        x = conv(params["conv1_conv"], x, stride=(2, 2), padding="VALID")
        x = torch.relu(self._bn(params, "conv1_bn", x))
        x = zero_pad(x, ((1, 1), (1, 1)))
        x = max_pool(x, 3, 2)
        for name, _, blocks, stride1 in STACKS:
            for b in range(1, blocks + 1):
                x = self._block(
                    params,
                    x,
                    f"{name}_block{b}",
                    stride=stride1 if b == 1 else 1,
                    conv_shortcut=b == 1,
                )
            if self.features == "spatial" and name == "conv4":
                return x  # (B, 14, 14, 1024)
        return global_avg_pool(x)
