"""InceptionV3 encoder (port of ``tpucap.models.encoders.inception_v3``),
Keras applications' topology: the stem (3 convs, pool, 2 convs, pool),
mixed0-2 (35x35), mixed3 (grid reduction), mixed4-7 (17x17, 7x1 / 1x7
factorized), mixed8 (reduction), mixed9-10 (8x8, split 1x3 / 3x1
branches), then the global average: 2048-d. 'spatial' returns the mixed7
map (17x17x768 at 299).

Every conv is bias-free, then BatchNorm(scale=False, eps=1e-3) and relu.
Params are keyed ``conv_{i}`` in creation order, as in the JAX package
(``{"conv": {"kernel"}, "bn": {...}}``; after ``fold_bn`` the conv has a
bias and the ``bn`` entry is gone), and branches are concatenated on the
channel axis in its order.
"""

from __future__ import annotations

import dataclasses

import torch

from tpucap_torch.models.encoders.common import (
    avg_pool_same,
    batch_norm,
    conv,
    global_avg_pool,
    init_bn,
    init_conv,
    max_pool,
)

BN_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class InceptionV3:
    features: str = "pooled"  # 'pooled' (2048) | 'spatial' (17x17x768)
    input_size: int = 299
    preprocess_mode: str = "tf"

    @property
    def feature_dim(self) -> int:
        return 2048 if self.features == "pooled" else 768

    @property
    def spatial_positions(self) -> int:
        """The mixed7 grid's length in 'spatial' mode, through the stem and
        mixed3's downsampling (17x17 at 299)."""
        s = (self.input_size - 3) // 2 + 1  # stem conv3/2 VALID
        s = s - 2  # conv3 VALID
        s = (s - 3) // 2 + 1  # maxpool3/2
        s = s - 2  # conv3 VALID
        s = (s - 3) // 2 + 1  # maxpool3/2
        s = (s - 3) // 2 + 1  # mixed3 stride-2
        return s * s

    def _conv_shapes(self) -> list[tuple[int, int, int, int]]:
        """Each conv's (cin, cout, kh, kw) in creation order, from one pass
        of the topology on the meta device (shapes only, no data)."""
        shapes = []

        def get(cin, cout, kh, kw):
            shapes.append((cin, cout, kh, kw))
            return {"conv": {"kernel": torch.empty((cout, cin, kh, kw), device="meta")}}

        size = self.input_size
        self._forward(torch.empty((1, size, size, 3), device="meta"), get)
        return shapes

    def init(self, gen: torch.Generator):
        return {
            f"conv_{i}": {
                "conv": init_conv(gen, kh, kw, cin, cout, use_bias=False),
                "bn": init_bn(cout, scale=False),
            }
            for i, (cin, cout, kh, kw) in enumerate(self._conv_shapes())
        }

    def apply(self, params, x):
        """x: (B, 299, 299, 3) preprocessed (tf mode: x / 127.5 - 1)."""
        counter = iter(range(len(params)))
        return self._forward(x, lambda *shape: params[f"conv_{next(counter)}"])

    def _forward(self, x, get):
        def cb(x, f, kh, kw, stride=(1, 1), padding="SAME"):
            p = get(x.shape[-1], f, kh, kw)
            y = conv(p["conv"], x, stride, padding)
            if p.get("bn") is not None:  # absent after fold_bn
                y = batch_norm(p["bn"], y, BN_EPS)
            return torch.relu(y)

        cat = lambda *xs: torch.cat(xs, dim=-1)  # noqa: E731

        # Stem
        x = cb(x, 32, 3, 3, (2, 2), "VALID")
        x = cb(x, 32, 3, 3, padding="VALID")
        x = cb(x, 64, 3, 3)
        x = max_pool(x, 3, 2)
        x = cb(x, 80, 1, 1, padding="VALID")
        x = cb(x, 192, 3, 3, padding="VALID")
        x = max_pool(x, 3, 2)

        # mixed0-2: 35x35
        for pool_ch in (32, 64, 64):
            b1 = cb(x, 64, 1, 1)
            b5 = cb(x, 48, 1, 1)
            b5 = cb(b5, 64, 5, 5)
            b3 = cb(x, 64, 1, 1)
            b3 = cb(b3, 96, 3, 3)
            b3 = cb(b3, 96, 3, 3)
            bp = avg_pool_same(x, 3)
            bp = cb(bp, pool_ch, 1, 1)
            x = cat(b1, b5, b3, bp)

        # mixed3: reduction to 17x17
        b3 = cb(x, 384, 3, 3, (2, 2), "VALID")
        bd = cb(x, 64, 1, 1)
        bd = cb(bd, 96, 3, 3)
        bd = cb(bd, 96, 3, 3, (2, 2), "VALID")
        bp = max_pool(x, 3, 2)
        x = cat(b3, bd, bp)

        # mixed4-7: 17x17, factorized 7x7
        for ch in (128, 160, 160, 192):
            b1 = cb(x, 192, 1, 1)
            b7 = cb(x, ch, 1, 1)
            b7 = cb(b7, ch, 1, 7)
            b7 = cb(b7, 192, 7, 1)
            bd = cb(x, ch, 1, 1)
            bd = cb(bd, ch, 7, 1)
            bd = cb(bd, ch, 1, 7)
            bd = cb(bd, ch, 7, 1)
            bd = cb(bd, 192, 1, 7)
            bp = avg_pool_same(x, 3)
            bp = cb(bp, 192, 1, 1)
            x = cat(b1, b7, bd, bp)

        if self.features == "spatial":
            return x  # mixed7: (B, 17, 17, 768)

        # mixed8: reduction to 8x8
        b3 = cb(x, 192, 1, 1)
        b3 = cb(b3, 320, 3, 3, (2, 2), "VALID")
        b7 = cb(x, 192, 1, 1)
        b7 = cb(b7, 192, 1, 7)
        b7 = cb(b7, 192, 7, 1)
        b7 = cb(b7, 192, 3, 3, (2, 2), "VALID")
        bp = max_pool(x, 3, 2)
        x = cat(b3, b7, bp)

        # mixed9-10: 8x8
        for _ in range(2):
            b1 = cb(x, 320, 1, 1)
            b3 = cb(x, 384, 1, 1)
            b3 = cat(cb(b3, 384, 1, 3), cb(b3, 384, 3, 1))
            bd = cb(x, 448, 1, 1)
            bd = cb(bd, 384, 3, 3)
            bd = cat(cb(bd, 384, 1, 3), cb(bd, 384, 3, 1))
            bp = avg_pool_same(x, 3)
            bp = cb(bp, 192, 1, 1)
            x = cat(b1, b3, bd, bp)

        return global_avg_pool(x)  # (B, 2048)
