"""Frozen config tree of the port: the subset of ``tpucap.config`` that the
serving and training slices read (same field names, defaults and
meaning).

The encoder default is ResNet-50, the first encoder the port had; the JAX
package defaults to VGG16.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

DecodeMethod = Literal["greedy", "beam"]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    name: str = "resnet50"
    # 'pooled' (global vector) | 'spatial' (the conv4 grid).
    features: Literal["pooled", "spatial"] = "pooled"
    feature_dim: int = 2048


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    name: str = "lstm1"
    embed_dim: int = 256
    hidden_dim: int = 256
    num_layers: int = 1
    dropout_rate: float = 0.5


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    method: DecodeMethod = "greedy"
    beam_width: int = 3
    max_len: int = 34  # Flickr8k max caption length
    # endseq leaves the candidate set at steps t < min_len; 0 = off.
    min_len: int = 0
    length_normalize: bool = True
    alpha: float = 1.0
    # 'simple' = len^alpha | 'gnmt' = ((5+len)/6)^alpha.
    length_penalty: str = "simple"
    # The JAX package's TPU approx_max_k for stage 1 of beam top-k. The
    # port maps it to the exact top-k (no such custom call on a GPU).
    approx_topk: bool = False
    # Words never generated; lowercased against the vocabulary, unknown
    # words ignored.
    bad_words: tuple = ()
    # Not ported yet: a non-zero value raises NotImplementedError.
    no_repeat_ngram_size: int = 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of ``tpucap.config.TrainConfig`` that the port's training
    reads, with tpucap's defaults."""

    batch_size: int = 64
    learning_rate: float = 1e-3  # Keras Adam default
    epochs: int = 20
    # Seeds the random init in CaptioningPipeline.build, the shuffle of
    # training rows and the dropout generator.
    seed: int = 0
    label_smoothing: float = 0.0
    optimizer: str = "adam"  # adam | adamw
    weight_decay: float = 0.0  # adamw's decoupled weight decay
    grad_clip_norm: float = 0.0  # global-norm clip; 0 = off
    # Training compute dtype: 'f32' (TF32 off) | 'bf16' (forward and
    # backward in bf16, f32 master params, optimizer state and loss
    # reductions). Distinct from Config.precision, the inference policy.
    precision: str = "f32"


@dataclasses.dataclass(frozen=True)
class Config:
    encoder: EncoderConfig = EncoderConfig()
    decoder: DecoderConfig = DecoderConfig()
    decode: DecodeConfig = DecodeConfig()
    train: TrainConfig = TrainConfig()
    vocab_size: int = 7580  # used only when no tokenizer is fitted
    # Inference precision policy; see tpucap_torch.core for the mapping
    # onto PyTorch's dtypes and TF32 flags.
    precision: Literal["bf16", "mixed", "f32"] = "mixed"


#: Feature width of each ported encoder per feature kind: ResNet-50's
#: global-average 2048-d vector and its conv4 1024-channel grid; the ViT
#: family's width either way (pooled = token mean, spatial = token grid).
FEATURE_DIMS = {
    ("resnet50", "pooled"): 2048,
    ("resnet50", "spatial"): 1024,
    ("vit_b16", "pooled"): 768,
    ("vit_b16", "spatial"): 768,
    ("vit_tiny", "pooled"): 64,
    ("vit_tiny", "spatial"): 64,
}


def encoder_config(name: str, features="pooled") -> EncoderConfig:
    return EncoderConfig(
        name=name, features=features, feature_dim=FEATURE_DIMS[name, features]
    )
