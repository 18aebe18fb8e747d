"""Frozen config tree of the port: the subset of ``tpucap.config`` that the
serving and training slices read (same field names, defaults and
meaning), and its ``config.json`` form.

``config_to_dict`` writes tpucap's section layout (its ``dataclasses.asdict``
of a Config): the port's fields, plus each field tpucap has and the port
does not at tpucap's default (``UNPORTED``). ``config_from_dict`` reads
that layout, from either package's bundle; an unported field away from its
default raises ``NotImplementedError`` naming it.

``PRESETS`` are tpucap's five judged configurations, and the port builds
each: ``config1`` (VGG16 + lstm1, greedy), ``config2`` and ``config5``
(InceptionV3 + lstm1, beam 3, batch 32 and 256), ``config3`` (ResNet-50 +
lstm2, beam 5) and ``config4`` (VGG16's 14x14 grid + the soft-attention
decoder, beam 3).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

DecodeMethod = Literal["greedy", "beam"]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    name: str = "vgg16"
    # 'pooled' (global vector; VGG16's fc2) | 'spatial' (a conv grid).
    features: Literal["pooled", "spatial"] = "pooled"
    feature_dim: int = 4096


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    name: str = "lstm1"
    embed_dim: int = 256
    hidden_dim: int = 256
    num_layers: int = 1
    dropout_rate: float = 0.5
    attention_dim: int = 256  # attention MLP width (attention decoder only)
    # The transformer decoder only:
    num_heads: int = 4
    mlp_dim: int = 1024
    # Positional table and KV-cache capacity; must hold decode.max_len + 1
    # (the start token and the generated tokens).
    max_positions: int = 40
    # Mixture-of-experts MLP: 0 = dense; > 0 = that many experts a layer,
    # top-k routed.
    num_experts: int = 0
    moe_top_k: int = 2


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
    # Tokens that would complete an n-gram the hypothesis already generated
    # leave the candidate set (selection only; decode/ngram.py). 1 = never
    # repeat a token; 0 = off.
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
    # Show-Attend-Tell's doubly-stochastic attention regularizer weight;
    # the attention decoder only (a warning for the others).
    attention_reg: float = 0.0
    optimizer: str = "adam"  # adam | adamw | sgd | rmsprop | adagrad
    momentum: float = 0.0  # sgd's momentum; 0 = none
    weight_decay: float = 0.0  # adamw's decoupled weight decay
    # The lr schedule: constant | cosine (to 0 at the end of the run) |
    # exponential (x lr_decay_rate every lr_decay_steps).
    lr_schedule: str = "constant"
    lr_decay_rate: float = 0.96
    lr_decay_steps: int = 1000
    warmup_steps: int = 0  # a linear ramp from 0 before the schedule
    grad_clip_norm: float = 0.0  # global-norm clip; 0 = off
    # Exponential moving average of the weights, d * ema + (1 - d) * params
    # after every step from a copy of the starting params; fit and
    # fit_finetune leave it on pipeline.ema_params, use_ema_weights() swaps
    # it in. Training itself is unchanged. 0 = off.
    ema_decay: float = 0.0
    # Training compute dtype: 'f32' (TF32 off) | 'bf16' (forward and
    # backward in bf16, f32 master params, optimizer state and loss
    # reductions). Distinct from Config.precision, the inference policy.
    precision: str = "f32"
    # With fit(val_data=...): stop after this many epochs without a strict
    # improvement of the monitor (Keras EarlyStopping's patience); 0 = off.
    early_stopping_patience: int = 0
    # The monitor: 'loss' (val_loss, min) | 'bleu4' | 'cider' | 'rouge_l' |
    # 'meteor' (a greedy decode of the dev split each epoch, max).
    val_metric: str = "loss"
    # The Switch load-balance loss weight of an MoE decoder. tpucap reads
    # it in its expert-parallel step alone; no training step of the port
    # reads it (as tpucap's single-device step does not).
    moe_aux_weight: float = 0.01
    # Microbatches a step's batch is split into, accumulated in sum form
    # (the full-batch update at 1/A of the activation memory); 1 = off.
    grad_accum_steps: int = 1
    # With a checkpoint manager: also a metric-less mid-epoch checkpoint
    # every N optimizer steps (what resume=True continues from); 0 = off.
    checkpoint_every_steps: int = 0
    # Scheduled sampling (train/scheduled.py): the largest probability with
    # which an input token is replaced by the model's own prediction, ramped
    # per epoch by ss_schedule (linear | inv_sigmoid | constant); 0 = off.
    scheduled_sampling: float = 0.0
    ss_schedule: str = "linear"
    # fit runs N optimizer steps per call of the step (one host visit); the
    # update sequence is that of N single steps. 1 = one step a call.
    steps_per_dispatch: int = 1


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


#: Feature width of each encoder per feature kind: VGG16's fc2 4096-d
#: vector and its block5_conv3 512-channel grid; InceptionV3's and
#: ResNet-50's global-average 2048-d vectors and their mixed7 768-channel
#: and conv4 1024-channel grids; the ViT
#: family's and tiny_cnn's width either way (pooled = mean, spatial = grid).
FEATURE_DIMS = {
    ("vgg16", "pooled"): 4096,
    ("vgg16", "spatial"): 512,
    ("inception_v3", "pooled"): 2048,
    ("inception_v3", "spatial"): 768,
    ("resnet50", "pooled"): 2048,
    ("resnet50", "spatial"): 1024,
    ("vit_b16", "pooled"): 768,
    ("vit_b16", "spatial"): 768,
    ("vit_tiny", "pooled"): 64,
    ("vit_tiny", "spatial"): 64,
    ("tiny_cnn", "pooled"): 128,
    ("tiny_cnn", "spatial"): 128,
}


def encoder_config(name: str, features="pooled") -> EncoderConfig:
    if (name, features) not in FEATURE_DIMS:
        raise ValueError(
            f"unknown encoder {name!r} ({features}); have "
            f"{sorted({n for n, _ in FEATURE_DIMS})}"
        )
    return EncoderConfig(
        name=name, features=features, feature_dim=FEATURE_DIMS[name, features]
    )


#: tpucap's presets (``tpucap/config.py``'s CONFIG_1..CONFIG_5).
PRESETS = {
    "config1": Config(
        encoder=encoder_config("vgg16"),
        decoder=DecoderConfig(name="lstm1"),
        decode=DecodeConfig(method="greedy"),
    ),
    "config2": Config(
        encoder=encoder_config("inception_v3"),
        decoder=DecoderConfig(name="lstm1"),
        decode=DecodeConfig(method="beam", beam_width=3),
        train=TrainConfig(batch_size=32),
    ),
    "config3": Config(
        encoder=encoder_config("resnet50"),
        decoder=DecoderConfig(name="lstm2", num_layers=2),
        decode=DecodeConfig(method="beam", beam_width=5),
    ),
    "config4": Config(
        encoder=encoder_config("vgg16", features="spatial"),
        decoder=DecoderConfig(name="attention"),
        decode=DecodeConfig(method="beam", beam_width=3),
    ),
    "config5": Config(
        encoder=encoder_config("inception_v3"),
        decoder=DecoderConfig(name="lstm1"),
        decode=DecodeConfig(method="beam", beam_width=3),
        train=TrainConfig(batch_size=256),
    ),
}


#: tpucap's fields that the port does not have, at tpucap's defaults
#: (tpucap/config.py), by config.json section. The whole ``mesh`` section
#: is tpucap's alone.
UNPORTED = {
    "encoder": {},
    "decoder": {},
    "decode": {},
    "train": {
        "checkpoint_dir": "checkpoints",
        "max_to_keep": 3,
    },
    "mesh": {"n_devices": None, "axis_name": "data", "model_devices": 1},
}
_SECTIONS = {
    "encoder": EncoderConfig,
    "decoder": DecoderConfig,
    "decode": DecodeConfig,
    "train": TrainConfig,
}


def config_to_dict(config: Config) -> dict:
    """-> the config.json dict, in tpucap's layout."""
    d = dataclasses.asdict(config)
    out = {name: {**d[name], **UNPORTED[name]} for name in _SECTIONS}
    out["mesh"] = dict(UNPORTED["mesh"])
    out["vocab_size"] = config.vocab_size
    out["precision"] = config.precision
    return out


def _section(name: str, values: dict, cls=None) -> dict:
    """A section's fields the port has; the unported ones must hold
    tpucap's default."""
    values = dict(values)
    for key, default in UNPORTED[name].items():
        if key in values and (value := values.pop(key)) != default:
            raise NotImplementedError(
                f"{name}.{key}={value!r} is not ported (only {default!r})"
            )
    own = {f.name: f for f in dataclasses.fields(cls)} if cls else {}
    unknown = sorted(set(values) - set(own))
    if unknown:
        raise ValueError(f"unknown {name} config fields {unknown}")
    # JSON has no tuples (DecodeConfig.bad_words).
    return {
        k: tuple(v) if isinstance(v, list) and isinstance(own[k].default, tuple) else v
        for k, v in values.items()
    }


def config_from_dict(d: dict) -> Config:
    """A Config from its config.json dict (``config_to_dict``'s layout,
    which is also what tpucap's ``save`` writes)."""
    unknown = sorted(set(d) - {*_SECTIONS, "mesh", "vocab_size", "precision"})
    if unknown:
        raise ValueError(f"unknown config sections {unknown}")
    _section("mesh", d.get("mesh", {}))
    kw = {name: cls(**_section(name, d.get(name, {}), cls)) for name, cls in _SECTIONS.items()}
    for key in ("vocab_size", "precision"):
        if key in d:
            kw[key] = d[key]
    return Config(**kw)
