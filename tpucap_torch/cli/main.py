"""CLI of the port: tpucap's workflow commands (``tpucap.cli.main``) on
tpucap_torch.

    python -m tpucap_torch extract  --images DIR --out features.npz [--preset config1]
    python -m tpucap_torch train    --tokens tokens.txt --split train.txt \\
                                    --features features.npz --checkpoint-dir DIR
    python -m tpucap_torch train    --tokens tokens.txt --split train.txt \\
                                    --finetune-encoder --images DIR --checkpoint-dir DIR \\
                                    [--augment] [--augment-shift N] [--remat-encoder]
    python -m tpucap_torch caption  --image photo.jpg --checkpoint-dir DIR
    python -m tpucap_torch score    --image photo.jpg --caption "a dog runs" \\
                                    --checkpoint-dir DIR
    python -m tpucap_torch evaluate --tokens tokens.txt --split test.txt \\
                                    --features features.npz --checkpoint-dir DIR
    python -m tpucap_torch compare  A.jsonl B.jsonl [--metric cider]
    python -m tpucap_torch export   --checkpoint-dir DIR --out decoder.h5 [--bundle-out DIR]
    python -m tpucap_torch serve    --model-dir BUNDLE [--port 8000] [--extra-model NAME=BUNDLE]
    python -m tpucap_torch caption  --image photo.jpg --server HOST:PORT [--server-model NAME]
    python -m tpucap_torch doctor   [--no-device-smoke]
    python -m tpucap_torch profile  --workload decode|train|encoder --out DIR [--steps 3]

(or ``tpucap-torch ...``). The parsers are tpucap's, flag for flag, and the
commands print tpucap's lines. Artifacts: features as ``.npz`` (image id ->
row), ``tokenizer.json`` (the format both packages share) and the port's
checkpoints (``tpucap_torch.checkpoint``; it reads no orbax).

``train --finetune-encoder`` trains the encoder and the decoder together
from the images and writes a bundle (``--bundle-out``, default
``<checkpoint-dir>/bundle``). Both training paths take ``--resume``,
``--handle-preemption`` (SIGTERM: finish the step, write a rescue
checkpoint, exit), ``--checkpoint-every-steps``, ``--grad-accum-steps``,
tpucap's optimizer flags (``--optimizer``, ``--momentum``,
``--lr-schedule``, ``--lr-decay-rate``, ``--lr-decay-steps``,
``--warmup-steps``) and ``--ema-decay``, which also writes
``<checkpoint-dir>/bundle_ema`` from the averaged weights. ``train`` also
takes ``--scheduled-sampling`` with ``--ss-schedule`` and
``--steps-per-dispatch`` (on features; the joint trainer ignores them, as
tpucap's does), and ``--embeddings FILE`` with ``--freeze-embeddings``.
``train --stream-features`` reads the feature rows a batch at a time from
the ``.npz`` (the same trajectory); ``--lora-rank N`` (``--lora-alpha``)
trains a LoRA overlay instead, on features (``fit_lora``; the merged
bundle goes to ``<checkpoint-dir>/bundle``) or with ``--finetune-encoder``,
and ``--lora-out FILE`` also writes the adapters as tpucap's artifact.
``caption``, ``score`` and ``evaluate`` build their restore template from
the same optimizer flags; ``caption --prefix "a dog"`` continues a forced
opening and ``caption --include-words W1,W2`` (beam only) captions that must
hold the words, offline or through ``--server``. Offline, ``caption
--method diverse`` prints each group's best caption (``--diverse-groups``,
``--diversity``), ``--method mbr`` picks the consensus caption of a pool
(``--mbr-candidates``, ``--mbr-from sample|beam|diverse``, ``--mbr-metric
cider|bleu4``), ``--ensemble-with BUNDLE`` (repeatable, with
``--ensemble-weights``) decodes a product of experts with other models'
bundles, each encoding with its own encoder, and ``--dump-attention
OUT.npz`` writes an attention decoder's maps beside its captions. Only
``--method speculative`` (with ``--draft-bundle``, ``--gamma``) is not
ported. ``score`` prints each image's teacher-forced
log-probability of its caption; ``compare`` is a paired bootstrap between
two ``evaluate --dump-captions`` files, host numpy, needing no card.
``extract``, ``train --finetune-encoder``, ``caption``, ``score`` and
``export`` take ``--keras-h5 FILE``, a Keras ``.h5`` whose encoder weights
replace the config seed's (``checkpoint.params_from_keras``, read with the
port's own HDF5 code); plain ``train`` ignores it, as tpucap does.
``export`` writes the trained decoder as a Keras ``.h5`` file
(``checkpoint.export_h5``; ``--format aot`` is not ported).
``serve`` runs the HTTP caption server (``serve_http.CaptionHTTPServer``,
tpucap's endpoints) on a bundle (``--model-dir``) or a restored checkpoint
(``--keras-h5`` as in ``caption``), with ``--extra-model``,
``--allow-reload``, the batcher's flags, ``--engine continuous`` (the
slot-recycling engine, greedy or beam, with the streaming routes) and a
SIGTERM drain (exit 0); ``--aot-bundle`` is not ported. ``caption
--server HOST:PORT`` captions through a running server with the port's
client (``tpucap_torch.client``), needing no model and no device here.

The commands run on ``cuda``; ``main(argv, device="cpu")`` runs them on the
CPU, which is how the tests drive them. A flag whose feature the port does
not have raises SystemExit naming it, before any file is read; a config
field the port does not have raises NotImplementedError from
``config_from_dict``. Every decoder family runs (lstm1, lstm2, gru1,
gru2, inject, attention, adaptive and transformer, dense or with
``--num-experts``). All five presets run (``--preset config1`` ... ``config5``). tpucap's other
subcommands (distill, bench) are not registered.

``doctor`` prints tpucap's report with the port's facts (torch, CUDA,
``nvcc``, the kernel build directory where tpucap has its compile cache,
the host JPEG decoder's and every kernel's build, a bf16 matmul on the
device unless ``--no-device-smoke``); without a card it prints the device's
error and exits 1. ``profile`` traces ``--steps`` iterations of a random
decode (the pipeline's step: K2 + K3 for lstm1 on the card), train step or
encoder pass with ``torch.profiler`` into a Chrome trace JSON under
``--out`` (Perfetto or chrome://tracing; tpucap writes a TensorBoard
profile), each iteration a ``profile_step`` range. ``train
--tensorboard-dir DIR`` mirrors the per-epoch metrics as TensorBoard
scalars, in event files the port writes itself (``utils/events.py``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch

from tpucap_torch.checkpoint import CheckpointManager, export_h5, params_from_keras
from tpucap_torch.config import (
    PRESETS,
    Config,
    DecodeConfig,
    DecoderConfig,
    TrainConfig,
    config_from_dict,
    config_to_dict,
    encoder_config,
)
from tpucap_torch.convert import params_from_jax
from tpucap_torch.core import resolve_device
from tpucap_torch.data import (
    load_descriptions,
    load_karpathy_json,
    load_split,
    prepare_descriptions,
)
from tpucap_torch.data.preprocess import preprocess_batch
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import load_tokenizer
from tpucap_torch.train import TrainState, build_optimizer
from tpucap_torch.train.compare import compare_caption_files
from tpucap_torch.train.evaluate import evaluate_captions
from tpucap_torch.utils import MetricsLogger

#: Flags of tpucap's parsers whose feature the port does not have, by
#: command: dest -> the values, besides the flag's default, that the port
#: takes.
UNPORTED_FLAGS = {
    "extract": {"parallelism": ("none",)},
    "train": {
        "sharded_checkpoints": (),
        "scst_epochs": (),
        "scst_lr": (),
        "scst_temperature": (),
        "tokenizer": (),
        "bpe_vocab_size": (),
        "data_parallel": (),
        "parallelism": ("none",),
        "model_devices": (),
    },
    "caption": {
        "method": ("greedy", "diverse", "mbr"),
        "draft_bundle": (),
        "gamma": (),
    },
    "score": {},
    "evaluate": {"parallelism": ("none",), "model_devices": ()},
    "compare": {},
    "export": {
        "format": ("h5",),
        "aot_batch_size": (),
        "aot_ladder": (),
        "include_encoder": (),
    },
    "serve": {"aot_bundle": ()},
    "doctor": {},
    "profile": {},
}
#: TrainConfig fields that the optimizer flags set, under their own names.
_OPTIMIZER_FIELDS = (
    "optimizer",
    "momentum",
    "weight_decay",
    "lr_schedule",
    "lr_decay_rate",
    "lr_decay_steps",
    "warmup_steps",
    "grad_clip_norm",
    "scheduled_sampling",
    "ss_schedule",
    "steps_per_dispatch",
)


def _monitor_keying(args):
    """(best_metric, best_mode) for the CheckpointManager from
    --val-metric: decode metrics are maximized, loss minimized."""
    vm = getattr(args, "val_metric", None) or "loss"
    if vm == "loss":
        return "val_loss", "min"
    return f"val_{vm}", "max"


def _add_optimizer_flags(p):
    """tpucap's optimizer flags, shared by ``train`` and the commands that
    restore a checkpoint (the restore template's optimizer state is built
    from them). Defaults are None, so an explicit 0 still overrides a
    preset."""
    p.add_argument("--optimizer", default=None,
                   choices=["adam", "adamw", "sgd", "rmsprop", "adagrad"],
                   help="optimizer (default adam, the reference's choice)")
    p.add_argument("--momentum", type=float, default=None, help="sgd momentum")
    p.add_argument("--weight-decay", type=float, default=None,
                   help="adamw decoupled weight decay")
    p.add_argument("--lr-schedule", default=None,
                   choices=["constant", "cosine", "exponential"])
    p.add_argument("--lr-decay-rate", type=float, default=None,
                   help="exponential schedule decay rate (default 0.96)")
    p.add_argument("--lr-decay-steps", type=int, default=None,
                   help="exponential schedule step interval (default 1000)")
    p.add_argument("--warmup-steps", type=int, default=None,
                   help="linear lr warmup steps prepended to the schedule")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="track an exponential moving average of the weights (e.g. "
                   "0.999); train then also writes a bundle_ema pipeline bundle "
                   "with the averaged weights")
    p.add_argument("--grad-accum-steps", type=int, default=None,
                   help="split each batch into N microbatches accumulated in sum "
                   "form: the full-batch update at 1/N of the activation memory")
    p.add_argument("--steps-per-dispatch", type=int, default=None,
                   help="run N optimizer steps per call of the step on N stacked "
                   "batches: the per-step update sequence at one host visit per N "
                   "steps (no --ema-decay)")
    p.add_argument("--checkpoint-every-steps", type=int, default=None,
                   help="also write a mid-epoch checkpoint every N optimizer "
                   "steps (what --resume continues from)")
    p.add_argument("--train-precision", default=None, choices=["f32", "bf16"],
                   help="training compute dtype: f32 (default) or bf16 with f32 "
                   "master weights and optimizer state")
    p.add_argument("--grad-clip-norm", type=float, default=None,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--scheduled-sampling", type=float, default=None,
                   help="scheduled sampling (exposure-bias training): max probability "
                   "of replacing each teacher-forcing input token with the model's own "
                   "first-pass prediction, ramped per epoch by --ss-schedule")
    p.add_argument("--ss-schedule", default=None,
                   choices=["linear", "inv_sigmoid", "constant"],
                   help="scheduled-sampling ramp (default linear)")
    p.add_argument("--val-metric", default=None,
                   choices=["loss", "bleu4", "cider", "rouge_l", "meteor"],
                   help="what best-checkpointing and early stopping monitor with "
                   "--val-split: loss (min, default) or a greedy-decode corpus "
                   "metric (max); restore commands need the same flag")


def _add_restore_flags(p):
    p.add_argument("--average-last", type=int, default=None,
                   help="restore the uniform average of the newest N retained "
                   "checkpoints instead of the best step")


def _add_common_model_flags(p):
    p.add_argument("--encoder", default="vgg16",
                   choices=["vgg16", "inception_v3", "resnet50", "tiny_cnn",
                            "vit_b16", "vit_tiny"])
    p.add_argument("--decoder", default="lstm1",
                   choices=["lstm1", "lstm2", "gru1", "gru2", "inject",
                            "attention", "adaptive", "transformer"])
    p.add_argument("--features-kind", default="pooled",
                   choices=["pooled", "spatial"])
    p.add_argument("--embed-dim", type=int, default=256)
    p.add_argument("--hidden-dim", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=None,
                   help="decoder depth (default: 1; lstm2 forces 2, "
                   "transformer defaults to 2)")
    p.add_argument("--num-heads", type=int, default=4,
                   help="attention heads (transformer decoder only)")
    p.add_argument("--mlp-dim", type=int, default=1024,
                   help="MLP width (transformer decoder only)")
    p.add_argument("--num-experts", type=int, default=0,
                   help="transformer decoder only: MoE experts per layer "
                   "(0 = dense MLP); top-2 routed. Pass the SAME value "
                   "used at training time when restoring a checkpoint")
    p.add_argument("--max-len", type=int, default=34)
    p.add_argument("--length-penalty", default=None,
                   choices=["simple", "gnmt"],
                   help="beam ranking denominator: simple = len^alpha "
                   "(default) | gnmt = ((5+len)/6)^alpha")
    p.add_argument("--min-len", type=int, default=0,
                   help="endseq blocked until this many tokens (0 = off)")
    p.add_argument("--bad-words", default=None,
                   help="comma-separated words never generated (or @FILE, one "
                   "word a line)")
    p.add_argument("--no-repeat-ngram", type=int, default=0,
                   help="block n-grams from repeating within a caption "
                   "(greedy/beam; 1 = never repeat a token, 0 = off)")
    p.add_argument("--preset", default=None,
                   help="config preset name (config1..config5), overrides "
                   "encoder/decoder flags")


def _parse_bad_words(spec) -> tuple:
    """--bad-words 'w1,w2' or '@FILE' (one word per line, # comments)
    -> tuple for DecodeConfig.bad_words."""
    if not spec:
        return ()
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            words = [
                ln.strip()
                for ln in f
                if ln.strip() and not ln.lstrip().startswith("#")
            ]
    else:
        words = [w.strip() for w in spec.split(",") if w.strip()]
    return tuple(words)


def _build_config(args) -> Config:
    """tpucap's config resolution from the flags, made in tpucap's
    config.json layout and read by ``config_from_dict``, so a field the
    port does not have (a mesh) raises NotImplementedError away from
    tpucap's default. The transformer's fields come from ``--num-heads``,
    ``--mlp-dim`` and ``--num-experts`` (``moe_top_k`` keeps its default),
    its KV-cache capacity ``max_positions`` from the decode budget,
    max(40, max_len + 2), and its depth defaults to 2."""
    if getattr(args, "preset", None):
        d = config_to_dict(PRESETS[args.preset])
        # Explicit flags override the preset.
        overrides = {
            "attention_reg": getattr(args, "attention_reg", 0.0) or None,
            "learning_rate": getattr(args, "lr", None),
            "grad_accum_steps": getattr(args, "grad_accum_steps", None) or None,
            "checkpoint_every_steps": getattr(args, "checkpoint_every_steps", None) or None,
            "ema_decay": getattr(args, "ema_decay", None) or None,
            "precision": getattr(args, "train_precision", None),
            "val_metric": getattr(args, "val_metric", None),
            "early_stopping_patience": getattr(args, "early_stopping_patience", None),
            **{k: getattr(args, k, None) for k in _OPTIMIZER_FIELDS},
        }
        d["train"].update({k: v for k, v in overrides.items() if v is not None})
        if getattr(args, "approx_topk", False):
            d["decode"]["approx_topk"] = True
        if getattr(args, "model_devices", 0):
            d["mesh"]["model_devices"] = args.model_devices
        return config_from_dict(d)
    feats = args.features_kind
    if args.decoder in ("attention", "adaptive"):
        feats = "spatial"
    num_layers = getattr(args, "num_layers", None)
    if num_layers is None:
        num_layers = {"lstm2": 2, "transformer": 2}.get(args.decoder, 1)
    elif args.decoder == "lstm2":
        num_layers = 2
    cfg = Config(
        encoder=encoder_config(args.encoder, feats),
        decoder=DecoderConfig(
            name=args.decoder,
            embed_dim=args.embed_dim,
            hidden_dim=args.hidden_dim,
            num_layers=num_layers,
            num_heads=getattr(args, "num_heads", 4),
            mlp_dim=getattr(args, "mlp_dim", 1024),
            # The KV-cache and positional capacity tracks the decode budget.
            max_positions=max(40, args.max_len + 2),
            num_experts=getattr(args, "num_experts", 0),
        ),
        decode=DecodeConfig(
            method=getattr(args, "method", None) or "greedy",
            beam_width=getattr(args, "beam_width", 3),
            max_len=args.max_len,
            min_len=getattr(args, "min_len", 0) or 0,
            bad_words=_parse_bad_words(getattr(args, "bad_words", None)),
            no_repeat_ngram_size=getattr(args, "no_repeat_ngram", 0) or 0,
            length_penalty=getattr(args, "length_penalty", None) or "simple",
            approx_topk=getattr(args, "approx_topk", False),
        ),
        train=TrainConfig(
            batch_size=getattr(args, "batch_size", 64),
            learning_rate=getattr(args, "lr", None) or 1e-3,
            epochs=getattr(args, "epochs", 20),
            early_stopping_patience=getattr(args, "early_stopping_patience", None) or 0,
            precision=getattr(args, "train_precision", None) or "f32",
            val_metric=getattr(args, "val_metric", None) or "loss",
            optimizer=getattr(args, "optimizer", None) or "adam",
            weight_decay=getattr(args, "weight_decay", None) or 0.0,
            grad_clip_norm=getattr(args, "grad_clip_norm", None) or 0.0,
        ),
    )
    d = config_to_dict(cfg)
    d["train"].update(
        attention_reg=getattr(args, "attention_reg", 0.0),
        grad_accum_steps=getattr(args, "grad_accum_steps", None) or 1,
        ema_decay=getattr(args, "ema_decay", None) or 0.0,
        momentum=getattr(args, "momentum", None) or 0.0,
        lr_schedule=getattr(args, "lr_schedule", None) or "constant",
        lr_decay_rate=getattr(args, "lr_decay_rate", None) or 0.96,
        lr_decay_steps=getattr(args, "lr_decay_steps", None) or 1000,
        warmup_steps=getattr(args, "warmup_steps", None) or 0,
        checkpoint_every_steps=getattr(args, "checkpoint_every_steps", None) or 0,
        scheduled_sampling=getattr(args, "scheduled_sampling", None) or 0.0,
        ss_schedule=getattr(args, "ss_schedule", None) or "linear",
        steps_per_dispatch=getattr(args, "steps_per_dispatch", None) or 1,
    )
    d["mesh"]["model_devices"] = getattr(args, "model_devices", 0) or 1
    return config_from_dict(d)


def cmd_extract(args, device):
    """Feature extraction over an image directory -> .npz artifact."""
    cfg = _build_config(args)
    pipe = CaptioningPipeline(cfg, device=device)
    # The config seed's weights: the same ones _restore_pipeline builds, so
    # extract -> train -> caption sees one encoder. Pretrained weights come
    # through --keras-h5.
    pipe.build()
    _maybe_keras_encoder(args, pipe)
    paths = sorted(glob.glob(os.path.join(args.images, "*.jpg")))
    feats = pipe.extract_features(paths, batch_size=args.batch_size)
    ids = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    np.savez(args.out, **dict(zip(ids, feats)))
    print(f"wrote {len(ids)} features to {args.out}")


def _maybe_keras_encoder(args, pipe) -> None:
    """--keras-h5 FILE: install the encoder imported from a Keras .h5 file
    (``params_from_keras``); ``set_params`` drops the cached bf16 params."""
    if getattr(args, "keras_h5", None):
        encoder = params_from_jax(params_from_keras(args.keras_h5, pipe.config.encoder.name))
        pipe.set_params({**pipe.params, "encoder": encoder})


def _karpathy_split(path, karpathy, flag: str, name: str):
    desc, splits = karpathy
    if not splits.get(name):
        # An empty split fails as an unknown name does.
        have = sorted(k for k, v in splits.items() if v)
        raise SystemExit(
            f"{flag} {name!r} is empty or absent in {path} (non-empty splits: {have})"
        )
    return prepare_descriptions(desc, splits[name])


def _load_dataset(args, default_split: str = "train", karpathy=None):
    """The split's cleaned descriptions, from --karpathy-json (``karpathy``:
    its parse, when the caller already has it) or --tokens and --split."""
    kj = getattr(args, "karpathy_json", None)
    if kj:
        return _karpathy_split(
            kj, karpathy or load_karpathy_json(kj), "--split", args.split or default_split
        )
    if not args.tokens:
        raise SystemExit("need --tokens FILE (or --karpathy-json JSON)")
    desc = load_descriptions(args.tokens)
    split_ids = load_split(args.split) if args.split else None
    return prepare_descriptions(desc, split_ids)


def _validate_train_flags(args) -> None:
    """tpucap's checks of train's flag combinations, with its messages,
    before any file is read."""
    if args.freeze_embeddings and not args.embeddings:
        raise SystemExit("--freeze-embeddings needs --embeddings FILE")
    if not args.finetune_encoder and (args.augment or args.augment_shift):
        raise SystemExit(
            "--augment/--augment-shift run inside the joint "
            "encoder+decoder step — add --finetune-encoder (feature-"
            "based training has no images to augment)"
        )
    if not args.finetune_encoder and args.remat_encoder:
        raise SystemExit(
            "--remat-encoder applies to the joint encoder+decoder step "
            "— add --finetune-encoder (feature-based training has no "
            "encoder activations to rematerialize)"
        )
    if args.lora_out and not args.lora_rank:
        raise SystemExit("--lora-out needs --lora-rank")
    if args.lora_rank:
        bad = [
            flag
            for flag, val in (
                ("--remat-encoder", args.remat_encoder),
                ("--ema-decay", args.ema_decay),
                ("--stream-features", args.stream_features),
                ("--val-split", args.val_split),
                ("--parallelism fsdp", args.parallelism == "fsdp"),
                ("--grad-accum-steps", (args.grad_accum_steps or 1) > 1),
            )
            if val
        ]
        if bad:
            raise SystemExit(
                f"--lora-rank does not compose with {', '.join(bad)} "
                "(the adapters ARE the memory/monitoring fix; train "
                "full weights for those dials)"
            )
    if args.resume or args.handle_preemption:
        # LoRA saves its adapters through --lora-out, and the EMA shadow is
        # not restored.
        bad = [
            flag
            for flag, val in (("--lora-rank", args.lora_rank), ("--ema-decay", args.ema_decay))
            if val
        ]
        if bad:
            raise SystemExit(
                f"--resume/--handle-preemption need the step-"
                f"checkpointed TrainState path; drop {', '.join(bad)}"
            )
    if args.finetune_encoder:
        _validate_finetune_flags(args)
    elif not args.features:
        raise SystemExit(
            "--features is required (or use --finetune-encoder --images "
            "to train end-to-end from JPEGs)"
        )


def _validate_finetune_flags(args) -> None:
    """The joint trainer's refusals, tpucap's: no dev split, no early
    stopping (parallelism is the port's none only, refused by name)."""
    if not args.images:
        raise SystemExit("--finetune-encoder needs --images DIR")
    unsupported = [
        name
        for name, val in (
            ("--val-split", args.val_split),
            ("--early-stopping-patience", args.early_stopping_patience),
        )
        if val
    ]
    if unsupported:
        raise SystemExit(
            f"{', '.join(unsupported)} not supported with "
            "--finetune-encoder (joint training runs single-device or "
            "--parallelism dp; train the decoder with `train` + "
            "extracted features for the rest)"
        )


def cmd_train(args, device):
    """train on extracted features, or with --finetune-encoder from the
    images."""
    _validate_train_flags(args)
    cfg = _build_config(args)
    pipe = CaptioningPipeline(cfg, device=device)
    kj = args.karpathy_json
    karpathy = load_karpathy_json(kj) if kj else None
    prepared = _load_dataset(args, karpathy=karpathy)
    if args.finetune_encoder:
        _train_finetune(args, pipe, prepared)
        return
    with np.load(args.features) as npz:
        # --stream-features keeps the handle lazy: fit(stream=True) reads the
        # rows a batch at a time (extract writes the members uncompressed, so
        # a row is one seek); the handle is closed once training is done.
        _train_features(args, pipe, prepared, npz if args.stream_features else dict(npz), karpathy)


def _train_features(args, pipe, prepared, features, karpathy) -> None:
    """train on extracted features: ``fit`` (``fit_lora`` with
    --lora-rank), ``features`` a dict or, with --stream-features, the lazy
    ``np.load`` handle."""
    kj = args.karpathy_json
    pipe.fit_tokenizer(prepared)
    pipe.build()
    _maybe_pretrained_embeddings(args, pipe)
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    pipe.tokenizer.save(os.path.join(args.checkpoint_dir, "tokenizer.json"))

    val_data = None
    if args.val_split:
        if kj:
            # --val-split names a split of the JSON (normally "val").
            val_prepared = _karpathy_split(kj, karpathy, "--val-split", args.val_split)
        else:
            val_prepared = prepare_descriptions(
                load_descriptions(args.tokens), load_split(args.val_split)
            )
        val_data = (val_prepared, features)

    best_metric, best_mode = _monitor_keying(args)
    mgr = CheckpointManager(args.checkpoint_dir, best_metric=best_metric, best_mode=best_mode)
    # Made before training, as tpucap makes it: wall_time counts from here.
    tb = args.tensorboard_dir
    logger = MetricsLogger(args.metrics_log, tensorboard_dir=tb) if (args.metrics_log or tb) else None
    if args.lora_rank:
        # Adapters over the decoder; the merged result is written as a
        # pipeline bundle, the adapters too with --lora-out. The artifact is
        # the checkpoint: the manager saves nothing.
        history = pipe.fit_lora(
            prepared,
            features,
            rank=args.lora_rank,
            alpha=args.lora_alpha,
            epochs=args.epochs,
            batch_size=args.batch_size,
            parallelism=args.parallelism,
        )
        bundle = os.path.join(args.checkpoint_dir, "bundle")
        pipe.save(bundle)
        if args.lora_out:
            pipe.save_lora(args.lora_out)
            print(f"LoRA adapters in {args.lora_out}")
        print(
            f"lora-trained {len(history)} epochs; final loss "
            f"{history[-1]['loss']:.4f}; bundle in {bundle}"
        )
        mgr.close()
        if logger:
            for h in history:
                logger.log(h)
            logger.close()
        return
    history = pipe.fit(
        prepared,
        features,
        epochs=args.epochs,
        batch_size=args.batch_size,
        checkpoint_manager=mgr,
        val_data=val_data,
        stream=args.stream_features,
        resume=args.resume,
        handle_preemption=args.handle_preemption,
    )
    if logger:
        for h in history:
            logger.log(h)
        logger.close()
    mgr.close()
    _maybe_save_ema_bundle(args, pipe)
    if history and history[-1].get("preempted"):
        print(
            f"preempted after {len(history)} epoch entries; rerun the "
            "same command with --resume to continue "
            f"(checkpoints in {args.checkpoint_dir})"
        )
        return
    if not history:
        _nothing_to_train(args)
    else:
        print(f"trained {len(history)} epochs; final loss "
              f"{history[-1]['loss']:.4f}; checkpoints in "
              f"{args.checkpoint_dir}")
    if args.bundle_out:
        pipe.save(args.bundle_out)
        print(f"wrote pipeline bundle to {args.bundle_out}")


def _maybe_pretrained_embeddings(args, pipe) -> None:
    """--embeddings FILE: the decoder's table from its vectors, frozen with
    --freeze-embeddings (the coverage line printed)."""
    if args.embeddings:
        pipe.set_pretrained_embeddings(args.embeddings, freeze=args.freeze_embeddings)


def _maybe_save_ema_bundle(args, pipe) -> None:
    """--ema-decay: also write a pipeline bundle of the averaged weights,
    <checkpoint-dir>/bundle_ema; the raw weights go back afterwards (the
    checkpoints hold the training iterate)."""
    if not args.ema_decay:
        return
    replaced = pipe.use_ema_weights()
    bundle = os.path.join(args.checkpoint_dir, "bundle_ema")
    pipe.save(bundle)
    pipe.params.update(replaced)
    pipe._params_changed()
    print(f"EMA weights (decay {args.ema_decay}) bundled in {bundle}")


def _nothing_to_train(args) -> None:
    """--resume on a run that already finished: no epoch was left."""
    print(
        "nothing to train: the restored checkpoint already covers "
        f"the requested epochs; checkpoints in {args.checkpoint_dir}"
    )


def _train_finetune(args, pipe, prepared) -> None:
    """train --finetune-encoder: the encoder and the decoder trained
    together from the images (--images DIR, one <id>.jpg per caption id),
    read in chunks of 64 as tpucap reads them. Writes a pipeline bundle
    (--bundle-out, default <checkpoint-dir>/bundle) that
    ``CaptioningPipeline.load`` serves. A checkpoint manager is made only
    for --resume, --handle-preemption or --checkpoint-every-steps."""
    pipe.fit_tokenizer(prepared)
    pipe.build()
    _maybe_pretrained_embeddings(args, pipe)
    # Start from pretrained encoder weights: the normal fine-tune setup.
    _maybe_keras_encoder(args, pipe)
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    pipe.tokenizer.save(os.path.join(args.checkpoint_dir, "tokenizer.json"))
    size, mode = pipe.encoder.input_size, pipe.encoder.preprocess_mode
    ids = list(prepared)
    images = {}
    for s in range(0, len(ids), 64):
        chunk = ids[s : s + 64]
        paths = [os.path.join(args.images, f"{i}.jpg") for i in chunk]
        images.update(zip(chunk, preprocess_batch(paths, size=size, mode=mode)))
    mgr = None
    wants_ckpt = args.resume or args.handle_preemption or args.checkpoint_every_steps
    if wants_ckpt and args.lora_rank:
        # Refused, not skipped: a run that asked for kill-insurance must not
        # go without it.
        raise SystemExit(
            "--lora-rank checkpoints its adapter artifact via "
            "--lora-out, not the joint TrainState; drop "
            "--resume/--handle-preemption/--checkpoint-every-steps "
            "or train full weights"
        )
    if wants_ckpt:
        mgr = CheckpointManager(args.checkpoint_dir, best_metric="val_loss")
    history = pipe.fit_finetune(
        prepared,
        images,
        epochs=args.epochs,
        batch_size=args.batch_size,
        encoder_lr_scale=args.encoder_lr_scale,
        remat_encoder=args.remat_encoder,
        augment=args.augment,
        augment_shift=args.augment_shift,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        checkpoint_manager=mgr,
        resume=args.resume,
        handle_preemption=args.handle_preemption,
    )
    if mgr is not None:
        mgr.close()
    if not history:
        _nothing_to_train(args)
        return
    if args.lora_out:
        pipe.save_lora(args.lora_out)
        print(f"LoRA adapters in {args.lora_out}")
    if args.metrics_log or args.tensorboard_dir:
        logger = MetricsLogger(args.metrics_log, tensorboard_dir=args.tensorboard_dir)
        for h in history:
            logger.log(h)
        logger.close()
    bundle = args.bundle_out or os.path.join(args.checkpoint_dir, "bundle")
    pipe.save(bundle)
    _maybe_save_ema_bundle(args, pipe)
    if history[-1].get("preempted"):
        print(
            f"preempted after {len(history)} epoch entries; rescue "
            "checkpoint written — rerun the same command with "
            f"--resume to continue (checkpoints in "
            f"{args.checkpoint_dir}; bundle in {bundle} carries the "
            "mid-run weights)"
        )
        return
    print(
        f"finetuned {len(history)} epochs; final loss "
        f"{history[-1]['loss']:.4f}; bundle in {bundle}"
    )


def _restore_pipeline(args, device) -> CaptioningPipeline:
    """The config seed's pipeline (its encoder the one ``extract`` used)
    with the decoder restored from --checkpoint-dir: the best step (the
    latest when no step has metrics), or the average of the newest
    --average-last steps."""
    cfg = _build_config(args)
    tok = load_tokenizer(os.path.join(args.checkpoint_dir, "tokenizer.json"))
    pipe = CaptioningPipeline(cfg, tokenizer=tok, device=device)
    pipe.build()
    _maybe_keras_encoder(args, pipe)
    best_metric, best_mode = _monitor_keying(args)
    mgr = CheckpointManager(args.checkpoint_dir, best_metric=best_metric, best_mode=best_mode)
    # The template's optimizer state comes from the same config resolution
    # the train command used.
    fresh = TrainState.create(
        pipe.params["decoder"],
        build_optimizer(cfg.train),
        torch.Generator(device=pipe.device),
    )
    if args.average_last:
        dec_params = mgr.average_params(fresh, last_k=args.average_last)
    else:
        dec_params = mgr.restore(fresh, step=mgr.best_step()).params
    pipe.set_params({**pipe.params, "decoder": dec_params})
    mgr.close()
    return pipe


def _include_words(args) -> list[str] | None:
    """--include-words W1,W2 -> the words (tpucap's split)."""
    if not args.include_words:
        return None
    return [w.strip() for w in args.include_words.split(",") if w.strip()]


def _ensemble_weights(args) -> list[float] | None:
    """--ensemble-weights W1,W2 -> the weights, checked against
    --ensemble-with (tpucap's parse and texts)."""
    if not args.ensemble_weights:
        return None
    if not args.ensemble_with:
        raise SystemExit("--ensemble-weights needs --ensemble-with")
    weights = [float(w) for w in args.ensemble_weights.split(",")]
    if len(weights) != 1 + len(args.ensemble_with):
        raise SystemExit(
            f"{len(weights)} weights for {1 + len(args.ensemble_with)} ensemble members"
        )
    return weights


def _validate_caption_flags(args) -> None:
    """tpucap's checks of ``caption --server`` and ``--server-model``, and
    offline those of the ensemble's flags, ``--prefix``,
    ``--include-words`` and ``--dump-attention``, in its order and with its
    messages, before the unported-flag check and before any file is
    read."""
    if args.server_model and not args.server:
        # --server-model without --server would be silently ignored.
        raise SystemExit("--server-model only applies with --server HOST:PORT")
    if not args.server:
        _ensemble_weights(args)
        if args.ensemble_with and args.method not in ("greedy", "beam"):
            raise SystemExit("--ensemble-with supports --method greedy|beam")
        if args.prefix and (args.method not in ("greedy", "beam") or args.ensemble_with):
            raise SystemExit("--prefix supports --method greedy|beam (no ensemble)")
        if args.include_words and (
            args.method != "beam" or args.ensemble_with or args.prefix or args.dump_attention
        ):
            raise SystemExit(
                "--include-words supports --method beam only "
                "(no ensemble/prefix/dump-attention)"
            )
        if args.dump_attention and (
            args.method not in ("greedy", "beam") or args.ensemble_with or args.prefix
        ):
            raise SystemExit(
                "--dump-attention supports --method greedy|beam (no ensemble/prefix)"
            )
        if args.dump_attention and args.decoder not in ("attention", "adaptive", "transformer"):
            # Pooled families have no per-step attention distribution.
            raise SystemExit(
                "--dump-attention needs an attention decoder family "
                f"(attention|adaptive|transformer), got --decoder {args.decoder}"
            )
        return
    if args.method in ("speculative", "diverse", "mbr"):
        raise SystemExit(
            f"--method {args.method} is an offline decode mode; "
            "--server supports the server's configured greedy/beam "
            "(plus --prefix / --include-words per request)"
        )
    if args.ensemble_with or args.dump_attention:
        raise SystemExit(
            "--ensemble-with/--dump-attention need a local model; "
            "drop --server to run offline"
        )
    if args.prefix and args.include_words:
        raise SystemExit("a request takes --prefix OR --include-words")


def _caption_remote(args) -> None:
    """``caption --server HOST:PORT``: caption through a running ``serve``
    (the port's or tpucap's) with the port's client instead of restoring a
    model here: no checkpoint, no device. Everything model-shaped
    (--method, --beam-width, --decoder, ...) is the server's and ignored
    here."""
    from tpucap_torch.client import CaptionClient, ServerError

    host, _, port = args.server.rpartition(":")
    if not port.isdigit():
        raise SystemExit(f"--server wants HOST:PORT, got {args.server!r}")
    # Bracketed IPv6 literals ([::1]:8000) parse to host '[::1]': strip the
    # brackets, which http.client does not accept.
    host = host.strip("[]")
    client = CaptionClient(host or "127.0.0.1", int(port), model=args.server_model or "")
    include_words = _include_words(args)
    blobs = []
    for path in args.image:
        with open(path, "rb") as f:
            blobs.append(f.read())
    try:
        if not include_words and not args.prefix:
            caps = client.caption_many(blobs)
        else:
            # The dials are per-request query parameters: one request an
            # image, sent together so that the server batches them.
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(32, len(blobs))) as pool:
                caps = list(
                    pool.map(
                        lambda b: client.caption(
                            b, prefix=args.prefix, include_words=include_words
                        ),
                        blobs,
                    )
                )
    except ServerError as e:
        raise SystemExit(f"server error ({e.status}): {e}")
    except OSError as e:
        raise SystemExit(f"cannot reach {args.server}: {e}")
    for path, cap in zip(args.image, caps):
        print(f"{path}\t{cap}")


def cmd_caption(args, device):
    if not args.keras_h5:
        print(
            "note: no --keras-h5 given — the encoder runs with its "
            "config-seed random init (matches a weightless `extract`; "
            "real photographs need pretrained encoder weights)",
            file=sys.stderr,
        )
    pipe = _restore_pipeline(args, device)
    include_words = _include_words(args)
    if args.method == "mbr":
        feats = pipe.extract_features(list(args.image))
        caps = pipe.generate_mbr(
            feats,
            n_candidates=args.mbr_candidates,
            candidates=args.mbr_from,
            metric=args.mbr_metric,
            beam_width=args.beam_width,
            diversity=args.diversity,
        )
    elif args.method == "diverse":
        feats = pipe.extract_features(list(args.image))
        diverse = pipe.generate_diverse(
            feats,
            num_groups=args.diverse_groups,
            group_width=args.beam_width,
            diversity=args.diversity,
        )
        for path, groups in zip(args.image, diverse):
            for g, (cap, score) in enumerate(groups):
                print(f"{path}\t[group {g} {score:.3f}] {cap}")
        return
    elif args.ensemble_with:
        others = [CaptioningPipeline.load(b, device=device) for b in args.ensemble_with]
        # Each member encodes with its own encoder: members may use
        # different encoder families (pooled rows or a spatial grid).
        feats = [p.extract_features(list(args.image)) for p in (pipe, *others)]
        caps = pipe.generate_ensemble(
            feats,
            others,
            method=args.method,
            beam_width=args.beam_width,
            weights=_ensemble_weights(args),
        )
    elif include_words:
        feats = pipe.extract_features(list(args.image))
        details = pipe.generate_constrained(
            feats, include_words, beam_width=args.beam_width, return_details=True
        )
        caps = [d["caption"] for d in details]
        for path, d in zip(args.image, details):
            if d["num_satisfied"] < len(d["satisfied"]):
                missing = [w for w, ok in d["satisfied"].items() if not ok]
                print(
                    f"{path}: could not include {missing} within "
                    "--max-len (returning the most-satisfied caption)",
                    file=sys.stderr,
                )
    elif args.prefix:
        feats = pipe.extract_features(list(args.image))
        caps = pipe.generate_continuation(
            feats, args.prefix, method=args.method, beam_width=args.beam_width
        )
    elif args.dump_attention:
        feats = pipe.extract_features(list(args.image))
        caps, alphas, lengths = pipe.generate_with_attention(
            feats, method=args.method, beam_width=args.beam_width
        )
        # alphas (B, T, L), or (B, T, L+1) for the adaptive family, whose
        # last column is the sentinel weight beta ("don't look");
        # spatial_positions reshapes L into the encoder's grid (196 -> 14 x
        # 14) for upsampled heatmaps.
        np.savez(
            args.dump_attention,
            alphas=alphas,
            lengths=lengths,
            captions=np.asarray(caps),
            images=np.asarray([str(p) for p in args.image]),
            spatial_positions=np.int32(pipe.encoder.spatial_positions),
        )
        print(
            f"wrote attention maps {tuple(alphas.shape)} to {args.dump_attention}",
            file=sys.stderr,
        )
    else:
        caps = pipe.caption_images(args.image, method=args.method, beam_width=args.beam_width)
    for path, cap in zip(args.image, caps):
        print(f"{path}\t{cap}")


def cmd_score(args, device):
    """Teacher-forced caption scoring: how likely is this caption for this
    image under the trained model (``score_captions``)."""
    if bool(args.caption) == bool(args.captions_file):
        raise SystemExit("give exactly one of --caption (repeatable) or --captions-file")
    if args.captions_file:
        with open(args.captions_file) as f:
            captions = [ln.strip() for ln in f if ln.strip()]
    else:
        captions = list(args.caption)
    if len(captions) != len(args.image):
        raise SystemExit(
            f"{len(captions)} captions for {len(args.image)} images — "
            "they pair one-to-one, in order"
        )
    pipe = _restore_pipeline(args, device)
    feats = pipe.extract_features(list(args.image))
    for path, cap, s in zip(args.image, captions, pipe.score_captions(feats, captions)):
        print(
            f"{path}\tlogp={s['logp']:.4f}\tppl={s['perplexity']:.3f}"
            f"\ttokens={s['tokens']}\t{cap}"
        )


def cmd_evaluate(args, device):
    # Validated before any IO or decoding.
    metrics = tuple(m.strip() for m in args.metrics.split(",") if m.strip())
    bad = set(metrics) - {"bleu", "cider", "rouge_l", "meteor", "diversity"}
    if bad or not metrics:
        raise SystemExit(
            f"--metrics: unknown {sorted(bad) or '(empty)'}; "
            "choose from bleu,cider,rouge_l,meteor,diversity"
        )
    syn = args.meteor_synonyms
    if syn:
        if "meteor" not in metrics:
            raise SystemExit("--meteor-synonyms needs meteor in --metrics")
        if not os.path.isfile(syn):
            raise SystemExit(f"--meteor-synonyms: no such file {syn!r}")
    pipe = _restore_pipeline(args, device)
    prepared = _load_dataset(args, default_split="test")
    features = dict(np.load(args.features))
    dump = args.dump_captions
    coco_out = args.coco_results
    out = pipe.evaluate(
        prepared,
        features,
        method=args.method,
        beam_width=args.beam_width,
        batch_size=args.batch_size,
        metrics=metrics,
        return_captions=bool(dump or coco_out),
        meteor_synonyms=syn or None,
    )
    scores, generated = out if (dump or coco_out) else (out, None)
    if dump:
        # Per-image JSONL with a sentence BLEU-4, for error analysis.
        with open(dump, "w") as f:
            for image_id, cap in generated.items():
                per = evaluate_captions({image_id: prepared[image_id]}, {image_id: cap})
                f.write(
                    json.dumps(
                        {
                            "image_id": image_id,
                            "caption": cap,
                            "references": prepared[image_id],
                            "bleu4": round(per["bleu4"], 4),
                        }
                    )
                    + "\n"
                )
        print(f"wrote per-image captions to {dump}", file=sys.stderr)
    if coco_out:
        # coco-caption results: numeric ids as ints (COCO's convention).
        rows = [
            {"image_id": int(i) if str(i).isdigit() else str(i), "caption": cap}
            for i, cap in generated.items()
        ]
        with open(coco_out, "w") as f:
            json.dump(rows, f)
        print(f"wrote {len(rows)} coco-format results to {coco_out}", file=sys.stderr)
    print(json.dumps(scores))


def cmd_compare(args):
    """Paired bootstrap significance test between two ``evaluate
    --dump-captions`` files (``train/compare.py``; Koehn 2004): host numpy,
    no card. The summary goes to stderr, the JSON result to stdout."""
    result = compare_caption_files(
        args.file_a, args.file_b, metric=args.metric, n_resamples=args.bootstrap, seed=args.seed
    )
    verdict = (
        "B != A (significant at 0.05)"
        if result["significant_at_05"]
        else "no significant difference at 0.05"
    )
    print(
        f"# {args.metric}: A={result['score_a']:.4f} "
        f"B={result['score_b']:.4f} delta={result['delta']:+.4f} "
        f"ci95=[{result['delta_ci95'][0]:+.4f}, "
        f"{result['delta_ci95'][1]:+.4f}] p={result['p_value']:.3f} "
        f"-> {verdict}",
        file=sys.stderr,
    )
    print(json.dumps(result))


def cmd_export(args, device):
    """Export the trained decoder to a reference-loadable Keras .h5
    (``export_h5``); also writes a pipeline bundle with --bundle-out.
    --method and --beam-width belong to tpucap's AOT format and are ignored
    here, as tpucap ignores them for h5."""
    pipe = _restore_pipeline(args, device)
    kw = {}
    if type(pipe.decoder).__name__ == "AttentionDecoder":
        # The stepwise export bakes the spatial grid size into the Input
        # shape: the restored encoder's own grid.
        kw["positions"] = pipe.encoder.spatial_positions
    export_h5(
        pipe.decoder,
        pipe.params["decoder"],
        args.out,
        max_len=pipe.config.decode.max_len,
        **kw,
    )
    print(f"wrote Keras h5 decoder to {args.out}")
    if args.bundle_out:
        pipe.save(args.bundle_out)
        print(f"wrote pipeline bundle to {args.bundle_out}")


def _validate_serve_flags(args) -> dict:
    """tpucap's checks of serve's flags, with its messages, before any model
    is loaded. -> the --extra-model specs, name -> bundle directory."""
    extra_specs = {}
    for spec in args.extra_model or []:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            raise SystemExit(f"--extra-model wants NAME=BUNDLE_DIR, got {spec!r}")
        if name in extra_specs or name == "default":
            raise SystemExit(f"--extra-model: duplicate/reserved name {name!r}")
        extra_specs[name] = path
    if extra_specs and args.aot_bundle:
        raise SystemExit("--extra-model is not supported with --aot-bundle")
    if extra_specs and args.engine != "batch":
        raise SystemExit("--extra-model needs --engine batch")
    if args.allow_reload and args.aot_bundle:
        raise SystemExit(
            "--allow-reload is not supported with --aot-bundle "
            "(AOT artifacts are immutable; restart on a new bundle)"
        )
    return extra_specs


def cmd_serve(args, device):
    """The HTTP caption server (``serve_http.CaptionHTTPServer``) on a
    bundle (--model-dir) or a restored checkpoint; --extra-model bundles
    behind the same port. SIGTERM drains the batchers and exits 0."""
    import signal
    import threading

    from tpucap_torch.serve_http import CaptionHTTPServer

    extra_specs = _validate_serve_flags(args)
    if args.model_dir:
        pipe = CaptioningPipeline.load(args.model_dir, device=device)
    else:
        pipe = _restore_pipeline(args, device)
    extra_models = {
        name: CaptioningPipeline.load(path, device=device) for name, path in extra_specs.items()
    } or None
    srv = CaptionHTTPServer(
        pipe,
        host=args.host,
        port=args.port,
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        method=args.method,
        beam_width=args.beam_width,
        max_queue=args.max_queue,
        engine=args.engine,
        allow_reload=args.allow_reload,
        extra_models=extra_models,
        max_body_bytes=int(args.max_body_mb * (1 << 20)),
    )
    if args.warmup:
        print("warming up (running every batch bucket)...", file=sys.stderr)
        srv.warmup()
    host, port = srv.address
    print(f"serving on http://{host}:{port} "
          f"(POST /caption, POST /caption_features, GET /stats)",
          file=sys.stderr)

    # Graceful drain on SIGTERM: stop accepting, finish in-flight batches
    # via close(), exit 0. The handler only schedules the shutdown:
    # BaseServer.shutdown() would deadlock if called from a signal frame
    # interrupting serve_forever itself.
    def _on_sigterm(signum, frame):
        del signum, frame
        print("SIGTERM: draining and shutting down...", file=sys.stderr)
        threading.Thread(target=srv._httpd.shutdown, daemon=True).start()

    old_term = signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, old_term)
        srv.close()
        print("drained; bye", file=sys.stderr)


def _nvcc_version() -> str:
    """The toolkit's release line (``nvcc --version``), or MISSING."""
    import subprocess

    from tpucap_torch import _build

    try:
        out = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[-1]
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        return f"MISSING ({type(e).__name__})"


def cmd_doctor(args, device):
    """Environment diagnostics: platform and devices, library versions, the
    host JPEG decoder's build, every kernel's build, and a one-matmul
    device smoke (tpucap's layout; the kernel build directory stands where
    tpucap has its compile cache). Without a card (and no
    ``device="cpu"``) the report carries the device's error and the
    command exits 1."""
    import time

    from tpucap_torch import __version__, _build

    report = {}
    t0 = time.perf_counter()
    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        dev = None
        report["platform"] = f"ERROR ({type(e).__name__}: {e})"
        report["devices"] = []
    else:
        if dev.type == "cuda":
            report["platform"] = "gpu"
            report["devices"] = [torch.cuda.get_device_name(i)
                                 for i in range(torch.cuda.device_count())]
        else:
            report["platform"] = dev.type
            report["devices"] = [str(dev)]
    report["device_query_s"] = round(time.perf_counter() - t0, 3)
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda or "none"
    report["nvcc"] = _nvcc_version()
    report["numpy"] = np.__version__
    report["tpucap_torch"] = __version__
    report["kernel_build_dir"] = str(_build.BUILD)
    try:
        from tpucap_torch.ops import jpeg

        # Build the host decoder here, not mid-serving.
        jpeg._lib()
        report["jpeg_extension"] = "ok"
    except Exception as e:
        report["jpeg_extension"] = f"BUILD FAILED ({type(e).__name__}: {e})"
    if dev is None:
        print(json.dumps(report, indent=2))
        raise SystemExit(1)
    if dev.type != "cuda":
        report["kernels"] = "skipped (cpu)"
    else:
        t0 = time.perf_counter()
        try:
            report["kernels"] = sorted(_build.build_all())
        except Exception as e:
            report["kernels"] = f"BUILD FAILED ({type(e).__name__}: {str(e).splitlines()[0]})"
        report["kernel_build_s"] = round(time.perf_counter() - t0, 3)
    if not args.no_device_smoke:
        t0 = time.perf_counter()
        x = torch.ones((512, 512), dtype=torch.bfloat16, device=dev)
        y = x @ x
        ok = bool(torch.isfinite(y).all())  # copies back: synchronizes
        report["matmul_smoke_s"] = round(time.perf_counter() - t0, 3)
        report["matmul_ok"] = ok
    print(json.dumps(report, indent=2))


def cmd_profile(args, device):
    """Trace the configured workload with ``torch.profiler`` into a Chrome
    trace JSON under ``--out`` (open it in Perfetto or chrome://tracing;
    tpucap writes a TensorBoard profile instead). Random params (profiling
    measures programs, not weights); the warm-up runs outside the trace.
    Each traced iteration is a ``profile_step`` range. ``decode`` runs the
    step the pipeline would (``pipeline.decode_step_fn``: K2 + K3 for lstm1
    on the card) on params in ``--dtype``; ``train`` runs
    ``make_train_step`` with Adam at 1e-3 on f32 features; ``encoder`` runs
    ``encoder.apply`` on random images (unfolded params: the unfused
    route)."""
    from tpucap_torch.core import precision_flags, tree_map
    from tpucap_torch.decode import beam_decode, greedy_decode
    from tpucap_torch.models.decoders import build_decoder
    from tpucap_torch.models.encoders import build_encoder
    from tpucap_torch.pipeline import decode_step_fn
    from tpucap_torch.train.loop import chain, make_train_step, scale_by_adam, scale_by_learning_rate
    from tpucap_torch.utils import profile_trace

    cfg = _build_config(args)
    enc = build_encoder(cfg.encoder.name, cfg.encoder.features)
    dec = build_decoder(
        cfg.decoder.name,
        vocab_size=cfg.vocab_size,
        feature_dim=cfg.encoder.feature_dim,
        embed_dim=cfg.decoder.embed_dim,
        hidden_dim=cfg.decoder.hidden_dim,
        num_layers=cfg.decoder.num_layers,
        attention_dim=cfg.decoder.attention_dim,
        num_heads=cfg.decoder.num_heads,
        mlp_dim=cfg.decoder.mlp_dim,
        max_positions=cfg.decoder.max_positions,
        num_experts=cfg.decoder.num_experts,
    )
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)  # noqa: E731
    params = tree_map(lambda t: t.to(device), dec.init(torch.Generator().manual_seed(0)))
    B = args.batch
    if cfg.encoder.features == "spatial":
        fshape = (B, enc.spatial_positions, cfg.encoder.feature_dim)
    else:
        fshape = (B, cfg.encoder.feature_dim)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    feats = torch.randn(fshape, generator=gen(1), device=device).to(dtype)

    if args.workload == "decode":
        kw = dict(start_id=1, end_id=2, max_len=cfg.decode.max_len)
        engine = greedy_decode
        if args.method == "beam":
            kw.update(beam_width=args.beam_width, decoder=dec)
            engine = beam_decode
        dparams = tree_map(lambda t: t.to(dtype), params)
        step = decode_step_fn(dec, device)

        @torch.inference_mode()
        def once():
            res = engine(step, dparams, dec.init_state(dparams, feats), **kw)
            return int(res.lengths.sum())

    elif args.workload == "train":
        from tpucap_torch.train import TrainState

        opt = chain(scale_by_adam(), scale_by_learning_rate(1e-3))
        state = TrainState.create(params, opt, gen(2))
        step = make_train_step(
            dec, opt,
            compute_dtype=torch.bfloat16 if getattr(args, "train_precision", None) == "bf16" else None,
        )
        tokens = torch.randint(1, cfg.vocab_size, (B, cfg.decode.max_len + 1), generator=gen(3),
                               device=device)
        tfeats = feats.float()

        def once():
            nonlocal state
            state, m = step(state, tfeats, tokens)
            return float(m["loss"])

    elif args.workload == "encoder":
        enc_params = tree_map(lambda t: t.to(device, dtype), enc.init(torch.Generator().manual_seed(4)))
        images = torch.rand((B, enc.input_size, enc.input_size, 3), generator=gen(5),
                            device=device).to(dtype)
        route = getattr(enc, "attention_impl", None)
        if route is not None:
            print(f"encoder {cfg.encoder.name}: attention_impl {route!r}", file=sys.stderr)

        @torch.inference_mode()
        def once():
            return float(enc.apply(enc_params, images).flatten()[0])

    else:
        raise SystemExit(f"unknown workload {args.workload!r}")

    with precision_flags(args.dtype):
        print(f"compiling + warmup ({args.workload})...", file=sys.stderr)
        once()
        print(f"tracing {args.steps} steps -> {args.out}", file=sys.stderr)
        with profile_trace(args.out, cuda=device.type == "cuda") as trace:
            for _ in range(args.steps):
                with torch.profiler.record_function("profile_step"):
                    once()
    print(
        f"trace written: {trace.path}; view with Perfetto (ui.perfetto.dev) "
        "or chrome://tracing"
    )


def refuse_unported_flags(parser, args) -> None:
    """SystemExit naming the first flag of ``args.cmd`` whose feature the
    port does not have and which was given a value the port does not take."""
    for dest, takes in UNPORTED_FLAGS[args.cmd].items():
        value = getattr(args, dest)
        if value == parser.get_default(dest) or value in takes:
            continue
        flag = "--" + dest.replace("_", "-")
        given = flag if value is True else f"{flag} {value}"
        raise SystemExit(f"{given}: not ported to tpucap_torch ({args.cmd})")


def build_parser() -> tuple[argparse.ArgumentParser, dict]:
    """tpucap's parser for the ten ported commands. -> (parser, the
    subcommands' parsers by name)."""
    ap = argparse.ArgumentParser(prog="tpucap-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = extract = sub.add_parser("extract", help="extract CNN features to .npz")
    _add_common_model_flags(p)
    p.add_argument("--images", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--keras-h5", default=None,
                   help="pretrained Keras .h5 to import encoder weights from")
    p.add_argument("--parallelism", default=None, choices=["none", "dp"],
                   help="none only")
    p.set_defaults(fn=cmd_extract)

    p = train = sub.add_parser("train", help="train a caption decoder")
    _add_common_model_flags(p)
    p.add_argument("--tokens", required=False, default=None,
                   help="Flickr8k token file (or use --karpathy-json)")
    p.add_argument("--karpathy-json", default=None,
                   help="Karpathy dataset_*.json with embedded splits; "
                   "--split/--val-split then name splits (train|val|test)")
    p.add_argument("--split", default=None)
    p.add_argument("--val-split", default=None,
                   help="dev-split id file; enables val_loss best-checkpoint "
                   "keying and --early-stopping-patience")
    p.add_argument("--early-stopping-patience", type=int, default=None,
                   help="stop when the monitor hasn't improved for N epochs "
                   "(needs --val-split); 0 = disabled")
    p.add_argument("--features", default=None, help="precomputed-features .npz")
    p.add_argument("--finetune-encoder", action="store_true",
                   help="end-to-end: train the encoder through the captioning "
                   "loss from --images (frozen BN; writes a pipeline bundle)")
    p.add_argument("--images", default=None,
                   help="image dir (<id>.jpg) for --finetune-encoder")
    p.add_argument("--augment", action="store_true",
                   help="--finetune-encoder only: a random horizontal flip of "
                   "each image inside the step")
    p.add_argument("--augment-shift", type=int, default=0,
                   help="--finetune-encoder only: also translate each image by "
                   "up to N px (reflect padding)")
    p.add_argument("--encoder-lr-scale", type=float, default=0.1,
                   help="scale on the encoder's updates during "
                   "--finetune-encoder (0.1 = standard backbone lr)")
    p.add_argument("--remat-encoder", action="store_true",
                   help="--finetune-encoder only: recompute the encoder's "
                   "activations in the backward (same update, lower peak memory)")
    p.add_argument("--bundle-out", default=None,
                   help="also write a pipeline.save() bundle (--finetune-encoder "
                   "defaults it to <checkpoint-dir>/bundle)")
    p.add_argument("--keras-h5", default=None,
                   help="pretrained Keras encoder weights to start "
                   "--finetune-encoder from")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="LoRA fine-tuning: freeze every base weight and "
                   "train a rank-N overlay on the 2-D matmul kernels "
                   "(~1-2%% trainable params; with --finetune-encoder "
                   "the overlay spans encoder+decoder)")
    p.add_argument("--lora-alpha", type=float, default=None,
                   help="LoRA scale numerator (effective scale "
                   "alpha/rank); default alpha=rank (scale 1)")
    p.add_argument("--lora-out", default=None,
                   help="also write the trained LoRA adapters as a "
                   "small .npz artifact (tpucap_torch.train.lora.load_lora)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in --checkpoint-dir "
                   "at its exact epoch and batch (bit-identical to an "
                   "uninterrupted run)")
    p.add_argument("--handle-preemption", action="store_true",
                   help="on SIGTERM: finish the step in flight, write a rescue "
                   "checkpoint, exit cleanly; rerun with --resume to continue")
    p.add_argument("--sharded-checkpoints", action="store_true", help="not ported")
    p.add_argument("--scst-epochs", type=int, default=0, help="not ported")
    p.add_argument("--scst-lr", type=float, default=5e-5, help="not ported")
    p.add_argument("--scst-temperature", type=float, default=1.0, help="not ported")
    p.add_argument("--tokenizer", default="word", choices=["word", "bpe"],
                   help="word only")
    p.add_argument("--bpe-vocab-size", type=int, default=1024, help="not ported")
    p.add_argument("--embeddings", default=None,
                   help="GloVe-format word-vector file to initialize the decoder "
                   "embedding table from (zero rows for uncovered words)")
    p.add_argument("--freeze-embeddings", action="store_true",
                   help="pin the pretrained embedding table during training "
                   "(optimizer updates masked to zero)")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=None,
                   help="learning rate (default 1e-3; also overrides --preset)")
    p.add_argument("--data-parallel", action="store_true", help="not ported")
    p.add_argument("--stream-features", action="store_true",
                   help="stream feature rows from the .npz per batch "
                   "(lazy reads + background prefetch) instead of "
                   "materializing the full (N, F) stack — the at-scale "
                   "path for spatial features; identical training "
                   "trajectory to the in-memory path")
    p.add_argument("--parallelism", default=None,
                   choices=["none", "dp", "fsdp", "tp", "dp_tp", "pp",
                            "dp_pp", "ep", "dp_ep", "sp", "dp_sp"],
                   help="none only")
    p.add_argument("--model-devices", type=int, default=0, help="not ported")
    p.add_argument("--attention-reg", type=float, default=0.0,
                   help="doubly-stochastic attention regularizer weight "
                   "(Show-Attend-Tell; attention decoder only)")
    _add_optimizer_flags(p)
    p.add_argument("--metrics-log", default=None, help="per-epoch JSONL records")
    p.add_argument("--tensorboard-dir", default=None,
                   help="also mirror per-epoch metrics as TensorBoard "
                   "scalars (same logdir family as the profiler traces)")
    p.set_defaults(fn=cmd_train)

    p = caption = sub.add_parser("caption", help="caption image files")
    _add_common_model_flags(p)
    _add_optimizer_flags(p)
    p.add_argument("--image", nargs="+", required=True)
    p.add_argument("--server", default=None, metavar="HOST:PORT",
                   help="caption through a running `serve` (the port's client); "
                   "no local model, checkpoint or device")
    p.add_argument("--server-model", default=None, metavar="NAME",
                   help="with --server: the --extra-model name to route to")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--method", default="beam",
                   choices=["greedy", "beam", "speculative", "diverse", "mbr"],
                   help="greedy, beam, diverse or mbr (speculative is not ported)")
    p.add_argument("--beam-width", type=int, default=3)
    p.add_argument("--dump-attention", default=None, metavar="OUT.npz",
                   help="also write per-token attention maps "
                   "(alphas/lengths/captions/spatial_positions) for "
                   "heatmap overlays — attention/adaptive/transformer "
                   "decoders, --method greedy|beam")
    p.add_argument("--mbr-candidates", type=int, default=5,
                   help="--method mbr: candidate pool size per image")
    p.add_argument("--mbr-from", default="sample",
                   choices=["sample", "beam", "diverse"],
                   help="--method mbr: candidate pool source")
    p.add_argument("--mbr-metric", default="cider",
                   choices=["cider", "bleu4"],
                   help="--method mbr: consensus utility")
    p.add_argument("--diverse-groups", type=int, default=2,
                   help="--method diverse: number of beam groups; each "
                   "group is --beam-width wide and prints its own "
                   "caption line")
    p.add_argument("--diversity", type=float, default=0.5,
                   help="--method diverse: Hamming penalty strength "
                   "pushing later groups off earlier groups' words "
                   "(0 = independent exact beams)")
    p.add_argument("--prefix", default=None,
                   help="forced caption opening ('a dog'): the decoder "
                   "is teacher-forced through it, then greedy/beam "
                   "continues — guided captioning / completion")
    p.add_argument("--include-words", default=None, metavar="W1,W2",
                   help="words the caption MUST contain (constrained "
                   "beam search, Anderson et al. 2017; up to 4 — each "
                   "word doubles the decode batch). Applies to every "
                   "image; --method beam only. Prints the achieved "
                   "satisfaction per image on stderr when full "
                   "satisfaction was unreachable within --max-len")
    p.add_argument("--draft-bundle", default=None,
                   help="--method speculative's draft bundle (not ported)")
    p.add_argument("--gamma", type=int, default=4,
                   help="speculative draft length per round (not ported)")
    p.add_argument("--ensemble-with", action="append", default=None,
                   metavar="BUNDLE",
                   help="pipeline.save() bundle of another trained "
                   "model (repeatable); decode combines all models' "
                   "per-step distributions as a product of experts "
                   "(greedy|beam). Members may use different decoder "
                   "families/encoders but must share the tokenizer; "
                   "each member's features come from its own encoder")
    p.add_argument("--ensemble-weights", default=None,
                   help="comma-separated per-model weights (first = "
                   "the --checkpoint-dir model), normalized to sum 1; "
                   "default uniform")
    p.add_argument("--approx-topk", action="store_true",
                   help="tpucap's TPU approx_max_k; the port's top-k stays exact")
    p.add_argument("--keras-h5", default=None,
                   help="pretrained Keras .h5 encoder weights — use the "
                   "same file `extract` used, or captions come from a "
                   "random encoder")
    _add_restore_flags(p)
    p.set_defaults(fn=cmd_caption)

    p = score = sub.add_parser(
        "score",
        help="score given captions against images (teacher-forced log-prob / "
        "perplexity — reranking & data filtering)",
    )
    _add_common_model_flags(p)
    _add_optimizer_flags(p)
    p.add_argument("--image", nargs="+", required=True)
    p.add_argument("--caption", action="append", default=None,
                   help="caption text to score (repeat once per --image, in order), "
                   "or give --captions-file")
    p.add_argument("--captions-file", default=None,
                   help="file with one caption per line, paired with --image order")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--keras-h5", default=None,
                   help="pretrained Keras .h5 encoder weights — use the "
                   "same file `extract` used, or scores come from a "
                   "random encoder")
    _add_restore_flags(p)
    p.set_defaults(fn=cmd_score)

    p = evaluate = sub.add_parser(
        "evaluate", help="BLEU-1..4 (+ CIDEr-D/ROUGE-L) over a split"
    )
    _add_common_model_flags(p)
    _add_optimizer_flags(p)
    p.add_argument("--tokens", required=False, default=None,
                   help="Flickr8k token file (or use --karpathy-json)")
    p.add_argument("--karpathy-json", default=None,
                   help="Karpathy dataset_*.json; --split then names a split")
    p.add_argument("--split", default=None)
    p.add_argument("--features", required=True)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--method", default="greedy", choices=["greedy", "beam"])
    p.add_argument("--beam-width", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--parallelism", default=None,
                   choices=["none", "dp", "tp", "dp_tp"], help="none only")
    p.add_argument("--model-devices", type=int, default=0, help="not ported")
    p.add_argument("--dump-captions", default=None,
                   help="also write per-image JSONL (image_id, caption, "
                   "references, sentence BLEU-4)")
    p.add_argument("--metrics", default="bleu",
                   help="comma list from bleu,cider,rouge_l,meteor,diversity")
    p.add_argument("--coco-results", default=None,
                   help="also write coco-caption results JSON")
    p.add_argument("--meteor-synonyms", default=None, metavar="FILE",
                   help="synonym-groups file for METEOR's synonym stage")
    _add_restore_flags(p)
    p.set_defaults(fn=cmd_evaluate)

    p = compare = sub.add_parser(
        "compare",
        help="paired bootstrap significance test between two "
        "`evaluate --dump-captions` files (Koehn 2004)",
    )
    p.add_argument("file_a", help="baseline system's --dump-captions JSONL")
    p.add_argument("file_b", help="candidate system's --dump-captions JSONL")
    p.add_argument("--metric", default="bleu4",
                   choices=["bleu1", "bleu2", "bleu3", "bleu4", "cider", "rouge_l", "meteor"],
                   help="corpus metric to compare (same conventions as evaluate --metrics)")
    p.add_argument("--bootstrap", type=int, default=1000, help="number of bootstrap resamples")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_compare)

    p = export = sub.add_parser(
        "export",
        help="export the trained decoder to a Keras .h5 (migration exit "
        "ramp); --format aot is not ported",
    )
    _add_common_model_flags(p)
    _add_optimizer_flags(p)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--out", required=True,
                   help="output path: .h5 file (--format h5) or bundle "
                   "directory (--format aot)")
    p.add_argument("--method", default=None, choices=["greedy", "beam"],
                   help="decode method baked into an AOT bundle "
                   "(ignored for h5)")
    p.add_argument("--beam-width", type=int, default=None,
                   help="beam width baked into an AOT bundle (ignored for h5)")
    p.add_argument("--format", default="h5", choices=["h5", "aot"],
                   help="h5 = Keras exit ramp; aot: not ported")
    p.add_argument("--aot-batch-size", type=int, default=64, help="not ported")
    p.add_argument("--aot-ladder", action="store_true", help="not ported")
    p.add_argument("--include-encoder", action="store_true", help="not ported")
    p.add_argument("--bundle-out", default=None,
                   help="also write a pipeline.save() bundle here")
    p.add_argument("--keras-h5", default=None, help=argparse.SUPPRESS)
    _add_restore_flags(p)
    p.set_defaults(fn=cmd_export)

    p = serve = sub.add_parser(
        "serve", help="HTTP caption server (micro-batched serving on the card)"
    )
    _add_common_model_flags(p)
    _add_optimizer_flags(p)
    p.add_argument("--model-dir", default=None,
                   help="a pipeline.save() bundle; overrides "
                   "--checkpoint-dir restore")
    p.add_argument("--aot-bundle", default=None, help="not ported")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--keras-h5", default=None,
                   help="pretrained Keras .h5 encoder weights for the "
                   "image path (as in `caption`)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--max-queue", type=int, default=None,
                   help="bounded admission: reject (HTTP 503) when this "
                   "many requests are queued (default unbounded)")
    p.add_argument("--max-body-mb", type=float, default=64.0,
                   help="request-body ceiling in MiB (HTTP 413 over it, "
                   "checked before the body is read; 0 disables)")
    p.add_argument("--engine", default="batch",
                   choices=["batch", "continuous"],
                   help="feature-serving engine: micro-batched (default) "
                   "or continuous slot-recycling (greedy, or beam with "
                   "--method beam)")
    p.add_argument("--no-warmup", dest="warmup", action="store_false",
                   help="skip running the batch buckets at startup")
    p.add_argument("--method", default="beam", choices=["greedy", "beam"])
    p.add_argument("--beam-width", type=int, default=3)
    p.add_argument("--allow-reload", action="store_true",
                   help="enable POST /reload {'bundle': path}: "
                   "zero-downtime weight hot-swap from a pipeline "
                   "bundle (admin surface — off by default)")
    p.add_argument("--extra-model", action="append", default=None,
                   metavar="NAME=BUNDLE_DIR",
                   help="serve an additional pipeline bundle behind the "
                   "same port (repeatable); requests route with "
                   "?model=NAME or a 'model' JSON field — each model "
                   "gets its own micro-batcher (engine batch only)")
    _add_restore_flags(p)
    p.set_defaults(fn=cmd_serve)

    p = doctor = sub.add_parser(
        "doctor",
        help="environment diagnostics (platform, devices, versions, "
        "JPEG extension, kernel build, device smoke)",
    )
    p.add_argument("--no-device-smoke", action="store_true",
                   help="skip the matmul probe on the device")
    p.set_defaults(fn=cmd_doctor)

    p = profile = sub.add_parser(
        "profile",
        help="capture a torch.profiler trace (Chrome trace JSON: Perfetto "
        "or chrome://tracing) of a decode/train/encoder workload",
    )
    _add_common_model_flags(p)
    _add_optimizer_flags(p)
    p.add_argument("--workload", default="decode",
                   choices=["decode", "train", "encoder"])
    p.add_argument("--method", default="greedy",
                   choices=["greedy", "beam"])
    p.add_argument("--beam-width", type=int, default=3)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=3,
                   help="traced iterations (after an untraced warmup)")
    p.add_argument("--dtype", default="bf16", choices=["f32", "bf16"])
    p.add_argument("--out", required=True,
                   help="trace log dir (a Chrome trace JSON is written there)")
    p.set_defaults(fn=cmd_profile)
    return ap, {"extract": extract, "train": train, "caption": caption, "score": score,
                "evaluate": evaluate, "compare": compare, "export": export, "serve": serve,
                "doctor": doctor, "profile": profile}


def main(argv=None, *, device=None):
    """Run one command. ``device``: None for the card (raises without
    one), ``"cpu"`` for the CPU. ``compare`` is host numpy and takes no
    device."""
    ap, commands = build_parser()
    args = ap.parse_args(argv)
    # tpucap's checks first, in its order, where one names a value that the
    # port refuses anyway (--lora-rank with --parallelism fsdp, --extra-model
    # with --aot-bundle, --server with --method speculative).
    if args.cmd == "train" and (args.lora_rank or args.lora_out):
        _validate_train_flags(args)
    elif args.cmd == "serve":
        _validate_serve_flags(args)
    elif args.cmd == "caption":
        _validate_caption_flags(args)
    refuse_unported_flags(commands[args.cmd], args)
    if args.cmd == "compare":
        args.fn(args)
        return
    if args.cmd == "caption" and args.server:
        _caption_remote(args)  # no device here: the server's
        return
    if args.cmd == "doctor":
        args.fn(args, device)  # reports a missing card itself
        return
    args.fn(args, resolve_device(device))
