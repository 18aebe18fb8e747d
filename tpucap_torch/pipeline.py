"""High-level captioning pipeline: the serving subset of
``tpucap.pipeline.CaptioningPipeline``.

    fit_tokenizer(descriptions)   vocabulary (Keras-parity word tokenizer)
    build(seed)                   encoder + decoder, random init
    fold_bn()                     BatchNorm folded into the conv weights
    encode_images(images)         preprocessed batch -> features
    generate(features, ...)       features -> captions (greedy | beam)
    generate_submit(features)     dispatch the decode -> a finalizer that
    encode_submit(images)         returns the captions (``generate`` is
                                  ``generate_submit(...)()``); the servers'
                                  entry points, each on one snapshot of the
                                  params
    caption_batch(images_u8, ...) uint8 (B, H, W, 3) -> captions: the body
                                  of the JAX package's caption_dataset
    caption_dataset(paths, ...)   JPEG files -> captions: host decode in a
                                  loader thread, each batch through the
                                  body of caption_batch
    extract_features(paths)       JPEG files -> encoder features (numpy)
    caption_images(paths)         extract_features, then generate
    score_captions(features,      each given caption's teacher-forced
                   captions)      log-probability (the engines' score)
    generate_continuation(        forced-prefix captioning: the decoder
        features, prefix)         primed through each row's opening
                                  (``decode/prefix.py``), then greedy or
                                  beam continues it
    generate_constrained(         constrained beam search: captions that
        features, include_words)  must hold the given words
                                  (``decode/constrained.py``); both with
                                  ``_submit`` forms and, for the servers'
                                  images mode, ``encode_continuation_submit``
                                  / ``encode_constrained_submit`` (the
                                  encoder and the decode on one snapshot)
    generate_diverse(features)    diverse beam search: the best caption of
                                  each group (``decode/diverse.py``)
    generate_mbr(features)        MBR (consensus) pick from a sampled,
                                  n-best or diverse pool (``decode/mbr.py``)
    generate_ensemble(features,   product-of-experts decode over several
                      others)     pipelines (``decode/ensemble.py``)
    generate_with_attention(      captions with the attention, adaptive or
        features)                 transformer decoder's maps,
                                  teacher-forced after the decode

    evaluate(descriptions,        decode features in padded batches, then
             features)            BLEU-1..4, CIDEr-D, ROUGE-L, METEOR and
                                  diversity (``tpucap_torch.train.evaluate``)
    save(directory)               the inference bundle: config.json,
    load(directory)               tokenizer.json and params.npz
    reload_params(source)         swap the weights from a bundle or a tree,
                                  checked against the live ones first

    fit(descriptions, features,   train the decoder on extracted features;
        val_data=...,             with a dev split, val_loss / val_accuracy
        checkpoint_manager=...,   each epoch, TrainConfig.val_metric's
        resume=...,               monitor and early stopping; each epoch
        handle_preemption=...,    checkpointed, resumed exactly, a SIGTERM
        stream=...)               answered with a rescue checkpoint; the
                                  feature rows streamed a batch at a time
                                  from a lazy mapping
    fit_lora(descriptions,        LoRA on the decoder: the base frozen, a
             features, rank=...)  low-rank overlay trained, then merged
    save_lora(path)               the adapters as tpucap's .npz artifact;
    apply_lora_file(path)         an artifact merged into the params
    fit_finetune(descriptions,    train encoder and decoder jointly on
                 images, ...)     preprocessed images, with augmentation,
                                  remat and fit's checkpoint dials; with
                                  lora_rank, a LoRA overlay on both
    set_pretrained_embeddings(    the decoder's embedding table from GloVe
        source, freeze=...)       vectors, frozen in fit and fit_finetune
    use_ema_weights()             swap in the EMA of the last fit's weights
                                  (TrainConfig.ema_decay)
    use_averaged_weights(dir)     swap in the mean of retained checkpoints'
                                  decoder params

``caption_batch`` is the main path: preprocess kernel K1 -> encoder ->
the decoder's init_state -> beam search whose step, on the card with a
1-layer MergeDecoder, is ``make_fused_merge_step`` (kernels K2 and K3: the
JAX package's own drop-in step_fn hook). Otherwise (on the CPU, lstm2,
the GRU merge decoders gru1 and gru2, ``InjectDecoder``, the soft-attention
``AttentionDecoder`` and the visual-sentinel ``AdaptiveAttentionDecoder``,
whose per-image grids the beam keeps untiled, and the KV-cache
``TransformerDecoder``, dense or MoE, whose cross-attention memory it keeps
untiled) the step is the decoder's plain ``step``, as the JAX package runs
them as plain XLA. A forced prefix primes the transformer in one
``step_chunk`` forward (``decode/prefix.py``). Training reads no MoE
load-balance loss (``TrainConfig.moe_aux_weight``), as tpucap's
single-device step does not. The encoder is ``EncoderConfig.name``'s: VGG16 (the default, fc2
features or the block5 grid, caffe mode), InceptionV3 (tf mode, 299),
ResNet-50 (caffe mode), ViT-B/16 or vit_tiny (tf mode) or tiny_cnn (tf
mode, 32). As in the JAX package the
encoder's kernel paths are opt-in on the built encoder:
``pipe.encoder = dataclasses.replace(pipe.encoder, fused_blocks=True)``
(ResNet-50's identity blocks as kernel K4, after ``fold_bn()``) or
``dataclasses.replace(pipe.encoder, attention_impl="flash")`` (ViT
attention as kernel K5; under ``fit_finetune`` K5's two backward kernels
too). Training is single-device, with tpucap's optimizers and lr schedules
(``tpucap_torch.train``).

JPEG files are read by the port's own decoder (``tpucap_torch.ops.jpeg``,
host C++, no libjpeg and no PIL): baseline and progressive Huffman JPEG,
the same bytes as tpucap's libjpeg decode at every scale. ``caption_dataset``
keeps tpucap's default ``fast_scale=True``, the smallest libjpeg scale N/8
that covers the encoder's input; ``fast_scale=False`` decodes at 8/8. The
host resizes to the encoder's input size, so K1 takes its same-size route
there.

Runs on ``cuda`` unless ``device="cpu"`` is passed; see
``tpucap_torch.core`` for the precision policy.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading

import numpy as np
import torch

from tpucap_torch.checkpoint import CheckpointManager
from tpucap_torch.config import Config, config_from_dict, config_to_dict
from tpucap_torch.core import (
    apply_precision,
    check_float_params,
    check_same_layout,
    infer_dtype,
    precision_flags,
    resolve_device,
    tree_leaves,
    tree_map,
)
from tpucap_torch.convert import load_npz, save_npz
from tpucap_torch.data.augment import make_augment_fn
from tpucap_torch.data.pipeline import caption_batch_stream, image_batch_loader, prefetch_iterator
from tpucap_torch.data.preprocess import preprocess_batch
from tpucap_torch.decode import (
    MAX_CONSTRAINTS,
    EnsembleDecoder,
    beam_decode,
    constrained_beam_decode,
    diverse_beam_decode,
    greedy_decode,
    ids_to_captions,
    mbr_select,
    normalized_scores,
    prime_prefix,
    sample_decode,
)
from tpucap_torch.models.decoders import MergeDecoder, build_decoder
from tpucap_torch.models.encoders import build_encoder, fold_batch_norms
from tpucap_torch.ops.decoder_step import make_fused_merge_step
from tpucap_torch.ops.preprocess import fused_preprocess
from tpucap_torch.text import END_TOKEN, START_TOKEN, Tokenizer, load_tokenizer
from tpucap_torch.text.embeddings import build_embedding_matrix, load_word_vectors
from tpucap_torch.text.tokenizer import text_to_word_sequence
from tpucap_torch.train import (
    TrainState,
    batch_iterator,
    build_optimizer,
    build_training_batch,
    build_training_tokens,
    encoder_learning_rate_optimizer,
    loss_from_sums,
    make_eval_sums_step,
    make_joint_train_step,
    make_train_step,
    own_state,
)
from tpucap_torch.train.evaluate import check_metrics, evaluate_captions
from tpucap_torch.train.lora import (
    DEFAULT_TARGET_KEYS,
    init_lora,
    load_lora,
    lora_param_counts,
    make_lora_train_step,
    merge_lora,
)
from tpucap_torch.train.lora import save_lora as _save_lora
from tpucap_torch.train.loop import freeze_subtree_updates, refuse_unported
from tpucap_torch.train.preemption import PreemptionGuard
from tpucap_torch.train.scheduled import SCHEDULES, epsilon_for_epoch

#: The bundle's param file (tpucap's bundles hold an orbax ``params/``
#: directory instead, which the port cannot read).
PARAMS_FILE = "params.npz"
#: TrainConfig.val_metric values that greedy-decode the dev split.
DECODE_MONITORS = ("bleu4", "cider", "rouge_l", "meteor")


def decode_step_fn(decoder, device):
    """The decode step on ``device``: kernels K2 + K3 on the card for a
    1-layer merge LSTM decoder, the plain decoder step otherwise (lstm2,
    gru1, gru2, inject, attention, adaptive and transformer, as in the JAX
    package)."""
    if (
        torch.device(device).type == "cuda"
        and isinstance(decoder, MergeDecoder)
        and decoder.num_layers == 1
    ):
        return make_fused_merge_step(decoder)
    return decoder.step


class CaptioningPipeline:
    def __init__(
        self, config: Config, tokenizer: Tokenizer | None = None, *, device=None
    ):
        self.config = config
        self.device = resolve_device(device)
        apply_precision(config.precision)
        self.encoder = build_encoder(config.encoder.name, config.encoder.features)
        self.tokenizer = tokenizer
        self.decoder = None
        self.params: dict = {}
        # The bf16 cast of ``params`` (``_inference_params``), and what keeps
        # it that tree's: every change of the params bumps the version under
        # the lock, and a cast is stored only under the version it was
        # made from.
        self._bf16_params = None
        self._params_version = 0
        self._params_lock = threading.Lock()
        # The EMA shadow of the last fit or fit_finetune with
        # TrainConfig.ema_decay > 0 (``use_ema_weights``).
        self.ema_params = None
        # set_pretrained_embeddings(freeze=True): fit and fit_finetune mask
        # the embedding table's updates.
        self._freeze_embeddings = False
        # The last fit_lora / fit_finetune(lora_rank=)'s adapters and their
        # {"rank", "alpha"} (``save_lora``).
        self.lora_adapters = None
        self.lora_meta = None

    # -- tokenizer ---------------------------------------------------------

    def fit_tokenizer(self, descriptions: dict[str, list[str]]) -> Tokenizer:
        """Fit the Keras-parity word vocabulary on the caption corpus."""
        tok = Tokenizer()
        tok.fit_on_texts(c for caps in descriptions.values() for c in caps)
        self.tokenizer = tok
        return tok

    @property
    def vocab_size(self) -> int:
        if self.tokenizer is None:
            return self.config.vocab_size
        return self.tokenizer.vocab_size

    def _token_ids(self):
        wi = self.tokenizer.word_index
        return wi[START_TOKEN], wi[END_TOKEN]

    def _banned_ids(self) -> tuple:
        """``DecodeConfig.bad_words`` -> sorted token ids, each entry run
        through the tokenizer's own normalization; words the head cannot
        emit (unknown, or at/above the num_words cap) drop out."""
        return tuple(
            sorted(
                {
                    i
                    for entry in self.config.decode.bad_words
                    for _, i in self._normalize_vocab_entry(entry)
                    if i is not None
                }
            )
        )

    def _normalize_vocab_entry(self, entry: str):
        """Run ``entry`` through the tokenizer's own normalization (filters,
        lowercase, split) and look up each word's model-emittable id ->
        [(word, id_or_None)]. None marks a word the head can never emit:
        absent from word_index, or at/above the num_words cap. The one rule
        of "is this a vocabulary word" for bad_words (drops None) and
        include_words (raises on None)."""
        tok = self.tokenizer
        wi = tok.word_index
        return [
            (w, wi[w] if w in wi and wi[w] < self.vocab_size else None)
            for w in text_to_word_sequence(entry, filters=tok.filters, lower=tok.lower)
        ]

    # -- model construction ------------------------------------------------

    def build(self, seed: int | None = None, init_params: bool = True):
        """Construct the decoder and (by default) random-initialize params
        from a seeded ``torch.Generator`` (``config.train.seed`` unless
        ``seed`` is given)."""
        d = self.config.decoder
        if d.name == "transformer" and d.max_positions < self.config.decode.max_len + 1:
            raise ValueError(
                f"decoder.max_positions {d.max_positions} cannot hold "
                f"decode.max_len {self.config.decode.max_len} generated "
                "tokens plus the start token"
            )
        self.decoder = build_decoder(
            d.name,
            vocab_size=self.vocab_size,
            feature_dim=self.config.encoder.feature_dim,
            embed_dim=d.embed_dim,
            hidden_dim=d.hidden_dim,
            num_layers=d.num_layers,
            dropout_rate=d.dropout_rate,
            attention_dim=d.attention_dim,
            num_heads=d.num_heads,
            mlp_dim=d.mlp_dim,
            max_positions=d.max_positions,
            num_experts=d.num_experts,
            moe_top_k=d.moe_top_k,
        )
        if init_params:
            gen = torch.Generator().manual_seed(
                self.config.train.seed if seed is None else seed
            )
            params = {
                "encoder": self.encoder.init(gen),
                "decoder": self.decoder.init(gen),
            }
            self.set_params(params)
        return self.params

    def set_params(self, params) -> None:
        """Install a param tree (e.g. from ``convert.params_from_jax`` or
        ``convert.load_npz``) on the pipeline's device. Every leaf must be
        float: an int8 (quantized) tree raises NotImplementedError."""
        check_float_params(params)
        params = tree_map(lambda t: t.to(self.device), params)
        with self._params_lock:
            self.params = params
            self._params_version += 1
            self._bf16_params = None

    def _params_changed(self) -> None:
        """Drop the cached bf16 params after ``self.params`` was changed in
        place; a cast still in progress on another thread is not stored."""
        with self._params_lock:
            self._params_version += 1
            self._bf16_params = None

    def fold_bn(self) -> None:
        """Fold inference BatchNorms into the conv weights."""
        self.params["encoder"] = fold_batch_norms(
            self.config.encoder.name, self.params["encoder"]
        )
        self._params_changed()

    def set_pretrained_embeddings(self, source, *, freeze: bool = False, log=print) -> int:
        """Initialize the decoder's embedding table from pretrained word
        vectors. ``source``: a GloVe-format text file's path, a ``{word:
        vector}`` dict, or a ready ``(vocab_size, embed_dim)`` matrix; rows
        of words without a vector (and padding row 0) are zero.
        ``freeze=True`` pins the table in later ``fit`` / ``fit_finetune``
        calls by masking its optimizer updates (so adamw's decay cannot move
        it either). Drops the cached bf16 params. -> the words covered (the
        rows of a matrix)."""
        if self.decoder is None:
            self.build()
        table = self.params["decoder"]["embedding"]["table"]
        if isinstance(source, (str, os.PathLike)):
            source = load_word_vectors(source)
        if isinstance(source, dict):
            if self.tokenizer is None:
                raise ValueError(
                    "a fitted tokenizer is required to index word vectors "
                    "— call fit_tokenizer() first or pass a matrix"
                )
            matrix, hits = build_embedding_matrix(
                self.tokenizer, source, embed_dim=table.shape[1], vocab_size=table.shape[0]
            )
        else:
            matrix, hits = torch.as_tensor(source), None
        if tuple(matrix.shape) != tuple(table.shape):
            raise ValueError(
                f"embedding matrix shape {tuple(matrix.shape)} != decoder "
                f"table shape {tuple(table.shape)}"
            )
        self.params["decoder"]["embedding"]["table"] = torch.as_tensor(matrix).to(
            table.device, table.dtype
        )
        self._freeze_embeddings = freeze
        self._params_changed()
        if log and hits is not None:
            log(
                f"pretrained embeddings: {hits}/{table.shape[0] - 1} vocab "
                f"words covered ({100.0 * hits / max(1, table.shape[0] - 1):.1f}%)"
                + (", table frozen" if freeze else "")
            )
        return hits if hits is not None else int(matrix.shape[0])

    # -- precision ----------------------------------------------------------

    def _infer_dtype(self) -> torch.dtype:
        return infer_dtype(self.config.precision)

    def _inference_params(self):
        """Params of the inference paths: a cached bf16 copy when
        config.precision == 'bf16', the params themselves otherwise. Conv
        kernels are kept channels_last on the card, the layout their
        NHWC inputs have."""
        if self.config.precision != "bf16":
            return self.params
        with self._params_lock:
            params, version, cached = self.params, self._params_version, self._bf16_params
        if cached is not None:
            return cached

        def cast(t):
            t = t.to(torch.bfloat16)
            if t.ndim == 4 and t.is_cuda:
                t = t.contiguous(memory_format=torch.channels_last)
            return t

        cast_params = tree_map(cast, params)
        # A reload (another thread's set_params) during the cast made it the
        # old tree's: serve it to this caller, whose batch began before the
        # reload, but never cache it.
        with self._params_lock:
            if self._params_version == version:
                self._bf16_params = cast_params
        return cast_params

    # -- encoder -----------------------------------------------------------

    def _apply_encoder(self, params, x):
        """Encoder apply + spatial flattening to (B, L, D), under the
        pipeline's own precision flags."""
        with precision_flags(self.config.precision):
            feats = self.encoder.apply(params, x)
        if self.config.encoder.features == "spatial":
            B, H, W, C = feats.shape
            feats = feats.reshape(B, H * W, C)
        return feats

    @torch.inference_mode()
    def encode_images(self, images) -> torch.Tensor:
        """Preprocessed NHWC image batch -> features, on the device."""
        x = torch.as_tensor(images).to(self.device, self._infer_dtype())
        return self._apply_encoder(self._inference_params()["encoder"], x)

    # -- decoding ----------------------------------------------------------

    def step_fn(self):
        """The decode step: ``decode_step_fn(self.decoder, self.device)``."""
        return decode_step_fn(self.decoder, self.device)

    def _decode(self, dec_params, feats, method, beam_width):
        """The decode engine on ``feats``, under the pipeline's own precision
        flags (``Config.precision``), as tpucap's decode programs apply their
        matmul precision per call: the flags are process-wide, and another
        pipeline or a training run may have set others."""
        with precision_flags(self.config.precision):
            start_id, end_id = self._token_ids()
            dcfg = self.config.decode
            state = self.decoder.init_state(dec_params, feats)
            if method == "greedy":
                return greedy_decode(
                    self.step_fn(),
                    dec_params,
                    state,
                    start_id=start_id,
                    end_id=end_id,
                    max_len=dcfg.max_len,
                    min_len=dcfg.min_len,
                    banned_ids=self._banned_ids(),
                    no_repeat_ngram_size=dcfg.no_repeat_ngram_size,
                )
            if method != "beam":
                raise ValueError(f"unknown decode method {method!r}")
            return beam_decode(
                self.step_fn(),
                dec_params,
                state,
                start_id=start_id,
                end_id=end_id,
                max_len=dcfg.max_len,
                beam_width=beam_width,
                min_len=dcfg.min_len,
                banned_ids=self._banned_ids(),
                no_repeat_ngram_size=dcfg.no_repeat_ngram_size,
                length_normalize=dcfg.length_normalize,
                alpha=dcfg.alpha,
                length_penalty=dcfg.length_penalty,
                decoder=self.decoder,
                approx_topk=dcfg.approx_topk,
            )

    def _captions(self, res) -> list[str]:
        _, end_id = self._token_ids()
        return ids_to_captions(
            self.tokenizer, res.tokens, res.lengths, end_id=end_id
        )

    def generate(
        self,
        features,
        *,
        method: str | None = None,
        beam_width: int | None = None,
        temperature: float = 1.0,
        top_k: int | None = None,
        top_p: float | None = None,
        repetition_penalty: float = 1.0,
        seed: int = 0,
        parallelism: str | None = None,
    ) -> list[str]:
        """Features (B, D) -> caption strings (sentinels stripped).

        method: 'greedy' | 'beam' (``generate_submit(features, ...)()``) |
        'sample' (``decode/sample.py``; temperature, top_k, top_p,
        repetition_penalty and seed apply to sampling only). ``seed`` seeds
        a ``torch.Generator`` on the pipeline's device: the same seed gives
        the same captions here, and other captions than tpucap's for that
        seed (its draws come from a jax key). ``parallelism`` other than
        none: sampling refuses it with tpucap's error, greedy and beam by
        name (not ported)."""
        method = method or self.config.decode.method
        if parallelism not in (None, "none"):
            if method == "sample":
                raise ValueError("sampling decode does not support parallelism")
            refuse_unported(parallelism=(parallelism, None))
        if method != "sample":
            return self.generate_submit(features, method=method, beam_width=beam_width)()
        params = self._inference_params()
        return self._sample_captions(
            params["decoder"], self._features(params, features, images=False),
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, seed=seed,
        )

    @torch.inference_mode()
    def _sample_captions(self, dec_params, feats, *, seed: int = 0, **dials) -> list[str]:
        """Sampling decode of ``feats`` under the pipeline's flags, on the
        given params snapshot; ``dials``: sample_decode's temperature,
        top_k, top_p and repetition_penalty."""
        with precision_flags(self.config.precision):
            start_id, end_id = self._token_ids()
            dcfg = self.config.decode
            res = sample_decode(
                self.step_fn(),
                dec_params,
                self.decoder.init_state(dec_params, feats),
                generator=torch.Generator(device=self.device).manual_seed(seed),
                start_id=start_id,
                end_id=end_id,
                max_len=dcfg.max_len,
                min_len=dcfg.min_len,
                banned_ids=self._banned_ids(),
                no_repeat_ngram_size=dcfg.no_repeat_ngram_size,
                **dials,
            )
        return self._captions(res)

    @torch.inference_mode()
    def generate_n_best(
        self, features, *, n: int | None = None, beam_width: int | None = None
    ) -> list[list[tuple[str, float]]]:
        """Beam search's n-best list a row: for each of the B feature rows,
        (caption, normalized score) pairs best first. ``n`` defaults to the
        beam width; entry 0 is exactly ``generate(method='beam')`` (the
        engine's own f32 ranking, ties to the lowest slot by a stable
        sort). Scores are length-normalized when
        ``config.decode.length_normalize``, raw log-prob sums otherwise."""
        beam_width = beam_width or self.config.decode.beam_width
        n = n or beam_width
        if n > beam_width:
            raise ValueError(
                f"n={n} exceeds beam_width={beam_width} — only "
                "beam_width hypotheses exist"
            )
        params = self._inference_params()
        feats = self._features(params, features, images=False)
        res = self._decode(params["decoder"], feats, "beam", beam_width)
        _, end_id = self._token_ids()
        dcfg = self.config.decode
        lengths = res.beam_lengths
        norm = normalized_scores(
            res.beam_scores.float(),
            lengths,
            length_normalize=dcfg.length_normalize,
            alpha=dcfg.alpha,
            length_penalty=dcfg.length_penalty,
        )
        order = torch.sort(norm, dim=-1, descending=True, stable=True).indices[:, :n]
        tokens = res.beam_tokens.gather(1, order[..., None].expand(-1, -1, res.beam_tokens.shape[-1]))
        caps = ids_to_captions(
            self.tokenizer, tokens.flatten(0, 1), lengths.gather(1, order).flatten(), end_id=end_id
        )
        scores = norm.gather(1, order).cpu().tolist()
        return [
            list(zip(caps[b * n:(b + 1) * n], scores[b])) for b in range(order.shape[0])
        ]

    @torch.inference_mode()
    def generate_submit(
        self, features, *, method: str | None = None, beam_width: int | None = None
    ):
        """Dispatch the decode of ``features`` under the pipeline's flags and
        return a zero-argument finalizer that waits for the tokens and
        detokenizes them (tpucap's ``generate_submit``; greedy and beam).
        The decode checks on the host every few steps whether every row has
        ended (``decode.beam.EXIT_CHECK_EVERY``), so the call returns near
        the decode's end; what the finalizer leaves to the caller is the copy
        back and the detokenizing."""
        params = self._inference_params()
        return self._submit_decode(params["decoder"], features, method, beam_width)

    @torch.inference_mode()
    def encode_submit(
        self, images, *, method: str | None = None, beam_width: int | None = None
    ):
        """``generate_submit`` of ``encode_images(images)``, the encoder and
        the decode on one snapshot of the params: a ``reload_params`` on
        another thread lands before or after the batch, never inside it."""
        params = self._inference_params()
        feats = self._features(params, images, images=True)
        return self._submit_decode(params["decoder"], feats, method, beam_width)

    def _submit_decode(self, dec_params, features, method, beam_width):
        method = method or self.config.decode.method
        beam_width = beam_width or self.config.decode.beam_width
        if method not in ("greedy", "beam"):
            raise ValueError(f"generate_submit supports greedy|beam, got {method!r}")
        feats = torch.as_tensor(features).to(self.device, self._infer_dtype())
        res = self._decode(dec_params, feats, method, beam_width)
        return lambda: self._captions(res)

    def encode_prefixes(self, texts: list) -> list:
        """Tokenize caption strings, refusing words outside the vocabulary
        (the tokenizer would drop them silently and score another caption).
        Words are counted under the tokenizer's own normalization."""
        seqs = self.tokenizer.texts_to_sequences(texts)
        for text, seq in zip(texts, seqs):
            if len(seq) != len(self.tokenizer._analyze(text)):
                raise ValueError(f"prefix {text!r} contains words outside the tokenizer vocabulary")
        return seqs

    def _features(self, params, x, images: bool):
        """Feature rows on the device: ``x`` itself, or the encoder's
        output of the image batch ``x`` under ``params``."""
        x = torch.as_tensor(x).to(self.device, self._infer_dtype())
        return self._apply_encoder(params["encoder"], x) if images else x

    def generate_continuation(
        self, features, prefix, *, method: str | None = None, beam_width: int | None = None
    ) -> list[str]:
        """Blocking forced-prefix captioning:
        ``generate_continuation_submit(...)()``."""
        return self.generate_continuation_submit(
            features, prefix, method=method, beam_width=beam_width
        )()

    @torch.inference_mode()
    def generate_continuation_submit(
        self, features, prefix, *, method: str | None = None, beam_width: int | None = None
    ):
        """Forced-prefix captioning: continue caption openings ("a dog ..."
        -> the model's best completion).

        prefix: one string for every row, or a list of per-row strings
        ("" rows decode from scratch). Words are encoded under the
        tokenizer's own normalization; a word outside the vocabulary
        raises. The decoder is teacher-forced through the prefix tokens
        (``decode/prefix.py``; rows past their own prefix keep their
        state), then the greedy or beam engine continues from each row's
        last prefix token, its score seeded by the prefix log-prob. The
        captions are "prefix + continuation"; beam ranks by the
        continuation's normalized score. DecodeConfig's dials apply to the
        continuation (min_len counts generated tokens, the n-gram history
        starts after the prefix, max_len bounds the continuation).

        Dispatches now and returns a zero-argument finalizer that yields
        the captions (``generate_submit``'s contract), on one snapshot of
        the params."""
        return self._continuation_submit(
            self._inference_params(), features, prefix, method, beam_width, images=False
        )

    @torch.inference_mode()
    def encode_continuation_submit(
        self, images, prefix, *, method: str | None = None, beam_width: int | None = None
    ):
        """``generate_continuation_submit`` of ``encode_images(images)``,
        the encoder and the decode on one snapshot of the params."""
        return self._continuation_submit(
            self._inference_params(), images, prefix, method, beam_width, images=True
        )

    def _continuation_submit(self, params, x, prefix, method, beam_width, *, images: bool):
        method = method or self.config.decode.method
        beam_width = beam_width or self.config.decode.beam_width
        if method not in ("greedy", "beam"):
            raise ValueError(f"generate_continuation supports greedy|beam, got {method!r}")
        B = len(x)
        if isinstance(prefix, str):
            prefix = [prefix] * B
        if len(prefix) != B:
            raise ValueError(f"{len(prefix)} prefixes for {B} feature rows")
        seqs = self.encode_prefixes(prefix)
        P = max((len(s) for s in seqs), default=0)
        if P:
            # The forced length padded to a power of two, as the JAX
            # package pads it (one program per bucket there).
            P = 1 << (P - 1).bit_length()
        pref = np.zeros((B, P), np.int64)
        plens = np.zeros((B,), np.int64)
        for i, s in enumerate(seqs):
            pref[i, : len(s)] = s
            plens[i] = len(s)
        start_id, end_id = self._token_ids()
        dcfg = self.config.decode
        max_pos = getattr(self.decoder, "max_positions", None)
        true_max = int(plens.max()) if P else 0
        if max_pos is not None and max(P, true_max + dcfg.max_len) > max_pos:
            raise ValueError(
                f"prefix length {true_max} (padded to {P}) + max_len "
                f"{dcfg.max_len} exceeds decoder.max_positions {max_pos}; "
                "raise max_positions or shorten the prefix"
            )
        dec_params = params["decoder"]
        feats = self._features(params, x, images)
        with precision_flags(self.config.precision):
            step = self.step_fn()
            state = self.decoder.init_state(dec_params, feats)
            state, last, lp = prime_prefix(
                step, dec_params, state, pref, plens, start_id=start_id, decoder=self.decoder
            )
            kw = dict(
                start_id=last,
                end_id=end_id,
                max_len=dcfg.max_len,
                min_len=dcfg.min_len,
                banned_ids=self._banned_ids(),
                no_repeat_ngram_size=dcfg.no_repeat_ngram_size,
                init_scores=lp,
            )
            if method == "greedy":
                res = greedy_decode(step, dec_params, state, **kw)
            else:
                res = beam_decode(
                    step,
                    dec_params,
                    state,
                    beam_width=beam_width,
                    length_normalize=dcfg.length_normalize,
                    alpha=dcfg.alpha,
                    length_penalty=dcfg.length_penalty,
                    decoder=self.decoder,
                    approx_topk=dcfg.approx_topk,
                    **kw,
                )
        # The prefix text rebuilt from its ids: what the model was forced
        # through, in the tokenizer's own casing.
        heads = self.tokenizer.sequences_to_texts(seqs)

        def finalize() -> list[str]:
            tails = self._captions(res)
            return [(h + " " + t).strip() if h else t for h, t in zip(heads, tails)]

        return finalize

    def _constraint_ids(self, include_words, batch: int, num_slots: int | None = None) -> np.ndarray:
        """Validate and encode must-include words -> (B, C) int array (pad
        id 0 = unused slot). ``include_words``: a list of words (the same
        for every image) or a list of per-image word lists (ragged; rows are
        padded). Every entry must normalize to exactly one in-vocabulary
        word: OOV, multi-word and duplicate entries raise."""
        if hasattr(self.tokenizer, "decode_ids"):
            raise NotImplementedError(
                "include_words requires the word-level tokenizer (a "
                "subword word decomposes into pieces — a must-include "
                "PIECE set is a phrase constraint, not supported)"
            )
        start_id, end_id = self._token_ids()
        banned = set(self._banned_ids())
        if not include_words:
            raise ValueError("include_words is empty")
        if batch == 0:
            raise ValueError("features batch is empty")
        per_image = isinstance(include_words[0], (list, tuple))
        rows = [list(r) for r in include_words] if per_image else [list(include_words)] * batch
        if per_image and len(rows) != batch:
            raise ValueError(
                f"per-image include_words has {len(rows)} rows for {batch} images"
            )

        def encode(entry: str) -> int:
            pairs = self._normalize_vocab_entry(entry)
            if len(pairs) != 1:
                raise ValueError(
                    f"include_words entry {entry!r} normalizes to "
                    f"{len(pairs)} words — phrase constraints are not "
                    "supported; pass single words"
                )
            w, i = pairs[0]
            if i is None:
                full = self.tokenizer.word_index.get(w)
                if full is None:
                    raise ValueError(
                        f"include_words entry {entry!r} -> {w!r} is "
                        "not in the vocabulary (the model can never "
                        "emit it)"
                    )
                raise ValueError(
                    f"include_words entry {w!r} has id {full} >= the "
                    f"model vocabulary size {self.vocab_size} "
                    "(num_words cap) — the model can never emit it"
                )
            if i in (start_id, end_id):
                raise ValueError(f"include_words entry {w!r} is a sequence sentinel")
            if i in banned:
                raise ValueError(f"include_words entry {w!r} is also in bad_words")
            return i

        id_rows = []
        for r, row in enumerate(rows):
            ids = [encode(e) for e in row]
            if len(set(ids)) != len(ids):
                raise ValueError(f"duplicate include_words in row {r}: {row!r}")
            id_rows.append(ids)
        C = max(len(ids) for ids in id_rows)
        if not 1 <= C <= MAX_CONSTRAINTS:
            raise ValueError(
                f"need 1..{MAX_CONSTRAINTS} include_words per image, "
                f"got {C} (each word doubles the decode batch)"
            )
        if num_slots is not None:
            # Extra slots are pre-satisfied: the server buckets C.
            if not C <= num_slots <= MAX_CONSTRAINTS:
                raise ValueError(f"num_slots={num_slots} must be in [{C}, {MAX_CONSTRAINTS}]")
            C = num_slots
        out = np.zeros((batch, C), np.int64)  # pad id 0 = pre-satisfied
        for b, ids in enumerate(id_rows):
            out[b, : len(ids)] = ids
        return out

    def generate_constrained(
        self, features, include_words, *, beam_width: int | None = None,
        return_details: bool = False,
    ):
        """``generate_constrained_submit(...)()``."""
        return self.generate_constrained_submit(
            features, include_words, beam_width=beam_width, return_details=return_details
        )()

    @torch.inference_mode()
    def generate_constrained_submit(
        self, features, include_words, *, beam_width: int | None = None,
        return_details: bool = False, num_slots: int | None = None,
    ):
        """Constrained beam search (``decode/constrained.py``, Anderson et
        al. 2017): captions that MUST include the given words, the
        complement of ``DecodeConfig.bad_words``. ``include_words``: a list
        of words for every image, or a list of per-image word lists (ragged
        rows; unused slots are pre-satisfied). Up to 4 words an image: the
        2^C satisfaction banks ride the decode batch.

        Where full satisfaction is unreachable within max_len, the caption
        is the best of the most-satisfied bank (check ``satisfied`` in the
        details). Scores stay true log-probs.

        Dispatches now and returns a zero-argument finalizer that yields
        the captions, or under ``return_details=True`` per-image dicts
        {caption, score (normalized), satisfied: {word: bool},
        num_satisfied}. ``num_slots`` pads the constraint axis (extra slots
        pre-satisfied), as the server buckets C."""
        return self._constrained_submit(
            self._inference_params(), features, include_words, beam_width,
            return_details, num_slots, images=False,
        )

    @torch.inference_mode()
    def encode_constrained_submit(
        self, images, include_words, *, beam_width: int | None = None,
        return_details: bool = False, num_slots: int | None = None,
    ):
        """``generate_constrained_submit`` of ``encode_images(images)``, the
        encoder and the decode on one snapshot of the params."""
        return self._constrained_submit(
            self._inference_params(), images, include_words, beam_width,
            return_details, num_slots, images=True,
        )

    def _constrained_submit(
        self, params, x, include_words, beam_width, return_details, num_slots, *, images: bool
    ):
        dcfg = self.config.decode
        if dcfg.no_repeat_ngram_size:
            raise NotImplementedError(
                "generate_constrained does not compose with "
                "no_repeat_ngram_size (the bank-hopping beam does not "
                "carry per-hypothesis histories)"
            )
        beam_width = beam_width or dcfg.beam_width
        cids = self._constraint_ids(include_words, len(x), num_slots)
        start_id, end_id = self._token_ids()
        dec_params = params["decoder"]
        feats = self._features(params, x, images)
        with precision_flags(self.config.precision):
            state = self.decoder.init_state(dec_params, feats)
            res = constrained_beam_decode(
                self.step_fn(),
                dec_params,
                state,
                start_id=start_id,
                end_id=end_id,
                max_len=dcfg.max_len,
                beam_width=beam_width,
                constraint_ids=cids,
                min_len=dcfg.min_len,
                banned_ids=self._banned_ids(),
                length_normalize=dcfg.length_normalize,
                alpha=dcfg.alpha,
                length_penalty=dcfg.length_penalty,
                decoder=self.decoder,
            )

        def finalize():
            caps = self._captions(res)
            if not return_details:
                return caps
            norm = normalized_scores(
                res.scores.float(),
                res.lengths,
                length_normalize=dcfg.length_normalize,
                alpha=dcfg.alpha,
                length_penalty=dcfg.length_penalty,
            ).cpu().numpy()
            satisfied = res.satisfied.cpu().numpy()
            index_word = self.tokenizer.index_word
            out = []
            for b in range(len(caps)):
                sat = {
                    index_word[int(i)]: bool(satisfied[b, c])
                    for c, i in enumerate(cids[b])
                    if int(i) != 0
                }
                out.append(
                    {
                        "caption": caps[b],
                        "score": float(norm[b]),
                        "satisfied": sat,
                        "num_satisfied": sum(sat.values()),
                    }
                )
            return out

        return finalize

    @torch.inference_mode()
    def generate_diverse(
        self,
        features,
        *,
        num_groups: int = 2,
        group_width: int | None = None,
        diversity: float = 0.5,
    ) -> list[list[tuple[str, float]]]:
        """Diverse beam search (``decode/diverse.py``): ``num_groups`` groups
        of ``group_width`` beams, a Hamming penalty of strength
        ``diversity`` pushing later groups off earlier groups' words. ->
        per image, the best caption of each group in group order as
        (caption, normalized score) pairs; scores are true log-probs under
        the engine's ranking function, comparable with ``generate_n_best``.
        ``group_width`` defaults to config.decode.beam_width; diversity=0
        makes every group an independent exact beam search."""
        dcfg = self.config.decode
        group_width = group_width or dcfg.beam_width
        params = self._inference_params()
        dec_params = params["decoder"]
        feats = self._features(params, features, images=False)
        start_id, end_id = self._token_ids()
        with precision_flags(self.config.precision):
            res = diverse_beam_decode(
                self.step_fn(),
                dec_params,
                self.decoder.init_state(dec_params, feats),
                start_id=start_id,
                end_id=end_id,
                max_len=dcfg.max_len,
                num_groups=num_groups,
                group_width=group_width,
                diversity=diversity,
                min_len=dcfg.min_len,
                banned_ids=self._banned_ids(),
                no_repeat_ngram_size=dcfg.no_repeat_ngram_size,
                length_normalize=dcfg.length_normalize,
                alpha=dcfg.alpha,
                length_penalty=dcfg.length_penalty,
                decoder=self.decoder,
            )
        norm = normalized_scores(
            res.scores.float(),
            res.lengths,
            length_normalize=dcfg.length_normalize,
            alpha=dcfg.alpha,
            length_penalty=dcfg.length_penalty,
        ).cpu().tolist()
        caps = ids_to_captions(
            self.tokenizer, res.tokens.flatten(0, 1), res.lengths.flatten(), end_id=end_id
        )
        G = res.tokens.shape[1]
        return [list(zip(caps[b * G:(b + 1) * G], norm[b])) for b in range(len(norm))]

    def generate_mbr(
        self,
        features,
        *,
        n_candidates: int = 5,
        candidates: str = "sample",
        metric: str = "cider",
        beam_width: int | None = None,
        diversity: float = 0.5,
        temperature: float = 1.0,
        top_k: int | None = None,
        top_p: float | None = None,
        seed: int = 0,
        return_candidates: bool = False,
    ):
        """Minimum-Bayes-risk (consensus) decoding: ``n_candidates``
        captions an image, and the one that agrees most with the rest of
        its pool (``decode/mbr.py``). ``candidates`` picks the pool:

        - 'sample' (default): sampled decodes ``generate(method="sample",
          seed=seed + i)`` for i < n (temperature, top_k, top_p apply);
          deterministic given ``seed``, but the port's draws come from a
          torch generator, so the pools differ from tpucap's for a seed;
        - 'beam': the n-best list of a beam of width max(n, beam_width);
        - 'diverse': the diverse beam groups (num_groups=n,
          group_width=beam_width, ``diversity``).

        -> caption strings; ``return_candidates=True`` gives
        ``(captions, pools)``."""
        if candidates not in ("sample", "beam", "diverse"):
            raise ValueError(
                f"unknown candidate source {candidates!r}; sample|beam|diverse"
            )
        if n_candidates < 1:
            raise ValueError("n_candidates must be >= 1")
        beam_width = beam_width or self.config.decode.beam_width
        if candidates == "sample":
            runs = [
                self.generate(
                    features, method="sample", temperature=temperature,
                    top_k=top_k, top_p=top_p, seed=seed + i,
                )
                for i in range(n_candidates)
            ]
            pools = [list(caps) for caps in zip(*runs)]
        else:
            rows = (
                self.generate_n_best(features, n=n_candidates, beam_width=max(n_candidates, beam_width))
                if candidates == "beam"
                else self.generate_diverse(
                    features, num_groups=n_candidates, group_width=beam_width, diversity=diversity
                )
            )
            pools = [[cap for cap, _ in row] for row in rows]
        picks, _ = mbr_select(pools, metric=metric)
        caps = [pool[i] for pool, i in zip(pools, picks)]
        return (caps, pools) if return_candidates else caps

    @torch.inference_mode()
    def generate_ensemble(
        self,
        features,
        others,
        *,
        method: str | None = None,
        beam_width: int | None = None,
        weights=None,
    ) -> list[str]:
        """Product-of-experts ensemble decode over this pipeline and
        ``others`` (``decode/ensemble.py``): at every step each model's
        softmax joins a weighted geometric mean (a weighted sum of
        log-probs) and selection runs on it. Members may differ in decoder
        family and encoder but must share the tokenizer. ``features``: one
        array that every member takes, or a list of per-model arrays (pooled
        rows for a merge model, a spatial grid for an attention model), each
        cast to its member's inference dtype. ``weights`` (length 1 +
        len(others)) are normalized to sum 1; default uniform. Each member
        decodes from its own inference params with its own step
        (``step_fn``: K2 + K3 on the card for a 1-layer merge decoder, with
        its own weight copies); the whole decode runs under this (the lead)
        pipeline's precision flags. A one-member ensemble gives
        ``generate``'s captions."""
        pipes = [self, *list(others)]
        method = method or self.config.decode.method
        if method not in ("greedy", "beam"):
            raise ValueError(f"generate_ensemble supports greedy|beam, got {method!r}")
        beam_width = beam_width or self.config.decode.beam_width
        for i, p in enumerate(pipes[1:], 1):
            if p.tokenizer is None or p.tokenizer.word_index != self.tokenizer.word_index:
                raise ValueError(
                    f"ensemble member {i} has a different tokenizer — "
                    "members must share the vocabulary (same word "
                    "indices), or their per-step distributions are "
                    "not over the same events"
                )
        if isinstance(features, (list, tuple)):
            if len(features) != len(pipes):
                raise ValueError(
                    f"{len(features)} feature arrays for {len(pipes)} "
                    "models (pass one ndarray to share features)"
                )
        else:
            features = [features] * len(pipes)
        feats = tuple(
            torch.as_tensor(f).to(self.device, p._infer_dtype()) for f, p in zip(features, pipes)
        )
        params = tuple(p._inference_params()["decoder"] for p in pipes)
        ens = EnsembleDecoder(
            [p.decoder for p in pipes],
            weights=weights,
            steps=[p.step_fn() for p in pipes],
        )
        start_id, end_id = self._token_ids()
        dcfg = self.config.decode
        with precision_flags(self.config.precision):
            state = ens.init_state(params, feats)
            common = dict(
                start_id=start_id, end_id=end_id, max_len=dcfg.max_len, min_len=dcfg.min_len,
                banned_ids=self._banned_ids(), no_repeat_ngram_size=dcfg.no_repeat_ngram_size,
            )
            if method == "greedy":
                res = greedy_decode(ens.step, params, state, **common)
            else:
                res = beam_decode(
                    ens.step, params, state, beam_width=beam_width,
                    length_normalize=dcfg.length_normalize, alpha=dcfg.alpha,
                    length_penalty=dcfg.length_penalty, approx_topk=dcfg.approx_topk,
                    decoder=ens, **common,
                )
        return self._captions(res)

    @torch.inference_mode()
    def generate_with_attention(
        self, features, *, method: str | None = None, beam_width: int | None = None
    ):
        """Captions with their attention maps (the Show-Attend-Tell
        visualization, CONFIG_4). -> ``(captions, alphas, lengths)``: alphas
        (B, T, L) f32 numpy, row t the softmax over the L grid cells that
        the decoder attended to while emitting token t (rows past
        lengths[b] come from pad inputs and mean nothing); for the adaptive
        family (B, T, L+1), the grid's weights and last the sentinel's beta
        ("don't look"); for the transformer the last layer's head-averaged
        cross-attention (L = 1 on pooled features); lengths (B,) int32. Reshape the first L columns to
        the encoder's grid (14 x 14 for VGG16) for overlays.

        Decodes with greedy or beam, then teacher-forces
        ``[start, tokens[:-1]]`` through ``forward_hidden_with_alphas`` on
        the same params snapshot and under the same precision flags: the
        recurrence is deterministic, so the maps are those of the decode's
        (chosen beam's) trajectory."""
        if not hasattr(self.decoder, "forward_hidden_with_alphas"):
            raise ValueError(
                "generate_with_attention requires a decoder exposing "
                "forward_hidden_with_alphas (the attention or transformer "
                f"family); got {type(self.decoder).__name__}"
            )
        method = method or self.config.decode.method
        beam_width = beam_width or self.config.decode.beam_width
        if method not in ("greedy", "beam"):
            raise ValueError(f"generate_with_attention supports greedy|beam, got {method!r}")
        params = self._inference_params()
        dec_params = params["decoder"]
        feats = self._features(params, features, images=False)
        res = self._decode(dec_params, feats, method, beam_width)
        start_id, _ = self._token_ids()
        tokens = res.tokens
        # The input at step t is the previous output (the start token at 0).
        tf_tokens = torch.cat([torch.full_like(tokens[:, :1], start_id), tokens[:, :-1]], dim=1)
        with precision_flags(self.config.precision):
            _, alphas = self.decoder.forward_hidden_with_alphas(dec_params, feats, tf_tokens)
        alphas = alphas.float().cpu().numpy()
        return self._captions(res), alphas, res.lengths.cpu().numpy().astype(np.int32)

    @torch.inference_mode()
    def score_captions(self, features, captions) -> list[dict]:
        """Score given captions against given features: each caption's
        teacher-forced log-probability under the model. ``captions``: one
        string a feature row (a single string is used for every row);
        leading startseq and trailing endseq are stripped, then both are
        added. -> per row ``{"logp", "tokens", "logp_per_token",
        "perplexity"}``, logp the sum of the full-softmax log-probs of the
        caption's tokens and its endseq: the decode engines' score, so
        ``score_captions(f, generate(f))[i]["logp"]`` is the greedy
        engine's score for a caption that ended.

        One teacher-forced ``forward_train`` (the decoder's plain cell, no
        kernel) on inputs padded to a power-of-two length, as tpucap buckets
        them; the log-softmax in f32, the sums masked. ``precision="f32"``
        runs with TF32 off, whatever the process's flags."""
        feats = torch.as_tensor(features).to(self.device, self._infer_dtype())
        B = feats.shape[0]
        if isinstance(captions, str):
            captions = [captions] * B
        if len(captions) != B:
            raise ValueError(f"{len(captions)} captions for {B} feature rows")
        stripped = []
        for c in captions:
            words = c.split()
            if words and words[0] == START_TOKEN:
                words = words[1:]
            if words and words[-1] == END_TOKEN:
                words = words[:-1]
            stripped.append(" ".join(words))
        seqs = self.encode_prefixes(stripped)
        start_id, end_id = self._token_ids()
        # Rows as in training: full = [start, w1 .. wn, end], inputs
        # full[:-1], targets full[1:], pad 0 masked.
        max_full = max(len(s) for s in seqs) + 2
        T = max(1 << (max_full - 2).bit_length(), 1)  # >= max_full - 1
        inputs = np.zeros((B, T), np.int64)
        targets = np.zeros((B, T), np.int64)
        for i, s in enumerate(seqs):
            full = [start_id, *s, end_id]
            inputs[i, : len(full) - 1] = full[:-1]
            targets[i, : len(full) - 1] = full[1:]
        inputs = torch.from_numpy(inputs).to(self.device)
        targets = torch.from_numpy(targets).to(self.device)
        params = self._inference_params()["decoder"]
        with precision_flags(self.config.precision):
            logits = self.decoder.forward_train(params, feats, inputs, deterministic=True)
        logp = torch.log_softmax(logits.float(), dim=-1)
        tok_lp = logp.gather(-1, targets[..., None])[..., 0]
        mask = (targets != 0).float()
        sums = (tok_lp * mask).sum(dim=-1).double().cpu().numpy()
        counts = mask.sum(dim=-1).double().cpu().numpy()
        out = []
        for lp, n in zip(sums, counts):
            per = lp / n if n else 0.0
            out.append(
                {
                    "logp": float(lp),
                    "tokens": int(n),
                    "logp_per_token": float(per),
                    "perplexity": float(np.exp(-per)),
                }
            )
        return out

    def _caption_device(self, images_u8, method, beam_width):
        """One batch's device work: K1 (resize to the encoder's input size
        and normalize), encoder, decode. -> the decode result."""
        params = self._inference_params()
        images = torch.as_tensor(images_u8).to(self.device)
        x = fused_preprocess(
            images,
            self.encoder.input_size,
            self.encoder.preprocess_mode,
            out_dtype=self._infer_dtype(),
        )
        feats = self._apply_encoder(params["encoder"], x)
        return self._decode(params["decoder"], feats, method, beam_width)

    @torch.inference_mode()
    def caption_batch(
        self,
        images_u8,
        *,
        method: str | None = None,
        beam_width: int | None = None,
    ) -> list[str]:
        """uint8 RGB (B, H, W, 3) -> captions, on the device: the per-batch
        body of the JAX package's ``caption_dataset`` (resize to the
        encoder's input size and normalize in one kernel, encode, decode)."""
        method = method or self.config.decode.method
        beam_width = beam_width or self.config.decode.beam_width
        return self._captions(self._caption_device(images_u8, method, beam_width))

    @torch.inference_mode()
    def caption_dataset(
        self,
        image_paths,
        *,
        batch_size: int = 256,
        method: str | None = None,
        beam_width: int | None = None,
        num_workers: int = 0,
        fast_scale: bool = True,
        parallelism: str | None = None,
    ) -> list[str]:
        """JPEG files -> captions, in path order: host decode (and nearest
        resize to the encoder's input size) in the loader's thread, each
        batch through ``caption_batch``'s device body, the tail batch
        zero-padded to ``batch_size``. The next batch decodes while the card
        works on this one; captions are read back one batch behind, as in
        tpucap."""
        refuse_unported(
            parallelism=(parallelism if parallelism != "none" else None, None)
        )
        method = method or self.config.decode.method
        beam_width = beam_width or self.config.decode.beam_width
        _, end_id = self._token_ids()
        captions: list[str] = []
        pending = []

        def drain(res, n):
            captions.extend(
                ids_to_captions(
                    self.tokenizer, res.tokens[:n], res.lengths[:n], end_id=end_id
                )
            )

        for _, images in image_batch_loader(
            list(image_paths),
            size=self.encoder.input_size,
            batch_size=batch_size,
            num_workers=num_workers,
            fast_scale=fast_scale,
        ):
            n = images.shape[0]
            res = self._caption_device(pad_rows(images, batch_size), method, beam_width)
            pending.append((res, n))
            if len(pending) > 1:
                drain(*pending.pop(0))
        for entry in pending:
            drain(*entry)
        return captions

    @torch.inference_mode()
    def extract_features(
        self,
        image_paths,
        batch_size: int = 32,
        *,
        parallelism: str | None = None,
    ) -> np.ndarray:
        """Image files -> encoder features, f32 numpy: decode, nearest resize
        and normalize on the host (``data.preprocess.preprocess_batch``: JPEGs
        through the port's decoder, other formats through PIL, as tpucap's
        ``load_image``), encode on the device in chunks of ``batch_size``.
        The tail chunk goes as it is: tpucap zero-pads it to keep one
        compiled shape, which eager PyTorch does not need (its padding rows
        would be encoded and thrown away)."""
        refuse_unported(
            parallelism=(parallelism if parallelism != "none" else None, None)
        )
        paths = list(image_paths)
        size = self.encoder.input_size
        mode = self.encoder.preprocess_mode
        outs = []
        for s in range(0, len(paths), batch_size):
            x = preprocess_batch(paths[s : s + batch_size], size=size, mode=mode)
            outs.append(self.encode_images(x).float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    def caption_images(self, image_paths, **kw) -> list[str]:
        """Image files -> captions through ``extract_features`` and
        ``generate`` (tpucap's one-call demo path)."""
        return self.generate(self.extract_features(list(image_paths)), **kw)

    # -- evaluation ----------------------------------------------------------

    def evaluate(
        self,
        descriptions: dict[str, list[str]],
        features: dict[str, np.ndarray],
        *,
        batch_size: int = 64,
        method: str | None = None,
        beam_width: int | None = None,
        parallelism: str | None = None,
        metrics: tuple = ("bleu",),
        return_captions: bool = False,
        meteor_synonyms=None,
    ):
        """Decode every image of ``descriptions`` from its features, in
        chunks of ``batch_size`` (the tail zero-padded, so every decode batch
        has one shape; the padding rows' captions are dropped), then score
        the captions against the references (``evaluate_captions``:
        'bleu', 'cider', 'rouge_l', 'meteor', 'diversity'). ->
        scores, or (scores, {image_id: caption}) with ``return_captions``."""
        refuse_unported(parallelism=(parallelism if parallelism != "none" else None, None))
        check_metrics(metrics)
        ids = list(descriptions)
        generated = {}
        for s in range(0, len(ids), batch_size):
            chunk = ids[s : s + batch_size]
            feats = np.stack([np.asarray(features[i]) for i in chunk])
            caps = self.generate(
                pad_rows(feats, batch_size), method=method, beam_width=beam_width
            )
            generated.update(zip(chunk, caps[: len(chunk)]))
        scores = evaluate_captions(
            descriptions, generated, metrics=metrics, meteor_synonyms=meteor_synonyms
        )
        return (scores, generated) if return_captions else scores

    # -- persistence ---------------------------------------------------------

    def save(self, directory) -> None:
        """Write the inference bundle: ``config.json`` (tpucap's section
        layout), ``tokenizer.json`` (the format both packages share) and
        ``params.npz`` (``convert.save_npz``: the port's param tree, each
        leaf with its dtype)."""
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(config_to_dict(self.config), f, indent=2)
        if self.tokenizer is not None:
            self.tokenizer.save(os.path.join(directory, "tokenizer.json"))
        save_npz(os.path.join(directory, PARAMS_FILE), self.params)

    @classmethod
    def load(cls, directory, *, device=None) -> "CaptioningPipeline":
        """A pipeline from a ``save`` bundle, on ``device`` (the card unless
        ``"cpu"``). A tpucap bundle loads once its params are also written
        as ``params.npz`` (``convert.save_npz(convert.params_from_jax(
        params))``)."""
        directory = os.path.abspath(directory)
        with open(os.path.join(directory, "config.json")) as f:
            config = config_from_dict(json.load(f))
        tokenizer = load_tokenizer(os.path.join(directory, "tokenizer.json"))
        params = _bundle_params(directory)
        pipe = cls(config, tokenizer=tokenizer, device=device)
        pipe.build(init_params=False)
        pipe.set_params(params)
        return pipe

    def reload_params(self, source) -> None:
        """Swap the weights in place: ``source`` is a ``save`` bundle
        directory or a param tree of the live tree's layout. Checked before
        anything is touched: a bundle's encoder and decoder config sections
        and its tokenizer must equal the live ones; the tree's structure and
        every leaf's shape and dtype must too. On a mismatch this raises
        and the live weights keep serving. Drops the cached bf16 params."""
        if isinstance(source, (str, os.PathLike)):
            directory = os.path.abspath(os.fspath(source))
            with open(os.path.join(directory, "config.json")) as f:
                theirs = json.load(f)
            ours = config_to_dict(self.config)
            for section in ("encoder", "decoder"):
                if theirs.get(section) != ours[section]:
                    raise ValueError(
                        f"bundle {section} config differs from the live pipeline's: "
                        "reload_params swaps weights only; load() a new pipeline "
                        "for another topology"
                    )
            tok_path = os.path.join(directory, "tokenizer.json")
            if self.tokenizer is not None and os.path.exists(tok_path):
                with open(tok_path) as f:
                    if json.load(f) != json.loads(self.tokenizer.to_json()):
                        raise ValueError(
                            "bundle tokenizer differs from the live pipeline's: "
                            "its captions would be read with the wrong vocabulary"
                        )
            new = _bundle_params(directory)
        else:
            new = tree_map(torch.as_tensor, source)
        check_float_params(new)
        check_same_layout(self.params, new, "params")
        self.set_params(new)

    # -- training ------------------------------------------------------------

    def _train_setup(self, n_rows: int, batch_size: int | None, log):
        cfg = self.config.train
        batch_size = batch_size or cfg.batch_size
        if n_rows < batch_size:
            # batch_iterator drops the remainder, so a dataset smaller than
            # one batch would run no step at all.
            if log:
                log(
                    f"batch_size {batch_size} > {n_rows} training rows; "
                    f"clamping batch_size to {n_rows}"
                )
            batch_size = n_rows
        if cfg.precision not in ("f32", "bf16"):
            raise ValueError(f"TrainConfig.precision={cfg.precision!r}; have f32|bf16")
        compute_dtype = torch.bfloat16 if cfg.precision == "bf16" else None
        return batch_size, compute_dtype

    def _train_flags(self):
        """The matmul flags of one training step (``core.precision_flags``):
        f32 training in full f32 (TF32 off), bf16 training under the bf16
        policy. A block a step, not one for the whole fit, so a serving
        thread's block can take the flags between steps and a step never
        sees another thread's setting."""
        return precision_flags("f32" if self.config.train.precision == "f32" else "bf16")

    def _run_epochs(
        self,
        step,
        state,
        batches,
        batch,
        epochs,
        log,
        validate=None,
        checkpoint_manager=None,
        resume=False,
        guard=None,
        ema=None,
        multi_step=None,
        spd: int = 1,
        ss=None,
        label: str = "epoch",
    ):
        """Shared epoch loop: shuffled batches (numpy, seeded with
        TrainConfig.seed as tpucap draws them), metrics summed on the card
        and read once per epoch. ``batches`` is the batch source,
        ``MemoryBatches`` or ``StreamedBatches``: each epoch it gives
        ``(index, host rows)`` from ``skip`` on, one shuffle drawn from the
        loop's generator; ``batch(*rows)`` puts a batch on the card;
        ``label`` starts each epoch's log line. ``validate``: fit's dev-split metrics of
        the current params (``_validation``), taken after each epoch, with
        early stopping on the monitor. ``checkpoint_manager``: the state is
        saved after each epoch, before the early-stopping check, with
        tpucap's checkpoint metrics, and every
        TrainConfig.checkpoint_every_steps steps mid-epoch without metrics.
        ``resume``: the latest step is restored and training continues at
        the epoch and batch its step count gives, the consumed shuffles
        replayed. ``guard`` (a ``PreemptionGuard``, or anything with
        ``fired``): once it fires, the step in flight finishes, a rescue
        checkpoint is written and the loop returns with a ``preempted``
        entry. ``ema`` (``_make_ema``'s shadow) is updated in place after
        every optimizer step.

        ``spd`` > 1 (fit's steps_per_dispatch): ``spd`` host batches are
        stacked, copied to the device once and trained by one call of
        ``multi_step``; the epoch's tail, shorter than ``spd``, goes through
        ``step`` one batch at a time. The guard is read at those dispatch
        boundaries only, and an interval checkpoint is saved at the first
        boundary at or past each multiple of checkpoint_every_steps (the
        tails save none). ``ss`` = (max_eps, ss_schedule) (fit's scheduled
        sampling): each epoch's eps, ``epsilon_for_epoch``, goes to every
        step call and into the history as ``ss_eps``. -> (state,
        history)."""
        cfg = self.config.train
        monitor = "val_loss" if cfg.val_metric == "loss" else f"val_{cfg.val_metric}"
        minimize = monitor == "val_loss"
        best = float("inf") if minimize else -float("inf")
        since_best = 0
        rng = np.random.default_rng(self.config.train.seed)
        n_rows = batches.n_rows
        steps_per_epoch = max(1, n_rows // batches.batch_size)
        every = cfg.checkpoint_every_steps if checkpoint_manager is not None else 0
        start_epoch = resume_batch = 0
        history = []
        with guard if hasattr(guard, "__enter__") else contextlib.nullcontext():
            # The restore runs inside the guard: a signal during the read is
            # latched and acted on after the next step.
            if resume and checkpoint_manager.latest_step() is not None:
                state = checkpoint_manager.restore(state)
                start_epoch, resume_batch = divmod(state.step, steps_per_epoch)
                for _ in range(start_epoch):
                    rng.shuffle(np.arange(n_rows))
                if log:
                    log(
                        f"resumed from step {state.step} (epoch {start_epoch}, "
                        f"batch {resume_batch})"
                    )
            # spd > 1: the next interval save, from the step the run starts at.
            start_step = start_epoch * steps_per_epoch + resume_batch
            next_save = (start_step // every + 1) * every if every else 0
            for epoch in range(start_epoch, epochs):
                sums: dict = {}
                n = 0
                skip = resume_batch if epoch == start_epoch else 0
                preempted = False
                eps = None
                if ss is not None:
                    eps = epsilon_for_epoch(epoch, epochs, max_eps=ss[0], schedule=ss[1])
                extra = () if eps is None else (eps,)
                pending: list = []  # spd > 1: host batches awaiting their group
                # Closed however the epoch ends: a streamed epoch cut short
                # stops its reader thread.
                with contextlib.closing(batches(rng, skip)) as source:
                    for b_i, rows in source:
                        if spd > 1:
                            pending.append(rows)
                            if len(pending) < spd:
                                continue
                            group = [np.stack(column) for column in zip(*pending)]
                            pending.clear()
                            with self._train_flags():
                                state, metrics = multi_step(state, *batch(*group), *extra)
                            n += spd  # the metrics come back summed over the group
                        else:
                            with self._train_flags():
                                state, metrics = step(state, *batch(*rows), *extra)
                                if ema is not None:
                                    ema_update(ema, state.params, cfg.ema_decay)
                            n += 1
                        for k, v in metrics.items():
                            sums[k] = sums.get(k, 0.0) + v
                        done = epoch * steps_per_epoch + b_i + 1
                        # The epoch's last step is the epoch save's. Groups move in
                        # strides of spd: save at the first boundary at or past
                        # each multiple.
                        if every > 0 and b_i + 1 < steps_per_epoch and (
                            done % every == 0 if spd == 1 else done >= next_save
                        ):
                            checkpoint_manager.save_rescue(state)
                            next_save = (done // every + 1) * every
                        if guard is not None and guard.fired:
                            preempted = True
                            break
                # The tail shorter than spd, one step at a time (empty after
                # a preemption: the guard is read at group boundaries only).
                for rows in () if preempted else pending:
                    with self._train_flags():
                        state, metrics = step(state, *batch(*rows), *extra)
                    n += 1
                    for k, v in metrics.items():
                        sums[k] = sums.get(k, 0.0) + v
                    if guard is not None and guard.fired:
                        preempted = True
                        break
                # By sorted key, the order in which tpucap's jax.device_get returns them.
                entry = {k: float(sums[k]) / max(n, 1) for k in sorted(sums)}
                entry["epoch"] = epoch
                if eps is not None:
                    entry["ss_eps"] = float(eps)
                if preempted:
                    entry["preempted"] = True
                    history.append(entry)
                    if checkpoint_manager is not None:
                        checkpoint_manager.save_rescue(state)
                    if log:
                        log(
                            f"preempted at epoch {epoch} step {state.step}; "
                            + (
                                "rescue checkpoint written — rerun with resume=True to continue"
                                if checkpoint_manager is not None
                                else "NO checkpoint_manager — mid-run state was NOT saved"
                            )
                        )
                    break
                if validate:
                    entry.update(validate(state.params))
                history.append(entry)
                if log:
                    msg = f"{label} {epoch}: loss={entry.get('loss', 0):.4f} acc={entry.get('accuracy', 0):.4f}"
                    if "val_loss" in entry:
                        msg += f" val_loss={entry['val_loss']:.4f}"
                    if monitor != "val_loss" and monitor in entry:
                        msg += f" {monitor}={entry[monitor]:.4f}"
                    log(msg)
                if checkpoint_manager is not None:
                    # val_loss (the training loss without a dev split), and the
                    # decode monitor when there is one: the manager's
                    # best_metric keys on whichever it names.
                    ckpt = {"val_loss": entry.get("val_loss", entry["loss"])}
                    if monitor != "val_loss" and monitor in entry:
                        ckpt[monitor] = entry[monitor]
                    checkpoint_manager.save(state, metrics=ckpt)
                # Keras EarlyStopping(monitor, mode, patience); the params stay
                # the last epoch's (the best is the checkpoint manager's).
                if cfg.early_stopping_patience > 0 and monitor in entry:
                    value = entry[monitor]
                    if value < best if minimize else value > best:
                        best, since_best = value, 0
                    else:
                        since_best += 1
                        if since_best >= cfg.early_stopping_patience:
                            if log:
                                log(
                                    f"early stopping at epoch {epoch} (no {monitor} "
                                    f"improvement for {since_best} epochs)"
                                )
                            break
        return state, history

    @staticmethod
    def _dispatch_dials(cfg) -> tuple[bool, int]:
        """tpucap's checks of fit's scheduled sampling and
        steps_per_dispatch, with its messages. -> (scheduled sampling on,
        steps per dispatch)."""
        use_ss = cfg.scheduled_sampling > 0
        if use_ss:
            if not 0.0 < cfg.scheduled_sampling <= 1.0:
                raise ValueError(
                    f"scheduled_sampling={cfg.scheduled_sampling} must be a probability in (0, 1]"
                )
            if cfg.ss_schedule not in SCHEDULES:
                raise ValueError(
                    f"unknown ss_schedule {cfg.ss_schedule!r}; have linear|inv_sigmoid|constant"
                )
        spd = cfg.steps_per_dispatch
        if spd < 1:
            raise ValueError(f"steps_per_dispatch={spd} must be >= 1")
        if spd > 1 and cfg.ema_decay:
            raise NotImplementedError(
                "ema_decay updates a per-step host-visible shadow; "
                f"steps_per_dispatch={spd} runs {spd} steps per "
                "host visit — drop one of the two flags"
            )
        return use_ss, spd

    def _checkpoint_dials(self, checkpoint_manager, resume, handle_preemption, preemption_guard):
        """tpucap's checks of the resume and preemption dials -> the guard
        to train under (None without one)."""
        if resume and checkpoint_manager is None:
            raise ValueError("resume=True needs a checkpoint_manager")
        if resume and self.config.train.ema_decay:
            raise NotImplementedError(
                "resume does not restore the EMA shadow; drop ema_decay or restart"
            )
        if handle_preemption and preemption_guard is None:
            return PreemptionGuard()
        return preemption_guard

    def _validation(self, val_data, batch_size: int, compute_dtype):
        """fit's dev split ``(descriptions, features)`` -> ``score(params)``,
        which gives val_loss and val_accuracy (the training objective,
        dropout off, over chunks of ``batch_size`` rows, the tail
        zero-padded, normalized once) and, for a decode monitor,
        ``val_<metric>`` of a greedy decode."""
        cfg = self.config.train
        if cfg.val_metric not in ("loss", *DECODE_MONITORS):
            raise ValueError(
                f"unknown val_metric {cfg.val_metric!r}; have loss|{'|'.join(DECODE_MONITORS)}"
            )
        val_desc, val_features = val_data
        VF, VT = build_training_batch(
            self.tokenizer, val_desc, val_features, self.config.decode.max_len
        )
        chunks = [
            self._to_device(
                pad_rows(VF[s : s + batch_size], batch_size),
                pad_rows(VT[s : s + batch_size], batch_size),
            )
            for s in range(0, VF.shape[0], batch_size)
        ]
        eval_step = make_eval_sums_step(
            self.decoder,
            pad_id=0,
            attention_reg=cfg.attention_reg,
            label_smoothing=cfg.label_smoothing,
            compute_dtype=compute_dtype,
        )
        metric = None if cfg.val_metric == "loss" else cfg.val_metric
        val_ids = list(val_desc)
        decode_feats = np.stack([np.asarray(val_features[i]) for i in val_ids]).astype(
            np.float32
        )

        def score(params) -> dict:
            sums: dict = {}
            with self._train_flags():
                for vf, vt in chunks:
                    for k, v in eval_step(params, vf, vt).items():
                        sums[k] = sums.get(k, 0.0) + v
            _, vm = loss_from_sums(sums, attention_reg=cfg.attention_reg)
            out = {"val_loss": float(vm["loss"]), "val_accuracy": float(vm["accuracy"])}
            if metric:
                out[f"val_{metric}"] = self._val_decode_metric(
                    params, val_ids, decode_feats, val_desc, metric, batch_size
                )
            return out

        return score

    @torch.no_grad()
    def _val_decode_metric(self, params, ids, feats, val_desc, metric: str, batch_size: int):
        """Greedy-decode the dev split on the current training params (f32
        masters, under ``Config.precision``'s flags as tpucap's decode
        program; on the card through the fused step, K2 and K3), chunks
        zero-padded to ``batch_size``, and return the corpus metric."""
        _, end_id = self._token_ids()
        generated = {}
        for s in range(0, len(ids), batch_size):
            chunk = ids[s : s + batch_size]
            x = torch.as_tensor(pad_rows(feats[s : s + batch_size], batch_size)).to(self.device)
            res = self._decode(params, x, "greedy", 1)
            generated.update(
                zip(
                    chunk,
                    ids_to_captions(
                        self.tokenizer,
                        res.tokens[: len(chunk)],
                        res.lengths[: len(chunk)],
                        end_id=end_id,
                    ),
                )
            )
        key = "bleu" if metric == "bleu4" else metric
        return float(evaluate_captions(val_desc, generated, metrics=(key,))[metric])

    def fit(
        self,
        descriptions: dict[str, list[str]],
        features: dict[str, np.ndarray],
        *,
        epochs: int | None = None,
        batch_size: int | None = None,
        data_parallel: bool = False,
        parallelism: str | None = None,
        checkpoint_manager=None,
        val_data=None,
        stream: bool = False,
        prefetch: int = 2,
        resume: bool = False,
        handle_preemption: bool = False,
        preemption_guard=None,
        sharded_checkpoints: bool = False,
        log=print,
    ) -> list[dict]:
        """Train the decoder on extracted features (teacher-forced masked
        CE, ``build_optimizer(TrainConfig)``), one device. -> per-epoch
        metric dicts (loss, accuracy, tokens, perplexity, epoch); updates
        ``self.params["decoder"]``.
        Dropout is on (``DecoderConfig.dropout_rate``); the rows are
        shuffled by ``np.random.default_rng(TrainConfig.seed)`` as tpucap
        shuffles them.

        ``val_data=(descriptions, features)``: after each epoch, val_loss
        and val_accuracy on that split, and with ``TrainConfig.val_metric``
        'bleu4' | 'cider' | 'rouge_l' | 'meteor' that metric of a greedy
        decode as ``val_<metric>``; ``early_stopping_patience`` > 0 stops
        after that many epochs without a strict improvement of the monitor
        (val_loss down, a decode metric up). The evaluation draws nothing
        from the dropout generator.

        ``checkpoint_manager`` (``tpucap_torch.checkpoint.CheckpointManager``):
        the state (its step the optimizer-step count) is saved after each
        epoch with ``val_loss`` (the training loss without val_data) and
        the decode monitor's ``val_<metric>``, as tpucap saves it; with
        ``TrainConfig.checkpoint_every_steps`` = N also every N steps
        mid-epoch, without metrics (``save_rescue``).

        ``resume=True`` (needs the manager) restores its latest step and
        continues at that step's epoch and batch: the consumed shuffles are
        replayed and the dropout generator is the checkpoint's, so the run
        is bit-identical to an uninterrupted one. An empty directory starts
        fresh. ``handle_preemption=True`` (or a ``preemption_guard``)
        latches SIGTERM: the step in flight finishes, a rescue checkpoint is
        written, and the history ends with a ``{"preempted": True}`` entry.

        ``TrainConfig.grad_accum_steps`` = A splits each batch into A
        microbatches accumulated in sum form (the batch must divide by A).
        The lr schedule's horizon is the run: epochs x (rows // batch size).
        ``TrainConfig.ema_decay`` = d > 0 keeps an EMA of the params, left
        on ``self.ema_params`` (``use_ema_weights``); resume=True refuses
        it, since the checkpoints do not hold the shadow.

        ``TrainConfig.scheduled_sampling`` = p in (0, 1] trains with
        scheduled sampling at each epoch's ``epsilon_for_epoch`` (p, ramped by
        ``ss_schedule``), recorded as the history's ``ss_eps``.
        ``steps_per_dispatch`` = N > 1 runs N steps in one call of the step
        on N stacked batches (``_run_epochs``), the update sequence of N
        single steps (not with ema_decay). After
        ``set_pretrained_embeddings(freeze=True)`` the embedding table's
        updates are zeroed.

        ``stream=True`` reads the feature rows a batch at a time
        (``data.pipeline.caption_batch_stream``) from ``features`` taken as
        a lazy mapping, such as an ``np.load`` handle of an uncompressed
        ``.npz``: only the tokens are built up front, and the host holds a
        few batches of rows instead of the whole (N, F) stack. A background
        thread assembles up to ``prefetch`` batches ahead; the copies to
        the card stay on the training thread. The batch order, and so the
        trajectory, is identical to ``stream=False`` under the same seed,
        resume, steps_per_dispatch and checkpoints included."""
        refuse_unported(
            data_parallel=(data_parallel, False),
            parallelism=(parallelism if parallelism != "none" else None, None),
            sharded_checkpoints=(sharded_checkpoints, False),
        )
        guard = self._checkpoint_dials(
            checkpoint_manager, resume, handle_preemption, preemption_guard
        )
        cfg = self.config.train
        epochs = epochs or cfg.epochs
        if self.decoder is None:
            self.build()
        max_len = self.config.decode.max_len
        if stream:
            # The tokens only: feature rows are read a batch at a time.
            row_ids, T = build_training_tokens(self.tokenizer, descriptions, max_len)
        else:
            F, T = build_training_batch(self.tokenizer, descriptions, features, max_len)
        batch_size, compute_dtype = self._train_setup(T.shape[0], batch_size, log)
        if stream:
            batches = StreamedBatches(row_ids, T, features, batch_size, prefetch)
        else:
            batches = MemoryBatches((F, T), batch_size)
        optimizer = build_optimizer(
            cfg, total_steps=epochs * max(1, T.shape[0] // batch_size)
        )
        if self._freeze_embeddings:
            # Updates, not gradients, are zeroed: adamw's decay cannot
            # move the pretrained table either.
            optimizer = freeze_subtree_updates(optimizer, lambda path: path[0] == "embedding")
        use_ss, spd = self._dispatch_dials(cfg)
        state = own_state(
            TrainState.create(
                self.params["decoder"], optimizer, self._train_generator()
            )
        )
        ema = self._make_ema(cfg, state.params)

        def make_step(multi_steps):
            return make_train_step(
                self.decoder,
                optimizer,
                pad_id=0,
                label_smoothing=cfg.label_smoothing,
                attention_reg=cfg.attention_reg,
                grad_accum_steps=cfg.grad_accum_steps,
                compute_dtype=compute_dtype,
                donate=True,
                scheduled_sampling=use_ss,
                multi_steps=multi_steps,
            )

        validate = (
            None
            if val_data is None
            else self._validation(val_data, batch_size, compute_dtype)
        )
        state, history = self._run_epochs(
            make_step(1),
            state,
            batches,
            self._to_device,
            epochs,
            log,
            validate,
            checkpoint_manager,
            resume,
            guard,
            ema,
            multi_step=make_step(spd) if spd > 1 else None,
            spd=spd,
            ss=(cfg.scheduled_sampling, cfg.ss_schedule) if use_ss else None,
        )
        self.params["decoder"] = state.params
        if ema is not None:
            self.ema_params = {"decoder": ema}
        self._params_changed()
        return history

    def fit_finetune(
        self,
        descriptions: dict[str, list[str]],
        images: dict[str, np.ndarray],
        *,
        epochs: int | None = None,
        batch_size: int | None = None,
        encoder_lr_scale: float = 0.1,
        freeze_encoder: bool = False,
        remat_encoder: bool = False,
        parallelism: str | None = None,
        augment: bool = False,
        augment_shift: int = 0,
        lora_rank: int = 0,
        lora_alpha: float | None = None,
        checkpoint_manager=None,
        resume: bool = False,
        handle_preemption: bool = False,
        preemption_guard=None,
        sharded_checkpoints: bool = False,
        log=print,
    ) -> list[dict]:
        """Train the encoder and the decoder jointly through the captioning
        loss, one device. ``images``: id -> preprocessed (H, W, 3) float
        array. ``encoder_lr_scale`` scales the encoder's updates after the
        optimizer;
        ``freeze_encoder=True`` stops gradients at the features and zeroes
        the encoder's updates. Each token row indexes an image store, which
        is gathered per batch on the host (as tpucap does). Updates
        ``self.params``.

        ``augment=True`` flips each image left to right with probability
        1/2 inside the step; ``augment_shift`` = N also translates it by up
        to N pixels, reflect-padded (``data.augment``). ``remat_encoder=True``
        recomputes the encoder's activations in the backward: the same
        update at a lower peak memory. ``TrainConfig.grad_accum_steps`` and
        ``attention_reg`` (the attention decoder) are ``fit``'s.

        ``checkpoint_manager``, ``resume``, ``handle_preemption`` and
        ``preemption_guard`` are ``fit``'s, on the joint
        ``{"encoder", "decoder"}`` state, each epoch saved with its
        training loss as ``val_loss``. A frozen pretrained table
        (``set_pretrained_embeddings``) stays put, as in ``fit``;
        ``TrainConfig.scheduled_sampling`` and ``steps_per_dispatch`` are
        not read here, as tpucap's fit_finetune does not read them.

        ``lora_rank`` = r > 0 trains a rank-r LoRA overlay instead
        (``_fit_finetune_lora``, ``train/lora.py``): the joint base stays
        frozen and the adapters span the 2-D matmul kernels of both
        subtrees (of the decoder alone with ``freeze_encoder=True``), at
        scale ``lora_alpha / r`` (alpha defaults to r); encoder_lr_scale
        is ignored, and the checkpoint dials, remat_encoder,
        grad_accum_steps and ema_decay are refused with tpucap's words. The
        merged encoder and decoder go to ``self.params``, the adapters to
        ``self.lora_adapters`` (``save_lora``)."""
        if not (lora_rank and parallelism in ("dp", "fsdp")):
            # Under LoRA these two are refused by _fit_finetune_lora, in
            # tpucap's order.
            refuse_unported(parallelism=(parallelism if parallelism != "none" else None, None))
        refuse_unported(sharded_checkpoints=(sharded_checkpoints, False))
        if lora_rank and (
            checkpoint_manager is not None or resume or handle_preemption or preemption_guard is not None
        ):
            raise NotImplementedError(
                "LoRA fine-tuning checkpoints its few-MB adapter "
                "artifact via save_lora (the base never moves, so "
                "there is no joint TrainState worth snapshotting) — "
                "drop the checkpoint/preemption dials or train full "
                "weights"
            )
        guard = self._checkpoint_dials(
            checkpoint_manager, resume, handle_preemption, preemption_guard
        )
        cfg = self.config.train
        epochs = epochs or cfg.epochs
        if self.decoder is None:
            self.build()
        store_ids = list(descriptions.keys())
        store = np.stack([np.asarray(images[i], np.float32) for i in store_ids])
        index_of = {i: np.asarray(k, np.int32) for k, i in enumerate(store_ids)}
        F_idx, T = build_training_batch(
            self.tokenizer, descriptions, index_of, self.config.decode.max_len
        )
        batch_size, compute_dtype = self._train_setup(T.shape[0], batch_size, log)
        if lora_rank:
            return self._fit_finetune_lora(
                store,
                F_idx,
                T,
                rank=lora_rank,
                alpha=lora_alpha,
                epochs=epochs,
                batch_size=batch_size,
                freeze_encoder=freeze_encoder,
                remat_encoder=remat_encoder,
                parallelism=parallelism,
                augment=augment,
                augment_shift=augment_shift,
                compute_dtype=compute_dtype,
                log=log,
            )
        optimizer = build_optimizer(
            cfg, total_steps=epochs * max(1, T.shape[0] // batch_size)
        )
        if encoder_lr_scale != 1.0 and not freeze_encoder:
            optimizer = encoder_learning_rate_optimizer(
                optimizer, encoder_lr_scale=encoder_lr_scale
            )
        if self._freeze_embeddings:
            # fit's rule on the joint tree.
            optimizer = freeze_subtree_updates(
                optimizer, lambda path: path[:2] == ("decoder", "embedding")
            )
        params = {"encoder": self.params["encoder"], "decoder": self.params["decoder"]}
        state = own_state(TrainState.create(params, optimizer, self._train_generator()))
        ema = self._make_ema(cfg, state.params)
        step = make_joint_train_step(
            self.encoder,
            self.decoder,
            optimizer,
            pad_id=0,
            label_smoothing=cfg.label_smoothing,
            attention_reg=cfg.attention_reg,
            grad_accum_steps=cfg.grad_accum_steps,
            freeze_encoder=freeze_encoder,
            remat_encoder=remat_encoder,
            compute_dtype=compute_dtype,
            augment_fn=make_augment_fn(flip=augment, max_shift=augment_shift),
            donate=True,
        )
        state, history = self._run_epochs(
            step,
            state,
            MemoryBatches((F_idx, T), batch_size),
            lambda bi, bt: self._to_device(store[np.asarray(bi)], bt),
            epochs,
            log,
            checkpoint_manager=checkpoint_manager,
            resume=resume,
            guard=guard,
            ema=ema,
        )
        self.params["encoder"] = state.params["encoder"]
        self.params["decoder"] = state.params["decoder"]
        if ema is not None:
            self.ema_params = dict(ema)  # {"encoder", "decoder"}
        self._params_changed()
        return history

    def _fit_finetune_lora(
        self,
        store,
        F_idx,
        T,
        *,
        rank: int,
        alpha: float | None,
        epochs: int,
        batch_size: int,
        freeze_encoder: bool,
        remat_encoder: bool,
        parallelism: str | None,
        augment: bool,
        augment_shift: int,
        compute_dtype,
        log,
    ) -> list[dict]:
        """fit_finetune(lora_rank=r): the joint {"encoder", "decoder"} base
        frozen, a rank-r overlay trained on every 2-D matmul kernel of both
        subtrees (of the decoder only with ``freeze_encoder``), the
        optimizer's state over the adapters alone. tpucap's refusals in its
        order; data parallelism is refused by name."""
        cfg = self.config.train
        if parallelism == "fsdp":
            raise NotImplementedError(
                "lora_rank with parallelism='fsdp': the trainable "
                "state is already tiny — use 'dp' (or full fine-"
                "tuning for ZeRO sharding)"
            )
        if remat_encoder:
            raise NotImplementedError("remat_encoder with lora_rank is not wired; drop one")
        if cfg.grad_accum_steps > 1:
            raise NotImplementedError("grad_accum_steps with lora_rank is not wired")
        if cfg.ema_decay:
            raise NotImplementedError(
                "ema_decay tracks full params; lora trains adapters — drop the flag"
            )
        refuse_unported(parallelism=(parallelism if parallelism != "none" else None, None))
        alpha = float(rank if alpha is None else alpha)
        scale = alpha / rank
        base = {"encoder": self.params["encoder"], "decoder": self.params["decoder"]}
        target_tree = {"decoder": base["decoder"]} if freeze_encoder else base
        adapters = init_lora(target_tree, rank, generator=self._lora_generator())
        if log:
            n_ad, n_base = lora_param_counts(base, adapters)
            log(
                f"LoRA rank {rank} (joint): {n_ad:,} trainable / "
                f"{n_base:,} frozen params ({100.0 * n_ad / n_base:.2f}%)"
            )
        optimizer = build_optimizer(cfg, total_steps=epochs * max(1, F_idx.shape[0] // batch_size))
        step = make_lora_train_step(
            self.decoder,
            base,
            optimizer,
            scale=scale,
            encoder=self.encoder,
            pad_id=0,
            label_smoothing=cfg.label_smoothing,
            attention_reg=cfg.attention_reg,
            compute_dtype=compute_dtype,
            augment_fn=make_augment_fn(flip=augment, max_shift=augment_shift),
            donate=True,
        )
        state = own_state(TrainState.create(adapters, optimizer, self._train_generator()))
        state, history = self._run_epochs(
            step,
            state,
            MemoryBatches((F_idx, T), batch_size),
            lambda bi, bt: self._to_device(store[np.asarray(bi)], bt),
            epochs,
            log,
            label="lora epoch",
        )
        self.lora_adapters, self.lora_meta = state.params, {"rank": rank, "alpha": alpha}
        self.params.update(self._merge_lora(base, state.params, scale))
        self._params_changed()
        return history

    def fit_lora(
        self,
        descriptions: dict[str, list[str]],
        features: dict[str, np.ndarray],
        *,
        rank: int = 8,
        alpha: float | None = None,
        target_keys=None,
        epochs: int | None = None,
        batch_size: int | None = None,
        parallelism: str | None = None,
        merge: bool = True,
        log=print,
    ) -> list[dict]:
        """LoRA fine-tuning of the decoder on extracted features
        (``train/lora.py``): every base weight frozen, a rank-``rank``
        overlay trained on the 2-D leaves named in ``target_keys`` (the
        matmul kernels by default), one device. Step 0 is the base model
        (B = 0 at init); ``a`` is drawn from a CPU generator seeded
        TrainConfig.seed + 7, as tpucap seeds its key. ``alpha`` defaults
        to ``rank`` (scale 1). The rows are shuffled as ``fit`` shuffles
        them; each epoch logs ``lora epoch e: loss=... acc=...``.

        ``merge=True`` puts the merged decoder in ``self.params`` (the
        bf16 copy dropped). The adapters stay on ``self.lora_adapters``
        with ``self.lora_meta`` = {"rank", "alpha"} for ``save_lora``.
        grad_accum_steps > 1 is refused with tpucap's words; data
        parallelism by name. -> per-epoch metric dicts, as ``fit``'s."""
        cfg = self.config.train
        epochs = epochs or cfg.epochs
        if self.decoder is None:
            self.build()
        if cfg.grad_accum_steps > 1:
            raise NotImplementedError(
                "grad_accum_steps with LoRA: the adapters are the "
                "memory fix — drop the accumulation"
            )
        if parallelism not in (None, "none", "dp"):
            raise NotImplementedError(
                f"fit_lora supports parallelism None|'none'|'dp', got {parallelism!r}"
            )
        refuse_unported(parallelism=(parallelism if parallelism != "none" else None, None))
        F, T = build_training_batch(
            self.tokenizer, descriptions, features, self.config.decode.max_len
        )
        # tpucap's fit_lora clamps the batch without a word.
        batch_size, compute_dtype = self._train_setup(T.shape[0], batch_size, None)
        alpha = float(rank if alpha is None else alpha)
        scale = alpha / rank
        base = self.params["decoder"]
        adapters = init_lora(
            base,
            rank,
            generator=self._lora_generator(),
            target_keys=target_keys or DEFAULT_TARGET_KEYS,
        )
        if log:
            n_ad, n_base = lora_param_counts(base, adapters)
            log(
                f"LoRA rank {rank}: {n_ad:,} trainable / {n_base:,} "
                f"frozen params ({100.0 * n_ad / n_base:.2f}%)"
            )
        optimizer = build_optimizer(cfg, total_steps=epochs * max(1, F.shape[0] // batch_size))
        step = make_lora_train_step(
            self.decoder,
            base,
            optimizer,
            scale=scale,
            pad_id=0,
            label_smoothing=cfg.label_smoothing,
            attention_reg=cfg.attention_reg,
            compute_dtype=compute_dtype,
            donate=True,
        )
        state = own_state(TrainState.create(adapters, optimizer, self._train_generator()))
        state, history = self._run_epochs(
            step,
            state,
            MemoryBatches((F, T), batch_size),
            self._to_device,
            epochs,
            log,
            label="lora epoch",
        )
        self.lora_adapters, self.lora_meta = state.params, {"rank": rank, "alpha": alpha}
        if merge:
            self.params["decoder"] = self._merge_lora(base, state.params, scale)
            self._params_changed()
        return history

    def _lora_generator(self) -> torch.Generator:
        """The CPU generator of init_lora's draw: TrainConfig.seed + 7, the
        seed of tpucap's LoRA key."""
        return torch.Generator().manual_seed(self.config.train.seed + 7)

    def _merge_lora(self, base, adapters, scale: float):
        """``base`` merged with ``adapters`` under the pipeline's precision
        flags (TF32 off at f32), as a decode on this pipeline computes."""
        with precision_flags(self.config.precision):
            return merge_lora(base, adapters, scale=scale)

    def save_lora(self, path) -> None:
        """Write the last fit_lora / fit_finetune(lora_rank=) adapters as
        tpucap's small ``.npz`` artifact (``train/lora.py::save_lora``),
        which tpucap's ``load_lora`` reads too."""
        if getattr(self, "lora_adapters", None) is None:
            raise ValueError("no trained LoRA adapters on this pipeline")
        _save_lora(path, self.lora_adapters, rank=self.lora_meta["rank"], alpha=self.lora_meta["alpha"])

    def apply_lora_file(self, path, *, subtree: str = "decoder") -> None:
        """Merge a saved adapter artifact (the port's or tpucap's) into this
        pipeline's params, under the pipeline's precision flags.
        ``subtree``: "decoder" for fit_lora's adapters, "joint" for
        fit_finetune(lora_rank=)'s, which span {"encoder", "decoder"}.
        Drops the cached bf16 params."""
        adapters, rank, alpha = load_lora(path)
        adapters = tree_map(lambda t: t.to(self.device), adapters)
        if subtree == "joint":
            base = {"encoder": self.params["encoder"], "decoder": self.params["decoder"]}
            self.params.update(self._merge_lora(base, adapters, alpha / rank))
        else:
            self.params["decoder"] = self._merge_lora(self.params["decoder"], adapters, alpha / rank)
        self._params_changed()

    @staticmethod
    def _make_ema(cfg, params):
        """The EMA shadow for TrainConfig.ema_decay (None when 0): a copy
        of the starting params, which the steps then update in place."""
        if not cfg.ema_decay:
            return None
        d = float(cfg.ema_decay)
        if not 0.0 < d < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {d}")
        return tree_map(torch.clone, params)

    def use_ema_weights(self):
        """Swap the EMA weights of the last fit / fit_finetune (with
        TrainConfig.ema_decay > 0) into ``self.params`` for decoding, save
        or evaluate. -> the replaced subtrees, to swap the raw weights
        back."""
        if not self.ema_params:
            raise ValueError(
                "no EMA weights tracked — set TrainConfig.ema_decay > 0 "
                "and run fit()/fit_finetune() first"
            )
        replaced = {k: self.params[k] for k in self.ema_params}
        self.params.update(self.ema_params)
        self._params_changed()
        return replaced

    def use_averaged_weights(self, checkpoint_dir, *, last_k: int | None = None, steps=None):
        """Swap in the uniform average of retained checkpoints' decoder
        params (``CheckpointManager.average_params``: the newest ``last_k``,
        the ``steps`` named, or all). The checkpoints' optimizer state must
        have the layout ``build_optimizer(config.train)`` gives. -> the
        replaced decoder params."""
        mgr = CheckpointManager(checkpoint_dir, best_metric=None)
        fresh = TrainState.create(
            self.params["decoder"], build_optimizer(self.config.train), None
        )
        averaged = mgr.average_params(fresh, steps=steps, last_k=last_k)
        mgr.close()
        replaced = self.params["decoder"]
        self.params["decoder"] = averaged
        self._params_changed()
        return replaced

    def _train_generator(self) -> torch.Generator:
        """The dropout generator, on the pipeline's device, seeded with
        TrainConfig.seed (its bits are not jax's)."""
        return torch.Generator(device=self.device).manual_seed(self.config.train.seed)

    def _to_device(self, features, tokens):
        return (
            torch.as_tensor(features).to(self.device, torch.float32),
            torch.as_tensor(tokens).to(self.device, torch.long),
        )


def ema_update(shadow, params, decay: float) -> None:
    """shadow <- decay * shadow + (1 - decay) * params, in place, in the
    order tpucap writes it: each product rounded, then the sum (a
    ``torch.lerp`` rounds otherwise). Three multi-tensor ops a step, not
    two per leaf."""
    e = tree_leaves(shadow)
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, torch._foreach_mul(tree_leaves(params), 1.0 - decay))


@dataclasses.dataclass(frozen=True)
class MemoryBatches:
    """``_run_epochs``' in-memory batch source: ``batch_iterator`` over
    stacked arrays; the batches before ``skip`` are drawn and passed over."""

    arrays: tuple
    batch_size: int

    @property
    def n_rows(self) -> int:
        return self.arrays[0].shape[0]

    def __call__(self, rng, skip: int):
        for b_i, rows in enumerate(batch_iterator(self.arrays, self.batch_size, rng=rng)):
            if b_i >= skip:  # the ones before trained before the run was cut
                yield b_i, rows


@dataclasses.dataclass(frozen=True)
class StreamedBatches:
    """``_run_epochs``' streamed batch source: ``caption_batch_stream`` on
    a thread ``depth`` batches ahead (``prefetch_iterator``), the batches
    before ``skip`` never read."""

    row_ids: list
    tokens: np.ndarray
    features: object
    batch_size: int
    depth: int

    @property
    def n_rows(self) -> int:
        return len(self.row_ids)

    def __call__(self, rng, skip: int):
        stream = prefetch_iterator(
            caption_batch_stream(
                self.row_ids, self.tokens, self.features, self.batch_size, rng=rng, start_batch=skip
            ),
            depth=self.depth,
        )
        try:
            yield from enumerate(stream, start=skip)
        finally:
            stream.close()


def pad_rows(arr: np.ndarray, target: int) -> np.ndarray:
    """Zero-pad the leading (batch) axis up to ``target`` rows (tpucap's
    tail-batch idiom: one batch shape on the device)."""
    n = arr.shape[0]
    if n > target:
        raise ValueError(f"batch has {n} rows, larger than target {target}")
    if n == target:
        return arr
    return np.pad(arr, [(0, target - n)] + [(0, 0)] * (arr.ndim - 1))


def _bundle_params(directory: str):
    """A bundle's ``params.npz`` as a tree of CPU tensors."""
    path = os.path.join(directory, PARAMS_FILE)
    if not os.path.exists(path) and os.path.isdir(os.path.join(directory, "params")):
        raise ValueError(
            f"{directory}: params/ is an orbax checkpoint, which tpucap_torch does not "
            f"read; write the params as {PARAMS_FILE} with "
            "convert.save_npz(path, convert.params_from_jax(params))"
        )
    return load_npz(path)

