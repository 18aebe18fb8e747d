"""High-level captioning pipeline: the serving subset of
``tpucap.pipeline.CaptioningPipeline``.

    fit_tokenizer(descriptions)   vocabulary (Keras-parity word tokenizer)
    build(seed)                   encoder + decoder, random init
    fold_bn()                     BatchNorm folded into the conv weights
    encode_images(images)         preprocessed batch -> features
    generate(features, ...)       features -> captions (greedy | beam)
    caption_batch(images_u8, ...) uint8 (B, H, W, 3) -> captions: the body
                                  of the JAX package's caption_dataset

``caption_batch`` is the main path: preprocess kernel K1 -> encoder ->
MergeDecoder.init_state -> beam search whose step, on the card with a
1-layer MergeDecoder, is ``make_fused_merge_step`` (kernels K2 and K3: the
JAX package's own drop-in step_fn hook). On the CPU the step is the plain
``MergeDecoder.step``. The encoder is ResNet-50 (caffe mode), or with
``encoder_config("vit_b16")`` ViT-B/16 (tf mode). As in the JAX package the
encoder's kernel paths are opt-in on the built encoder:
``pipe.encoder = dataclasses.replace(pipe.encoder, fused_blocks=True)``
(ResNet-50's identity blocks as kernel K4, after ``fold_bn()``) or
``dataclasses.replace(pipe.encoder, attention_impl="flash")`` (ViT
attention as kernel K5). Reading JPEG files (``caption_dataset(paths)``) and
training are not ported yet.

Runs on ``cuda`` unless ``device="cpu"`` is passed; see
``tpucap_torch.core`` for the precision policy.
"""

from __future__ import annotations

import torch

from tpucap_torch.config import Config
from tpucap_torch.core import (
    apply_precision,
    infer_dtype,
    resolve_device,
    tree_map,
)
from tpucap_torch.decode import beam_decode, greedy_decode, ids_to_captions
from tpucap_torch.models.decoders import MergeDecoder, build_decoder
from tpucap_torch.models.encoders import build_encoder, fold_batch_norms
from tpucap_torch.ops.decoder_step import make_fused_merge_step
from tpucap_torch.ops.preprocess import fused_preprocess
from tpucap_torch.text import END_TOKEN, START_TOKEN, Tokenizer
from tpucap_torch.text.tokenizer import text_to_word_sequence


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
        self._bf16_params = None

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
        tok = self.tokenizer
        wi = tok.word_index
        ids = set()
        for entry in self.config.decode.bad_words:
            for w in text_to_word_sequence(
                entry, filters=tok.filters, lower=tok.lower
            ):
                if w in wi and wi[w] < self.vocab_size:
                    ids.add(wi[w])
        return tuple(sorted(ids))

    # -- model construction ------------------------------------------------

    def build(self, seed: int | None = None, init_params: bool = True):
        """Construct the decoder and (by default) random-initialize params
        from a seeded ``torch.Generator`` (``config.train.seed`` unless
        ``seed`` is given)."""
        d = self.config.decoder
        self.decoder = build_decoder(
            d.name,
            vocab_size=self.vocab_size,
            feature_dim=self.config.encoder.feature_dim,
            embed_dim=d.embed_dim,
            hidden_dim=d.hidden_dim,
            num_layers=d.num_layers,
            dropout_rate=d.dropout_rate,
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
        ``convert.load_npz``) on the pipeline's device."""
        self.params = tree_map(lambda t: t.to(self.device), params)
        self._bf16_params = None

    def fold_bn(self) -> None:
        """Fold inference BatchNorms into the conv weights."""
        self.params["encoder"] = fold_batch_norms(
            self.config.encoder.name, self.params["encoder"]
        )
        self._bf16_params = None

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
        if self._bf16_params is None:

            def cast(t):
                t = t.to(torch.bfloat16)
                if t.ndim == 4 and t.is_cuda:
                    t = t.contiguous(memory_format=torch.channels_last)
                return t

            self._bf16_params = tree_map(cast, self.params)
        return self._bf16_params

    # -- encoder -----------------------------------------------------------

    def _apply_encoder(self, params, x):
        """Encoder apply + spatial flattening to (B, L, D)."""
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
        """The decode step: kernels K2 + K3 on the card for a 1-layer merge
        decoder, the plain decoder step otherwise."""
        if (
            self.device.type == "cuda"
            and isinstance(self.decoder, MergeDecoder)
            and self.decoder.num_layers == 1
        ):
            return make_fused_merge_step(self.decoder)
        return self.decoder.step

    def _decode(self, dec_params, feats, method, beam_width):
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
            approx_topk=dcfg.approx_topk,
        )

    def _captions(self, res) -> list[str]:
        _, end_id = self._token_ids()
        return ids_to_captions(
            self.tokenizer, res.tokens, res.lengths, end_id=end_id
        )

    @torch.inference_mode()
    def generate(
        self, features, *, method: str | None = None, beam_width: int | None = None
    ) -> list[str]:
        """Features (B, D) -> caption strings (sentinels stripped)."""
        method = method or self.config.decode.method
        beam_width = beam_width or self.config.decode.beam_width
        feats = torch.as_tensor(features).to(self.device, self._infer_dtype())
        res = self._decode(
            self._inference_params()["decoder"], feats, method, beam_width
        )
        return self._captions(res)

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
        params = self._inference_params()
        images = torch.as_tensor(images_u8).to(self.device)
        x = fused_preprocess(
            images,
            self.encoder.input_size,
            self.encoder.preprocess_mode,
            out_dtype=self._infer_dtype(),
        )
        feats = self._apply_encoder(params["encoder"], x)
        res = self._decode(params["decoder"], feats, method, beam_width)
        return self._captions(res)
