"""Joint encoder + decoder training through the captioning loss (port of
``tpucap.train.finetune``).

One step differentiates the encoder's forward together with the decoder's
loss; the params tree is ``{"encoder": ..., "decoder": ...}``. BN encoders
train with frozen BN statistics (inference-mode BN). With ViT-B/16 and
``attention_impl="flash"`` the attention runs kernel K5 forward (with its
row statistics) and K5's two backward kernels (``ops.attention``).

``freeze_encoder=True`` stops gradients at the feature boundary and zeroes
the encoder's updates, so the decoder's update equals ``make_train_step``'s
on the extracted features. ``remat_encoder=True`` keeps only the encoder's
output features for the backward and recomputes its activations there
(``torch.utils.checkpoint``; with flash attention K5 runs again in the
recompute). ``augment_fn`` (``data.augment``) transforms the batch before
anything else, its draws from the step's generator. ``grad_accum_steps``
and ``attention_reg`` are ``make_train_step``'s.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils.checkpoint

from tpucap_torch.core import tree_map
from tpucap_torch.train.loop import (
    GradientTransformation,
    TrainState,
    check_compute_dtype,
    loss_and_grads,
    optimizer_step,
    refuse_unported,
    trainable,
)
from tpucap_torch.train.loss import caption_loss_sums, cast_floats, warn_if_attention_reg_unused


def encode_for_decoder(encoder, enc_params, images):
    """(B, H, W, 3) preprocessed images -> decoder-ready features: (B, D)
    pooled, or (B, L, D) rows of the spatial grid."""
    feats = encoder.apply(enc_params, images)
    if encoder.features == "spatial":
        b, h, w, c = feats.shape
        feats = feats.reshape(b, h * w, c)
    return feats


def make_joint_train_step(
    encoder,
    decoder,
    optimizer,
    *,
    pad_id: int = 0,
    label_smoothing: float = 0.0,
    attention_reg: float = 0.0,
    deterministic: bool = False,
    grad_accum_steps: int = 1,
    freeze_encoder: bool = False,
    remat_encoder: bool = False,
    mesh=None,
    axis: str = "data",
    compute_dtype=None,
    augment_fn=None,
    fsdp_state_template=None,
    grad_clip_norm: float = 0.0,
    fsdp_min_size: int | None = None,
    donate: bool = False,
) -> Callable:
    """Single-device joint step: (state, images, tokens) -> (state,
    metrics), ``state.params = {"encoder": ..., "decoder": ...}`` and the
    optimizer initialized over that tree. ``compute_dtype`` casts the
    encoder's params and the images as well as the decoder's, inside the
    differentiated function. ``augment_fn(images, generator)`` draws from
    ``state.rng`` before the dropout does. ``grad_clip_norm`` belongs to
    tpucap's fsdp branch (elsewhere it lives in the optimizer) and is not
    ported."""
    refuse_unported(
        mesh=(mesh, None),
        axis=(axis, "data"),
        fsdp_state_template=(fsdp_state_template, None),
        grad_clip_norm=(grad_clip_norm, 0.0),
        fsdp_min_size=(fsdp_min_size, None),
    )
    check_compute_dtype(compute_dtype)
    warn_if_attention_reg_unused(decoder, attention_reg)
    use_reg = attention_reg > 0.0 and hasattr(decoder, "forward_train_with_alphas")

    def encode(enc_params, images):
        if remat_encoder:
            # The encoder draws nothing at random, so no generator state
            # needs keeping for the recompute.
            return torch.utils.checkpoint.checkpoint(
                encode_for_decoder, encoder, enc_params, images,
                use_reentrant=False, preserve_rng_state=False,
            )
        return encode_for_decoder(encoder, enc_params, images)

    def step(state: TrainState, images, tokens):
        enc = state.params["encoder"]
        params = {
            "encoder": tree_map(lambda t: t.detach(), enc) if freeze_encoder else trainable(enc),
            "decoder": trainable(state.params["decoder"]),
        }
        if augment_fn is not None:
            images = augment_fn(images, state.rng)

        def sums_fn(p, x, t):
            feats = encode(cast_floats(p["encoder"], compute_dtype), cast_floats(x, compute_dtype))
            return caption_loss_sums(
                decoder,
                p["decoder"],
                feats,
                t,
                rng=state.rng,
                deterministic=deterministic,
                pad_id=pad_id,
                label_smoothing=label_smoothing,
                attention_reg=attention_reg,
                compute_dtype=compute_dtype,
            )

        grads, metrics = loss_and_grads(
            sums_fn, params, images, tokens, grad_accum_steps, use_reg, attention_reg
        )
        mask = None
        if freeze_encoder:
            # Zero gradients leave Adam's update at zero but not adamw's
            # decayed weights: frozen means no update at all.
            def mask(updates):
                return {**updates, "encoder": tree_map(torch.zeros_like, updates["encoder"])}

        return optimizer_step(state, optimizer, grads, metrics, donate, mask)

    return step


def encoder_learning_rate_optimizer(base_optimizer, *, encoder_lr_scale: float):
    """Scale the encoder subtree's UPDATES by ``encoder_lr_scale`` after
    the base optimizer has run on the joint gradient tree (so a global-norm
    clip and Adam's statistics see the joint tree unscaled). Under Adam,
    scaling the gradient instead would change nothing."""

    def update(grads, state, params=None):
        updates, state = base_optimizer.update(grads, state, params)
        updates = {
            **updates,
            "encoder": tree_map(lambda u: u * encoder_lr_scale, updates["encoder"]),
        }
        return updates, state

    return GradientTransformation(base_optimizer.init, update, base_optimizer.stateless)
