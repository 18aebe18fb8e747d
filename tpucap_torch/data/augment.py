"""On-device image augmentation for encoder fine-tuning (port of
``tpucap.data.augment``).

Fine-tuning puts the encoder inside the step, so each step can see another
view of its images: a per-image horizontal flip and a reflect-padded
integer translation, on the batch already on the device, drawn from the
step's generator (``TrainState.rng``, which a checkpoint carries, so a
resumed run draws what the uninterrupted one drew). Both ops are pixel
permutations and commute with the per-encoder normalization already
applied to the batch.

The draws and their application are separate: ``augment_draws`` takes the
flip mask and the offsets from a ``torch.Generator``, ``apply_augment``
applies given draws. tpucap draws from a jax key, whose bits torch cannot
reproduce; the tests hand tpucap's draws to ``apply_augment``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def augment_draws(batch: int, generator, *, flip: bool = True, max_shift: int = 0):
    """-> (flip_mask (B,) bool or None, dx (B,) or None, dy (B,) or None) on
    the generator's device: a flip with probability 1/2 per image, offsets
    uniform in [0, 2 max_shift] (a shift of offset - max_shift pixels)."""
    device = generator.device
    do = torch.rand(batch, generator=generator, device=device) < 0.5 if flip else None
    if not max_shift:
        return do, None, None
    hi = 2 * max_shift + 1
    dx = torch.randint(0, hi, (batch,), generator=generator, device=device)
    dy = torch.randint(0, hi, (batch,), generator=generator, device=device)
    return do, dx, dy


def apply_augment(images, flip_mask=None, dx=None, dy=None, *, max_shift: int = 0):
    """(B, H, W, C) -> (B, H, W, C): images where ``flip_mask`` is set
    mirrored left to right, then each one cropped at (dy, dx) from its
    reflect padding by ``max_shift`` (no edge repeat, numpy's "reflect")."""
    B, H, W, C = images.shape
    if flip_mask is not None:
        images = torch.where(flip_mask.view(B, 1, 1, 1), images.flip(2), images)
    if max_shift:
        if max_shift >= min(H, W):
            raise ValueError(f"max_shift {max_shift} must be smaller than the image ({H}x{W})")
        p = max_shift
        padded = F.pad(images.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect").permute(0, 2, 3, 1)
        rows = dy.view(B, 1, 1) + torch.arange(H, device=images.device).view(1, H, 1)
        cols = dx.view(B, 1, 1) + torch.arange(W, device=images.device).view(1, 1, W)
        images = padded[torch.arange(B, device=images.device).view(B, 1, 1), rows, cols]
    return images


def augment_images(images, generator, *, flip: bool = True, max_shift: int = 0):
    """(B, H, W, C) -> (B, H, W, C), randomly flipped and shifted per image,
    the draws taken from ``generator``."""
    if not flip and max_shift == 0:
        return images
    draws = augment_draws(images.shape[0], generator, flip=flip, max_shift=max_shift)
    return apply_augment(images, *draws, max_shift=max_shift)


def make_augment_fn(*, flip: bool = True, max_shift: int = 0):
    """-> ``augment_fn(images, generator)`` for ``make_joint_train_step``,
    or None when every op is off."""
    if not flip and max_shift == 0:
        return None

    def fn(images, generator):
        return augment_images(images, generator, flip=flip, max_shift=max_shift)

    return fn
