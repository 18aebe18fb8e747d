"""Scheduled sampling: train on the model's own predictions (port of
``tpucap.train.scheduled``).

The parallel two-pass form (Duckworth et al. 2019): pass 1 is one
teacher-forced forward, dropout off and without gradient, whose argmax
predicts every position; each input position t >= 1 is then replaced by
the prediction for it with probability eps; pass 2, the ordinary loss
forward, runs on the mixed inputs against the unchanged gold targets.

Mixing rules, tpucap's:
- position 0 (startseq) is never replaced;
- pad inputs stay pad;
- a pad prediction is never injected;
- eps == 0 gives plain teacher forcing exactly (the mixed inputs are the
  gold ones).

tpucap draws its coin from a jax key, whose bits torch cannot reproduce,
so the draw (``scheduled_draws``, from the step's ``torch.Generator``) is
split from its use (``scheduled_inputs``, which takes a coin), as
``data/augment.py`` splits augmentation. At eps = 1 the coin is all true
in both packages. ``epsilon_for_epoch`` gives the per-epoch ramps on the
host, tpucap's floats exactly.
"""

from __future__ import annotations

import math

import torch

SCHEDULES = ("linear", "inv_sigmoid", "constant")


def scheduled_draws(shape, eps: float, generator: torch.Generator) -> torch.Tensor:
    """The replacement coin: a bool tensor of ``shape`` on the generator's
    device, each entry true with probability ``eps`` (uniform < eps, so
    eps = 1 is all true and eps = 0 all false)."""
    return torch.rand(shape, generator=generator, device=generator.device) < eps


def scheduled_inputs(decoder, params, features, inputs, *, coin, pad_id: int = 0):
    """Mix the model's own first-pass predictions into teacher-forcing
    inputs: (B, T) -> mixed (B, T). ``coin`` (B, T - 1) bool says which of
    positions 1 .. T - 1 may be replaced. Pass 1 runs deterministic and
    without gradient, on the params as given (bf16 under bf16 compute)."""
    with torch.no_grad():
        logits = decoder.forward_train(params, features, inputs, deterministic=True)
        preds = logits.argmax(dim=-1)  # (B, T)
    # preds[:, t] estimates targets[:, t] == inputs[:, t + 1]: the
    # candidate for input position t + 1 is preds[:, t].
    prev_pred = preds[:, :-1].to(inputs.dtype)
    tail = inputs[:, 1:]
    replace = coin & (tail != pad_id) & (prev_pred != pad_id)
    return torch.cat([inputs[:, :1], torch.where(replace, prev_pred, tail)], dim=1)


def epsilon_for_epoch(
    epoch: int,
    total_epochs: int,
    *,
    max_eps: float,
    schedule: str = "linear",
    k: float = 5.0,
) -> float:
    """Host-side per-epoch sampling probability.

    - ``linear``: 0 at epoch 0 ramping to ``max_eps`` at the last epoch;
    - ``inv_sigmoid``: 1 - k / (k + exp(epoch / k)), normalized so that
      epoch 0 is exactly 0 and scaled by ``max_eps``;
    - ``constant``: ``max_eps`` from epoch 0.
    """
    if schedule == "constant":
        return float(max_eps)
    if schedule == "linear":
        return float(max_eps) * (epoch / max(total_epochs - 1, 1))
    if schedule == "inv_sigmoid":
        s = 1.0 - k / (k + math.exp(epoch / k))
        s0 = 1.0 / (k + 1.0)  # the raw curve at epoch 0
        # max() absorbs the rounding at epoch 0 (s - s0 ~ -1e-16).
        return float(max_eps) * max(0.0, (s - s0) / (1.0 - s0))
    raise ValueError(f"unknown ss_schedule {schedule!r}; have linear|inv_sigmoid|constant")
