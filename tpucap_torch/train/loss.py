"""Masked cross-entropy over padded caption batches (port of
``tpucap.train.loss``).

Logits (B, T, V) against next-token targets (B, T), pad positions
(target == 0) masked out, in sum form: the caller divides by the number of
real tokens (``loss_from_sums``). For a decoder with attention maps,
``attention_reg`` > 0 adds Show-Attend-Tell's doubly-stochastic
regularizer, lambda * mean over live rows of sum_i (1 - sum_t alpha_ti)^2.
"""

from __future__ import annotations

import torch

from tpucap_torch.core import tree_map
from tpucap_torch.train.scheduled import scheduled_draws, scheduled_inputs


def cast_floats(tree, dtype):
    """Cast every floating-point leaf of ``tree`` to ``dtype`` (integer
    leaves pass through). The mixed-precision boundary: called inside the
    differentiated function on the f32 master params, so autograd brings
    each gradient back through the cast as f32. ``None`` is a no-op."""
    if dtype is None:
        return tree
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def masked_cross_entropy_sums(logits, targets, *, pad_id: int = 0, label_smoothing: float = 0.0):
    """-> (nll_sum, token_count, correct_count), f32 scalars. Label
    smoothing in Keras's convention: y*(1 - ls) + ls / V, uniform over all
    classes, the target included."""
    vocab = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = (targets != pad_id).float()
    target_logp = logp.gather(-1, targets[..., None].long())[..., 0]
    if label_smoothing > 0.0:
        target_logp = (1.0 - label_smoothing) * target_logp + (
            label_smoothing / vocab
        ) * logp.sum(dim=-1)
    nll = -target_logp
    nll_sum = (nll * mask).sum()
    n_tokens = mask.sum()
    n_correct = ((logits.argmax(dim=-1) == targets).float() * mask).sum()
    return nll_sum, n_tokens, n_correct


def warn_if_attention_reg_unused(decoder, attention_reg: float) -> None:
    """Warn, when a train step is built, that a nonzero ``attention_reg``
    does nothing for a decoder without attention maps."""
    if attention_reg > 0.0 and not hasattr(decoder, "forward_train_with_alphas"):
        import warnings

        warnings.warn(
            f"attention_reg={attention_reg} has no effect: decoder "
            f"{type(decoder).__name__} has no attention maps "
            "(doubly-stochastic regularization applies to the attention "
            "decoder only)",
            stacklevel=3,
        )


def caption_loss_sums(
    decoder,
    params,
    features,
    tokens,
    *,
    rng=None,
    deterministic=True,
    pad_id: int = 0,
    label_smoothing: float = 0.0,
    attention_reg: float = 0.0,
    compute_dtype=None,
    ss_eps=None,
    ss_rng=None,
):
    """Sum-form teacher-forced loss pieces for a batch: -> dict(nll_sum,
    tokens, correct, reg_sum, batch). tokens (B, T + 1) post-padded full
    captions; inputs are tokens[:, :-1], targets tokens[:, 1:].

    ``compute_dtype=torch.bfloat16`` casts params and features at this
    boundary (``cast_floats``), so the forward and backward run in bf16
    while the caller's master params stay f32; every loss reduction stays
    f32 (the coverage sum of the regularizer too). All-pad rows add
    nothing to any sum. ``rng``: a ``torch.Generator`` for dropout when not
    ``deterministic``.

    ``ss_eps`` (None = off) is scheduled sampling (``train/scheduled.py``):
    the coin is drawn from ``ss_rng`` (a ``torch.Generator``, the step's
    own) before the loss forward draws its dropout, and pass 1 runs on the
    cast params, so in bf16 under bf16 compute. Targets stay gold."""
    params = cast_floats(params, compute_dtype)
    features = cast_floats(features, compute_dtype)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if ss_eps is not None:
        if ss_rng is None:
            raise ValueError("scheduled sampling (ss_eps) needs ss_rng")
        coin = scheduled_draws(inputs[:, 1:].shape, ss_eps, ss_rng)
        inputs = scheduled_inputs(decoder, params, features, inputs, coin=coin, pad_id=pad_id)
    row_live = (targets != pad_id).any(dim=-1).float()
    if attention_reg > 0.0 and hasattr(decoder, "forward_train_with_alphas"):
        logits, alphas = decoder.forward_train_with_alphas(
            params, features, inputs, rng=rng, deterministic=deterministic
        )
        # Coverage over live input steps, summed in f32.
        live = (inputs != pad_id).float()[:, :, None]
        coverage = (alphas.float() * live).sum(dim=1)  # (B, L)
        reg_sum = (((1.0 - coverage) ** 2).sum(dim=-1) * row_live).sum()
    else:
        logits = decoder.forward_train(
            params, features, inputs, rng=rng, deterministic=deterministic
        )
        reg_sum = torch.zeros((), device=row_live.device)
    nll_sum, n_tokens, n_correct = masked_cross_entropy_sums(
        logits, targets, pad_id=pad_id, label_smoothing=label_smoothing
    )
    return {
        "nll_sum": nll_sum,
        "tokens": n_tokens,
        "correct": n_correct,
        "reg_sum": reg_sum,
        "batch": row_live.sum(),
    }


def loss_from_sums(sums, *, attention_reg: float = 0.0):
    """Normalize sum-form pieces into (loss, metrics); with
    ``attention_reg`` > 0 the loss adds attention_reg * reg_sum / rows and
    the metrics hold ``attention_reg``, that mean."""
    denom = sums["tokens"].clamp(min=1.0)
    loss = sums["nll_sum"] / denom
    reg = sums["reg_sum"] / sums["batch"].clamp(min=1.0)
    if attention_reg > 0.0:
        loss = loss + attention_reg * reg
    metrics = {
        "loss": loss,
        "accuracy": sums["correct"] / denom,
        "tokens": sums["tokens"],
        "perplexity": torch.exp((sums["nll_sum"] / denom).clamp(max=20.0)),
    }
    if attention_reg > 0.0:
        metrics["attention_reg"] = reg
    return loss, metrics
