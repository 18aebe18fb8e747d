"""Stochastic sampling decode: temperature, top-k and top-p (port of
``tpucap.decode.sample``).

Each step masks the f32 logits in tpucap's order, each mask acting on the
previous one's output: pad, ``banned_ids``, the repetition penalty on the
seen set, the n-gram ban, ``min_len``'s end mask, the temperature, top-k
(a threshold at the k-th value, so ties with it stay), top-p (a threshold
at the last value of the smallest descending prefix whose exclusive
cumulative probability stays under p). The token is drawn as
``jax.random.categorical`` draws it, the Gumbel-max trick:
``argmax(logits + g)`` with ``g = -log(-log(u))``, u uniform in
[tiny, 1). Its log-probability is the log-softmax of the masked logits.

Randomness. tpucap threads a jax key through the loop (a ``split`` a step);
torch cannot reproduce its bits. The draw is kept apart from its use: the
noise comes from ``generator`` (a ``torch.Generator`` on the state's
device), or from ``draws``, the caller's own Gumbel noise a step
(``draws[t]``, (B, V) f32). Handed tpucap's noise, the engine gives
tpucap's tokens; a ``seed`` alone gives other captions than tpucap's for
the same seed.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpucap_torch.core import tree_leaves
from tpucap_torch.decode.beam import EXIT_CHECK_EVERY, NEG_INF, apply_banned, min_len_mask
from tpucap_torch.decode.greedy import DecodeResult
from tpucap_torch.decode.ngram import apply_ngram_ban

_TINY = torch.finfo(torch.float32).tiny


def gumbel_noise(shape, *, generator, device) -> torch.Tensor:
    """(B, V) f32 Gumbel noise as jax's low-range sampler makes it from its
    uniforms: u in [tiny, 1), then -log(-log(u))."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(_TINY)))


def mask_logits(
    logits,
    *,
    t: int,
    tokens,
    seen,
    end_id: int,
    pad_id: int,
    min_len: int,
    banned_ids: tuple,
    no_repeat_ngram_size: int,
    temperature: float,
    top_k: int | None,
    top_p: float | None,
    repetition_penalty: float,
):
    """One step's f32 logits (B, V) after every mask, in tpucap's order."""
    logits = logits.float().clone()
    logits[:, pad_id] = NEG_INF
    logits = apply_banned(logits, banned_ids)
    if seen is not None:
        penalized = torch.where(logits > 0, logits / repetition_penalty, logits * repetition_penalty)
        logits = torch.where(seen, penalized, logits)
    if no_repeat_ngram_size:
        logits = apply_ngram_ban(logits, tokens, t, no_repeat_ngram_size)
    logits = min_len_mask(logits, t, min_len, end_id)
    if temperature != 1.0:
        logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p is not None and top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        kcount = ((cum - probs) < top_p).sum(dim=-1)
        thresh = sorted_desc.gather(1, (kcount - 1)[:, None])
        logits = torch.where(logits < thresh, NEG_INF, logits)
    return logits


def sample_decode(
    step_fn: Callable,
    params,
    state,
    *,
    generator: torch.Generator | None = None,
    start_id: int,
    end_id: int,
    max_len: int,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    repetition_penalty: float = 1.0,
    pad_id: int = 0,
    min_len: int = 0,
    banned_ids: tuple = (),
    no_repeat_ngram_size: int = 0,
    init_scores=None,
    draws=None,
) -> DecodeResult:
    """Ancestral sampling of a batch. ``step_fn(params, state, token) ->
    (logits, state)``.

    ``repetition_penalty`` != 1 divides a seen token's positive logit by the
    penalty and multiplies a negative one (the seen set is a (B, V) bool that
    exists only then). ``no_repeat_ngram_size``, ``banned_ids`` and
    ``min_len`` mask before the softmax, so the rest of the vocabulary
    renormalizes. A finished row writes ``pad_id`` and adds no length and
    no score.

    generator: the source of the uniforms (the same seed gives the same
    captions). draws: instead, the Gumbel noise of each step, ``draws[t]``
    of shape (B, V)."""
    if temperature <= 0.0:
        raise ValueError(
            f"temperature must be > 0, got {temperature}; for "
            "deterministic decoding use greedy_decode"
        )
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if repetition_penalty <= 0.0:
        raise ValueError(f"repetition_penalty must be > 0, got {repetition_penalty}")
    if draws is None and generator is None:
        raise ValueError("sample_decode needs a generator or the draws of each step")
    leaf = tree_leaves(state)[0]
    B, device = leaf.shape[0], leaf.device
    tokens = torch.full((B, max_len), pad_id, dtype=torch.long, device=device)
    last = torch.full((B,), start_id, dtype=torch.long, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    lengths = torch.zeros((B,), dtype=torch.long, device=device)
    scores = (
        torch.zeros((B,), dtype=torch.float32, device=device)
        if init_scores is None
        else torch.as_tensor(init_scores, dtype=torch.float32, device=device).clone()
    )
    seen = None
    t = 0
    while t < max_len:
        logits, state = step_fn(params, state, last)
        if seen is None and repetition_penalty != 1.0:
            seen = torch.zeros((B, logits.shape[-1]), dtype=torch.bool, device=device)
        logits = mask_logits(
            logits, t=t, tokens=tokens, seen=seen, end_id=end_id, pad_id=pad_id,
            min_len=min_len, banned_ids=banned_ids,
            no_repeat_ngram_size=no_repeat_ngram_size, temperature=temperature,
            top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty,
        )
        if draws is None:
            noise = gumbel_noise(logits.shape, generator=generator, device=device)
        else:
            noise = torch.as_tensor(draws[t], dtype=torch.float32, device=device)
        nxt = torch.argmax(logits + noise, dim=-1)
        tok_logp = torch.log_softmax(logits, dim=-1).gather(1, nxt[:, None])[:, 0]
        nxt = torch.where(done, pad_id, nxt)
        tokens[:, t] = nxt
        lengths = lengths + (~done).long()
        scores = scores + torch.where(done, 0.0, tok_logp)
        if seen is not None:
            seen.scatter_(1, nxt[:, None], True)
        done = done | (nxt == end_id)
        last = nxt
        t += 1
        if t % EXIT_CHECK_EVERY == 0 and bool(done.all()):
            break
    return DecodeResult(tokens=tokens, lengths=lengths, scores=scores)
