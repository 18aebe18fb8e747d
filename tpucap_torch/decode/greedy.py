"""Batched greedy decoding (port of ``tpucap.decode.greedy``).

The decoder state (h, c, image branch) stays on the device and each step
is one incremental step for the whole batch. The JAX package runs the loop
as a ``lax.while_loop``; here it is a Python loop over eager steps with the
same semantics, token for token. ``no_repeat_ngram_size`` bans the tokens
that would complete an already generated n-gram (``decode/ngram.py``),
selection only. ``unroll`` exists in the JAX package only to cut
while-loop boundaries; eager mode has none, so only 1 is accepted.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from tpucap_torch.core import tree_leaves
from tpucap_torch.decode.beam import EXIT_CHECK_EVERY, apply_banned, min_len_mask
from tpucap_torch.decode.ngram import apply_ngram_ban


@dataclasses.dataclass
class DecodeResult:
    """tokens: (B, max_len) generated ids (end token included, pad after);
    lengths: (B,) generated tokens incl. the end token; scores: (B,) sum of
    the generated tokens' log-probs."""

    tokens: Any
    lengths: Any
    scores: Any


def greedy_decode(
    step_fn: Callable,
    params,
    state,
    *,
    start_id,
    end_id: int,
    max_len: int,
    pad_id: int = 0,
    min_len: int = 0,
    banned_ids: tuple = (),
    no_repeat_ngram_size: int = 0,
    init_scores=None,
    unroll: int = 1,
) -> DecodeResult:
    """Greedy-decode a batch. ``step_fn(params, state, token) -> (logits,
    state)``. ``pad_id`` is masked out of the argmax (selection only: the
    score's normalizer is the full softmax, pad mass included)."""
    if unroll != 1:
        raise ValueError("unroll is a while-loop dial; eager decode takes 1")
    leaf = tree_leaves(state)[0]
    B, device = leaf.shape[0], leaf.device
    tokens = torch.full((B, max_len), pad_id, dtype=torch.long, device=device)
    last = torch.as_tensor(start_id, dtype=torch.long, device=device).expand(B)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    lengths = torch.zeros((B,), dtype=torch.long, device=device)
    scores = (
        torch.zeros((B,), dtype=torch.float32, device=device)
        if init_scores is None
        else torch.as_tensor(init_scores, dtype=torch.float32, device=device)
    )
    t = 0
    while t < max_len:
        logits, state = step_fn(params, state, last)
        logits = logits.float()
        masked = logits.clone()
        masked[:, pad_id] = -torch.inf
        masked = apply_banned(masked, banned_ids)
        if no_repeat_ngram_size:
            masked = apply_ngram_ban(masked, tokens, t, no_repeat_ngram_size)
        masked = min_len_mask(masked, t, min_len, end_id)
        lse = torch.logsumexp(logits, dim=-1)
        nxt = torch.argmax(masked, dim=-1)
        tok_logp = logits.gather(1, nxt[:, None])[:, 0] - lse
        nxt = torch.where(done, pad_id, nxt)
        tokens[:, t] = nxt
        lengths = lengths + (~done).long()
        scores = scores + torch.where(done, 0.0, tok_logp)
        done = done | (nxt == end_id)
        last = nxt
        t += 1
        if t % EXIT_CHECK_EVERY == 0 and bool(done.all()):
            break
    return DecodeResult(tokens=tokens, lengths=lengths, scores=scores)
