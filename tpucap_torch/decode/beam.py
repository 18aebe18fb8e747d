"""Vectorized batched beam search (port of ``tpucap.decode.beam``).

Hypotheses are vectorized: decoder state has shape (B*k, ...), one step
scores all B*k hypotheses, and an exact two-stage top-k does the beam
bookkeeping on the device. The JAX package runs this as one
``lax.while_loop``; here it is a Python loop over eager steps with the same
semantics, checked token for token against ``tpucap.decode.oracle``:

- beams start identical with scores [0, -inf, ...], so the first expansion
  selects the global top-k first words;
- a beam that emits ``end_id`` is frozen: it keeps its slot, and its only
  continuation is ``pad_id`` with its score unchanged;
- ``pad_id`` (reserved index 0) and ``banned_ids`` are masked out of live
  expansions, and ``end_id`` while t < ``min_len``; the log-softmax
  normalizer stays the full softmax (lazy logsumexp on the survivors);
- ties rank by score descending, then parent ascending, then word
  ascending. ``torch.topk`` promises no tie order, so both stages take the
  first k of a stable descending sort;
- final ranking is score / length**alpha (or the GNMT penalty); ties go to
  the lowest slot.

``no_repeat_ngram_size`` bans, per hypothesis, the tokens that would
complete an n-gram that hypothesis already generated (``decode/ngram.py``),
from a (B, k, max_len) token history re-gathered by parent every step.
``decoder=`` honors the decoder's ``beam_shared_keys``: per-image state
entries (the attention decoder's feature grids) stay (B, ...), neither
tiled to (B*k, ...) nor gathered by parent; the step infers k from the
shape ratio. ``approx_topk`` (a TPU custom call in the JAX package) maps to
the exact top-k.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from tpucap_torch.core import tree_leaves, tree_map
from tpucap_torch.decode.ngram import apply_ngram_ban

NEG_INF = -1e30  # avoid inf-inf NaNs inside score arithmetic

# Every this many steps the loop asks the device whether all beams are
# finished (one host sync). Steps after that point run on frozen beams,
# which pass through unchanged, so the tokens equal an every-step check.
EXIT_CHECK_EVERY = 4


@dataclasses.dataclass
class BeamResult:
    """tokens: (B, max_len) best beam; lengths/scores: (B,);
    beam_tokens: (B, k, max_len) all beams; beam_lengths/beam_scores: (B, k)
    (raw, un-normalized log-prob sums)."""

    tokens: Any
    lengths: Any
    scores: Any
    beam_tokens: Any
    beam_lengths: Any
    beam_scores: Any


def normalized_scores(
    scores, lengths, *, length_normalize: bool = True,
    alpha: float = 1.0, length_penalty: str = "simple",
):
    """The beam ranking quantity: 'simple' divides by len^alpha, 'gnmt' by
    ((5+len)/6)^alpha. f32 throughout."""
    if not length_normalize:
        return scores
    lengths = torch.clamp(lengths, min=1).float()
    if length_penalty == "gnmt":
        denom = ((5.0 + lengths) / 6.0) ** alpha
    elif length_penalty == "simple":
        denom = lengths**alpha
    else:
        raise ValueError(
            f"unknown length_penalty {length_penalty!r}; have simple|gnmt"
        )
    return scores / denom


def apply_banned(masked, banned_ids):
    """Exclude ``banned_ids`` from the candidate vocabulary (selection
    only: the softmax normalizer comes from the raw logits)."""
    if not banned_ids:
        return masked
    masked[:, list(banned_ids)] = NEG_INF
    return masked


def topk_stable(x, k: int):
    """Top-k along the last axis with ties in ascending index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def min_len_mask(masked, t, min_len: int, end_id: int):
    """Length floor: endseq leaves the candidate set while t < min_len.
    ``t`` is the step (an int), or a (rows,) tensor of each row's own step
    (the continuous engines' lanes and groups)."""
    if isinstance(t, torch.Tensor):
        if min_len:
            masked[:, end_id] = masked[:, end_id].masked_fill(t < min_len, NEG_INF)
        return masked
    if t < min_len:
        masked[:, end_id] = NEG_INF
    return masked


def _start_scores(B: int, k: int, device, offsets=None):
    """(B, k) f32 start scores [0, -inf, ...] (+ a per-row offset)."""
    scores = torch.full((B, k), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    if offsets is not None:
        scores = scores + torch.as_tensor(
            offsets, dtype=torch.float32, device=device
        )[:, None]
    return scores


def _shared_keys(decoder, state) -> frozenset:
    """Top-level state keys that are per-image constants, identical across
    a beam's hypotheses (the decoder's ``beam_shared_keys``)."""
    keys = getattr(decoder, "beam_shared_keys", frozenset())
    if isinstance(state, dict):
        return frozenset(k for k in keys if k in state)
    return frozenset()


def _per_entry(fn, state, shared: frozenset):
    """``fn`` on every leaf of ``state`` except its shared entries."""
    if isinstance(state, dict) and shared:
        return {key: v if key in shared else tree_map(fn, v) for key, v in state.items()}
    return tree_map(fn, state)


def _tile_state(state, k: int, shared: frozenset = frozenset()):
    """(B, ...) -> (B*k, ...) with each row repeated k times (beam-major);
    shared entries stay untiled."""
    return _per_entry(lambda x: x.repeat_interleave(k, dim=0), state, shared)


def _gather_beams(tree, parent, B: int, k: int, shared: frozenset = frozenset()):
    """Reindex (B*k, ...) state by parent (B, k) beam indices; shared
    entries are the same for every beam, so they stay as they are."""
    flat = (parent + torch.arange(B, device=parent.device)[:, None] * k).reshape(-1)
    return _per_entry(lambda x: x.index_select(0, flat), tree, shared)


def beam_decode(
    step_fn: Callable,
    params,
    state,
    *,
    start_id,
    end_id: int,
    max_len: int,
    beam_width: int,
    pad_id: int = 0,
    min_len: int = 0,
    banned_ids: tuple = (),
    no_repeat_ngram_size: int = 0,
    length_normalize: bool = True,
    alpha: float = 1.0,
    length_penalty: str = "simple",
    decoder=None,
    approx_topk: bool = False,
    init_scores=None,
) -> BeamResult:
    """Beam-search a batch. ``step_fn(params, state, token) -> (logits,
    state)`` where state leaves carry a leading hypothesis axis. Pass
    ``decoder`` to keep its ``beam_shared_keys`` untiled.

    ``start_id`` may be a scalar or a (B,) tensor; ``init_scores`` (B,)
    shifts every slot's score (rank-invariant within a row)."""
    del approx_topk  # see the module docstring
    k = beam_width
    leaf = tree_leaves(state)[0]
    B, device = leaf.shape[0], leaf.device
    shared = _shared_keys(decoder, state)
    state = _tile_state(state, k, shared)
    ngram = no_repeat_ngram_size
    # Each hypothesis's generated tokens, for the n-gram ban only.
    seqs = torch.full((B, k, max_len), pad_id, dtype=torch.long, device=device) if ngram else None

    words_acc = torch.full((max_len, B, k), pad_id, dtype=torch.long, device=device)
    parents_acc = torch.arange(k, device=device).expand(max_len, B, k).clone()
    scores = _start_scores(B, k, device, init_scores)
    last = torch.as_tensor(start_id, dtype=torch.long, device=device)
    last = last.expand(B).repeat_interleave(k)
    finished = torch.zeros((B, k), dtype=torch.bool, device=device)
    lengths = torch.zeros((B, k), dtype=torch.long, device=device)
    frozen_rank = torch.full((k,), NEG_INF, dtype=torch.float32, device=device)
    frozen_rank[0] = 0.0

    t = 0
    while t < max_len:
        logits, new_state = step_fn(params, state, last)  # (B*k, V)
        # Lazy log-softmax: per-beam top-k on the masked raw logits, the
        # logsumexp correction applied to the k survivors only.
        lse = torch.logsumexp(logits.float(), dim=-1)
        masked = logits.clone()
        masked[:, pad_id] = NEG_INF
        masked = apply_banned(masked, banned_ids)
        if ngram:
            masked = apply_ngram_ban(masked, seqs.reshape(B * k, max_len), t, ngram)
        masked = min_len_mask(masked, t, min_len, end_id)
        pb_vals, pb_words = topk_stable(masked, k)  # stage 1: (B*k, k)
        pb_logp = (pb_vals.float() - lse[:, None]).reshape(B, k, k)
        pb_words = pb_words.reshape(B, k, k)

        # Frozen beams contribute one candidate, pad at their rank-0 slot
        # with the score unchanged.
        fin = finished[:, :, None]
        cand = torch.where(
            fin,
            scores[:, :, None] + frozen_rank,
            scores[:, :, None] + pb_logp,
        )
        cand_words = torch.where(fin, pad_id, pb_words)

        # Stage 2: merge the k*k survivors; candidates stay grouped by
        # parent, so the flat order is (parent, word) on ties.
        top_scores, idx2 = topk_stable(cand.reshape(B, k * k), k)
        parent = idx2 // k
        word = cand_words.reshape(B, k * k).gather(1, idx2)

        parent_finished = finished.gather(1, parent)
        lengths = lengths.gather(1, parent) + (~parent_finished).long()
        word = torch.where(parent_finished, pad_id, word)
        words_acc[t] = word
        parents_acc[t] = parent
        finished = parent_finished | (word == end_id)
        scores = top_scores
        state = _gather_beams(new_state, parent, B, k, shared)
        last = word.reshape(B * k)
        if ngram:
            # Re-gathered by parent, this step's word appended (pad for a
            # frozen slot, which never expands again).
            seqs = seqs.gather(1, parent[:, :, None].expand(B, k, max_len)).clone()
            seqs[:, :, t] = word
        t += 1
        if t % EXIT_CHECK_EVERY == 0 and bool(finished.all()):
            break

    # Reconstruct (B, k, max_len) by walking the parent pointers backwards.
    ptr = torch.arange(k, device=device).expand(B, k)
    toks = []
    for s in range(t - 1, -1, -1):
        toks.append(words_acc[s].gather(1, ptr))
        ptr = parents_acc[s].gather(1, ptr)
    tokens = torch.full((B, k, max_len), pad_id, dtype=torch.long, device=device)
    if toks:
        tokens[:, :, :t] = torch.stack(toks[::-1], dim=-1)

    rank_scores = scores
    if init_scores is not None:
        rank_scores = scores - torch.as_tensor(
            init_scores, dtype=torch.float32, device=device
        )[:, None]
    norm = normalized_scores(
        rank_scores,
        lengths,
        length_normalize=length_normalize,
        alpha=alpha,
        length_penalty=length_penalty,
    )
    best = torch.argmax(norm, dim=1)  # ties -> lowest slot
    rows = torch.arange(B, device=device)
    return BeamResult(
        tokens=tokens[rows, best],
        lengths=lengths[rows, best],
        scores=scores[rows, best],
        beam_tokens=tokens,
        beam_lengths=lengths,
        beam_scores=scores,
    )
