"""Constrained beam search (Anderson et al., EMNLP 2017; port of
``tpucap.decode.constrained``): captions that MUST include given words.

For C single-word constraints there are S = 2^C satisfaction banks, each
holding its own beam of k hypotheses; emitting an unsatisfied constraint
word w_i moves a hypothesis from bank s to bank s | {i}, and the answer is
the best finished hypothesis of the most-satisfied reachable bank (the
paper's fallback when full satisfaction is unreachable). The complement
dial, words that must NOT appear, is ``banned_ids``.

The bank axis rides the hypothesis axis: one model step scores all B*S*k
hypotheses, and the per-bank selection is a Python loop over the S banks
(the JAX package unrolls the same loop at trace time):

- bank t's "stay" candidates are its own beams' per-hypothesis top-k over
  the masked logits, every UNSATISFIED constraint word masked out (emitting
  one cannot stay in t);
- bank t's "arrival" candidates, for each i in t, are bank t\\{i}'s
  hypotheses extended by exactly w_i, scored from the RAW logits (before
  the pad, banned and min_len masks), as the JAX package does.

Backpointers are global hypothesis indices in [0, S*k). The per-step
arithmetic is ``decode/beam.py``'s (``apply_banned``, ``min_len_mask``,
``topk_stable`` for both top-k stages, ``_gather_beams``, ``NEG_INF``), so
ties break at the lowest index as ``lax.top_k`` does: dead banks are all
NEG_INF and tie everywhere. A slot of score NEG_INF (unreachable) stays
dead: in f32 NEG_INF + logp absorbs back to NEG_INF.

The JAX package's while loop stops at the first step where no slot is live.
After that step a dead slot would still take words and grow its length, so
the loop here asks the device for that condition before every step (one
host sync a step), and every slot's tokens, lengths and scores equal the
JAX package's.

The final ranking is two-stage: the largest satisfaction count among
reachable slots, then the normalized score's argmax at that count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from tpucap_torch.core import tree_leaves
from tpucap_torch.decode.beam import (
    NEG_INF,
    _gather_beams,
    _shared_keys,
    _tile_state,
    apply_banned,
    min_len_mask,
    normalized_scores,
    topk_stable,
)

MAX_CONSTRAINTS = 4  # 2^C banks ride the step batch; 16x is the ceiling


@dataclasses.dataclass
class ConstrainedBeamResult:
    """tokens: (B, max_len) the winning caption; lengths/scores: (B,)
    (scores = raw log-prob sums); satisfied: (B, C) bool per constraint
    slot (padded slots read True: they were pre-satisfied); num_satisfied:
    (B,); beam_*: every bank's beams, (B, S, k, ...), bank index bit i set
    == constraint i satisfied."""

    tokens: Any
    lengths: Any
    scores: Any
    satisfied: Any
    num_satisfied: Any
    beam_tokens: Any
    beam_lengths: Any
    beam_scores: Any


def _unreachable(scores):
    return scores < (NEG_INF / 2)


def constrained_beam_decode(
    step_fn: Callable,
    params,
    state,
    *,
    start_id: int,
    end_id: int,
    max_len: int,
    beam_width: int,
    constraint_ids,
    pad_id: int = 0,
    min_len: int = 0,
    banned_ids: tuple = (),
    length_normalize: bool = True,
    alpha: float = 1.0,
    length_penalty: str = "simple",
    decoder=None,
) -> ConstrainedBeamResult:
    """Beam-search a batch under must-include word constraints.

    ``step_fn(params, state, token) -> (logits, state)`` as for beam_decode.
    ``constraint_ids`` is (C,) or (B, C): the token ids each row's caption
    must hold; a ``pad_id`` entry is an unused slot for that row (it starts
    pre-satisfied). Returns the best hypothesis of the most-satisfied
    reachable bank per row; scores are true log-prob sums."""
    k = beam_width
    leaf = tree_leaves(state)[0]
    B, device = leaf.shape[0], leaf.device
    cids = torch.as_tensor(constraint_ids, dtype=torch.long, device=device)
    if cids.ndim == 1:
        cids = cids[None, :]
    C = cids.shape[-1]
    if not 1 <= C <= MAX_CONSTRAINTS:
        raise ValueError(
            f"need 1 <= C <= {MAX_CONSTRAINTS} constraint slots, got {C} "
            "(each slot doubles the step batch; pad unused slots with "
            "pad_id instead of widening C)"
        )
    S = 1 << C
    SK = S * k
    cids = cids.expand(B, C)
    shared = _shared_keys(decoder, state)
    state = _tile_state(state, SK, shared)

    # Pre-satisfied slots (pad_id = unused): the row's live seed sits in the
    # bank whose bits are exactly its pre-satisfied set.
    bit = 1 << torch.arange(C, device=device)
    bank0 = ((cids == pad_id).long() * bit).sum(-1)  # (B,)
    hyp = torch.arange(SK, device=device)
    words_acc = torch.full((max_len, B, SK), pad_id, dtype=torch.long, device=device)
    # Identity global backpointers: steps after the exit are pass-through.
    parents_acc = hyp.expand(max_len, B, SK).clone()
    slot_live = torch.full((k,), NEG_INF, dtype=torch.float32, device=device)
    slot_live[0] = 0.0  # rank stagger within the seed bank
    in_seed = (torch.arange(S, device=device)[None, :] == bank0[:, None])[:, :, None]
    scores = torch.where(in_seed, slot_live, torch.tensor(NEG_INF, device=device))  # (B, S, k)
    finished = torch.zeros((B, S, k), dtype=torch.bool, device=device)
    lengths = torch.zeros((B, S, k), dtype=torch.long, device=device)
    last = torch.full((B * SK,), start_id, dtype=torch.long, device=device)
    frozen_rank = torch.full((k,), NEG_INF, dtype=torch.float32, device=device)
    frozen_rank[0] = 0.0
    iota_v = None
    slots = torch.arange(k, device=device)

    t = 0
    while t < max_len and bool((~(finished | _unreachable(scores))).any()):
        logits, new_state = step_fn(params, state, last)  # (B*S*k, V)
        V = logits.shape[-1]
        lse = torch.logsumexp(logits.float(), dim=-1).reshape(B, S, k)
        base = logits.clone()
        base[:, pad_id] = NEG_INF
        base = apply_banned(base, banned_ids)
        base = min_len_mask(base, t, min_len, end_id).reshape(B, S, k, V)
        logits_r = logits.reshape(B, S, k, V)
        if iota_v is None:
            iota_v = torch.arange(V, device=device)
            # Per-constraint word-match masks (per-row ids).
            eq = [iota_v[None, :] == cids[:, i][:, None] for i in range(C)]  # (B, V)

        out_w, out_gp, out_fin, out_len, out_sc = [], [], [], [], []
        for tbank in range(S):
            # Stay candidates: bank t's own top-k with its unsatisfied
            # constraint words excluded, ranked in the logits' own dtype.
            m = base[:, tbank]  # (B, k, V)
            for i in range(C):
                if not tbank & (1 << i):
                    m = m.masked_fill(eq[i][:, None, :], NEG_INF)
            pb_vals, pb_words = topk_stable(m, k)  # (B, k, k)
            pb_logp = pb_vals.float() - lse[:, tbank][:, :, None]
            fin_t = finished[:, tbank][:, :, None]
            sc_t = scores[:, tbank][:, :, None]
            stay = torch.where(fin_t, sc_t + frozen_rank, sc_t + pb_logp)
            stay_words = torch.where(fin_t, pad_id, pb_words)
            stay_parent = (tbank * k + slots)[None, :, None].expand(B, k, k)
            cand = [stay.reshape(B, k * k)]
            cand_w = [stay_words.reshape(B, k * k)]
            cand_p = [stay_parent.reshape(B, k * k)]

            # Arrival candidates: for each satisfied bit i, bank t\{i}'s
            # hypotheses extended by exactly w_i.
            for i in range(C):
                if not tbank & (1 << i):
                    continue
                sbank = tbank & ~(1 << i)
                wi = cids[:, i]
                arr_logit = logits_r[:, sbank].gather(-1, wi[:, None, None].expand(B, k, 1))[..., 0]
                arr_logp = arr_logit.float() - lse[:, sbank]
                cand.append(torch.where(finished[:, sbank], NEG_INF, scores[:, sbank] + arr_logp))
                cand_w.append(wi[:, None].expand(B, k))
                cand_p.append((sbank * k + slots)[None, :].expand(B, k))

            top_sc, idx2 = topk_stable(torch.cat(cand, dim=1), k)
            word = torch.cat(cand_w, dim=1).gather(1, idx2)
            gparent = torch.cat(cand_p, dim=1).gather(1, idx2)
            pf = finished.reshape(B, SK).gather(1, gparent)
            ln = lengths.reshape(B, SK).gather(1, gparent) + (~pf).long()
            word = torch.where(pf, pad_id, word)
            out_w.append(word)
            out_gp.append(gparent)
            out_fin.append(pf | (word == end_id))
            out_len.append(ln)
            out_sc.append(top_sc)

        word_all = torch.stack(out_w, dim=1)  # (B, S, k)
        gparent_all = torch.stack(out_gp, dim=1).reshape(B, SK)
        words_acc[t] = word_all.reshape(B, SK)
        parents_acc[t] = gparent_all
        state = _gather_beams(new_state, gparent_all, B, SK, shared)
        last = word_all.reshape(B * SK)
        finished = torch.stack(out_fin, dim=1)
        lengths = torch.stack(out_len, dim=1)
        scores = torch.stack(out_sc, dim=1)
        t += 1

    # Walk the global backpointers backwards.
    ptr = hyp.expand(B, SK)
    toks = []
    for s in range(t - 1, -1, -1):
        toks.append(words_acc[s].gather(1, ptr))
        ptr = parents_acc[s].gather(1, ptr)
    tokens = torch.full((B, SK, max_len), pad_id, dtype=torch.long, device=device)
    if toks:
        tokens[:, :, :t] = torch.stack(toks[::-1], dim=-1)

    # Two-stage final ranking: the largest satisfaction count among
    # reachable slots, then the normalized score's argmax at that count
    # (dead slots rank NEG_INF).
    norm = normalized_scores(
        scores, lengths, length_normalize=length_normalize, alpha=alpha,
        length_penalty=length_penalty,
    )
    popcount = torch.tensor([bin(s).count("1") for s in range(S)], device=device)
    reach = ~_unreachable(scores)
    pc = popcount[None, :, None].expand(B, S, k)
    best_pop = torch.where(reach, pc, -1).reshape(B, SK).amax(dim=1)
    rank = torch.where(reach & (pc == best_pop[:, None, None]), norm, NEG_INF)
    best = torch.argmax(rank.reshape(B, SK), dim=1)  # ties -> lowest slot
    satisfied = ((best // k)[:, None] >> torch.arange(C, device=device)[None, :]) & 1 == 1
    rows = torch.arange(B, device=device)
    return ConstrainedBeamResult(
        tokens=tokens[rows, best],
        lengths=lengths.reshape(B, SK)[rows, best],
        scores=scores.reshape(B, SK)[rows, best],
        satisfied=satisfied,
        num_satisfied=satisfied.long().sum(-1),
        beam_tokens=tokens.reshape(B, S, k, max_len),
        beam_lengths=lengths,
        beam_scores=scores,
    )
