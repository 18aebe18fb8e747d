"""Diverse beam search (Vijayakumar et al., AAAI 2018; port of
``tpucap.decode.diverse``): grouped beams with a Hamming diversity
penalty.

The beam budget is split into G groups of k' beams. At every step the
groups select in order, and group g's candidate scores are penalized by
``diversity * n(v)``, where ``n(v)`` counts how many times token ``v`` was
already emitted at this step by groups 0..g-1; each group keeps exact beam
bookkeeping inside (``decode/beam.py``'s frozen slots, backpointers, tie
order, min_len masking and ``beam_shared_keys``). All groups advance every
step (no stagger).

One model step scores all B*G*k' hypotheses (on the card, for a 1-layer
merge decoder, kernels K2 + K3 at B*G*k' rows); the group-ordered
selection is a Python loop of G small (B, k'*k') top-k stages. As in the
port's other engines the search is a Python loop of eager steps that asks
the device every ``EXIT_CHECK_EVERY`` steps whether every beam has ended.

The penalty shapes selection only: a parallel "selection score" carries
the accumulated penalties, while the reported and ranking scores stay true
log-prob sums under the full softmax. The true step score is formed as
tpucap forms it, ``(pb_vals - lse) + diversity * n_sel``, so scores agree
within f32 rounding and rankings exactly. With diversity=0 or
num_groups=1 every group is exactly a standard beam search of width k'.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from tpucap_torch.core import tree_leaves
from tpucap_torch.decode.beam import (
    EXIT_CHECK_EVERY,
    NEG_INF,
    _gather_beams,
    _shared_keys,
    _start_scores,
    _tile_state,
    apply_banned,
    min_len_mask,
    normalized_scores,
    topk_stable,
)
from tpucap_torch.decode.ngram import apply_ngram_ban


@dataclasses.dataclass
class DiverseBeamResult:
    """tokens: (B, G, max_len) each group's best beam; lengths/scores:
    (B, G) (scores = raw true log-prob sums); beam_*: all beams,
    (B, G, k', ...)."""

    tokens: Any
    lengths: Any
    scores: Any
    beam_tokens: Any
    beam_lengths: Any
    beam_scores: Any


def diverse_beam_decode(
    step_fn: Callable,
    params,
    state,
    *,
    start_id: int,
    end_id: int,
    max_len: int,
    num_groups: int,
    group_width: int,
    diversity: float = 0.5,
    pad_id: int = 0,
    min_len: int = 0,
    banned_ids: tuple = (),
    no_repeat_ngram_size: int = 0,
    length_normalize: bool = True,
    alpha: float = 1.0,
    length_penalty: str = "simple",
    decoder=None,
) -> DiverseBeamResult:
    """Diverse beam search over ``num_groups`` groups of ``group_width``
    beams. ``step_fn(params, state, token) -> (logits, state)`` as for
    ``beam_decode``; state rows are laid out image-major, then group, then
    beam. ``diversity`` is the Hamming penalty strength (lambda); 0 makes
    every group an independent standard beam.

    ``no_repeat_ngram_size`` > 0 bans, per hypothesis, the completions of
    n-grams it already generated (``decode/ngram.py``), from a (B, G, k',
    max_len) history re-gathered by parent every step."""
    if num_groups < 1 or group_width < 1:
        raise ValueError(
            f"need num_groups >= 1 and group_width >= 1, got "
            f"{num_groups}x{group_width}"
        )
    G, kg = num_groups, group_width
    K = G * kg
    leaf = tree_leaves(state)[0]
    B, device = leaf.shape[0], leaf.device
    shared = _shared_keys(decoder, state)
    state = _tile_state(state, K, shared)
    lam = float(diversity)
    ngram = no_repeat_ngram_size
    seqs = (
        torch.full((B, G, kg, max_len), pad_id, dtype=torch.long, device=device)
        if ngram else None
    )

    words_acc = torch.full((max_len, B, G, kg), pad_id, dtype=torch.long, device=device)
    parents_acc = torch.arange(kg, device=device).expand(max_len, B, G, kg).clone()
    start = _start_scores(B * G, kg, device).reshape(B, G, kg)
    sel_scores, true_scores = start, start.clone()
    last = torch.full((B * K,), start_id, dtype=torch.long, device=device)
    finished = torch.zeros((B, G, kg), dtype=torch.bool, device=device)
    lengths = torch.zeros((B, G, kg), dtype=torch.long, device=device)
    frozen_rank = torch.full((kg,), NEG_INF, dtype=torch.float32, device=device)
    frozen_rank[0] = 0.0

    t = 0
    while t < max_len:
        logits, new_state = step_fn(params, state, last)  # (B*K, V)
        V = logits.shape[-1]
        lse = torch.logsumexp(logits.float(), dim=-1).reshape(B, G, kg)
        masked = logits.clone()
        masked[:, pad_id] = NEG_INF
        masked = apply_banned(masked, banned_ids)
        if ngram:
            masked = apply_ngram_ban(masked, seqs.reshape(B * K, max_len), t, ngram)
        masked = min_len_mask(masked, t, min_len, end_id).reshape(B, G, kg, V)

        # This step's cross-group token counts: the diversity state. f32
        # small integers, exact in any order of summation.
        n = torch.zeros((B, V), dtype=torch.float32, device=device)
        out_w, out_p, out_fin, out_len, out_sel, out_true = [], [], [], [], [], []
        for g in range(G):
            m_g = masked[:, g].float()  # (B, kg, V)
            pen_logits = m_g - lam * n[:, None, :]
            pb_vals, pb_words = topk_stable(pen_logits, kg)  # stage 1: (B, kg, kg)
            pen_logp = pb_vals - lse[:, g][:, :, None]
            # Reported scores stay true log-probs: the selected tokens'
            # penalty added back.
            n_sel = n.gather(1, pb_words.reshape(B, kg * kg)).reshape(B, kg, kg)
            true_logp = pen_logp + lam * n_sel

            fin_g = finished[:, g][:, :, None]
            sel_g, true_g = sel_scores[:, g], true_scores[:, g]
            cand_sel = torch.where(
                fin_g, sel_g[:, :, None] + frozen_rank, sel_g[:, :, None] + pen_logp
            )
            cand_true = torch.where(
                fin_g, true_g[:, :, None] + frozen_rank, true_g[:, :, None] + true_logp
            )
            cand_words = torch.where(fin_g, pad_id, pb_words)

            # Stage 2 over the k'*k' survivors, grouped by parent.
            top_sel, idx2 = topk_stable(cand_sel.reshape(B, kg * kg), kg)
            parent = idx2 // kg
            word = cand_words.reshape(B, kg * kg).gather(1, idx2)
            new_true = cand_true.reshape(B, kg * kg).gather(1, idx2)

            parent_finished = finished[:, g].gather(1, parent)
            emit = ~parent_finished
            word = torch.where(parent_finished, pad_id, word)
            len_g = lengths[:, g].gather(1, parent) + emit.long()
            fin_next = parent_finished | (word == end_id)

            # This group's live emissions count for the later groups
            # (end_id counts; pad never does: frozen slots do not emit).
            n.scatter_add_(1, word, emit.float())

            out_w.append(word)
            out_p.append(parent)
            out_fin.append(fin_next)
            out_len.append(len_g)
            out_sel.append(top_sel)
            out_true.append(new_true)

        word_all = torch.stack(out_w, dim=1)  # (B, G, kg)
        parent_all = torch.stack(out_p, dim=1)
        words_acc[t] = word_all
        parents_acc[t] = parent_all
        state = _gather_beams(new_state, parent_all.reshape(B * G, kg), B * G, kg, shared)
        last = word_all.reshape(B * K)
        finished = torch.stack(out_fin, dim=1)
        lengths = torch.stack(out_len, dim=1)
        sel_scores = torch.stack(out_sel, dim=1)
        true_scores = torch.stack(out_true, dim=1)
        if ngram:
            # Re-gathered by parent within each group, this step's words
            # appended (pad for frozen slots, which never expand again).
            seqs = seqs.gather(2, parent_all[..., None].expand(B, G, kg, max_len)).clone()
            seqs[..., t] = word_all
        t += 1
        if t % EXIT_CHECK_EVERY == 0 and bool(finished.all()):
            break

    # Backpointers walked backwards, groups flattened into the batch
    # (parents index within their group).
    ptr = torch.arange(kg, device=device).expand(B * G, kg)
    toks = []
    for s in range(t - 1, -1, -1):
        toks.append(words_acc[s].reshape(B * G, kg).gather(1, ptr))
        ptr = parents_acc[s].reshape(B * G, kg).gather(1, ptr)
    tokens = torch.full((B * G, kg, max_len), pad_id, dtype=torch.long, device=device)
    if toks:
        tokens[:, :, :t] = torch.stack(toks[::-1], dim=-1)
    tokens = tokens.reshape(B, G, kg, max_len)

    norm = normalized_scores(
        true_scores,
        lengths,
        length_normalize=length_normalize,
        alpha=alpha,
        length_penalty=length_penalty,
    )
    best = torch.argmax(norm, dim=-1)  # (B, G); ties -> lowest slot
    pick = lambda a: a.gather(  # noqa: E731
        2, best.reshape((B, G, 1) + (1,) * (a.ndim - 3)).expand((B, G, 1) + a.shape[3:])
    ).squeeze(2)
    return DiverseBeamResult(
        tokens=pick(tokens),
        lengths=pick(lengths),
        scores=pick(true_scores),
        beam_tokens=tokens,
        beam_lengths=lengths,
        beam_scores=true_scores,
    )
