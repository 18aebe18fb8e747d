"""Continuous batching for BEAM search: group recycling over k-lane pools
(port of ``tpucap.decode.continuous_beam``).

Extends the greedy slot-recycling engine (continuous.py) to beam decode:
each request occupies a GROUP of ``beam_width`` lanes that run the exact
``beam_decode`` bookkeeping (frozen slots, lazy log-softmax, the two-stage
top-k, backpointers), and a group retires the moment every one of its beams
is finished, freeing its lanes for the next queued request. The per-step
arithmetic is transcribed from the port's ``decode/beam.py``, so a group's
result is ``beam_decode``'s on the same features whenever it was admitted:
both top-k stages go through ``topk_stable`` (``torch.topk`` promises no
tie order), and ``approx_topk`` (a TPU custom call in the JAX package)
maps to the exact top-k, as in beam.py.

``decoder.beam_shared_keys`` (the attention decoder's per-image grids) are
stored ONE row per group, never tiled k-fold and never gathered by parent.

Same fixed-shape host API as ContinuousDecodeEngine (admit / tick / flags /
progress / collect over group indices, padded to a bucket ladder whose pad
rows are dropped on the host), so ContinuousCaptionServer drives either
engine unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpucap_torch.core import tree_map
from tpucap_torch.decode.beam import (
    NEG_INF,
    apply_banned,
    min_len_mask,
    normalized_scores,
    topk_stable,
)
from tpucap_torch.decode.continuous import (
    AdmissionMixin,
    _bucket_ladder,
    _device_of,
    _mask_tree,
    _real_rows,
)
from tpucap_torch.decode.ngram import apply_ngram_ban


@dataclasses.dataclass
class BeamSlotState:
    dec: Any  # decoder state tree; leaves (R*k, ...), shared keys (R, ...)
    last: Any  # (R*k,) int64
    t: Any  # (R,) int64 per-group step counter
    scores: Any  # (R, k) f32 raw log-prob sums
    beam_finished: Any  # (R, k) bool: frozen beam slots
    lengths: Any  # (R, k) int64
    words: Any  # (R, max_len, k) int64 emitted word per step
    parents: Any  # (R, max_len, k) int64 backpointers
    seqs: Any  # (R, k, max_len) per-hypothesis history (ngram dial; (R, k, 1) when off)
    active: Any  # (R,) bool: live request group
    finished: Any  # (R,) bool: group done, awaiting collection


def _backtrack(words, parents):
    """(G, L, k) words and backpointers -> (G, k, L) sequences, walked
    backwards from each final slot (beam.py's reconstruction)."""
    G, L, k = words.shape
    ptr = torch.arange(k, device=words.device).expand(G, k)
    toks = []
    for s in range(L - 1, -1, -1):
        toks.append(words[:, s].gather(1, ptr))
        ptr = parents[:, s].gather(1, ptr)
    return torch.stack(toks[::-1], dim=-1)


class ContinuousBeamEngine(AdmissionMixin):
    """Device half of a continuous-batching beam server. ``slots`` is the
    number of GROUPS (concurrent requests); the lane count is slots * k."""

    def __init__(
        self,
        decoder,
        params,
        *,
        slots: int,
        beam_width: int,
        start_id: int,
        end_id: int,
        max_len: int,
        pad_id: int = 0,
        min_len: int = 0,
        banned_ids: tuple = (),
        no_repeat_ngram_size: int = 0,
        length_normalize: bool = True,
        alpha: float = 1.0,
        length_penalty: str = "simple",
        approx_topk: bool = False,
        feature_shape: tuple | None = None,
        feature_dtype=torch.float32,
        step_fn=None,
        precision: str | None = None,
    ):
        del approx_topk  # see the module docstring
        self.decoder = decoder
        self.params = tree_map(lambda t: t, params)  # the engine's own tree
        self.step_fn = step_fn or decoder.step
        self.device = _device_of(params)
        self.slots = slots
        self.k = beam_width
        self.start_id = start_id
        self.end_id = end_id
        self.max_len = max_len
        self.pad_id = pad_id
        self.min_len = min_len
        self.banned_ids = tuple(banned_ids)
        self.no_repeat_ngram_size = no_repeat_ngram_size
        self.length_normalize = length_normalize
        self.alpha = alpha
        self.length_penalty = length_penalty
        self.feature_shape = tuple(feature_shape or (decoder.feature_dim,))
        self.feature_dtype = feature_dtype
        self.precision = precision
        self._admit_buckets = _bucket_ladder(slots)
        # Per-step constants: a frozen beam's one candidate (pad at rank 0,
        # score unchanged), and each group's first lane.
        self._frozen_rank = torch.full((beam_width,), NEG_INF, dtype=torch.float32, device=self.device)
        self._frozen_rank[0] = 0.0
        self._first_lane = torch.arange(slots, device=self.device)[:, None] * beam_width

    def _shared(self, state) -> frozenset:
        keys = getattr(self.decoder, "beam_shared_keys", frozenset())
        if isinstance(state, dict):
            return frozenset(k for k in keys if k in state)
        return frozenset()

    def _per_entry(self, fn_shared, fn_lane, tree, *rest):
        """``fn_shared`` on the shared entries' leaves, ``fn_lane`` on the
        others' (leaves of ``rest`` trees side by side)."""
        shared = self._shared(tree)
        if isinstance(tree, dict) and shared:
            return {
                key: tree_map(fn_shared if key in shared else fn_lane, v, *(r[key] for r in rest))
                for key, v in tree.items()
            }
        return tree_map(fn_lane, tree, *rest)

    # -- state ----------------------------------------------------------------

    @torch.inference_mode()
    def init_state(self) -> BeamSlotState:
        R, k, L, dev = self.slots, self.k, self.max_len, self.device
        feats = torch.zeros((R,) + self.feature_shape, dtype=self.feature_dtype, device=dev)
        with self._precision():
            dec_r = self.decoder.init_state(self.params, feats)
        dec = self._per_entry(lambda x: x, lambda x: x.repeat_interleave(k, dim=0), dec_r)
        long = dict(dtype=torch.long, device=dev)
        return BeamSlotState(
            dec=dec,
            last=torch.full((R * k,), self.start_id, **long),
            t=torch.zeros((R,), **long),
            scores=torch.zeros((R, k), dtype=torch.float32, device=dev),
            beam_finished=torch.zeros((R, k), dtype=torch.bool, device=dev),
            lengths=torch.zeros((R, k), **long),
            words=torch.full((R, L, k), self.pad_id, **long),
            parents=torch.arange(k, **long).expand(R, L, k).clone(),
            seqs=torch.full((R, k, L if self.no_repeat_ngram_size else 1), self.pad_id, **long),
            active=torch.zeros((R,), dtype=torch.bool, device=dev),
            finished=torch.zeros((R,), dtype=torch.bool, device=dev),
        )

    # -- device operations ------------------------------------------------------

    @torch.inference_mode()
    def admit(self, state: BeamSlotState, group_idx, features) -> BeamSlotState:
        """Write K new requests into groups ``group_idx`` ((K,) host ints;
        pad rows carry an index >= slots and are dropped). Non-shared state
        is tiled beam-major to the group's k lanes."""
        k, dev = self.k, self.device
        with self._precision():
            new_r = self.decoder.init_state(self.params, features)
        rows, groups = _real_rows(group_idx, self.slots, dev)
        lanes = (groups[:, None] * k + torch.arange(k, device=dev)).reshape(-1)
        lane_rows = rows.repeat_interleave(k)
        dec = self._per_entry(
            lambda buf, new: buf.index_copy(0, groups, new.index_select(0, rows)),
            lambda buf, new: buf.index_copy(0, lanes, new.index_select(0, lane_rows)),
            state.dec, new_r,
        )
        n = groups.shape[0]
        scores0 = torch.full((n, k), NEG_INF, dtype=torch.float32, device=dev)
        scores0[:, 0] = 0.0
        parents0 = torch.arange(k, dtype=torch.long, device=dev).expand(n, self.max_len, k)
        fill = lambda buf, v: buf.index_fill(0, groups, v)  # noqa: E731
        return BeamSlotState(
            dec=dec,
            last=state.last.index_fill(0, lanes, self.start_id),
            t=fill(state.t, 0),
            scores=state.scores.index_copy(0, groups, scores0),
            beam_finished=fill(state.beam_finished, False),
            lengths=fill(state.lengths, 0),
            words=fill(state.words, self.pad_id),
            parents=state.parents.index_copy(0, groups, parents0),
            seqs=fill(state.seqs, self.pad_id),
            active=fill(state.active, True),
            finished=fill(state.finished, False),
        )

    @torch.inference_mode()
    def tick(self, state: BeamSlotState, n: int = 1) -> BeamSlotState:
        """``n`` beam steps for every group: beam.py's body with B = R
        groups, inactive groups' commits masked out."""
        with self._precision():
            for _ in range(n):
                state = self._step(state)
        return state

    def _step(self, state: BeamSlotState) -> BeamSlotState:
        R, k, L = self.slots, self.k, self.max_len
        ngram = self.no_repeat_ngram_size
        logits, new_dec = self.step_fn(self.params, state.dec, state.last)  # (R*k, V)
        lse = torch.logsumexp(logits.float(), dim=-1)
        masked = logits.clone()
        masked[:, self.pad_id] = NEG_INF
        masked = apply_banned(masked, self.banned_ids)
        lane_t = state.t.repeat_interleave(k)  # each lane at its group's step
        if ngram:
            masked = apply_ngram_ban(masked, state.seqs.reshape(R * k, L), lane_t, ngram)
        masked = min_len_mask(masked, lane_t, self.min_len, self.end_id)
        pb_vals, pb_words = topk_stable(masked, k)  # stage 1: (R*k, k)
        pb_logp = (pb_vals.float() - lse[:, None]).reshape(R, k, k)
        pb_words = pb_words.reshape(R, k, k)

        fin = state.beam_finished[:, :, None]
        cand = torch.where(
            fin, state.scores[:, :, None] + self._frozen_rank, state.scores[:, :, None] + pb_logp
        )
        cand_words = torch.where(fin, self.pad_id, pb_words)
        top_scores, idx2 = topk_stable(cand.reshape(R, k * k), k)  # stage 2
        parent = idx2 // k
        word = cand_words.reshape(R, k * k).gather(1, idx2)

        parent_finished = state.beam_finished.gather(1, parent)
        lengths = state.lengths.gather(1, parent) + (~parent_finished).long()
        word = torch.where(parent_finished, self.pad_id, word)
        beam_finished = parent_finished | (word == self.end_id)
        act = state.active
        act_g = act[:, None]
        pos = torch.clamp(state.t, max=L - 1)[:, None, None].expand(R, 1, k)

        def put_step(buf, value):  # buf (R, L, k): value at each group's step
            return buf.scatter(1, pos, torch.where(act_g, value, buf.gather(1, pos)[:, 0])[:, None])

        # Parent lanes' decoder state (beam.py _gather_beams); a group's
        # shared entries are the same for every lane, so only the commit
        # mask applies to them.
        flat = (parent + self._first_lane).reshape(-1)
        act_lane = act.repeat_interleave(k)
        dec = self._per_entry(
            lambda new, old: _mask_tree(act, new, old),
            lambda new, old: _mask_tree(act_lane, new.index_select(0, flat), old),
            new_dec, state.dec,
        )
        seqs = state.seqs
        if ngram:
            # Re-gathered by parent, this step's word appended at the
            # group's position; inactive groups keep their rows.
            new_seqs = seqs.gather(1, parent[:, :, None].expand(R, k, L))
            new_seqs = new_seqs.scatter(2, pos[:, 0, :, None], word[:, :, None])
            seqs = torch.where(act[:, None, None], new_seqs, seqs)
        t = state.t + act.long()
        group_done = act & (beam_finished.all(dim=1) | (t >= L))
        return BeamSlotState(
            dec=dec,
            last=torch.where(act_lane, word.reshape(R * k), state.last),
            t=t,
            scores=torch.where(act_g, top_scores, state.scores),
            beam_finished=torch.where(act_g, beam_finished, state.beam_finished),
            lengths=torch.where(act_g, lengths, state.lengths),
            words=put_step(state.words, word),
            parents=put_step(state.parents, parent),
            seqs=seqs,
            active=act & ~group_done,
            finished=state.finished | group_done,
        )

    def flags(self, state: BeamSlotState):
        """Small host fetch: (finished, active, t), on the device."""
        return state.finished, state.active, state.t

    @torch.inference_mode()
    def progress(self, state: BeamSlotState):
        """Streaming fetch: each group's STABLE PREFIX so far, ``(tokens
        (R, max_len), stable_len (R,))``, the greedy engine's contract.

        Every beam slot at step t+1 is a frozen copy of, or extends, one of
        the k slots at step t, so whichever slot wins at retirement carries
        the longest common prefix of the CURRENT k slots: that prefix can
        only grow and never has to be retracted. Frozen slots take part at
        their full final length (conservative); the retirement flush
        (ContinuousCaptionServer._retire) delivers the rest."""
        L = self.max_len
        tokens = _backtrack(state.words, state.parents)  # (R, k, L)
        pos = torch.arange(L, device=self.device)
        valid = pos[None, None, :] < state.lengths[:, :, None]  # (R, k, L)
        # A position is stable iff every slot has a real token there and
        # all k agree on it.
        agree = (tokens == tokens[:, :1, :]).all(dim=1) & valid.all(dim=1)  # (R, L)
        stable_len = torch.cumprod(agree.long(), dim=1).sum(dim=1)
        return tokens[:, 0, :], stable_len

    @torch.inference_mode()
    def collect(self, state: BeamSlotState, group_idx):
        """Gather groups ``group_idx``, rebuild their sequences from the
        backpointers, rank by the engine's length normalization (ties to
        the lowest slot), clear their finished bits. -> ((tokens (K,
        max_len), lengths (K,), scores (K,)), state). Pad rows gather a
        clamped group, garbage the host discards, and clear nothing."""
        idx = torch.as_tensor(np.asarray(group_idx), dtype=torch.long)
        gather = idx.clamp(max=self.slots - 1).to(self.device)
        lengths = state.lengths.index_select(0, gather)  # (K, k)
        scores = state.scores.index_select(0, gather)
        tokens = _backtrack(state.words.index_select(0, gather), state.parents.index_select(0, gather))
        norm = normalized_scores(
            scores, lengths, length_normalize=self.length_normalize,
            alpha=self.alpha, length_penalty=self.length_penalty,
        )
        best = torch.argmax(norm, dim=1)
        rows = torch.arange(gather.shape[0], device=self.device)
        _, groups = _real_rows(idx, self.slots, self.device)
        cleared = dataclasses.replace(state, finished=state.finished.index_fill(0, groups, False))
        return (tokens[rows, best], lengths[rows, best], scores[rows, best]), cleared
