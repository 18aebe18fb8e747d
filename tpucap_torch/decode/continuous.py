"""Continuous batching: slot-recycling greedy decode over a fixed pool
(port of ``tpucap.decode.continuous``).

The batch engines (greedy.py / beam.py) run a whole batch to completion; an
online server then pays head-of-line blocking: a finished caption's row
idles until the batch's slowest member ends. This engine keeps ONE
persistent device state of ``slots`` decode lanes and three operations on
it, all at fixed shapes:

- ``admit``: write freshly initialized decoder state into free lanes. The
  admission count is padded to a power-of-two ladder, as in tpucap, whose
  programs are compiled per bucket; pad rows carry the out-of-range slot
  index ``slots``. XLA's scatter drops such rows and its gather clamps
  them. PyTorch's index ops raise on them (a device-side assert on the
  card, which ends the process's CUDA context), so the pad rows are
  dropped on the host before any index op, and gathers clamp explicitly;
- ``tick``: greedy steps for every lane. Inactive lanes compute too (the
  shapes stay fixed) but every leaf of their state, their token and score
  writes are masked out with ``torch.where``;
- ``collect``: gather finished lanes' token rows for the host.

A lane's numerics are ``greedy_decode``'s (same pad-masked argmax, same
full-softmax normalizer for scores), so a continuous server and the offline
path caption identically. The step is the caller's ``step_fn`` (the
pipeline's: kernels K2 + K3 on the card for a 1-layer merge decoder), run
on the engine's own snapshot of the decoder params, taken when the engine
is built, as tpucap's jitted methods close over theirs. Every operation runs
under ``core.precision_flags(precision)`` when a precision is given, as the
pipeline's ``_decode`` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from tpucap_torch.core import precision_flags, tree_leaves, tree_map
from tpucap_torch.decode.beam import apply_banned, min_len_mask
from tpucap_torch.decode.ngram import apply_ngram_ban


def _mask_tree(mask, new, old):
    """where(mask, new, old) broadcast over each leaf's trailing dims."""

    def sel(n, o):
        return torch.where(mask.reshape(mask.shape + (1,) * (n.ndim - 1)), n, o)

    return tree_map(sel, new, old)


def _bucket_ladder(n: int) -> list:
    """Power-of-two admission ladder 1, 2, ..., n (n always included)."""
    out, b = [], 1
    while b < n:
        out.append(b)
        b *= 2
    out.append(n)
    return out


def _real_rows(idx, n: int, device):
    """(positions of the rows whose index is < n, those indices), both on
    ``device``: the pad rows (index >= n) dropped on the host."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.long)
    keep = torch.nonzero(idx < n).reshape(-1)
    return keep.to(device), idx[keep].to(device)


class AdmissionMixin:
    """Host-side admission helpers shared by the greedy and beam continuous
    engines: one definition of the bucket ladder and of the pad contract
    (serve.py's _retire relies on it)."""

    def admit_bucket(self, n: int) -> int:
        return next(b for b in self._admit_buckets if b >= n)

    def pad_ids(self, slot_ids: list) -> np.ndarray:
        """Slot indices padded to the bucket ladder: pad rows carry index
        == ``slots``, which admission drops and collection clamps to
        garbage the host discards."""
        b = self.admit_bucket(len(slot_ids))
        idx = np.full((b,), self.slots, np.int64)
        idx[: len(slot_ids)] = slot_ids
        return idx

    def pad_admission(self, slot_ids: list, feats: list):
        """(ids, features) padded to the bucket ladder; pad rows carry slot
        index == slots and zero features. ids stay on the host."""
        idx = self.pad_ids(slot_ids)
        out = np.zeros(idx.shape + tuple(self.feature_shape), np.float32)
        for i, f in enumerate(feats):
            out[i] = f
        return idx, torch.as_tensor(out).to(self.device, self.feature_dtype)

    def _precision(self):
        """The engine's precision block (a null block without one)."""
        if self.precision is None:
            return contextlib.nullcontext()
        return precision_flags(self.precision)


def _device_of(params):
    return tree_leaves(params)[0].device


@dataclasses.dataclass
class SlotState:
    dec: Any  # decoder state tree, leaves (S, ...)
    last: Any  # (S,) int64 last emitted / start token
    lengths: Any  # (S,) int64 tokens emitted so far
    scores: Any  # (S,) f32 sum log-prob
    tokens: Any  # (S, max_len) int64
    active: Any  # (S,) bool: live request, still decoding
    finished: Any  # (S,) bool: done, awaiting collection


class ContinuousDecodeEngine(AdmissionMixin):
    """Device half of a continuous-batching greedy server.

    Host contract: the caller owns the free-slot bookkeeping (this class is
    purely functional over SlotState) and drives ``admit -> tick* -> flags
    -> collect`` from ONE thread. ``step_fn(params, state, token) ->
    (logits, state)`` defaults to the decoder's plain step."""

    def __init__(
        self,
        decoder,
        params,
        *,
        slots: int,
        start_id: int,
        end_id: int,
        max_len: int,
        pad_id: int = 0,
        min_len: int = 0,
        banned_ids: tuple = (),
        no_repeat_ngram_size: int = 0,
        feature_shape: tuple | None = None,
        feature_dtype=torch.float32,
        step_fn=None,
        precision: str | None = None,
    ):
        self.decoder = decoder
        # The engine's own tree: replacing a leaf of the pipeline's (a
        # reload, set_pretrained_embeddings) leaves this one as it was.
        self.params = tree_map(lambda t: t, params)
        self.step_fn = step_fn or decoder.step
        self.device = _device_of(params)
        self.slots = slots
        self.start_id = start_id
        self.end_id = end_id
        self.max_len = max_len
        self.pad_id = pad_id
        self.min_len = min_len
        self.banned_ids = tuple(banned_ids)
        self.no_repeat_ngram_size = no_repeat_ngram_size
        self.feature_shape = tuple(feature_shape or (decoder.feature_dim,))
        self.feature_dtype = feature_dtype
        self.precision = precision
        self._admit_buckets = _bucket_ladder(slots)

    # -- state construction -------------------------------------------------

    @torch.inference_mode()
    def init_state(self) -> SlotState:
        S, dev = self.slots, self.device
        feats = torch.zeros((S,) + self.feature_shape, dtype=self.feature_dtype, device=dev)
        with self._precision():
            dec = self.decoder.init_state(self.params, feats)
        return SlotState(
            dec=dec,
            last=torch.full((S,), self.start_id, dtype=torch.long, device=dev),
            lengths=torch.zeros((S,), dtype=torch.long, device=dev),
            scores=torch.zeros((S,), dtype=torch.float32, device=dev),
            tokens=torch.full((S, self.max_len), self.pad_id, dtype=torch.long, device=dev),
            active=torch.zeros((S,), dtype=torch.bool, device=dev),
            finished=torch.zeros((S,), dtype=torch.bool, device=dev),
        )

    # -- device operations ----------------------------------------------------

    @torch.inference_mode()
    def admit(self, state: SlotState, slot_idx, features) -> SlotState:
        """Write K new requests into lanes ``slot_idx`` ((K,) host ints;
        pad rows carry an index >= slots and are dropped)."""
        with self._precision():
            new_dec = self.decoder.init_state(self.params, features)
        rows, lanes = _real_rows(slot_idx, self.slots, self.device)
        put = lambda buf, new: buf.index_copy(0, lanes, new.index_select(0, rows))  # noqa: E731
        fill = lambda buf, v: buf.index_fill(0, lanes, v)  # noqa: E731
        return SlotState(
            dec=tree_map(put, state.dec, new_dec),
            last=fill(state.last, self.start_id),
            lengths=fill(state.lengths, 0),
            scores=fill(state.scores, 0.0),
            tokens=fill(state.tokens, self.pad_id),
            active=fill(state.active, True),
            finished=fill(state.finished, False),
        )

    @torch.inference_mode()
    def tick(self, state: SlotState, n: int = 1) -> SlotState:
        """Run ``n`` greedy steps for every lane."""
        with self._precision():
            for _ in range(n):
                state = self._step(state)
        return state

    def _step(self, state: SlotState) -> SlotState:
        logits, new_dec = self.step_fn(self.params, state.dec, state.last)
        logits = logits.float()
        masked = logits.clone()
        masked[:, self.pad_id] = -torch.inf
        masked = apply_banned(masked, self.banned_ids)
        if self.no_repeat_ngram_size:
            # Per lane, a lane's emitted length IS its step index; admit
            # clears the token buffer, so no stale history leaks into a
            # recycled lane's mask.
            masked = apply_ngram_ban(masked, state.tokens, state.lengths, self.no_repeat_ngram_size)
        masked = min_len_mask(masked, state.lengths, self.min_len, self.end_id)
        lse = torch.logsumexp(logits, dim=-1)
        nxt = torch.argmax(masked, dim=-1)
        tok_logp = logits.gather(1, nxt[:, None])[:, 0] - lse
        act = state.active
        pos = torch.clamp(state.lengths, max=self.max_len - 1)[:, None]
        old = state.tokens.gather(1, pos)
        tokens = state.tokens.scatter(1, pos, torch.where(act[:, None], nxt[:, None], old))
        lengths = state.lengths + act.long()
        done_now = act & ((nxt == self.end_id) | (lengths >= self.max_len))
        return SlotState(
            dec=_mask_tree(act, new_dec, state.dec),
            last=torch.where(act, nxt, state.last),
            lengths=lengths,
            scores=state.scores + torch.where(act, tok_logp, 0.0),
            tokens=tokens,
            active=act & ~done_now,
            finished=state.finished | done_now,
        )

    def flags(self, state: SlotState):
        """Small host fetch: (finished, active, lengths), on the device."""
        return state.finished, state.active, state.lengths

    def progress(self, state: SlotState):
        """Streaming fetch: every lane's (tokens (slots, max_len), lengths
        (slots,)) so far; rows beyond ``lengths`` are pad_id."""
        return state.tokens, state.lengths

    @torch.inference_mode()
    def collect(self, state: SlotState, slot_idx):
        """Gather (tokens, lengths, scores) rows of lanes ``slot_idx`` and
        clear their finished bit. Pad rows (index >= slots) gather a
        clamped lane, garbage the host discards, and clear nothing."""
        idx = torch.as_tensor(np.asarray(slot_idx), dtype=torch.long)
        gather = idx.clamp(max=self.slots - 1).to(self.device)
        rows = (
            state.tokens.index_select(0, gather),
            state.lengths.index_select(0, gather),
            state.scores.index_select(0, gather),
        )
        _, lanes = _real_rows(idx, self.slots, self.device)
        cleared = dataclasses.replace(state, finished=state.finished.index_fill(0, lanes, False))
        return rows, cleared
