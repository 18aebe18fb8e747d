"""No-repeat-ngram blocking (port of ``tpucap.decode.ngram``): a token that
would complete an n-gram the sequence already generated leaves the
candidate set.

- The history is the generated tokens only; ``startseq`` belongs to no
  window.
- Emitting w at step t is banned iff the (n-1)-token suffix y[t-n+1:t]
  already occurred at some position i <= t-n followed by w.
- n = 1 bans any repeat of a token; an n longer than the buffer bans
  nothing.
- The engines apply it as selection only: NEG_INF at the matched
  completions of the masked logits, the softmax normalizer left full, so
  scores stay true log-probs (the pad / min_len / bad_words convention).

Windows are gathered with a static index grid over the engine's
(rows, max_len) token buffer: (rows, P, n-1) compares a step, a few
thousand integer compares a row at caption lengths.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # as decode/beam.py


def _ngram_matches(tokens, t, n: int):
    """-> (match, next_tok), both (..., P): ``match[.., i]`` is True iff the
    (n-1)-gram at position i equals the current suffix and its completing
    token ``next_tok[.., i] = tokens[.., i+n-1]`` is already generated.
    (None, None) when the buffer is too short for any window."""
    if n < 1:
        raise ValueError(f"no_repeat_ngram_size must be >= 1, got {n}")
    L = tokens.shape[-1]
    P = L - (n - 1)  # window start positions
    if P <= 0:
        return None, None
    dev = tokens.device
    pos = torch.arange(P, device=dev)
    win = pos[:, None] + torch.arange(n - 1, device=dev)[None, :]
    windows = tokens[..., win]  # (..., P, n-1)
    if isinstance(t, torch.Tensor):
        t_arr = t.to(dev, torch.long).expand(tokens.shape[:-1])
    else:  # made on the device: no host copy in the decode loop
        t_arr = torch.full(tokens.shape[:-1], t, dtype=torch.long, device=dev)
    sidx = (t_arr[..., None] - (n - 1) + torch.arange(n - 1, device=dev)).clamp(min=0)
    suffix = tokens.gather(-1, sidx)  # (..., n-1)
    match = (windows == suffix[..., None, :]).all(dim=-1)  # (..., P)
    # Window i's completing token sits at i + n - 1 <= t - 1.
    match = match & (pos <= (t_arr[..., None] - n))
    next_tok = tokens[..., pos + (n - 1)]
    return match, next_tok


def apply_ngram_ban(masked, tokens, t, n: int):
    """NEG_INF at every matched completion of a (rows, V) logits tensor, in
    its dtype. tokens: (rows, L) generated ids; t: the step about to be
    written (a scalar or (rows,))."""
    match, next_tok = _ngram_matches(tokens, t, n)
    if match is None:
        return masked
    vals = torch.full(match.shape, float("inf"), dtype=masked.dtype, device=masked.device)
    vals = vals.masked_fill(match, NEG_INF)  # min(x, +inf) = x
    return masked.scatter_reduce(1, next_tok, vals, reduce="amin")


def ngram_banned_mask(tokens, t, n: int, vocab: int):
    """(..., vocab) bool, True where emitting that token at step t would
    complete an n-gram already in tokens[..., :t]."""
    match, next_tok = _ngram_matches(tokens, t, n)
    lead = tokens.shape[:-1]
    if match is None:
        return torch.zeros(lead + (vocab,), dtype=torch.bool, device=tokens.device)
    flat_tok = next_tok.reshape(-1, next_tok.shape[-1])
    flat_match = match.reshape(-1, match.shape[-1])
    mask = torch.zeros(
        (flat_tok.shape[0], vocab), dtype=torch.bool, device=tokens.device
    ).scatter_reduce(1, flat_tok, flat_match, reduce="amax")
    return mask.reshape(lead + (vocab,))
