"""Forced-prefix (caption-completion) decoding (port of
``tpucap.decode.prefix``): prime the decoder state through user-supplied
prefix tokens, then let the unchanged engines continue.

Priming is a loop of P steps over the padded prefix length, as the JAX
package's ``lax.scan``: every row steps each time, and a row past its own
prefix keeps its state (``torch.where`` over every leaf the step returns).
The engines then run untouched: they take a per-row start token and an
initial score, which is all a primed prefix is to them. The reported score
is the whole caption's log-probability: the prefix tokens scored
teacher-forced under the engines' full-softmax normalizer, plus the
continuation.

A decoder that has ``step_chunk`` (the KV-cache transformer) is primed as
the JAX package primes it (``_prime_chunked``): in one chunked forward over
the padded prefix.
"""

from __future__ import annotations

import torch

from tpucap_torch.core import tree_leaves, tree_map


def prime_prefix(step_fn, params, state, prefix, lengths, *, start_id: int, decoder=None):
    """Advance decoder state through per-row forced prefixes.

    step_fn(params, state, token) -> (logits, state), the engines' step.
    prefix: (B, P) ints, row b's forced tokens in prefix[b, :lengths[b]]
        (entries past a row's length are ignored).
    lengths: (B,) per-row prefix lengths (0 = no prefix).
    decoder: optional; one with ``step_chunk`` is primed in one chunked
        forward instead of P steps (``_prime_chunked``).

    -> ``(state, last, logp)``: the state advanced by lengths[b]
    teacher-forced steps per row; last (B,) the token the continuation
    starts from (prefix[b, lengths[b]-1], or start_id when lengths[b] == 0);
    logp (B,) f32, the sum of the prefix tokens' full-softmax log-probs."""
    leaf = tree_leaves(state)[0]
    B, device = leaf.shape[0], leaf.device
    prefix = torch.as_tensor(prefix, dtype=torch.long, device=device)
    lengths = torch.as_tensor(lengths, dtype=torch.long, device=device)
    P = prefix.shape[1]
    last = torch.full((B,), start_id, dtype=torch.long, device=device)
    acc = torch.zeros((B,), dtype=torch.float32, device=device)
    if P == 0:
        return state, last, acc
    if decoder is not None and hasattr(decoder, "step_chunk"):
        return _prime_chunked(decoder, params, state, prefix, lengths, start_id=start_id)
    for i in range(P):
        logits, new_state = step_fn(params, state, last)
        logits = logits.float()
        tok = prefix[:, i]
        lp = logits.gather(1, tok[:, None])[:, 0] - torch.logsumexp(logits, dim=-1)
        active = i < lengths

        def sel(n, o):
            return torch.where(active.reshape(active.shape + (1,) * (n.ndim - 1)), n, o)

        state = tree_map(sel, new_state, state)
        last = torch.where(active, tok, last)
        acc = acc + torch.where(active, lp, 0.0)
    return state, last, acc


def _prime_chunked(decoder, params, state, prefix, lengths, *, start_id: int):
    """KV-cache prefill: the chunk [start, p0, .., p_{P-2}] (the step loop's
    inputs) in one ``step_chunk``, so logits[:, c] scores p_c; each row's
    f32 log-probs summed over its own length. A short row is repaired after
    the chunk: ``pos`` is overwritten with ``lengths``, and the K/V the
    chunk wrote at its positions [lengths[b], P) stay, never seen: a query
    at position q sees keys <= q, and the decode writes position q in the
    step that first queries it."""
    B, P = prefix.shape
    chunk = torch.cat([torch.full_like(prefix[:, :1], start_id), prefix[:, :-1]], dim=1)
    logits, new_state = decoder.step_chunk(params, state, chunk)
    logits = logits.float()  # (B, P, V)
    tok_lp = logits.gather(2, prefix[..., None])[..., 0] - torch.logsumexp(logits, dim=-1)
    valid = torch.arange(P, device=prefix.device)[None, :] < lengths[:, None]
    logp = torch.where(valid, tok_lp, 0.0).sum(dim=1)
    new_state = dict(new_state, pos=lengths.to(new_state["pos"].dtype))
    last = torch.where(
        lengths > 0,
        prefix.gather(1, torch.clamp(lengths - 1, min=0)[:, None])[:, 0],
        torch.full_like(lengths, start_id),
    )
    return new_state, last, logp
