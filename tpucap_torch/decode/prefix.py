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

The JAX package primes a decoder that has ``step_chunk`` (its KV-cache
transformer) in one chunked prefill forward instead; the port has no such
decoder (ROADMAP item 6.2), so that branch raises.
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
        raise NotImplementedError(
            "chunked prefix priming (step_chunk, the KV-cache transformer) is "
            "not ported to tpucap_torch (ROADMAP queue 1, item 6.2)"
        )
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
