"""Bridge from decoded token ids back to caption strings (port of
``tpucap.decode.text``)."""

from __future__ import annotations

import numpy as np
import torch


def ids_to_captions(
    tokenizer,
    tokens,
    lengths,
    *,
    end_id: int | None = None,
    strip_end: bool = True,
) -> list[str]:
    """tokens (B, L), lengths (B,) -> caption strings, the end sentinel
    stripped, words joined by spaces (id 0 and unknown ids dropped)."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.cpu().numpy()
    tokens = np.asarray(tokens)
    lengths = np.asarray(lengths)
    out = []
    for row, n in zip(tokens, lengths):
        ids = list(row[: int(n)])
        if strip_end and end_id is not None and ids and ids[-1] == end_id:
            ids = ids[:-1]
        words = [tokenizer.word_for_id(int(i)) for i in ids]
        out.append(" ".join(w for w in words if w is not None))
    return out
