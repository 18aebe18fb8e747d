"""``pad_sequences`` with Keras-parity semantics (copy of
``tpucap.text.padding.pad_sequences``).

Keras's default is pre-padding and pre-truncation with value 0; the
training batches use post-padding and post-truncation (full captions,
startseq first).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def pad_sequences(
    sequences: Sequence[Sequence[int]],
    maxlen: int | None = None,
    dtype: str = "int32",
    padding: str = "pre",
    truncating: str = "pre",
    value: float = 0.0,
) -> np.ndarray:
    """Pad each sequence to the same length (Keras-identical)."""
    if padding not in ("pre", "post"):
        raise ValueError(f"padding must be 'pre' or 'post', got {padding!r}")
    if truncating not in ("pre", "post"):
        raise ValueError(
            f"truncating must be 'pre' or 'post', got {truncating!r}"
        )

    lengths = [len(s) for s in sequences]
    if maxlen is None:
        maxlen = max(lengths) if lengths else 0

    out = np.full((len(sequences), maxlen), value, dtype=dtype)
    for i, s in enumerate(sequences):
        if not len(s):
            continue
        trunc = s[-maxlen:] if truncating == "pre" else s[:maxlen]
        trunc = np.asarray(trunc, dtype=dtype)
        if padding == "post":
            out[i, : len(trunc)] = trunc
        else:
            out[i, -len(trunc) :] = trunc
    return out
