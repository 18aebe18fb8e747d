"""Pretrained word embeddings (GloVe-format) for the decoder's embedding
table (port of ``tpucap.text.embeddings``, numpy only).

``load_word_vectors`` parses the whitespace text format (``word v1 .. vd``
a line) into a dict; ``build_embedding_matrix`` makes the ``(vocab_size,
dim)`` matrix indexed by the tokenizer's word indices, rows without a
vector left at zero. ``CaptioningPipeline.set_pretrained_embeddings`` puts
it into the decoder's ``embedding.table`` leaf and, frozen, masks that
leaf's optimizer updates.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_word_vectors", "build_embedding_matrix"]


def load_word_vectors(path, *, dtype=np.float32) -> dict[str, np.ndarray]:
    """Parse a GloVe / word2vec-text vector file into ``{word: (dim,)
    array}``. A first line of exactly two integer fields (word2vec's
    ``count dim`` header) is skipped; every line must have the first
    line's dimension; a word seen twice keeps its first vector."""
    vectors: dict[str, np.ndarray] = {}
    dim = None
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh):
            parts = line.rstrip("\n").split(" ")
            if not parts or parts == [""]:
                continue
            if lineno == 0 and len(parts) == 2:
                try:
                    int(parts[0]), int(parts[1])
                    continue  # word2vec-style header
                except ValueError:
                    pass
            word, values = parts[0], parts[1:]
            vec = np.asarray(values, dtype=dtype)
            if dim is None:
                dim = vec.shape[0]
                if dim == 0:
                    raise ValueError(f"{path}:{lineno + 1}: no vector values after word {word!r}")
            elif vec.shape[0] != dim:
                raise ValueError(
                    f"{path}:{lineno + 1}: vector for {word!r} has "
                    f"{vec.shape[0]} dims, expected {dim}"
                )
            vectors.setdefault(word, vec)
    if not vectors:
        raise ValueError(f"{path}: no word vectors found")
    return vectors


def build_embedding_matrix(
    tokenizer,
    vectors: dict[str, np.ndarray],
    *,
    embed_dim: int | None = None,
    vocab_size: int | None = None,
    dtype=np.float32,
):
    """The ``(vocab_size, embed_dim)`` init matrix: rows indexed by
    ``tokenizer.word_index``; words without a vector and row 0 (padding)
    stay zero; indices at or past ``vocab_size`` are skipped. -> (matrix,
    hits), hits the in-vocabulary words that got a pretrained row."""
    if vocab_size is None:
        vocab_size = tokenizer.vocab_size
    if embed_dim is None:
        embed_dim = next(iter(vectors.values())).shape[0]
    matrix = np.zeros((vocab_size, embed_dim), dtype=dtype)
    hits = 0
    for word, idx in tokenizer.word_index.items():
        if idx >= vocab_size:
            continue
        vec = vectors.get(word)
        if vec is None:
            continue
        if vec.shape[0] != embed_dim:
            raise ValueError(
                f"pretrained vectors have dim {vec.shape[0]}, decoder "
                f"embed_dim is {embed_dim}; pick matching sizes"
            )
        matrix[idx] = vec
        hits += 1
    return matrix, hits
