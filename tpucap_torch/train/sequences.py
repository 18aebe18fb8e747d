"""Training batches from captions and image features (port of
``tpucap.train.sequences``).

One row per (image, caption): the post-padded full token sequence
(startseq ... endseq), teacher-forced in one pass; the loss over the
non-pad positions equals the reference's per-prefix samples' loss.
"""

from __future__ import annotations

import numpy as np

from tpucap_torch.text.clean import END_TOKEN
from tpucap_torch.text.padding import pad_sequences


def build_training_tokens(tokenizer, descriptions: dict[str, list[str]], max_len: int):
    """-> (row_ids list[N], tokens (N, max_len + 1) int32). ``row_ids[i]``
    is the image id whose feature row pairs with ``tokens[i]``. Captions of
    fewer than two tokens are dropped; a caption longer than max_len + 1
    that ends in endseq keeps endseq as its last token."""
    end_id = tokenizer.word_index.get(END_TOKEN)
    row_ids, seqs = [], []
    for image_id, captions in descriptions.items():
        for seq in tokenizer.texts_to_sequences(captions):
            if len(seq) < 2:
                continue
            if len(seq) > max_len + 1 and end_id is not None and seq[-1] == end_id:
                # Post-truncation would drop endseq and teach the model
                # never to end this caption.
                seq = seq[:max_len] + [end_id]
            row_ids.append(image_id)
            seqs.append(seq)
    tokens = pad_sequences(seqs, maxlen=max_len + 1, padding="post", truncating="post")
    return row_ids, tokens


def build_training_batch(tokenizer, descriptions, features, max_len: int):
    """-> (features (N, ...), tokens (N, max_len + 1)): each caption's row
    beside its image's feature row."""
    row_ids, tokens = build_training_tokens(tokenizer, descriptions, max_len)
    return np.stack([np.asarray(features[i]) for i in row_ids]), tokens


def batch_iterator(arrays, batch_size: int, *, rng=None, drop_remainder=True):
    """Aligned minibatches of a tuple of arrays; ``rng`` (a numpy
    ``Generator``) shuffles the row order in place, as tpucap draws it."""
    n = arrays[0].shape[0]
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for s in range(0, end, batch_size):
        sel = idx[s : s + batch_size]
        yield tuple(a[sel] for a in arrays)
