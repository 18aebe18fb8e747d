"""Pure-Python tokenizer with tf_keras-parity semantics.

A copy of ``tpucap.text.tokenizer.Tokenizer`` restricted to what serving
and training need (fit, words to ids and back, reverse lookup, vocab size, JSON
persistence), so a vocabulary fitted or saved by either package loads in
the other:

- index 0 is reserved for padding and never assigned to a word;
- the vocabulary is sorted by descending frequency, ties in first-seen
  order (Python's stable sort over an insertion-ordered dict);
- ``oov_token``, if set, is forced to index 1;
- ``num_words`` caps the model vocabulary while ``word_index`` keeps every
  word;
- the filter set is all ASCII punctuation plus tab/newline, minus ``'``.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from typing import Iterable, Sequence

DEFAULT_FILTERS = '!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n'


def text_to_word_sequence(
    input_text: str,
    filters: str = DEFAULT_FILTERS,
    lower: bool = True,
    split: str = " ",
) -> list[str]:
    """Split a text into words, Keras-style."""
    if lower:
        input_text = input_text.lower()
    translate_map = str.maketrans({c: split for c in filters})
    input_text = input_text.translate(translate_map)
    return [w for w in input_text.split(split) if w]


class Tokenizer:
    """Word <-> index vocabulary with tf_keras.Tokenizer-identical semantics."""

    def __init__(
        self,
        num_words: int | None = None,
        filters: str = DEFAULT_FILTERS,
        lower: bool = True,
        split: str = " ",
        oov_token: str | None = None,
    ):
        self.num_words = num_words
        self.filters = filters
        self.lower = lower
        self.split = split
        self.oov_token = oov_token
        self.word_counts: OrderedDict[str, int] = OrderedDict()
        self.word_docs: dict[str, int] = {}
        self.index_docs: dict[int, int] = {}
        self.document_count = 0
        self.word_index: dict[str, int] = {}
        self.index_word: dict[int, str] = {}

    def _analyze(self, text: str) -> list[str]:
        return text_to_word_sequence(
            text, filters=self.filters, lower=self.lower, split=self.split
        )

    def fit_on_texts(self, texts: Iterable[str]) -> None:
        for text in texts:
            self.document_count += 1
            seq = self._analyze(text)
            for w in seq:
                self.word_counts[w] = self.word_counts.get(w, 0) + 1
            for w in set(seq):
                self.word_docs[w] = self.word_docs.get(w, 0) + 1

        wcounts = list(self.word_counts.items())
        # Stable sort: frequency desc, ties keep first-seen order.
        wcounts.sort(key=lambda x: x[1], reverse=True)
        sorted_voc = [] if self.oov_token is None else [self.oov_token]
        sorted_voc.extend(w for w, _ in wcounts)
        # Index 0 reserved for padding — never assigned.
        self.word_index = {w: i for i, w in enumerate(sorted_voc, start=1)}
        self.index_word = {i: w for w, i in self.word_index.items()}
        for w, c in self.word_docs.items():
            self.index_docs[self.word_index[w]] = c

    def texts_to_sequences(self, texts: Iterable[str]) -> list[list[int]]:
        """Words -> ids; unknown words dropped (or the OOV id), ids at or
        above ``num_words`` dropped (or the OOV id)."""
        num_words = self.num_words
        oov_index = self.word_index.get(self.oov_token)
        out = []
        for text in texts:
            vect: list[int] = []
            for w in self._analyze(text):
                i = self.word_index.get(w)
                if i is not None:
                    if num_words and i >= num_words:
                        if oov_index is not None:
                            vect.append(oov_index)
                    else:
                        vect.append(i)
                elif self.oov_token is not None:
                    vect.append(oov_index)
            out.append(vect)
        return out

    def sequences_to_texts(self, sequences: Iterable[Sequence[int]]) -> list[str]:
        """Ids -> space-joined words; ids at or above ``num_words`` (and
        unknown ids) become the OOV word, or drop without one."""
        num_words = self.num_words
        oov_index = self.word_index.get(self.oov_token)
        out = []
        for seq in sequences:
            vect: list[str] = []
            for num in seq:
                word = self.index_word.get(num)
                if word is not None:
                    if num_words and num >= num_words:
                        if oov_index is not None:
                            vect.append(self.index_word[oov_index])
                    else:
                        vect.append(word)
                elif self.oov_token is not None:
                    vect.append(self.index_word[oov_index])
            out.append(" ".join(vect))
        return out

    def word_for_id(self, index: int) -> str | None:
        """Reverse lookup used by the caption join."""
        return self.index_word.get(index)

    @property
    def vocab_size(self) -> int:
        """Model vocab size: +1 for the reserved padding index 0, clipped
        by num_words."""
        full = len(self.word_index) + 1
        if self.num_words:
            return min(full, self.num_words)
        return full

    def to_json(self) -> str:
        return json.dumps(
            {
                "num_words": self.num_words,
                "filters": self.filters,
                "lower": self.lower,
                "split": self.split,
                "oov_token": self.oov_token,
                "word_counts": list(self.word_counts.items()),
                "word_docs": self.word_docs,
                "index_docs": self.index_docs,
                "document_count": self.document_count,
                "word_index": self.word_index,
            }
        )

    @classmethod
    def from_json(cls, payload) -> "Tokenizer":
        """``payload``: JSON string or an already-parsed dict."""
        d = json.loads(payload) if isinstance(payload, str) else payload
        tok = cls(
            num_words=d["num_words"],
            filters=d["filters"],
            lower=d["lower"],
            split=d["split"],
            oov_token=d["oov_token"],
        )
        tok.word_counts = OrderedDict(
            (w, int(c)) for w, c in d["word_counts"]
        )
        tok.word_docs = {w: int(c) for w, c in d["word_docs"].items()}
        # JSON stringifies int keys; artifacts without index_docs rebuild
        # it from word_docs.
        tok.index_docs = {
            int(i): int(c) for i, c in d.get("index_docs", {}).items()
        }
        tok.document_count = d["document_count"]
        tok.word_index = {w: int(i) for w, i in d["word_index"].items()}
        tok.index_word = {i: w for w, i in tok.word_index.items()}
        if not tok.index_docs and tok.word_docs:
            tok.index_docs = {
                tok.word_index[w]: c
                for w, c in tok.word_docs.items()
                if w in tok.word_index
            }
        return tok

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path) -> "Tokenizer":
        with open(path) as f:
            return cls.from_json(f.read())


def load_tokenizer(path) -> Tokenizer:
    """A saved word tokenizer (``tokenizer.json``); tpucap's BPE artifacts
    (``"kind": "bpe"``) are not ported."""
    with open(path) as f:
        d = json.load(f)
    if d.get("kind") == "bpe":
        raise NotImplementedError(f"{path}: the BPE tokenizer is not ported")
    return Tokenizer.from_json(d)
