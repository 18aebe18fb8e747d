"""tpucap_torch.text against tpucap.text: the same corpus fits the same
vocabulary, and a vocabulary saved by either package loads in the other
(exact: no arithmetic)."""

import numpy as np
import pytest
import torch

from tpucap.text.clean import END_TOKEN as JAX_END
from tpucap.text.clean import START_TOKEN as JAX_START
from tpucap.text import Tokenizer as JaxTokenizer
from tpucap_torch.text import END_TOKEN, START_TOKEN, Tokenizer

torch.set_num_threads(2)


def _corpus(seed=0, n=40):
    rng = np.random.default_rng(seed)
    words = ["dog", "Dog's", "runs,", "a", "red-ball", "on", "grass.", "the", "A", "child"]
    return [
        f"{START_TOKEN} " + " ".join(rng.choice(words, size=rng.integers(2, 9))) + f" {END_TOKEN}"
        for _ in range(n)
    ]


@pytest.mark.parametrize("num_words,oov", [(None, None), (6, "<unk>")])
def test_fit_matches_jax_tokenizer(num_words, oov):
    texts = _corpus()
    ref = JaxTokenizer(num_words=num_words, oov_token=oov)
    ref.fit_on_texts(texts)
    tok = Tokenizer(num_words=num_words, oov_token=oov)
    tok.fit_on_texts(texts)
    assert (START_TOKEN, END_TOKEN) == (JAX_START, JAX_END)
    assert tok.word_index == ref.word_index
    assert list(tok.word_counts.items()) == list(ref.word_counts.items())
    assert tok.vocab_size == ref.vocab_size
    for i in range(len(ref.word_index) + 2):
        assert tok.word_for_id(i) == ref.word_for_id(i)


def test_json_round_trips_between_packages(tmp_path):
    ref = JaxTokenizer()
    ref.fit_on_texts(_corpus(1))
    tok = Tokenizer.from_json(ref.to_json())
    assert tok.word_index == ref.word_index and tok.index_docs == ref.index_docs
    tok.save(tmp_path / "tok.json")
    back = JaxTokenizer.from_json((tmp_path / "tok.json").read_text())
    assert back.word_index == ref.word_index
    assert Tokenizer.load(tmp_path / "tok.json").to_json() == tok.to_json()
