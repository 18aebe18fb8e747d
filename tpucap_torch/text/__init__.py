"""Text layer of the port: the Keras-parity word tokenizer, caption cleaning
and the sentinels, copied from ``tpucap.text`` so the port imports nothing
of it."""

from tpucap_torch.text.clean import (
    END_TOKEN,
    START_TOKEN,
    clean_caption,
    clean_descriptions,
    wrap_caption,
)
from tpucap_torch.text.tokenizer import Tokenizer, load_tokenizer, text_to_word_sequence

__all__ = [
    "Tokenizer",
    "load_tokenizer",
    "text_to_word_sequence",
    "clean_caption",
    "clean_descriptions",
    "wrap_caption",
    "START_TOKEN",
    "END_TOKEN",
]
