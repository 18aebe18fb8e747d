"""Text layer of the port: the Keras-parity word tokenizer and the caption
sentinels, copied from ``tpucap.text`` so the port imports nothing of it."""

from tpucap_torch.text.clean import END_TOKEN, START_TOKEN
from tpucap_torch.text.tokenizer import Tokenizer, text_to_word_sequence

__all__ = ["Tokenizer", "text_to_word_sequence", "START_TOKEN", "END_TOKEN"]
