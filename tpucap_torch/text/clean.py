"""Caption cleaning and the sentinels the decoder is trained on (copy of
``tpucap.text.clean``): lowercase, strip ``string.punctuation``, drop
one-character words and words that are not all letters (``str.isalpha``,
true for non-ASCII letters too), then wrap with ``startseq``/``endseq``."""

from __future__ import annotations

import string

START_TOKEN = "startseq"
END_TOKEN = "endseq"

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def clean_caption(caption: str) -> str:
    """Lowercase, de-punctuate, drop 1-char and numeric-containing words."""
    words = [w.lower().translate(_PUNCT_TABLE) for w in caption.split()]
    return " ".join(w for w in words if len(w) > 1 and w.isalpha())


def wrap_caption(caption: str) -> str:
    """Add the start/end sentinels the decoder is trained on."""
    return f"{START_TOKEN} {caption} {END_TOKEN}"


def clean_descriptions(descriptions: dict[str, list[str]]) -> dict[str, list[str]]:
    """Clean every caption in an {image_id: [captions]} mapping in place."""
    for image_id, captions in descriptions.items():
        descriptions[image_id] = [clean_caption(c) for c in captions]
    return descriptions
