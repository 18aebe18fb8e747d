"""The Porter stemmer as NLTK's ``PorterStemmer`` runs it by default (its
``NLTK_EXTENSIONS`` mode, ``nltk/stem/porter.py``, nltk 3.10.0), so that
METEOR's stem stage and ``SynonymTable``'s stem expansion give NLTK's
stems without importing NLTK.

Porter, M. "An algorithm for suffix stripping." Program 14.3 (1980):
130-137, with the modifications NLTK's default mode adds to it:

- a pool of irregular forms looked up first (``dying`` -> ``die``);
- ``ies`` and ``ied`` on four-letter words keep their ``ie``
  (``dies`` -> ``die``, ``died`` -> ``die``);
- step 1b's ``*o`` also holds for a two-letter vowel-consonant stem;
- step 1c turns ``y`` into ``i`` only after a consonant that is not the
  word's first letter (``happy`` -> ``happi``, ``enjoy`` stays);
- step 2 applies ``alli`` -> ``al`` first and runs again on the result,
  takes ``bli`` -> ``ble`` (not ``abli``), and adds ``fulli`` -> ``ful``
  and ``logi`` -> ``log`` (the ``l`` counted with the stem);
- words of one or two letters are returned as they are (lowercased).
"""

from __future__ import annotations

_IRREGULAR_FORMS = {
    "sky": ["sky", "skies"],
    "die": ["dying"],
    "lie": ["lying"],
    "tie": ["tying"],
    "news": ["news"],
    "inning": ["innings", "inning"],
    "outing": ["outings", "outing"],
    "canning": ["cannings", "canning"],
    "howe": ["howe"],
    "proceed": ["proceed"],
    "exceed": ["exceed"],
    "succeed": ["succeed"],
}
_POOL = {form: key for key, forms in _IRREGULAR_FORMS.items() for form in forms}
_VOWELS = frozenset("aeiou")


def _is_consonant(word: str, i: int) -> bool:
    """A letter other than a, e, i, o, u, and other than a y after a
    consonant (a run of y's alternates)."""
    if word[i] in _VOWELS:
        return False
    if word[i] == "y":
        negate = False
        while i > 0 and word[i] == "y":
            negate = not negate
            i -= 1
        return (word[i] not in _VOWELS) != negate
    return True


def _measure(stem: str) -> int:
    """m in [C](VC){m}[V]: the count of vowel-consonant transitions."""
    cv = "".join("c" if _is_consonant(stem, i) else "v" for i in range(len(stem)))
    return cv.count("vc")


def _positive_measure(stem: str) -> bool:
    return _measure(stem) > 0


def _measure_gt_1(stem: str) -> bool:
    return _measure(stem) > 1


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return len(word) >= 2 and word[-1] == word[-2] and _is_consonant(word, len(word) - 1)


def _ends_cvc(word: str) -> bool:
    """*o: the stem ends consonant-vowel-consonant, the last not w, x or y;
    or it is a two-letter vowel-consonant stem."""
    return (
        len(word) >= 3
        and _is_consonant(word, len(word) - 3)
        and not _is_consonant(word, len(word) - 2)
        and _is_consonant(word, len(word) - 1)
        and word[-1] not in ("w", "x", "y")
    ) or (len(word) == 2 and not _is_consonant(word, 0) and _is_consonant(word, 1))


def _strip(word: str, suffix: str) -> str:
    return word[: -len(suffix)] if suffix else word


def _apply_rule_list(word: str, rules) -> str:
    """The first rule whose suffix ends the word decides: its replacement
    where its condition holds on the stem, the word unchanged otherwise.
    The suffix ``*d`` stands for a double consonant."""
    for suffix, replacement, condition in rules:
        if suffix == "*d" and _ends_double_consonant(word):
            stem = word[:-2]
            return stem + replacement if condition is None or condition(stem) else word
        if word.endswith(suffix):
            stem = _strip(word, suffix)
            return stem + replacement if condition is None or condition(stem) else word
    return word


def _step1a(word: str) -> str:
    if word.endswith("ies") and len(word) == 4:
        return _strip(word, "ies") + "ie"
    return _apply_rule_list(
        word, [("sses", "ss", None), ("ies", "i", None), ("ss", "ss", None), ("s", "", None)]
    )


def _step1b(word: str) -> str:
    if word.endswith("ied"):
        return _strip(word, "ied") + ("ie" if len(word) == 4 else "i")
    if word.endswith("eed"):
        stem = _strip(word, "eed")
        return stem + "ee" if _measure(stem) > 0 else word
    for suffix in ("ed", "ing"):
        if word.endswith(suffix):
            stem = _strip(word, suffix)
            if _contains_vowel(stem):
                break
    else:
        return word
    return _apply_rule_list(
        stem,
        [
            ("at", "ate", None),
            ("bl", "ble", None),
            ("iz", "ize", None),
            ("*d", stem[-1], lambda _: stem[-1] not in ("l", "s", "z")),
            ("", "e", lambda s: _measure(s) == 1 and _ends_cvc(s)),
        ],
    )


def _step1c(word: str) -> str:
    return _apply_rule_list(
        word, [("y", "i", lambda stem: len(stem) > 1 and _is_consonant(stem, len(stem) - 1))]
    )


_STEP2_RULES = [
    ("ational", "ate"),
    ("tional", "tion"),
    ("enci", "ence"),
    ("anci", "ance"),
    ("izer", "ize"),
    ("bli", "ble"),
    ("alli", "al"),
    ("entli", "ent"),
    ("eli", "e"),
    ("ousli", "ous"),
    ("ization", "ize"),
    ("ation", "ate"),
    ("ator", "ate"),
    ("alism", "al"),
    ("iveness", "ive"),
    ("fulness", "ful"),
    ("ousness", "ous"),
    ("aliti", "al"),
    ("iviti", "ive"),
    ("biliti", "ble"),
    ("fulli", "ful"),
]


def _step2(word: str) -> str:
    if word.endswith("alli") and _positive_measure(_strip(word, "alli")):
        return _step2(_strip(word, "alli") + "al")
    rules = [(s, r, _positive_measure) for s, r in _STEP2_RULES]
    rules.append(("logi", "log", lambda _: _positive_measure(word[:-3])))
    return _apply_rule_list(word, rules)


_STEP3_RULES = [
    ("icate", "ic", _positive_measure),
    ("ative", "", _positive_measure),
    ("alize", "al", _positive_measure),
    ("iciti", "ic", _positive_measure),
    ("ical", "ic", _positive_measure),
    ("ful", "", _positive_measure),
    ("ness", "", _positive_measure),
]

_STEP4_RULES = [
    (s, "", _measure_gt_1)
    for s in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment", "ent")
] + [("ion", "", lambda stem: _measure(stem) > 1 and stem[-1] in ("s", "t"))] + [
    (s, "", _measure_gt_1) for s in ("ou", "ism", "ate", "iti", "ous", "ive", "ize")
]


def _step5a(word: str) -> str:
    if word.endswith("e"):
        stem = _strip(word, "e")
        if _measure(stem) > 1:
            return stem
        if _measure(stem) == 1 and not _ends_cvc(stem):
            return stem
    return word


def _step5b(word: str) -> str:
    return _apply_rule_list(word, [("ll", "l", lambda _: _measure(word[:-1]) > 1)])


class PorterStemmer:
    """``stem(word)`` as ``nltk.stem.porter.PorterStemmer().stem(word)``."""

    def stem(self, word: str, to_lowercase: bool = True) -> str:
        stem = word.lower() if to_lowercase else word
        if stem in _POOL:
            return _POOL[stem]
        if len(word) <= 2:
            return stem
        stem = _step1a(stem)
        stem = _step1b(stem)
        stem = _step1c(stem)
        stem = _step2(stem)
        stem = _apply_rule_list(stem, _STEP3_RULES)
        stem = _apply_rule_list(stem, _STEP4_RULES)
        stem = _step5a(stem)
        return _step5b(stem)

    def __repr__(self) -> str:
        return "<PorterStemmer>"
