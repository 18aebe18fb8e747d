"""Caption evaluation (port of ``tpucap.train.evaluate``): corpus BLEU-1..4
and ``evaluate_captions``, the metric front of ``CaptioningPipeline.evaluate``.

tpucap scores BLEU with NLTK's ``corpus_bleu`` and no smoothing
(``SmoothingFunction().method0``). The port imports no NLTK, so
``corpus_bleu`` here follows ``nltk/translate/bleu_score.py`` (nltk 3.10.0)
step for step, and gives its floats:

- each order's modified precision as integer sums over the corpus: clipped
  hypothesis n-gram counts over hypothesis n-grams (at least 1 a sentence);
- the closest reference length, ties to the shorter one, and the brevity
  penalty ``exp(1 - r / c)``, 1 for c > r and 0 for an empty corpus of
  hypotheses;
- 0 when no unigram matches;
- method0: an order with no match counts as ``sys.float_info.min``, so it
  weighs ``w * log(float_info.min)`` (0 under a zero weight);
- ``bp * exp(fsum(w_i * log(p_i)))``.

``sentence_bleu`` is NLTK's ``sentence_bleu(references, hypothesis,
smoothing_function=SmoothingFunction().method1)``, the smoothed BLEU-4 of
MBR reranking (``decode/mbr.py``): ``corpus_bleu`` of one sentence, where
an order with no match counts as ``epsilon / denominator`` (epsilon 0.1)
over its unnormalized denominator, as NLTK's ``Fraction(num, den,
_normalize=False)`` keeps it: 0/5 becomes 0.1/5, not 0.1/1.

It emits no warning where NLTK warns about an order without matches.
"""

from __future__ import annotations

import math
import sys
from collections import Counter
from fractions import Fraction

BLEU_WEIGHTS = {
    "bleu1": (1.0, 0, 0, 0),
    "bleu2": (0.5, 0.5, 0, 0),
    "bleu3": (1 / 3, 1 / 3, 1 / 3, 0),
    "bleu4": (0.25, 0.25, 0.25, 0.25),
}
METRICS = ("bleu", "cider", "rouge_l", "meteor", "diversity")
SENTINELS = ("startseq", "endseq")


def _ngrams(tokens, n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def modified_precision(references, hypothesis, n: int) -> tuple[int, int]:
    """-> (clipped matches, hypothesis n-grams, at least 1): NLTK's
    ``modified_precision`` as its numerator and denominator."""
    counts = _ngrams(hypothesis, n)
    max_counts: dict = {}
    for reference in references:
        ref_counts = _ngrams(reference, n)
        for ngram in counts:
            max_counts[ngram] = max(max_counts.get(ngram, 0), ref_counts[ngram])
    numerator = sum(min(c, max_counts[g]) for g, c in counts.items())
    return numerator, max(1, sum(counts.values()))


def closest_ref_length(references, hyp_len: int) -> int:
    return min((len(r) for r in references), key=lambda n: (abs(n - hyp_len), n))


def brevity_penalty(closest_ref_len: int, hyp_len: int) -> float:
    if hyp_len > closest_ref_len:
        return 1
    if hyp_len == 0:
        return 0
    return math.exp(1 - closest_ref_len / hyp_len)


def corpus_bleu(
    list_of_references, hypotheses, weights_list, *, smoothing: str = "method0"
) -> list[float]:
    """NLTK's ``corpus_bleu(list_of_references, hypotheses, weights=
    weights_list, smoothing_function=SmoothingFunction().<smoothing>)`` for
    a list of weight tuples: one score per tuple. ``smoothing``: method0
    (no smoothing) or method1 (epsilon 0.1 for an order without
    matches)."""
    if smoothing not in ("method0", "method1"):
        raise ValueError(f"unknown smoothing {smoothing!r}; have method0|method1")
    if len(list_of_references) != len(hypotheses):
        raise ValueError(
            f"{len(list_of_references)} reference sets vs {len(hypotheses)} hypotheses"
        )
    orders = max(len(w) for w in weights_list)
    numerators = [0] * (orders + 1)
    denominators = [0] * (orders + 1)
    hyp_lengths = ref_lengths = 0
    for references, hypothesis in zip(list_of_references, hypotheses):
        for n in range(1, orders + 1):
            num, den = modified_precision(references, hypothesis, n)
            numerators[n] += num
            denominators[n] += den
        hyp_lengths += len(hypothesis)
        ref_lengths += closest_ref_length(references, len(hypothesis))
    bp = brevity_penalty(ref_lengths, hyp_lengths)
    if numerators[1] == 0:
        return [0] * len(weights_list)
    p_n = [
        Fraction(numerators[n], denominators[n]) if numerators[n]
        else 0.1 / denominators[n] if smoothing == "method1"
        else sys.float_info.min
        for n in range(1, orders + 1)
    ]
    return [
        bp * math.exp(math.fsum(w * math.log(p) for w, p in zip(weights, p_n) if p > 0))
        for weights in weights_list
    ]


def sentence_bleu(references, hypothesis, weights=(0.25, 0.25, 0.25, 0.25)) -> float:
    """NLTK's ``sentence_bleu(references, hypothesis, weights,
    smoothing_function=SmoothingFunction().method1)`` as a float (0.0 when
    no unigram matches)."""
    return float(corpus_bleu([references], [hypothesis], [weights], smoothing="method1")[0])


def bleu_scores(references, hypotheses) -> dict[str, float]:
    """references: per-image list of tokenized reference captions;
    hypotheses: per-image tokenized generated caption. -> BLEU-1..4."""
    scores = corpus_bleu(references, hypotheses, list(BLEU_WEIGHTS.values()))
    return {k: float(s) for k, s in zip(BLEU_WEIGHTS, scores)}


def check_metrics(metrics) -> None:
    unknown = set(metrics) - set(METRICS)
    if unknown:
        raise ValueError(f"unknown metrics {sorted(unknown)}; have {'|'.join(METRICS)}")


def evaluate_captions(
    descriptions: dict[str, list[str]],
    generated: dict[str, str],
    *,
    strip_sentinels: bool = True,
    metrics: tuple = ("bleu",),
    meteor_synonyms=None,
) -> dict[str, float]:
    """Generated captions against each image's reference captions:
    ``metrics`` from 'bleu' (BLEU-1..4, the default), 'cider' (CIDEr-D),
    'rouge_l', 'meteor' (exact, stem and, with ``meteor_synonyms``, synonym
    stages) and 'diversity' (``caption_stats``). ``strip_sentinels`` drops
    startseq / endseq from both sides."""
    refs, hyps = [], []
    for image_id, hyp in generated.items():
        ref_tokens = [c.split() for c in descriptions[image_id]]
        hyp_tokens = hyp.split()
        if strip_sentinels:
            ref_tokens = [[w for w in r if w not in SENTINELS] for r in ref_tokens]
            hyp_tokens = [w for w in hyp_tokens if w not in SENTINELS]
        refs.append(ref_tokens)
        hyps.append(hyp_tokens)
    check_metrics(metrics)
    # Imported here, as tpucap does: BLEU alone needs none of it.
    from tpucap_torch.train import metrics as m

    out: dict[str, float] = {}
    if "bleu" in metrics:
        out.update(bleu_scores(refs, hyps))
    if "cider" in metrics:
        out["cider"] = m.cider_d(refs, hyps)
    if "rouge_l" in metrics:
        out["rouge_l"] = m.rouge_l(refs, hyps)
    if "meteor" in metrics:
        out["meteor"] = m.meteor(refs, hyps, synonyms=meteor_synonyms)
    if "diversity" in metrics:
        out.update(m.caption_stats(hyps))
    return out
