"""Paired bootstrap significance testing for caption systems (port of
``tpucap.train.compare``): Koehn (2004) paired bootstrap resampling over
the metric conventions of ``train/evaluate.py`` and ``train/metrics.py``,
read by ``compare A.jsonl B.jsonl`` from two ``evaluate --dump-captions``
files.

Host numpy only: it touches no tensor and needs no card. Each image
contributes a fixed row of BLEU sufficient statistics (clipped n-gram
matches, totals, hypothesis length, closest reference length), so a
resample of corpus BLEU is a row sum and the closed form, vectorized over
all resamples; CIDEr-D, ROUGE-L and METEOR are corpus means of
per-sentence scores, so a resample is a mean (CIDEr-D's IDF stays that of
the full corpus). The test is paired: both systems are scored on the same
resampled image multiset. The resamples are drawn from
``np.random.default_rng(seed)`` as tpucap draws them, so the two packages
resample the same indices.
"""

from __future__ import annotations

import json
import sys
from collections import Counter

import numpy as np

from tpucap_torch.train.metrics import CiderDScorer, meteor, rouge_l

_SENTINELS = ("startseq", "endseq")


def _strip(tokens: list[str]) -> list[str]:
    return [w for w in tokens if w not in _SENTINELS]


# -- BLEU sufficient statistics ---------------------------------------------


def bleu_sentence_stats(
    ref_tokens: list[list[str]], hyp_tokens: list[str], max_n: int = 4
):
    """-> (matches[max_n], totals[max_n], hyp_len, closest_ref_len).

    matches[n-1] is the CLIPPED n-gram match count (each hypothesis
    n-gram credited at most max-over-references count — NLTK
    modified_precision's numerator), totals[n-1] the hypothesis n-gram
    count CLAMPED to >= 1 (modified_precision returns Fraction(num,
    max(1, den)), so a sentence shorter than n still contributes 1 to
    the corpus denominator — matching that is what makes the
    differential test exact). closest_ref_len breaks ties toward the
    SHORTER reference (NLTK closest_ref_length's min over
    (abs diff, len))."""
    matches = np.zeros(max_n, np.int64)
    totals = np.zeros(max_n, np.int64)
    h = len(hyp_tokens)
    for n in range(1, max_n + 1):
        hyp_counts = Counter(
            tuple(hyp_tokens[i : i + n]) for i in range(h - n + 1)
        )
        totals[n - 1] = max(1, sum(hyp_counts.values()))
        if not hyp_counts:
            continue
        max_ref: Counter = Counter()
        for ref in ref_tokens:
            rc = Counter(
                tuple(ref[i : i + n]) for i in range(len(ref) - n + 1)
            )
            for g, c in rc.items():
                if c > max_ref[g]:
                    max_ref[g] = c
        matches[n - 1] = sum(
            min(c, max_ref[g]) for g, c in hyp_counts.items()
        )
    ref_len = min(
        (len(r) for r in ref_tokens),
        key=lambda rl: (abs(rl - h), rl),
    )
    return matches, totals, h, ref_len


def corpus_stats(
    references: list[list[list[str]]],
    hypotheses: list[list[str]],
    max_n: int = 4,
):
    """Stack per-image BLEU stats: -> dict of arrays keyed
    matches (N, max_n), totals (N, max_n), hyp_len (N,), ref_len (N,)."""
    ms, ts, hl, rl = [], [], [], []
    for refs, hyp in zip(references, hypotheses):
        m, t, h, r = bleu_sentence_stats(refs, hyp, max_n)
        ms.append(m)
        ts.append(t)
        hl.append(h)
        rl.append(r)
    return {
        "matches": np.asarray(ms, np.int64),
        "totals": np.asarray(ts, np.int64),
        "hyp_len": np.asarray(hl, np.int64),
        "ref_len": np.asarray(rl, np.int64),
    }


def corpus_bleu_from_stats(stats, weights=(0.25, 0.25, 0.25, 0.25)):
    """Corpus BLEU from summed sufficient statistics — exactly NLTK's
    corpus_bleu with SmoothingFunction().method0, the evaluate-surface
    default (``train/evaluate.py``'s ``bleu_scores``): a zero corpus
    precision is replaced by sys.float_info.min (method0's behavior),
    and the whole score is 0 only when there are no unigram matches at
    all. ``tests/test_torch_score.py`` holds it to tpucap's, which tpucap's
    tests hold to NLTK.

    ``stats`` arrays may carry a leading resample axis: matches/totals
    (..., N, max_n), hyp_len/ref_len (..., N) — the corpus sum runs
    over axis -2 / -1 and the BLEU algebra vectorizes over the rest.
    """
    m = stats["matches"].sum(axis=-2).astype(np.float64)
    t = stats["totals"].sum(axis=-2).astype(np.float64)
    c = stats["hyp_len"].sum(axis=-1).astype(np.float64)
    r = stats["ref_len"].sum(axis=-1).astype(np.float64)
    w = np.asarray(weights, np.float64)
    # modified_precision uses Fraction(num, max(1, den)); method0 then
    # maps a zero precision to float_info.min.
    p = m / np.maximum(t, 1.0)
    p = np.where(p > 0, p, sys.float_info.min)
    with np.errstate(divide="ignore", invalid="ignore"):
        score = np.exp((w * np.log(p)).sum(axis=-1))
        # brevity_penalty: 1 when c > r; 0 when c == 0; else exp(1-r/c).
        bp = np.where(
            c > r, 1.0, np.exp(1.0 - r / np.maximum(c, 1e-300))
        )
        bp = np.where(c == 0, 0.0, bp)
    # corpus_bleu early-returns 0 when the corpus has no unigram match.
    return np.where(m[..., 0] == 0, 0.0, bp * score)


# -- per-sentence scores for the mean-convention metrics ---------------------


def per_sentence_scores(
    references: list[list[list[str]]],
    hypotheses: list[list[str]],
    metric: str,
) -> np.ndarray:
    """Per-image scores whose corpus metric is their mean (the
    coco-caption conventions of ``train/metrics.py``). For 'cider' the
    IDF is fixed to the FULL reference corpus passed here."""
    if metric == "cider":
        scorer = CiderDScorer(references)
        return np.asarray(
            [
                scorer.score(refs, hyp)
                for refs, hyp in zip(references, hypotheses)
            ],
            np.float64,
        )
    if metric == "rouge_l":
        return np.asarray(
            [
                rouge_l([refs], [hyp])
                for refs, hyp in zip(references, hypotheses)
            ],
            np.float64,
        )
    if metric == "meteor":
        return np.asarray(
            [
                meteor([refs], [hyp])
                for refs, hyp in zip(references, hypotheses)
            ],
            np.float64,
        )
    raise ValueError(
        f"unknown per-sentence metric {metric!r}; have cider|rouge_l|meteor"
    )


# -- the paired bootstrap -----------------------------------------------------

_BLEU_WEIGHTS = {
    "bleu1": (1.0, 0.0, 0.0, 0.0),
    "bleu2": (0.5, 0.5, 0.0, 0.0),
    "bleu3": (1 / 3, 1 / 3, 1 / 3, 0.0),
    "bleu4": (0.25, 0.25, 0.25, 0.25),
}

METRICS = tuple(_BLEU_WEIGHTS) + ("cider", "rouge_l", "meteor")


def paired_bootstrap(
    references: list[list[list[str]]],
    hyps_a: list[list[str]],
    hyps_b: list[list[str]],
    *,
    metric: str = "bleu4",
    n_resamples: int = 1000,
    seed: int = 0,
) -> dict:
    """Koehn (2004): resample the image set with replacement
    ``n_resamples`` times, score BOTH systems on each identical
    resample, and read significance off the distribution of the paired
    delta (B - A).

    -> dict with the full-set scores/delta, the 95% percentile CI of
    the delta, the two-sided sign p-value (fraction of resamples where
    the delta's sign flips or vanishes, doubled, capped at 1), and the
    win counts. A p_value below 0.05 is the conventional "B is really
    different from A".
    """
    n = len(references)
    if not (n == len(hyps_a) == len(hyps_b)):
        raise ValueError(
            f"aligned corpora required: {n} reference sets vs "
            f"{len(hyps_a)}/{len(hyps_b)} hypotheses"
        )
    if n == 0:
        raise ValueError("empty corpus")
    if metric not in METRICS:
        raise ValueError(
            f"unknown metric {metric!r}; have {'|'.join(METRICS)}"
        )
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n_resamples, n))

    if metric in _BLEU_WEIGHTS:
        w = _BLEU_WEIGHTS[metric]
        sa = corpus_stats(references, hyps_a)
        sb = corpus_stats(references, hyps_b)
        score_a = float(corpus_bleu_from_stats(sa, w))
        score_b = float(corpus_bleu_from_stats(sb, w))
        res_a = corpus_bleu_from_stats(
            {k: v[idx] for k, v in sa.items()}, w
        )
        res_b = corpus_bleu_from_stats(
            {k: v[idx] for k, v in sb.items()}, w
        )
    else:
        pa = per_sentence_scores(references, hyps_a, metric)
        pb = per_sentence_scores(references, hyps_b, metric)
        score_a = float(pa.mean())
        score_b = float(pb.mean())
        res_a = pa[idx].mean(axis=-1)
        res_b = pb[idx].mean(axis=-1)

    deltas = res_b - res_a
    delta = score_b - score_a
    lo, hi = np.percentile(deltas, [2.5, 97.5])
    wins_b = int((deltas > 0).sum())
    wins_a = int((deltas < 0).sum())
    ties = int((deltas == 0).sum())
    # Two-sided sign test on the bootstrap distribution: how often does
    # the resampled delta fail to reproduce the full-set delta's sign?
    if delta > 0:
        flips = (deltas <= 0).mean()
    elif delta < 0:
        flips = (deltas >= 0).mean()
    else:
        flips = 0.5
    p_value = float(min(1.0, 2.0 * flips))
    return {
        "metric": metric,
        "n_images": n,
        "n_resamples": int(n_resamples),
        "score_a": score_a,
        "score_b": score_b,
        "delta": delta,
        "delta_ci95": [float(lo), float(hi)],
        "p_value": p_value,
        "wins_a": wins_a,
        "wins_b": wins_b,
        "ties": ties,
        "significant_at_05": p_value < 0.05,
    }


# -- the dump-file front-end --------------------------------------------------


def load_caption_dump(path: str) -> dict[str, dict]:
    """Parse an ``evaluate --dump-captions`` JSONL artifact:
    -> {image_id: {"caption": str, "references": [str, ...]}}."""
    out: dict[str, dict] = {}
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            for key in ("image_id", "caption", "references"):
                if key not in row:
                    raise ValueError(
                        f"{path}:{line_no}: missing {key!r} — is this an "
                        "`evaluate --dump-captions` artifact?"
                    )
            if not row["references"]:
                # An empty reference list would crash deep inside the
                # BLEU stats (min() over ref lengths) — name the row.
                raise ValueError(
                    f"{path}:{line_no}: image {row['image_id']!r} has "
                    "no references"
                )
            image_id = str(row["image_id"])
            if image_id in out:
                # Silently keeping the last row would compare a smaller
                # corpus than the file contains (e.g. two evaluate runs
                # appended to one path).
                raise ValueError(
                    f"{path}:{line_no}: duplicate image_id "
                    f"{image_id!r} — was the dump file appended to "
                    "by more than one evaluate run?"
                )
            out[image_id] = {
                "caption": row["caption"],
                "references": list(row["references"]),
            }
    if not out:
        raise ValueError(f"{path}: no caption rows")
    return out


def compare_caption_files(
    path_a: str,
    path_b: str,
    *,
    metric: str = "bleu4",
    n_resamples: int = 1000,
    seed: int = 0,
) -> dict:
    """Paired bootstrap over two ``--dump-captions`` files. Images are
    aligned by id (both files must cover the identical set — a paired
    test on mismatched sets would be meaningless, so that's an error,
    as are diverging references for the same image)."""
    a = load_caption_dump(path_a)
    b = load_caption_dump(path_b)
    if set(a) != set(b):
        only_a = sorted(set(a) - set(b))[:3]
        only_b = sorted(set(b) - set(a))[:3]
        raise ValueError(
            "image sets differ — paired testing needs identical ids "
            f"(only in A: {only_a}{'...' if len(set(a) - set(b)) > 3 else ''}; "
            f"only in B: {only_b}{'...' if len(set(b) - set(a)) > 3 else ''})"
        )
    ids = sorted(a)
    refs, hyps_a, hyps_b = [], [], []
    for i in ids:
        if a[i]["references"] != b[i]["references"]:
            raise ValueError(
                f"references for image {i!r} differ between the two "
                "files — were they evaluated on the same split?"
            )
        refs.append([_strip(r.split()) for r in a[i]["references"]])
        hyps_a.append(_strip(a[i]["caption"].split()))
        hyps_b.append(_strip(b[i]["caption"].split()))
    result = paired_bootstrap(
        refs,
        hyps_a,
        hyps_b,
        metric=metric,
        n_resamples=n_resamples,
        seed=seed,
    )
    result["file_a"] = path_a
    result["file_b"] = path_b
    return result
