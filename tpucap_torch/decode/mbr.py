"""Minimum-Bayes-risk (consensus) reranking of candidate captions (port of
``tpucap.decode.mbr``).

Generate N candidates an image, then pick the one with the highest
expected utility against the other candidates: the caption that agrees
most with the rest of its pool (Devlin et al. 2015's CIDEr consensus; MBR
decoding in NMT). Selection is host post-processing of decoded strings;
the device work is the N decodes, which the pipeline takes from the
sampler, the n-best beam or the diverse beam groups. Utilities:

- 'cider': per-sentence CIDEr-D (``train.metrics.CiderDScorer``) with the
  IDF taken over the candidate pools, each candidate scored with the other
  candidates of its image as the references;
- 'bleu4': smoothed sentence BLEU-4 against the other candidates
  (``train.evaluate.sentence_bleu``: NLTK's ``sentence_bleu`` with
  ``method1`` smoothing, written out; the port imports no NLTK).
"""

from __future__ import annotations

from tpucap_torch.train.evaluate import sentence_bleu
from tpucap_torch.train.metrics import CiderDScorer


def mbr_select(
    candidates: list[list[str]], *, metric: str = "cider"
) -> tuple[list[int], list[float]]:
    """candidates: per-image list of caption strings (N >= 1 each).
    Returns (per-image index of the consensus pick, its expected
    utility). Ties resolve to the lowest index; single-candidate pools
    pick index 0 with utility 0."""
    if metric not in ("cider", "bleu4"):
        raise ValueError(f"unknown MBR metric {metric!r}; cider|bleu4")
    if not candidates:
        return [], []
    tokenized = [[c.split() for c in pool] for pool in candidates]

    if metric == "cider":
        # IDF over the candidate pools (each pool one "image"): n-grams that
        # every candidate shares weigh little, as in the corpus metric.
        scorer = CiderDScorer(tokenized)

        def utility(others, hyp):
            return scorer.score(others, hyp) if others else 0.0

    else:

        def utility(others, hyp):
            return sentence_bleu(others, hyp) if others else 0.0

    picks, utils = [], []
    for pool in tokenized:
        best_i, best_u = 0, float("-inf")
        for i, hyp in enumerate(pool):
            u = utility(pool[:i] + pool[i + 1:], hyp)
            if u > best_u:  # strict: ties keep the lowest index
                best_i, best_u = i, u
        picks.append(best_i)
        utils.append(best_u if len(pool) > 1 else 0.0)
    return picks, utils
