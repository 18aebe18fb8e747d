"""CIDEr-D, ROUGE-L, METEOR and diversity statistics of generated captions
(port of ``tpucap.train.metrics``), in plain Python.

- **CIDEr-D**: TF-IDF n-gram (n = 1..4) cosine between the candidate and
  each reference, counts clipped to the reference's, a Gaussian length
  penalty (sigma 6); per image the mean over n and references, x10; the
  corpus score is the mean over images. IDF is ``log(N_images) -
  log(max(1, DF))`` with DF over each image's reference set.
- **ROUGE-L**: LCS precision and recall, each the maximum over references,
  combined with F-beta (beta 1.2); the mean over images.
- **METEOR**: NLTK's ``meteor_score`` (``nltk/translate/meteor_score.py``,
  nltk 3.10.0) copied here: exact, Porter-stem and synonym stages, each
  matching hypothesis words from the last to the first against the highest
  reference position still free; chunks; alpha 0.9, beta 3, gamma 0.5; the
  maximum over references. The synonym stage reads ``synsets(word)`` /
  ``lemmas()`` / ``name()`` from ``SynonymTable`` or the empty
  ``_NoWordnet`` (no WordNet offline: exact + stem, a lower bound).
- **caption_stats**: distinct-1/2, vocabulary used, share of unique
  captions, mean length.

Each takes the (references, hypotheses) token-list layout of
``train.evaluate.bleu_scores``.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict

from tpucap_torch.text.porter import PorterStemmer

_CIDER_N = 4
_CIDER_SIGMA = 6.0
_ROUGE_BETA = 1.2


def _check_corpus(references, hypotheses) -> None:
    if len(references) != len(hypotheses):
        raise ValueError(f"{len(references)} reference sets vs {len(hypotheses)} hypotheses")
    if not references:
        raise ValueError("empty corpus")


def _ngram_counts(tokens: list, n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _counts_to_vec(tokens: list, doc_freq: dict, log_n: float):
    """-> (per-n {ngram: tfidf}, per-n L2 norm, length)."""
    vecs, norms = [], []
    for n in range(1, _CIDER_N + 1):
        vec = {}
        for ngram, count in _ngram_counts(tokens, n).items():
            vec[ngram] = count * (log_n - math.log(max(1.0, doc_freq.get(ngram, 0.0))))
        vecs.append(vec)
        norms.append(math.sqrt(sum(v * v for v in vec.values())))
    return vecs, norms, len(tokens)


class CiderDScorer:
    """Per-sentence CIDEr-D against the document frequencies of the
    reference sets given to the constructor; ``cider_d`` is its mean."""

    def __init__(self, corpus_references: list[list[list[str]]]):
        if not corpus_references:
            raise ValueError("empty corpus")
        doc_freq: Counter = Counter()
        for refs in corpus_references:
            seen = set()
            for ref in refs:
                for n in range(1, _CIDER_N + 1):
                    seen.update(_ngram_counts(ref, n))
            doc_freq.update(seen)
        self.doc_freq = doc_freq
        self.log_n = math.log(float(len(corpus_references)))

    def score(self, references: list[list[str]], hypothesis: list[str]) -> float:
        """One image's tokenized references and candidate -> CIDEr-D (x10)."""
        vec_h, norm_h, len_h = _counts_to_vec(hypothesis, self.doc_freq, self.log_n)
        per_n = [0.0] * _CIDER_N
        for ref in references:
            vec_r, norm_r, len_r = _counts_to_vec(ref, self.doc_freq, self.log_n)
            penalty = math.exp(-((len_h - len_r) ** 2) / (2.0 * _CIDER_SIGMA**2))
            for n in range(_CIDER_N):
                val = sum(
                    min(w, vec_r[n].get(g, 0.0)) * vec_r[n].get(g, 0.0)
                    for g, w in vec_h[n].items()
                )
                if norm_h[n] != 0.0 and norm_r[n] != 0.0:
                    val /= norm_h[n] * norm_r[n]
                per_n[n] += val * penalty
        return sum(per_n) / _CIDER_N / max(1, len(references)) * 10.0


def cider_d(references, hypotheses) -> float:
    """Corpus CIDEr-D (sigma 6, n 1..4, DF over reference sets)."""
    if len(references) != len(hypotheses):
        raise ValueError(f"{len(references)} reference sets vs {len(hypotheses)} hypotheses")
    scorer = CiderDScorer(references)
    scores = [scorer.score(refs, hyp) for refs, hyp in zip(references, hypotheses)]
    return float(sum(scores) / len(scores))


def _lcs_len(a: list, b: list) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[-1]


def rouge_l(references, hypotheses) -> float:
    """Corpus ROUGE-L: per image the maximum precision and the maximum
    recall over references, F-beta (beta 1.2); the mean over images."""
    _check_corpus(references, hypotheses)
    beta2 = _ROUGE_BETA**2
    scores = []
    for refs, hyp in zip(references, hypotheses):
        prec_max = rec_max = 0.0
        for ref in refs:
            lcs = _lcs_len(hyp, ref)
            if hyp:
                prec_max = max(prec_max, lcs / len(hyp))
            if ref:
                rec_max = max(rec_max, lcs / len(ref))
        if prec_max and rec_max:
            f = ((1 + beta2) * prec_max * rec_max) / (rec_max + beta2 * prec_max)
        else:
            f = 0.0
        scores.append(f)
    return float(sum(scores) / len(scores))


# -- METEOR ------------------------------------------------------------------


class _NoWordnet:
    """A synonym source with no synonyms: the stage matches nothing."""

    def synsets(self, word):
        del word
        return []


class _Lemma:
    __slots__ = ("_name",)

    def __init__(self, name):
        self._name = name

    def name(self):
        return self._name


class _Synset:
    __slots__ = ("_lemmas",)

    def __init__(self, words):
        self._lemmas = [_Lemma(w) for w in words]

    def lemmas(self):
        return self._lemmas


class SynonymTable:
    """Synonym groups for METEOR's synonym stage, read through the surface
    of NLTK's WordNet reader (``synsets(word)`` -> [synset],
    ``synset.lemmas()`` -> [lemma], ``lemma.name()`` -> str).

    Built from a mapping ``{word: [synonyms...]}`` or from groups of words;
    ``from_file`` reads one group a line, words separated by whitespace or
    commas, ``#`` comments. Membership of a group is enough (symmetric). The
    stem stage hands the synonym stage Porter stems of the words it left,
    so each group also holds its members' stems."""

    def __init__(self, groups_or_map):
        stem = PorterStemmer().stem
        if hasattr(groups_or_map, "items"):
            groups = [{str(w), *map(str, syns)} for w, syns in groups_or_map.items()]
        else:
            groups = [set(map(str, g)) for g in groups_or_map]
        self._syns: dict[str, set] = {}
        for group in groups:
            group = group | {stem(w) for w in group}
            for word in group:
                self._syns.setdefault(word, set()).update(group)

    @classmethod
    def from_file(cls, path) -> "SynonymTable":
        groups = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                words = [w for w in line.replace(",", " ").split() if w]
                if len(words) >= 2:
                    groups.append(words)
        return cls(groups)

    def synsets(self, word):
        group = self._syns.get(word)
        return [_Synset(sorted(group))] if group else []


def _match_enums(enum_hyp, enum_ref):
    """Exact matches of (position, word) lists, hypothesis words from the
    last, each to the highest free reference position of the same word.
    -> (matches (hyp pos, ref pos), unmatched hyp, unmatched ref)."""
    ref_positions = defaultdict(list)
    for j, (_, word) in enumerate(enum_ref):
        ref_positions[word].append(j)
    matches, hit_h, hit_r = [], set(), set()
    for i in range(len(enum_hyp))[::-1]:
        positions = ref_positions.get(enum_hyp[i][1])
        if positions:
            j = positions.pop()
            hit_h.add(i)
            hit_r.add(j)
            matches.append((enum_hyp[i][0], enum_ref[j][0]))
    return (
        matches,
        [p for i, p in enumerate(enum_hyp) if i not in hit_h],
        [p for j, p in enumerate(enum_ref) if j not in hit_r],
    )


def _enum_stem_match(enum_hyp, enum_ref, stemmer):
    return _match_enums(
        [(i, stemmer.stem(w)) for i, w in enum_hyp], [(j, stemmer.stem(w)) for j, w in enum_ref]
    )


def _enum_synonym_match(enum_hyp, enum_ref, wordnet):
    """Each hypothesis word (from the last) to the highest free reference
    position whose word is the word itself or one of its synonyms (lemma
    names without '_')."""
    ref_positions = defaultdict(list)
    for j, (_, word) in enumerate(enum_ref):
        ref_positions[word].append(j)
    matches, hit_h, hit_r = [], set(), set()
    for i in range(len(enum_hyp))[::-1]:
        word = enum_hyp[i][1]
        syns = {
            lemma.name()
            for synset in wordnet.synsets(word)
            for lemma in synset.lemmas()
            if lemma.name().find("_") < 0
        } | {word}
        best_j, best_word = -1, None
        for syn in syns:
            positions = ref_positions.get(syn)
            if positions and positions[-1] > best_j:
                best_j, best_word = positions[-1], syn
        if best_word is not None:
            ref_positions[best_word].pop()
            hit_h.add(i)
            hit_r.add(best_j)
            matches.append((enum_hyp[i][0], enum_ref[best_j][0]))
    return (
        matches,
        [p for i, p in enumerate(enum_hyp) if i not in hit_h],
        [p for j, p in enumerate(enum_ref) if j not in hit_r],
    )


def _align_words(enum_hyp, enum_ref, stemmer, wordnet):
    exact, enum_hyp, enum_ref = _match_enums(enum_hyp, enum_ref)
    stem, enum_hyp, enum_ref = _enum_stem_match(enum_hyp, enum_ref, stemmer)
    syn, enum_hyp, enum_ref = _enum_synonym_match(enum_hyp, enum_ref, wordnet)
    return sorted(exact + stem + syn, key=lambda pair: pair[0])


def _count_chunks(matches) -> int:
    """The fewest runs of matches adjacent on both sides."""
    chunks = 1
    for a, b in zip(matches, matches[1:]):
        if not (b[0] == a[0] + 1 and b[1] == a[1] + 1):
            chunks += 1
    return chunks


def single_meteor_score(reference, hypothesis, *, stemmer, wordnet, alpha=0.9, beta=3.0,
                        gamma=0.5) -> float:
    """NLTK's ``single_meteor_score`` (words lowercased first)."""
    enum_hyp = list(enumerate(map(str.lower, hypothesis)))
    enum_ref = list(enumerate(map(str.lower, reference)))
    translation_length, reference_length = len(enum_hyp), len(enum_ref)
    matches = _align_words(enum_hyp, enum_ref, stemmer, wordnet)
    matches_count = len(matches)
    try:
        precision = float(matches_count) / translation_length
        recall = float(matches_count) / reference_length
        fmean = (precision * recall) / (alpha * precision + (1 - alpha) * recall)
        frag_frac = float(_count_chunks(matches)) / matches_count
    except ZeroDivisionError:
        return 0.0
    penalty = gamma * frag_frac**beta
    return (1 - penalty) * fmean


def meteor_score(references, hypothesis, *, stemmer=None, wordnet=None) -> float:
    """NLTK's ``meteor_score``: the best single score over the references."""
    stemmer = stemmer or PorterStemmer()
    wordnet = wordnet or _NoWordnet()
    return max(
        single_meteor_score(r, hypothesis, stemmer=stemmer, wordnet=wordnet) for r in references
    )


def meteor(references, hypotheses, synonyms=None) -> float:
    """Corpus METEOR: per image the best score over its references, the mean
    over images. ``synonyms``: None (no synonym stage: exact + stem), a
    ``SynonymTable``, a path to a synonym-groups file, or a
    ``{word: [synonyms]}`` mapping."""
    _check_corpus(references, hypotheses)
    if synonyms is None:
        wn = _NoWordnet()
    elif isinstance(synonyms, SynonymTable):
        wn = synonyms
    elif isinstance(synonyms, (str, bytes)) or hasattr(synonyms, "__fspath__"):
        wn = SynonymTable.from_file(synonyms)
    else:
        wn = SynonymTable(synonyms)
    stemmer = PorterStemmer()
    scores = [
        meteor_score(refs, hyp, stemmer=stemmer, wordnet=wn)
        for refs, hyp in zip(references, hypotheses)
    ]
    return float(sum(scores) / len(scores))


def caption_stats(hypotheses: list[list[str]]) -> dict[str, float]:
    """Reference-free statistics of a caption set: distinct_1 / distinct_2
    (unique n-grams over all n-grams; None where the corpus has no n-gram
    of that order), vocab_used, unique_captions (the share of captions no
    other image has) and mean_len (words)."""
    if not hypotheses:
        raise ValueError("empty corpus")
    total = {1: 0, 2: 0}
    uniq: dict[int, set] = {1: set(), 2: set()}
    for hyp in hypotheses:
        for n in (1, 2):
            grams = [tuple(hyp[i : i + n]) for i in range(len(hyp) - n + 1)]
            total[n] += len(grams)
            uniq[n].update(grams)
    caps = Counter(tuple(h) for h in hypotheses)
    return {
        "distinct_1": len(uniq[1]) / total[1] if total[1] else None,
        "distinct_2": len(uniq[2]) / total[2] if total[2] else None,
        "vocab_used": float(len(uniq[1])),
        "unique_captions": sum(1 for c in caps.values() if c == 1) / len(hypotheses),
        "mean_len": sum(len(h) for h in hypotheses) / len(hypotheses),
    }
