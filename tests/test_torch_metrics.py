"""The port's caption metrics against NLTK's and tpucap's, on the CPU.

- corpus BLEU (``tpucap_torch.train.evaluate``) against NLTK's
  ``corpus_bleu`` with ``SmoothingFunction().method0`` and against tpucap's
  ``bleu_scores``;
- CIDEr-D, ROUGE-L, METEOR (no synonyms, a mapping, a groups file) and
  ``caption_stats`` against tpucap's (``tpucap.train.metrics``, whose METEOR
  is NLTK's ``meteor_score``);
- the port's Porter stemmer against NLTK's ``PorterStemmer`` on words that
  reach every rule and the irregular pool, and on drawn lowercase words.

Corpora are drawn by hypothesis from a small vocabulary with inflected
forms (so the stem stage fires), with empty hypotheses, single words and
repeated n-grams. The arithmetic is the same on both sides: scores within
1e-12.
"""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from nltk.stem.porter import PorterStemmer as NltkStemmer
from nltk.translate.bleu_score import SmoothingFunction
from nltk.translate.bleu_score import corpus_bleu as nltk_corpus_bleu

from tpucap.train import evaluate as jeval
from tpucap.train import metrics as jmetrics
from tpucap_torch.text.porter import PorterStemmer
from tpucap_torch.train import evaluate as teval
from tpucap_torch.train import metrics as tmetrics

torch.set_num_threads(2)

TOL = 1e-12
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True, database=None)

# Words with inflections and derivations the Porter steps join.
VOCAB = [
    "a", "the", "dog", "dogs", "run", "runs", "running", "ran", "jump", "jumped",
    "jumping", "jumps", "play", "played", "playing", "ball", "balls", "happy",
    "happily", "happiness", "fly", "flies", "flying", "sky", "skies", "red",
    "grass", "grassy", "relate", "relational", "relation", "connect",
    "connected", "connection", "is", "on", "in", "of", "man", "men", "canine",
]
SYNONYMS = {"dog": ["canine", "hound"], "run": ["sprint"], "happy": ["glad", "cheerful"]}
FIXTURE_SYNONYMS = str(Path(__file__).parent / "fixtures" / "synonyms.txt")

sentence = st.lists(st.sampled_from(VOCAB), min_size=0, max_size=9)
nonempty = st.lists(st.sampled_from(VOCAB), min_size=1, max_size=9)
# A repeated n-gram: a short sentence written twice or three times.
repeated = st.builds(lambda s, k: s * k, st.lists(st.sampled_from(VOCAB), min_size=1, max_size=3),
                     st.integers(2, 3))
hypotheses = st.one_of(sentence, repeated)
corpora = st.integers(1, 6).flatmap(
    lambda n: st.tuples(
        st.lists(st.lists(st.one_of(nonempty, repeated), min_size=1, max_size=4),
                 min_size=n, max_size=n),
        st.lists(hypotheses, min_size=n, max_size=n),
    )
)


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def nltk_bleu(refs, hyps):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return [
            float(nltk_corpus_bleu(refs, hyps, weights=w,
                                   smoothing_function=SmoothingFunction().method0))
            for w in teval.BLEU_WEIGHTS.values()
        ]


def tpucap_bleu(refs, hyps):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jeval.bleu_scores(refs, hyps)


# -- BLEU ---------------------------------------------------------------------


@SETTINGS
@given(corpora)
def test_corpus_bleu_matches_nltk_and_tpucap(corpus):
    refs, hyps = corpus
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the port warns about nothing
        got = teval.bleu_scores(refs, hyps)
    close(list(got.values()), nltk_bleu(refs, hyps))
    want = tpucap_bleu(refs, hyps)
    assert list(got) == list(want)
    close(list(got.values()), list(want.values()))


@pytest.mark.parametrize(
    "refs, hyps",
    [
        ([[["a", "dog", "runs"]]], [[]]),  # an empty hypothesis: brevity penalty 0
        ([[["a", "dog", "runs"]]], [["a"]]),  # one word: no bigram at all
        ([[["a", "dog"], ["a", "dog", "runs", "on"]]], [["a", "dog", "runs"]]),  # tie: the shorter
        ([[["the", "the", "dog"]]], [["the"] * 7]),  # clipped counts
        ([[["red", "ball"]]], [["blue", "sky"]]),  # no unigram matches: 0
        ([[["a", "dog", "runs", "on", "the", "grass"]]] * 2,
         [["a", "dog", "runs", "on", "the", "grass"], ["dog", "a"]]),
    ],
)
def test_corpus_bleu_edge_cases(refs, hyps):
    got = teval.bleu_scores(refs, hyps)
    close(list(got.values()), nltk_bleu(refs, hyps))
    close(list(got.values()), list(tpucap_bleu(refs, hyps).values()))


def test_bleu_pieces_match_nltk():
    from nltk.translate import bleu_score as nb

    refs = [["a", "dog", "runs", "a", "dog"], ["the", "dog", "runs"]]
    for hyp in (["a", "dog", "a", "dog", "a"], [], ["runs"]):
        for n in (1, 2, 3):
            p = nb.modified_precision(refs, hyp, n)
            assert teval.modified_precision(refs, hyp, n) == (p.numerator, p.denominator)
        assert teval.closest_ref_length(refs, len(hyp)) == nb.closest_ref_length(refs, len(hyp))
    for r, c in ((5, 0), (5, 3), (3, 5), (4, 4)):
        assert teval.brevity_penalty(r, c) == nb.brevity_penalty(r, c)


# -- CIDEr-D, ROUGE-L, caption_stats ---------------------------------------------


@SETTINGS
@given(corpora)
def test_cider_rouge_and_stats_match_tpucap(corpus):
    refs, hyps = corpus
    close(tmetrics.cider_d(refs, hyps), jmetrics.cider_d(refs, hyps))
    close(tmetrics.rouge_l(refs, hyps), jmetrics.rouge_l(refs, hyps))
    got, want = tmetrics.caption_stats(hyps), jmetrics.caption_stats(hyps)
    assert list(got) == list(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            close(got[k], want[k])
    scorer, jscorer = tmetrics.CiderDScorer(refs), jmetrics.CiderDScorer(refs)
    for r, h in zip(refs, hyps):
        close(scorer.score(r, h), jscorer.score(r, h))


def test_metric_errors_match_tpucap():
    for fn in ("cider_d", "rouge_l", "meteor"):
        for args in (([], []), ([[["a"]]], [])):
            with pytest.raises(ValueError):
                getattr(jmetrics, fn)(*args)
            with pytest.raises(ValueError):
                getattr(tmetrics, fn)(*args)
    for mod in (jmetrics, tmetrics):
        with pytest.raises(ValueError):
            mod.caption_stats([])
        assert mod.caption_stats([["a"], ["b"]])["distinct_2"] is None


# -- METEOR ---------------------------------------------------------------------


@pytest.mark.parametrize("synonyms", [None, "mapping", "file", "table"])
@SETTINGS
@given(corpus=corpora)
def test_meteor_matches_tpucap(synonyms, corpus):
    refs, hyps = corpus
    syn = {
        None: None,
        "mapping": SYNONYMS,
        "file": FIXTURE_SYNONYMS,
        "table": tmetrics.SynonymTable(SYNONYMS),
    }[synonyms]
    jsyn = jmetrics.SynonymTable(SYNONYMS) if synonyms == "table" else syn
    close(tmetrics.meteor(refs, hyps, synonyms=syn), jmetrics.meteor(refs, hyps, synonyms=jsyn))


def test_meteor_stages_fire():
    """The stem and synonym stages change the score where tpucap's do, and
    the sentence scores equal NLTK's ``meteor_score``."""
    from nltk.translate.meteor_score import meteor_score

    refs = [[["a", "dog", "runs", "on", "the", "grass"], ["the", "happy", "dog", "jumped"]]]
    hyp = [["a", "hound", "running", "on", "grass", "happily"]]
    plain = tmetrics.meteor(refs, hyp)
    syn = tmetrics.meteor(refs, hyp, synonyms=SYNONYMS)
    unstemmed = tmetrics.meteor(refs, [["a", "hound", "ran", "on", "grass", "happily"]])
    assert syn > plain > unstemmed > 0
    close(plain, jmetrics.meteor(refs, hyp))
    close(syn, jmetrics.meteor(refs, hyp, synonyms=SYNONYMS))
    for wn, jwn in ((tmetrics._NoWordnet(), jmetrics._NoWordnet()),
                    (tmetrics.SynonymTable(SYNONYMS), jmetrics.SynonymTable(SYNONYMS))):
        close(tmetrics.meteor_score(refs[0], hyp[0], wordnet=wn),
              meteor_score(refs[0], hyp[0], wordnet=jwn))


def test_synonym_table_matches_tpucap():
    for src in (SYNONYMS, [["dog", "canine"], ["running", "sprinting", "dashes"]]):
        got, want = tmetrics.SynonymTable(src), jmetrics.SynonymTable(src)
        assert got._syns == want._syns
    got = tmetrics.SynonymTable.from_file(FIXTURE_SYNONYMS)
    assert got._syns == jmetrics.SynonymTable.from_file(FIXTURE_SYNONYMS)._syns
    assert [lem.name() for s in got.synsets("canin") for lem in s.lemmas()] == [
        lem.name() for s in jmetrics.SynonymTable.from_file(FIXTURE_SYNONYMS).synsets("canin")
        for lem in s.lemmas()
    ]
    assert got.synsets("zebra") == []


# -- evaluate_captions ---------------------------------------------------------------


def test_evaluate_captions_matches_tpucap():
    desc = {
        "i1": ["startseq a dog runs on the grass endseq", "startseq the dog is running endseq"],
        "i2": ["startseq a man played ball endseq", "startseq men playing endseq"],
        "i3": ["startseq the sky endseq"],
    }
    gen = {"i1": "a dog running on grass", "i2": "startseq a man plays ball endseq", "i3": ""}
    metrics = ("bleu", "cider", "rouge_l", "meteor", "diversity")
    for strip in (True, False):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jeval.evaluate_captions(desc, gen, metrics=metrics, strip_sentinels=strip,
                                           meteor_synonyms=SYNONYMS)
        got = teval.evaluate_captions(desc, gen, metrics=metrics, strip_sentinels=strip,
                                      meteor_synonyms=SYNONYMS)
        assert list(got) == list(want)
        close([got[k] for k in want], [want[k] for k in want])
    with pytest.raises(ValueError, match="unknown metrics"):
        teval.evaluate_captions(desc, gen, metrics=("spice",))


# -- the Porter stemmer -----------------------------------------------------------------

# Words that reach each rule of each step, both sides of its condition, and
# the irregular pool (NLTK's own examples and the paper's).
STEM_WORDS = """
caresses ponies ties caress cats dies lies flies feed agreed plastered bled
motoring sing conflated troubled sized hopping tanned falling hissing fizzed
failing filing died spied cried tied happy sky enjoy spy fly try relational
conditional rational valenci hesitanci digitizer conformabli radicalli
differentli vileli analogousli vietnamization predication operator
feudalism decisiveness hopefulness callousness formaliti sensitiviti
sensibiliti fulli hopefulli archaeologi geologi theologi triplicate
formative formalize electriciti electrical hopeful goodness revival
allowance inference airliner gyroscopic adjustable defensible irritant
replacement adjustment dependent adoption homologou communism activate
angulariti homologous effective bowdlerize probate rate cease controll
roll skies dying lying tying news innings inning outings outing cannings
canning howe proceed exceed succeed generously ably rally tally
syzygy toy yyyy yay eyed sayings a is as be by ox axe ies ied eed ing
abed bling ting meeting mating meeeting capitalli feasibly dresses
happiness skis caresses generalization oscillators Running DOGS Flies
""".split()


def test_porter_matches_nltk_on_every_rule():
    theirs, ours = NltkStemmer(), PorterStemmer()
    for w in STEM_WORDS:
        assert ours.stem(w) == theirs.stem(w), w
        assert ours.stem(w, to_lowercase=False) == theirs.stem(w, to_lowercase=False), w
    for w in VOCAB:
        assert ours.stem(w) == theirs.stem(w), w


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(st.text(alphabet="abcdeilnorstuyz", min_size=0, max_size=14))
def test_porter_matches_nltk_on_drawn_words(word):
    assert PorterStemmer().stem(word) == NltkStemmer().stem(word)
