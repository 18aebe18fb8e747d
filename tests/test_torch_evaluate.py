"""``evaluate`` and ``fit(val_data=...)`` of tpucap_torch against tpucap's, on
the CPU, same weights (bridged), f32: vit_tiny features (64-d), lstm1 with
embed 16 and hidden 32, max_len 8, beam 3, a corpus of 10 images with 3
captions each in inflected words.

- ``evaluate(return_captions=True)``: the captions identical, token for
  token, and every score within 1e-12 (the same captions through the same
  arithmetic), greedy and beam, with a zero-padded tail chunk;
- ``fit(val_data=...)``: per-epoch val_loss and val_accuracy within
  rtol 1e-6 (three epochs: the two trainings drift apart by summation order,
  measured at most 3e-7), the train losses within fit's 1e-5; the decode
  monitors val_bleu4 and val_cider equal to tpucap's; early stopping at the
  same epoch; and a run with val_data trains exactly as a run without it,
  dropout on (the evaluation draws nothing from the dropout generator).
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from tpucap import config as jcfg
from tpucap.pipeline import CaptioningPipeline as JaxPipeline
from tpucap_torch import config as tcfg
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer

from ports_init import build_on_ports_init

torch.set_num_threads(2)

STEMS = ["dog", "run", "play", "jump", "ball", "grass", "man", "child", "red", "blue", "water",
         "sit"]
FORMS = {"dog": ["dog", "dogs"], "run": ["runs", "running", "ran"],
         "play": ["plays", "playing", "played"], "jump": ["jumps", "jumping", "jumped"]}
SYNONYMS = {"dog": ["hound"], "child": ["kid"]}
METRICS = ("bleu", "cider", "rouge_l", "meteor", "diversity")


def _corpus():
    rng = np.random.default_rng(5)
    caps = {}
    for i in range(10):
        base = list(rng.choice(STEMS, 5, replace=False))
        caps[f"img{i}"] = [
            "startseq a " + " ".join(rng.choice(FORMS.get(s, [s])) for s in base[: 3 + j])
            + " endseq"
            for j in range(3)
        ]
    feats = {k: rng.normal(size=64).astype(np.float32) for k in caps}
    return caps, feats


CAPTIONS, FEATURES = _corpus()
TRAIN = {k: CAPTIONS[k] for k in list(CAPTIONS)[:7]}
HELD_OUT = {k: CAPTIONS[k] for k in list(CAPTIONS)[7:]}


def _pipelines(rate=0.0, **train):
    train = dict(dict(batch_size=8, learning_rate=3e-2, seed=3), **train)
    dec = dict(embed_dim=16, hidden_dim=32, dropout_rate=rate)
    decode = dict(max_len=8, beam_width=3)
    jpipe = JaxPipeline(
        jcfg.Config(
            encoder=jcfg.encoder_config("vit_tiny"), decoder=jcfg.DecoderConfig(**dec),
            decode=jcfg.DecodeConfig(**decode), train=jcfg.TrainConfig(**train), precision="f32",
        )
    )
    jpipe.fit_tokenizer(CAPTIONS)
    build_on_ports_init(jpipe, 4)
    pipe = CaptioningPipeline(
        tcfg.Config(
            encoder=tcfg.encoder_config("vit_tiny"), decoder=tcfg.DecoderConfig(**dec),
            decode=tcfg.DecodeConfig(**decode), train=tcfg.TrainConfig(**train), precision="f32",
        ),
        tokenizer=Tokenizer.from_json(jpipe.tokenizer.to_json()),
        device="cpu",
    )
    pipe.build(init_params=False)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    return jpipe, pipe


@pytest.fixture(scope="module")
def trained():
    """Both pipelines on tpucap's weights after four epochs, so the captions
    share words with the references."""
    jpipe, pipe = _pipelines()
    jpipe.fit(CAPTIONS, FEATURES, epochs=4, log=None)
    pipe.set_params(params_from_jax(jax.tree.map(np.asarray, jpipe.params)))
    return jpipe, pipe


def _tpucap_evaluate(jpipe, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # NLTK warns on orders without matches
        return jpipe.evaluate(*args, **kw)


# -- evaluate --------------------------------------------------------------------


@pytest.mark.parametrize("method", ["greedy", "beam"])
@pytest.mark.parametrize("synonyms", [None, SYNONYMS])
def test_evaluate_matches_tpucap(trained, method, synonyms):
    """Batches of 4 over 10 images: the last chunk is 2 rows and 2 of zeros."""
    jpipe, pipe = trained
    kw = dict(batch_size=4, method=method, metrics=METRICS, return_captions=True,
              meteor_synonyms=synonyms)
    want_scores, want_caps = _tpucap_evaluate(jpipe, CAPTIONS, FEATURES, **kw)
    scores, caps = pipe.evaluate(CAPTIONS, FEATURES, **kw)
    assert caps == want_caps
    assert list(caps) == list(CAPTIONS) and len(set(caps.values())) > 3
    assert list(scores) == list(want_scores)
    np.testing.assert_allclose([scores[k] for k in want_scores],
                               [want_scores[k] for k in want_scores], rtol=0, atol=1e-12)
    assert scores["bleu1"] > 0.3 and scores["cider"] > 0.3 and scores["meteor"] > 0.2


def test_evaluate_defaults_and_refusals(trained):
    """The default metric is BLEU, the default method the config's; an
    unknown metric and a parallelism other than none raise before decoding."""
    jpipe, pipe = trained
    want = _tpucap_evaluate(jpipe, CAPTIONS, FEATURES, batch_size=3)
    got = pipe.evaluate(CAPTIONS, FEATURES, batch_size=3, parallelism="none")
    assert list(got) == ["bleu1", "bleu2", "bleu3", "bleu4"]
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="unknown metrics"):
        pipe.evaluate(CAPTIONS, FEATURES, metrics=("spice",))
    with pytest.raises(NotImplementedError, match="parallelism"):
        pipe.evaluate(CAPTIONS, FEATURES, parallelism="dp")


def test_evaluate_captions_equal_generate(trained):
    """A padded chunk's captions are those of its real rows."""
    _, pipe = trained
    ids = list(CAPTIONS)[:5]
    _, caps = pipe.evaluate({k: CAPTIONS[k] for k in ids}, FEATURES, batch_size=8,
                            method="beam", return_captions=True)
    want = pipe.generate(np.stack([FEATURES[k] for k in ids]), method="beam")
    assert list(caps.values()) == want


# -- fit(val_data=...) -------------------------------------------------------------


def _compare_histories(got, want, keys, rtol):
    assert len(got) == len(want)
    assert [sorted(e) for e in got] == [sorted(e) for e in want]
    for g, w in zip(got, want):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)


def test_fit_val_loss_matches_tpucap():
    jpipe, pipe = _pipelines()
    want = jpipe.fit(TRAIN, FEATURES, epochs=3, val_data=(HELD_OUT, FEATURES), log=None)
    got = pipe.fit(TRAIN, FEATURES, epochs=3, val_data=(HELD_OUT, FEATURES), log=None)
    _compare_histories(got, want, ("val_loss", "val_accuracy"), 1e-6)
    _compare_histories(got, want, ("loss", "accuracy"), 1e-5)


@pytest.mark.parametrize("metric", ["bleu4", "cider"])
def test_fit_val_decode_metric_matches_tpucap(metric):
    """The greedy decode of the dev split (here the training split) on the
    current params gives tpucap's captions, so the same metric values."""
    jpipe, pipe = _pipelines(val_metric=metric)
    val = (CAPTIONS, FEATURES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jpipe.fit(CAPTIONS, FEATURES, epochs=3, val_data=val, log=None)
    got = pipe.fit(CAPTIONS, FEATURES, epochs=3, val_data=val, log=None)
    _compare_histories(got, want, ("val_loss", "val_accuracy"), 1e-6)
    key = f"val_{metric}"
    assert [e[key] for e in got] == [e[key] for e in want]
    assert got[-1][key] > 0


def test_early_stopping_matches_tpucap():
    """val_loss on a held-out split rises after the second epoch: with
    patience 1 both stop at epoch 2, logging the same line."""
    jpipe, pipe = _pipelines(early_stopping_patience=1)
    jlog, tlog = [], []
    want = jpipe.fit(TRAIN, FEATURES, epochs=6, val_data=(HELD_OUT, FEATURES), log=jlog.append)
    got = pipe.fit(TRAIN, FEATURES, epochs=6, val_data=(HELD_OUT, FEATURES), log=tlog.append)
    assert len(got) == len(want) < 6
    assert tlog[-1] == jlog[-1] and tlog[-1].startswith(f"early stopping at epoch {len(got) - 1}")
    _compare_histories(got, want, ("val_loss", "val_accuracy"), 1e-6)


def test_validation_draws_no_randomness():
    """Dropout on: the train losses and the final params of a run with a dev
    split and a decode monitor equal those of a run without one."""
    _, plain = _pipelines(rate=0.5)
    _, monitored = _pipelines(rate=0.5, val_metric="cider")
    want = plain.fit(TRAIN, FEATURES, epochs=3, log=None)
    got = monitored.fit(TRAIN, FEATURES, epochs=3, val_data=(HELD_OUT, FEATURES), log=None)
    assert [e["loss"] for e in got] == [e["loss"] for e in want]
    for a, b in zip(jax.tree.leaves(params_to_numpy(monitored.params)),
                    jax.tree.leaves(params_to_numpy(plain.params))):
        np.testing.assert_array_equal(a, b)
    assert all("val_cider" in e and "val_loss" in e for e in got)


def test_unknown_val_metric_raises_as_tpucap():
    jpipe, pipe = _pipelines(val_metric="spice")
    for p in (jpipe, pipe):
        with pytest.raises(ValueError, match="unknown val_metric"):
            p.fit(TRAIN, FEATURES, epochs=1, val_data=(HELD_OUT, FEATURES), log=None)
    # Without a dev split the monitor is never read, in both.
    assert len(pipe.fit(TRAIN, FEATURES, epochs=1, log=None)) == 1
