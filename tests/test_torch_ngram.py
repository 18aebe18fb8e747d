"""tpucap_torch's no-repeat-ngram ban (``decode/ngram.py``) and the two
engines that apply it, against tpucap's.

- ``ngram_banned_mask`` equal to tpucap's, element for element, for n =
  1..4 on token buffers with repeats, at a shared step and at per-row
  steps; an n longer than the buffer bans nothing; ``apply_ngram_ban``
  puts NEG_INF (in the logits' dtype) exactly where the mask is set.
- greedy and beam (k = 3) with ``no_repeat_ngram_size`` 1-3 on a merge
  LSTM with params bridged from tpucap's, token for token against
  tpucap's engines, scores within 1e-5 absolute (f32 both ways, sums in
  another order); no output holds a repeated n-gram, and the ban changed
  the captions; n = 0 is the engine without the ban.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap.decode import beam_decode as jax_beam_decode
from tpucap.decode import greedy_decode as jax_greedy_decode
from tpucap.decode.ngram import apply_ngram_ban as jax_apply_ngram_ban
from tpucap.decode.ngram import ngram_banned_mask as jax_ngram_banned_mask
from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap_torch.convert import params_from_jax
from tpucap_torch.decode import beam_decode, greedy_decode
from tpucap_torch.decode.ngram import NEG_INF, apply_ngram_ban, ngram_banned_mask
from tpucap_torch.models.decoders import build_decoder

from ports_init import jit_init

torch.set_num_threads(2)

V, FEAT, START, END, MAXLEN, B = 13, 11, 1, 2, 14, 6
DIMS = dict(vocab_size=V, feature_dim=FEAT, embed_dim=8, hidden_dim=16, dropout_rate=0.0)


def _buffer(seed, rows=8, length=12):
    """Token rows over a 3-word alphabet, so n-grams repeat."""
    return np.random.default_rng(seed).integers(3, 6, size=(rows, length)).astype(np.int32)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_mask_matches_tpucap(n):
    toks = _buffer(n)
    banned = 0
    for t in range(toks.shape[1] + 1):
        want = np.asarray(jax_ngram_banned_mask(jnp.asarray(toks), t, n, V))
        got = ngram_banned_mask(torch.from_numpy(toks).long(), t, n, V).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"t={t}")
        banned += got.sum()
    assert banned > 0
    per_row = np.random.default_rng(10 + n).integers(0, toks.shape[1] + 1, size=toks.shape[0])
    want = np.asarray(jax_ngram_banned_mask(jnp.asarray(toks), jnp.asarray(per_row), n, V))
    got = ngram_banned_mask(torch.from_numpy(toks).long(), torch.from_numpy(per_row), n, V).numpy()
    np.testing.assert_array_equal(got, want)


def test_ngram_longer_than_the_buffer_bans_nothing():
    toks = torch.from_numpy(_buffer(0, length=3)).long()
    assert not ngram_banned_mask(toks, 3, 5, V).any()
    logits = torch.randn(8, V)
    assert torch.equal(apply_ngram_ban(logits, toks, 3, 5), logits)
    with pytest.raises(ValueError):
        ngram_banned_mask(toks, 3, 0, V)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ban_is_neg_inf_where_the_mask_is(dtype):
    toks = _buffer(7)
    logits = np.random.default_rng(7).normal(size=(toks.shape[0], V)).astype(np.float32)
    t = toks.shape[1] - 1
    got = apply_ngram_ban(torch.from_numpy(logits).to(dtype), torch.from_numpy(toks).long(), t, 2)
    mask = ngram_banned_mask(torch.from_numpy(toks).long(), t, 2, V)
    want = torch.where(mask, torch.tensor(NEG_INF, dtype=dtype), torch.from_numpy(logits).to(dtype))
    assert got.dtype == dtype and torch.equal(got, want)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax_apply_ngram_ban(jnp.asarray(logits).astype(jdt), jnp.asarray(toks), t, 2)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def _bridged(seed=3):
    jdec = jax_build_decoder("lstm1", **DIMS)
    jp = jit_init(jdec, jax.random.key(seed))
    tdec = build_decoder("lstm1", **DIMS)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    feats = np.random.default_rng(seed).normal(size=(B, FEAT)).astype(np.float32)
    return jdec, jp, jdec.init_state(jp, jnp.asarray(feats)), tdec, tp, tdec.init_state(tp, torch.from_numpy(feats))


def _has_repeat(row, n):
    grams = [tuple(row[i : i + n]) for i in range(len(row) - n + 1)]
    return len(grams) != len(set(grams))


def _decode(method, n):
    jdec, jp, js, tdec, tp, ts = _bridged()
    kw = dict(start_id=START, end_id=END, max_len=MAXLEN, no_repeat_ngram_size=n)
    if method == "beam":
        return (jax_beam_decode(jdec.step, jp, js, beam_width=3, **kw),
                beam_decode(tdec.step, tp, ts, beam_width=3, **kw))
    return jax_greedy_decode(jdec.step, jp, js, **kw), greedy_decode(tdec.step, tp, ts, **kw)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_engines_with_the_ban_match_tpucap(method, n):
    ref, got = _decode(method, n)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=1e-5)
    if method == "beam":
        np.testing.assert_array_equal(got.beam_tokens.numpy(), np.asarray(ref.beam_tokens))
        np.testing.assert_allclose(got.beam_scores.numpy(), np.asarray(ref.beam_scores), atol=1e-5)
    for row, length in zip(got.tokens.numpy(), got.lengths.numpy()):
        assert not _has_repeat(list(row[:length]), n), row
    _, plain = _decode(method, 0)
    assert not np.array_equal(plain.tokens.numpy(), got.tokens.numpy())
    assert any(_has_repeat(list(r[:ln]), n) for r, ln in zip(plain.tokens.numpy(), plain.lengths.numpy()))


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_ngram_zero_is_the_engine_without_the_ban(method):
    _, _, _, tdec, tp, ts = _bridged()
    kw = dict(start_id=START, end_id=END, max_len=MAXLEN)
    engine = (lambda **k: beam_decode(tdec.step, tp, ts, beam_width=3, **k)) if method == "beam" else (
        lambda **k: greedy_decode(tdec.step, tp, ts, **k))
    a, b = engine(**kw), engine(no_repeat_ngram_size=0, **kw)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.scores, b.scores)
