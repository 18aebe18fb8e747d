"""tpucap_torch's on-device augmentation (``data/augment.py``) against
tpucap's ``augment_images``, on the CPU.

jax's random bits cannot be drawn in torch, so the test draws tpucap's
flip mask and offsets exactly as ``augment_images`` splits its key and
hands them to the port's ``apply_augment``: the images must then be equal,
element for element (both ops are pixel permutations; tolerance 0). Also:
the port's own draws (``augment_images`` on a generator) have tpucap's
ranges and are a pure function of the generator's state, ``max_shift`` at
the image's side raises tpucap's ``ValueError``, and ``make_augment_fn``
is None with both ops off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap.data.augment import augment_images as jax_augment
from tpucap.data.augment import make_augment_fn as jax_make_augment_fn
from tpucap_torch.data.augment import (
    apply_augment,
    augment_draws,
    augment_images,
    make_augment_fn,
)


def _images(seed, b=6, h=9, w=7, c=3):
    return np.random.default_rng(seed).normal(size=(b, h, w, c)).astype(np.float32)


def _tpucaps_draws(key, b, flip, max_shift):
    """The draws of ``tpucap.data.augment.augment_images``, key split for key split."""
    k_flip, k_dx, k_dy = jax.random.split(key, 3)
    do = np.asarray(jax.random.bernoulli(k_flip, 0.5, (b,))) if flip else None
    if not max_shift:
        return do, None, None
    hi = 2 * max_shift + 1
    return do, np.asarray(jax.random.randint(k_dx, (b,), 0, hi)), np.asarray(jax.random.randint(k_dy, (b,), 0, hi))


@pytest.mark.parametrize("flip,max_shift", [(True, 0), (False, 3), (True, 3), (True, 6)])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_augment_equals_tpucap_on_its_draws(flip, max_shift, seed):
    x = _images(seed)
    key = jax.random.key(100 + seed)
    want = np.asarray(jax_augment(jnp.asarray(x), key, flip=flip, max_shift=max_shift))
    draws = [None if d is None else torch.tensor(d) for d in _tpucaps_draws(key, x.shape[0], flip, max_shift)]
    got = apply_augment(torch.from_numpy(x), *draws, max_shift=max_shift).numpy()
    np.testing.assert_array_equal(got, want)
    if flip and draws[0].any() and not draws[0].all():
        assert not np.array_equal(got, x)  # the draws did something


def test_port_draws_are_the_generators():
    x = torch.from_numpy(_images(3, b=64))
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    a = augment_images(x, g, flip=True, max_shift=2)
    g.set_state(state)
    do, dx, dy = augment_draws(64, g, flip=True, max_shift=2)
    assert torch.equal(a, apply_augment(x, do, dx, dy, max_shift=2))
    assert do.dtype == torch.bool and 0 < int(do.sum()) < 64
    for d in (dx, dy):
        assert int(d.min()) >= 0 and int(d.max()) <= 4 and len(set(d.tolist())) == 5
    b = augment_images(x, g, flip=True, max_shift=2)  # the generator moved on
    assert not torch.equal(a, b)


def test_shift_at_the_image_side_raises_and_off_is_none():
    x = _images(4, h=5, w=8)
    with pytest.raises(ValueError, match=r"max_shift 5 must be smaller than the image \(5x8\)") as ours:
        augment_images(torch.from_numpy(x), torch.Generator(), max_shift=5)
    with pytest.raises(ValueError) as theirs:
        jax_augment(jnp.asarray(x), jax.random.key(0), max_shift=5)
    assert str(ours.value) == str(theirs.value)
    assert make_augment_fn(flip=False, max_shift=0) is None
    assert jax_make_augment_fn(flip=False, max_shift=0) is None
    assert augment_images(torch.from_numpy(x), torch.Generator(), flip=False) is not None
    fn = make_augment_fn(flip=False, max_shift=2)
    g = torch.Generator().manual_seed(1)
    assert fn(torch.from_numpy(x), g).shape == x.shape
