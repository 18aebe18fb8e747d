"""tpucap_torch's ResNet-50 and BN folding against tpucap's, on params
bridged through params_from_jax (HWIO -> OIHW), at input 64, batch 2, f32.

BN statistics are drawn at random so folding is not the identity.
Tolerance: both sides run f32 convolutions that sum in different orders
through 53 layers; activations grow to O(10^2..10^3) under glorot init, so
the bound is relative to the output's scale: 1e-4 * max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap.models.encoders.fold_bn import fold_resnet50 as jax_fold
from tpucap.models.encoders.resnet50 import ResNet50 as JaxResNet50
from tpucap_torch.convert import params_from_jax
from tpucap_torch.models.encoders import ResNet50, build_encoder
from tpucap_torch.models.encoders.fold_bn import fold_resnet50

torch.set_num_threads(2)

SIZE = 64


@pytest.fixture(scope="module")
def jax_params():
    p = jax.tree.map(np.asarray, JaxResNet50().init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    for name, bn in p.items():
        if name.endswith("_bn"):
            c = bn["beta"].shape[0]
            bn["gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            bn["beta"] = rng.normal(0, 0.1, c).astype(np.float32)
            bn["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(1)
    return rng.uniform(-120, 150, size=(2, SIZE, SIZE, 3)).astype(np.float32)


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize(
    "features,folded", [("pooled", False), ("pooled", True), ("spatial", True)]
)
def test_resnet50_matches_jax(jax_params, images, features, folded):
    jenc = JaxResNet50(features=features, input_size=SIZE)
    tenc = ResNet50(features=features, input_size=SIZE)
    jp = jax_fold(jax_params) if folded else jax_params
    tp = params_from_jax(jax_params)
    if folded:
        tp = fold_resnet50(tp)
    ref = jax.jit(jenc.apply)(jp, jnp.asarray(images))
    with torch.inference_mode():
        got = tenc.apply(tp, torch.from_numpy(images))
    assert tuple(got.shape) == ref.shape
    _close(got.numpy(), ref)


def test_fold_resnet50_matches_jax(jax_params):
    ref = jax_fold(jax_params)
    got = fold_resnet50(params_from_jax(jax_params))
    assert sorted(got) == sorted(ref)
    for name, p in ref.items():
        np.testing.assert_allclose(
            got[name]["kernel"].permute(2, 3, 1, 0).numpy(), p["kernel"], rtol=1e-6, atol=1e-7
        )
        np.testing.assert_allclose(got[name]["bias"].numpy(), p["bias"], rtol=1e-6, atol=1e-6)


def test_resnet50_layout_and_options():
    enc = build_encoder("resnet50")
    assert (enc.input_size, enc.preprocess_mode, enc.feature_dim) == (224, "caffe", 2048)
    assert enc.spatial_positions == JaxResNet50().spatial_positions == 196
    tp = enc.init(torch.Generator().manual_seed(0))
    jp = JaxResNet50().init(jax.random.key(0))
    assert sorted(tp) == sorted(jp)
    for name in jp:
        for k, v in jp[name].items():
            want = v.shape if v.ndim != 4 else (v.shape[3], v.shape[2], v.shape[0], v.shape[1])
            assert tuple(tp[name][k].shape) == want
    with pytest.raises(NotImplementedError, match="bottleneck"):
        ResNet50(fused_blocks=True)
    with pytest.raises(NotImplementedError):
        build_encoder("vgg16")
