"""tpucap_torch's ResNet-50, BN folding and fused identity block (kernel
K4's plain version) against tpucap's, on the port's seeded init carried to
tpucap by params_to_numpy and back through params_from_jax (HWIO <-> OIHW),
at input 64, batch 2, f32.

BN statistics are drawn at random so folding is not the identity.
Tolerance: both sides run f32 convolutions that sum in different orders
through 53 layers; activations grow to O(10^2..10^3) under glorot init, so
the bound is relative to the output's scale: 1e-4 * max|ref|. A single
fused block against tpucap's Pallas kernel in interpret mode: f32 within
atol 1e-4 + rtol 1e-5 (tpucap's own test of the kernel); bf16 within two
bf16 ulps (2**-6 relative, and 2**-6 of the output's scale absolute),
since each of the three convs rounds its f32 sum to bf16 and a sum taken
in another order can round to the neighbouring value.

VGG16 and tiny_cnn against tpucap's on bridged params, f32, atol 1e-4 on
the outputs (measured 5.5e-6 on VGG16's fc2 at scale 1.3): VGG16's fc2
form at 224, batch 1 (its fc1 alone holds 25088 x 4096 weights, so once),
its spatial and block5-pooled forms at 32, tiny_cnn pooled and spatial at
32. The Flatten before fc1 is NHWC's row-major order, which the 224 case
holds: flattening NCHW would permute fc1's inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap.models.encoders import PREPROCESS_MODES as JAX_PREPROCESS_MODES
from tpucap.models.encoders.fold_bn import fold_resnet50 as jax_fold
from tpucap.models.encoders.registry import build_encoder as jax_build_encoder
from tpucap.models.encoders.resnet50 import ResNet50 as JaxResNet50
from tpucap.models.encoders.tiny import TinyCNN as JaxTinyCNN
from tpucap.models.encoders.vgg16 import VGG16 as JaxVGG16
from tpucap.ops.pallas.bottleneck import fused_identity_block as jax_block
from tpucap_torch import ops
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.models.encoders import VGG16, ResNet50, TinyCNN, build_encoder, resnet50
from tpucap_torch.models.encoders.fold_bn import fold_resnet50
from tpucap_torch.ops.bottleneck import fused_identity_block_plain

torch.set_num_threads(2)

SIZE = 64


@pytest.fixture(scope="module")
def jax_params():
    """The port's seeded init in tpucap's layout (torch's init takes a
    second where tpucap's eager one compiles op by op), BN drawn."""
    p = params_to_numpy(ResNet50().init(torch.Generator().manual_seed(0)))
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
    jp = jax.eval_shape(lambda: JaxResNet50().init(jax.random.key(0)))
    assert sorted(tp) == sorted(jp)
    for name in jp:
        for k, v in jp[name].items():
            want = v.shape if v.ndim != 4 else (v.shape[3], v.shape[2], v.shape[0], v.shape[1])
            assert tuple(tp[name][k].shape) == want
    assert (enc.fused_blocks, enc.fused_stages) == (
        JaxResNet50().fused_blocks, JaxResNet50().fused_stages
    )
    with pytest.raises(ValueError, match="unknown encoder"):
        build_encoder("inception_v4")


# -- K4: the fused identity block --------------------------------------------

BLOCK_TOL = {
    "f32": lambda ref: dict(rtol=1e-5, atol=1e-4),
    "bf16": lambda ref: dict(rtol=2**-6, atol=2**-6 * float(np.abs(ref).max())),
}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize(
    "blk,shape", [("conv2_block2", (2, 8, 8, 256)), ("conv4_block2", (2, 4, 4, 1024))]
)
def test_fused_identity_block_plain_matches_pallas_kernel(jax_params, blk, shape, dt):
    jdt, tdt = DT[dt]
    folded = params_from_jax(jax_fold(jax_params))
    tp = [{k: v.to(tdt) for k, v in folded[f"{blk}_{i}_conv"].items()} for i in (1, 2, 3)]
    x = torch.from_numpy(np.random.default_rng(2).normal(size=shape).astype(np.float32)).to(tdt)
    # The same (rounded) values on the JAX side, kernels back to HWIO.
    jp = [
        {
            "kernel": jnp.asarray(p["kernel"].float().permute(2, 3, 1, 0).numpy(), jdt),
            "bias": jnp.asarray(p["bias"].float().numpy(), jdt),
        }
        for p in tp
    ]
    ref = np.asarray(jax_block(*jp, jnp.asarray(x.float().numpy(), jdt)), np.float32)
    got = fused_identity_block_plain(*tp, x)
    assert got.dtype == tdt and tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(), ref, **BLOCK_TOL[dt](ref))


def test_resnet50_fused_blocks_matches_jax(jax_params, images):
    """Fused blocks (plain K4 on the CPU) on folded params against
    tpucap's fused encoder (Pallas in interpret mode); on unfolded params
    the flag changes nothing."""
    jenc = JaxResNet50(input_size=SIZE, fused_blocks=True)
    tenc = ResNet50(input_size=SIZE, fused_blocks=True)
    ref = jax.jit(jenc.apply)(jax_fold(jax_params), jnp.asarray(images))
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = tenc.apply(fold_resnet50(params_from_jax(jax_params)), torch.from_numpy(images))
        tp = params_from_jax(jax_params)
        unfolded = tenc.apply(tp, torch.from_numpy(images))
        plain = ResNet50(input_size=SIZE).apply(tp, torch.from_numpy(images))
    _close(got.numpy(), ref)
    torch.testing.assert_close(unfolded, plain, rtol=0, atol=0)
    assert ops.launch_counts()["identity_block"] == 0  # CPU: plain version


@pytest.mark.parametrize(
    "stages,folded,calls",
    [(("conv3",), True, 3), (ResNet50.fused_stages, True, 12), (ResNet50.fused_stages, False, 0)],
)
def test_fused_stages_route_only_their_identity_blocks(monkeypatch, stages, folded, calls):
    """12 identity blocks with every stage (16 blocks less each stack's
    first, which has a conv shortcut); counted with a spy, since the launch
    counter counts kernel launches only."""
    seen = []

    def spy(p1, p2, p3, x):
        seen.append(tuple(x.shape))
        return fused_identity_block_plain(p1, p2, p3, x)

    monkeypatch.setattr(resnet50, "fused_identity_block", spy)
    enc = ResNet50(input_size=32, fused_blocks=True, fused_stages=stages)
    p = enc.init(torch.Generator().manual_seed(0))
    if folded:
        p = fold_resnet50(p)
    with torch.inference_mode():
        enc.apply(p, torch.zeros(1, 32, 32, 3))
    assert len(seen) == calls
    if stages == ("conv3",):
        assert all(s[-1] == 512 for s in seen)


# -- VGG16 and tiny_cnn ------------------------------------------------------


def _encoder_against_tpucap(jenc, tenc, size, batch, seed):
    jp = params_to_numpy(tenc.init(torch.Generator().manual_seed(seed)))  # carried to tpucap
    want = jax.eval_shape(lambda: jenc.init(jax.random.key(seed)))
    assert jax.tree.map(lambda a: a.shape, jp) == jax.tree.map(lambda a: a.shape, want)
    x = np.random.default_rng(seed).uniform(-120, 150, (batch, size, size, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jenc.apply)(jp, x))
    tp = params_from_jax(jp)
    assert {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in tp.items()} == {
        k: {n: (a.shape if a.ndim != 4 else (a.shape[3], a.shape[2], a.shape[0], a.shape[1]))
            for n, a in v.items()}
        for k, v in jp.items()
    }
    del jp
    with torch.inference_mode():
        got = tenc.apply(tp, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    return got


def test_vgg16_fc2_at_224_matches_jax():
    got = _encoder_against_tpucap(JaxVGG16(), VGG16(), 224, 1, 5)
    assert got.shape == (1, 4096) and (got >= 0).all()


@pytest.mark.parametrize(
    "jenc,tenc,shape",
    [
        (JaxVGG16(features="spatial", input_size=32), VGG16(features="spatial", input_size=32),
         (2, 2, 2, 512)),
        (JaxVGG16(features="pooled", input_size=32), VGG16(features="pooled", input_size=32),
         (2, 512)),
        (JaxTinyCNN(), TinyCNN(), (2, 128)),
        (JaxTinyCNN(features="spatial"), TinyCNN(features="spatial"), (2, 4, 4, 128)),
    ],
    ids=["vgg16-spatial", "vgg16-pooled", "tiny-pooled", "tiny-spatial"],
)
def test_small_encoders_match_jax(jenc, tenc, shape):
    got = _encoder_against_tpucap(jenc, tenc, jenc.input_size, 2, 6)
    assert got.shape == shape


@pytest.mark.parametrize("name", ["vgg16", "tiny_cnn"])
@pytest.mark.parametrize("kind", ["pooled", "spatial"])
def test_vgg16_and_tiny_cnn_registry_match_tpucaps(name, kind):
    """build_encoder's form, input size, preprocess mode, feature width and
    grid, and the config's FEATURE_DIMS row, as tpucap's ('pooled' VGG16 is
    its fc2 vector)."""
    from tpucap import config as jcfg
    from tpucap_torch import config as tcfg

    got, want = build_encoder(name, kind), jax_build_encoder(name, kind)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.input_size, got.preprocess_mode) == JAX_PREPROCESS_MODES[name]
    assert (got.feature_dim, got.spatial_positions) == (want.feature_dim, want.spatial_positions)
    assert tcfg.encoder_config(name, kind) == tcfg.EncoderConfig(**dataclasses.asdict(
        jcfg.encoder_config(name, kind)))
