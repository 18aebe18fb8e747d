"""tpucap_torch's MergeDecoder (1 and 2 layers) against tpucap's on params
bridged through tpucap_torch.convert.params_from_jax, dropout off; the
param layout of every ported family (the inject and attention decoders'
steps are held in ``test_torch_attention.py``, the GRU and adaptive
decoders' in ``test_torch_gru.py`` and ``test_torch_adaptive.py``, the
transformer's in ``test_torch_transformer.py``).

Tolerance: f32 on both sides, differing only by summation order: 1e-5
absolute on O(1) states and logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucap.models.decoders import build_decoder as jax_build_decoder
from tpucap_torch.convert import params_from_jax, params_to_numpy
from tpucap_torch.models.decoders import build_decoder

from ports_init import jit_init

torch.set_num_threads(2)

DIMS = dict(vocab_size=37, feature_dim=20, embed_dim=16, hidden_dim=24, dropout_rate=0.0)
ATOL = 1e-5


@pytest.mark.parametrize("name", ["lstm1", "lstm2"])
def test_merge_decoder_steps_match_jax(name):
    jdec = jax_build_decoder(name, **DIMS)
    tdec = build_decoder(name, **DIMS)
    jp = jit_init(jdec, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))

    rng = np.random.default_rng(0)
    feats = rng.normal(size=(5, DIMS["feature_dim"])).astype(np.float32)
    js = jax.jit(jdec.init_state)(jp, jnp.asarray(feats))
    ts = tdec.init_state(tp, torch.from_numpy(feats))
    for key in ("fe", "h", "c"):
        assert tuple(ts[key].shape) == js[key].shape
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), atol=ATOL)

    jstep = jax.jit(jdec.step)
    for t in range(4):
        tok = rng.integers(1, DIMS["vocab_size"], size=(5,))
        jl, js = jstep(jp, js, jnp.asarray(tok, jnp.int32))
        tl, ts = tdec.step(tp, ts, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, err_msg=f"step {t}")
        for key in ("h", "c"):
            np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), atol=ATOL)
    hid_j, _ = jax.jit(jdec.step_hidden)(jp, js, jnp.asarray(tok, jnp.int32))
    hid_t, _ = tdec.step_hidden(tp, ts, torch.from_numpy(tok))
    np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j), atol=ATOL)


@pytest.mark.parametrize("name", ["lstm1", "lstm2", "gru1", "gru2", "inject", "attention", "adaptive"])
def test_port_init_has_the_jax_param_layout(name):
    jp = jax.eval_shape(jax_build_decoder(name, **DIMS).init, jax.random.key(0))  # shapes only
    tp = build_decoder(name, **DIMS).init(torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in jflat:
        node = tp
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert tuple(node.shape) == leaf.shape, path


def test_build_decoder_refuses_unported_families():
    """No family is left unported: the transformer builds, dense and MoE,
    with tpucap's fields and param layout (shapes only); an unknown name
    raises as tpucap's factory does."""
    from tpucap_torch.models.decoders import UNPORTED

    assert UNPORTED == ()
    for moe in ({}, dict(num_experts=3, moe_top_k=1)):
        kw = dict(DIMS, num_layers=2, num_heads=6, mlp_dim=40, max_positions=9, **moe)
        jdec, tdec = jax_build_decoder("transformer", **kw), build_decoder("transformer", **kw)
        assert dataclasses.asdict(tdec) == dataclasses.asdict(jdec)
        jp = jax.eval_shape(jdec.init, jax.random.key(0))
        tp = params_to_numpy(tdec.init(torch.Generator().manual_seed(0)))
        assert jax.tree.structure(tp) == jax.tree.structure(jp)
        assert [a.shape for a in jax.tree.leaves(tp)] == [a.shape for a in jax.tree.leaves(jp)]
    with pytest.raises(ValueError, match="unknown decoder"):
        build_decoder("lstm3", **DIMS)
