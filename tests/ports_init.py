"""Test helper: a tpucap pipeline built on the port's seeded init.

tpucap's random init runs eagerly, op by op, and its jax caches are cleared
for every test module (``tests/conftest.py``): its first build in a module
takes 8-17 s on the CPU, where the port's torch init of the same config
takes under a second. ``build_on_ports_init`` builds the port's pipeline
for tpucap's config, vocabulary and encoder input size from ``seed`` and
carries its params to tpucap with ``convert.params_to_numpy``; a test then
hands them back to the port with ``params_from_jax`` as before, so both
sides still decode and train from one tree. ``jit_init`` runs a tpucap
decoder's own init as one jit program.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp

from tpucap_torch import config as tcfg
from tpucap_torch.convert import params_to_numpy
from tpucap_torch.pipeline import CaptioningPipeline
from tpucap_torch.text import Tokenizer


def build_on_ports_init(jpipe, seed=None):
    """``jpipe.build()`` with the port's init from ``seed`` (the config's
    train seed when None) in place of tpucap's. -> jpipe.params."""
    config = tcfg.config_from_dict(json.loads(json.dumps(dataclasses.asdict(jpipe.config))))
    tokenizer = None if jpipe.tokenizer is None else Tokenizer.from_json(jpipe.tokenizer.to_json())
    pipe = CaptioningPipeline(config, tokenizer=tokenizer, device="cpu")
    size = getattr(jpipe.encoder, "input_size", None)
    if size is not None and size != pipe.encoder.input_size:
        pipe.encoder = dataclasses.replace(pipe.encoder, input_size=size)
    pipe.build(seed=seed)
    jpipe.build(init_params=False)
    jpipe.params = jax.tree.map(jnp.asarray, params_to_numpy(pipe.params))
    return jpipe.params


@functools.cache
def _jitted_init(model):
    return jax.jit(model.init)


def jit_init(model, key):
    """``model.init(key)`` of a tpucap encoder or decoder as one jit program, compiled
    once a model config and module (the eager init compiles its ops one by
    one: about 4-6 s in a module, against 1.5 s). For the merge, inject and
    attention decoders the jitted draw gives the eager one's bits."""
    return _jitted_init(model)(key)


def jit_build(jpipe, rng=None):
    """``jpipe.build(rng)`` (tpucap's draws from ``split(rng)``, the
    config's train seed when None) with the encoder's and the decoder's
    init each one jit program: for tiny_cnn and the merge decoders the
    eager build's bits. -> jpipe.params."""
    jpipe.build(init_params=False)
    rng = rng if rng is not None else jax.random.key(jpipe.config.train.seed)
    enc_rng, dec_rng = jax.random.split(rng)
    jpipe.params = {"encoder": jit_init(jpipe.encoder, enc_rng), "decoder": jit_init(jpipe.decoder, dec_rng)}
    return jpipe.params
