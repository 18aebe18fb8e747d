"""LoRA: low-rank adaptation for parameter-efficient fine-tuning (port of
``tpucap.train.lora``).

Every base weight stays frozen; a rank-r overlay trains on the matmul
kernels,

    W_eff = W + (alpha / r) * A @ B,   A: (d_in, r),  B: (r, d_out),

with A ~ N(0, 1/r) and B = 0 at init, so step 0 is the base model. The
adapters are a tree of their own, ``{keystr: {"a": A, "b": B}}``, keyed by
the base tree's key paths written as ``jax.tree_util.keystr`` writes them
(``['decoder']['cells'][0]['kernel']``), so that an artifact written by
either package's ``save_lora`` loads into the other. ``apply_lora`` makes
the effective params inside the step, under autograd: the gradients reach
the adapters alone and the base rides through as a constant, and the
models' forwards run unchanged.

What gets adapted: the 2-D floating leaves whose last key is in
``target_keys`` (``"kernel"`` by default): LSTM input kernels, dense
projections, the ViT's qkv / o / mlp kernels, VGG16's fc layers. Conv
kernels (4-D, OIHW in the port as HWIO in tpucap) stay out.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from tpucap_torch.core import tree_leaves, tree_map_with_path
from tpucap_torch.train.finetune import encode_for_decoder
from tpucap_torch.train.loop import grads_of, optimizer_step, refuse_unported, trainable
from tpucap_torch.train.loss import caption_loss_sums, loss_from_sums, warn_if_attention_reg_unused

DEFAULT_TARGET_KEYS = ("kernel",)


def keystr(path) -> str:
    """A key path (a tuple of dict keys and list indices) as
    ``jax.tree_util.keystr`` writes it: dict keys quoted in brackets, list
    indices bare, ``['decoder']['cells'][0]['kernel']``."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, (*path, i))
    elif tree is not None:
        yield path, tree


def lora_targets(params, *, target_keys=DEFAULT_TARGET_KEYS) -> dict[str, tuple[int, int]]:
    """-> {keystr: (d_in, d_out)} for every adaptable leaf: a 2-D floating
    tensor whose last key is in ``target_keys``."""
    out: dict[str, tuple[int, int]] = {}
    for path, leaf in _leaves_with_path(params):
        if (
            path
            and isinstance(path[-1], str)
            and path[-1] in target_keys
            and leaf.ndim == 2
            and leaf.is_floating_point()
        ):
            out[keystr(path)] = (int(leaf.shape[0]), int(leaf.shape[1]))
    if not out:
        raise ValueError(
            f"no LoRA-adaptable leaves (2-D float leaves named "
            f"{target_keys}) in the given tree"
        )
    return out


def init_lora(params, rank: int, *, generator: torch.Generator, target_keys=DEFAULT_TARGET_KEYS):
    """-> adapters ``{keystr: {"a": (d_in, r), "b": (r, d_out)}}``, f32 on
    the base leaves' device: ``a ~ N(0, 1/r)``, drawn from ``generator``
    (a CPU generator) leaf by leaf in sorted key order, ``b = 0``; so
    ``apply_lora(base, init)`` is the base. tpucap draws ``a`` from its jax
    key, whose bits torch cannot make."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    targets = lora_targets(params, target_keys=target_keys)
    device = next(leaf for _, leaf in _leaves_with_path(params)).device
    adapters = {}
    for key, (d_in, d_out) in sorted(targets.items()):
        a = torch.randn((d_in, rank), generator=generator, dtype=torch.float32) / math.sqrt(rank)
        adapters[key] = {
            "a": a.to(device),
            "b": torch.zeros((rank, d_out), dtype=torch.float32, device=device),
        }
    return adapters


def apply_lora(params, adapters, *, scale: float):
    """The effective params: ``leaf + (scale * (a @ b)).to(leaf.dtype)`` on
    the adapted leaves, in tpucap's order, the base elsewhere (the same
    tensors). Differentiable in the adapters. The product runs under the
    caller's matmul flags: hold it under ``core.precision_flags``."""

    def eff(path, leaf):
        ad = adapters.get(keystr(path))
        if ad is None:
            return leaf
        return leaf + (scale * (ad["a"] @ ad["b"])).to(leaf.dtype)

    return tree_map_with_path(eff, params)


@torch.no_grad()
def merge_lora(params, adapters, *, scale: float):
    """The merged tree for deployment: ``apply_lora`` without autograd, so
    a decode on it is the decode on apply_lora's view, the same adds in
    the same dtypes."""
    return apply_lora(params, adapters, scale=scale)


def lora_param_counts(params, adapters) -> tuple[int, int]:
    """-> (trainable adapter params, total base params)."""
    n_ad = sum(t.numel() for t in tree_leaves(adapters))
    n_base = sum(t.numel() for t in tree_leaves(params))
    return n_ad, n_base


def save_lora(path, adapters, *, rank: int, alpha: float) -> None:
    """Write the adapter artifact, tpucap's ``.npz`` layout: ``<key>::a``
    and ``<key>::b`` (f32) for each adapter, ``__lora_rank__`` int32 and
    ``__lora_alpha__`` float32."""
    flat = {}
    for key, ab in adapters.items():
        flat[f"{key}::a"] = ab["a"].detach().float().cpu().numpy()
        flat[f"{key}::b"] = ab["b"].detach().float().cpu().numpy()
    np.savez(path, __lora_rank__=np.int32(rank), __lora_alpha__=np.float32(alpha), **flat)


def load_lora(path):
    """-> (adapters as f32 CPU tensors, rank, alpha) from ``save_lora``'s
    artifact, the port's or tpucap's."""
    with np.load(path) as z:
        rank = int(z["__lora_rank__"])
        alpha = float(z["__lora_alpha__"])
        adapters: dict = {}
        for name in z.files:
            if name.startswith("__lora_"):
                continue
            key, part = name.rsplit("::", 1)
            adapters.setdefault(key, {})[part] = torch.from_numpy(np.array(z[name], np.float32))
    return adapters, rank, alpha


def make_lora_train_step(
    decoder,
    base_params,
    optimizer,
    *,
    scale: float,
    encoder=None,
    pad_id: int = 0,
    label_smoothing: float = 0.0,
    attention_reg: float = 0.0,
    deterministic: bool = False,
    compute_dtype=None,
    mesh=None,
    axis: str = "data",
    augment_fn=None,
    donate: bool = False,
) -> Callable:
    """Single-device step ``(state, features_or_images, tokens) -> (state,
    metrics)``, ``state`` a ``TrainState`` over the adapters alone, so the
    optimizer's state has the adapters' shapes.

    Decoder-only (``encoder=None``): ``base_params`` is the decoder's tree
    and the step takes feature rows. Joint (``encoder`` given):
    ``base_params = {"encoder": ..., "decoder": ...}``, the images run
    through ``encode_for_decoder`` on the effective encoder params (in f32,
    as tpucap's step runs them: ``compute_dtype`` casts the decoder's side
    only), and the adapters may span both subtrees. ``augment_fn(images,
    generator)`` draws from ``state.rng`` before the dropout does, as the
    joint step's. The base is never updated. ``mesh`` (tpucap's data-
    parallel branch) is not ported."""
    refuse_unported(mesh=(mesh, None), axis=(axis, "data"))
    warn_if_attention_reg_unused(decoder, attention_reg)

    def step(state, batch_x, tokens):
        adapters = trainable(state.params)
        if augment_fn is not None:
            batch_x = augment_fn(batch_x, state.rng)
        eff = apply_lora(base_params, adapters, scale=scale)
        if encoder is not None:
            features = encode_for_decoder(encoder, eff["encoder"], batch_x)
            dec_eff = eff["decoder"]
        else:
            features, dec_eff = batch_x, eff
        sums = caption_loss_sums(
            decoder,
            dec_eff,
            features,
            tokens,
            rng=state.rng,
            deterministic=deterministic,
            pad_id=pad_id,
            label_smoothing=label_smoothing,
            attention_reg=attention_reg,
            compute_dtype=compute_dtype,
        )
        loss, metrics = loss_from_sums(sums, attention_reg=attention_reg)
        return optimizer_step(state, optimizer, grads_of(loss, adapters), metrics, donate)

    return step
