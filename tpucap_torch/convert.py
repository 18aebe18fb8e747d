"""Weight bridge from the JAX package's param pytrees and training state,
and ``.npz`` persistence that needs neither jax nor orbax (each leaf keeps
its dtype, bf16 included).

The layouts are the same except for convolution kernels: ``tpucap`` keeps
them HWIO, the port OIHW. Dense kernels stay ``(in, out)``; key names are
unchanged (``conv2_block1_1_conv``, ``cells/0/kernel``). Adam's moments
have their params' layout and convert the same way.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tpucap_torch.core import refuse_int8


def params_from_jax(tree):
    """A tpucap param tree (nested dicts/lists whose leaves are arrays) ->
    the port's params: float32 CPU tensors, conv kernels HWIO -> OIHW; a
    None entry (an InceptionV3 conv's folded BatchNorm) is left out. A
    quantized tree (an int8 leaf or a ``kernel_scale`` key) raises
    NotImplementedError: cast to f32, its kernels would lose their scale."""

    def convert(node, key=None, path="params"):
        if isinstance(node, dict):
            if "kernel_scale" in node:
                refuse_int8(path)
            return {
                k: convert(v, k, f"{path}/{k}") for k, v in node.items() if v is not None
            }
        if isinstance(node, (list, tuple)):
            return [convert(v, None, f"{path}/{i}") for i, v in enumerate(node)]
        arr = np.asarray(node)
        if arr.dtype.kind in "iub":  # numpy's bf16 is kind "V"
            refuse_int8(f"{path} ({arr.dtype})")
        arr = arr.astype(np.float32)
        t = torch.from_numpy(arr.copy())
        if key == "kernel" and t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        return t

    return convert(tree)


def params_to_numpy(tree):
    """The inverse of ``params_from_jax``: the port's tree -> nested
    dicts/lists of f32 numpy arrays in tpucap's layout (conv kernels OIHW
    -> HWIO)."""

    def convert(node, key=None):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        t = node.detach().float().cpu()
        if key == "kernel" and t.ndim == 4:
            t = t.permute(2, 3, 1, 0)
        return t.contiguous().numpy()

    return convert(tree)


def adam_state_from_jax(opt_state):
    """An optax optimizer state (``adam``, ``adamw``, clipped or with the
    encoder's update scale: the chains ``tpucap.train`` builds) -> the
    port's Adam state ``{"count", "mu", "nu"}``: the one member of the
    chain that carries Adam's ``count``, ``mu`` and ``nu``."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return {
            "count": torch.tensor(int(np.asarray(opt_state.count)), dtype=torch.int32),
            "mu": params_from_jax(opt_state.mu),
            "nu": params_from_jax(opt_state.nu),
        }
    if isinstance(opt_state, (list, tuple)):
        found = [s for s in (_adam_or_none(x) for x in opt_state) if s is not None]
        if len(found) == 1:
            return found[0]
    raise ValueError("no single Adam state (count, mu, nu) in this optimizer state")


def _adam_or_none(node):
    try:
        return adam_state_from_jax(node)
    except ValueError:
        return None


def train_state_from_jax(state, rng=None):
    """A tpucap ``TrainState`` (step, params, Adam's state) -> the port's,
    so a step can be compared from a shared state. The jax key has no torch
    counterpart: ``rng`` (a ``torch.Generator``) takes its place."""
    from tpucap_torch.train.loop import TrainState

    return TrainState(
        step=int(np.asarray(state.step)),
        params=params_from_jax(state.params),
        opt_state=adam_state_from_jax(state.opt_state),
        rng=rng,
    )


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(f"param key {k!r} contains '/'")
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = tree.detach().cpu()


# The .npz entry that records each leaf's torch dtype (numpy has no bf16:
# a bf16 leaf is stored as its raw 16-bit patterns).
DTYPES_KEY = "__dtypes__"


def save_npz(path, params) -> None:
    """Write a param tree as one ``.npz``: keys are '/'-joined paths, list
    positions are their indices; each leaf keeps its dtype, recorded in
    the ``__dtypes__`` entry (bf16 leaves as their bits, int16)."""
    flat: dict = {}
    _flatten(params, "", flat)
    arrays, dtypes = {}, {}
    for name, t in flat.items():
        dtypes[name] = str(t.dtype).removeprefix("torch.")
        t = t.contiguous()
        arrays[name] = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    arrays[DTYPES_KEY] = np.array(json.dumps(dtypes))
    np.savez(path, **arrays)


def load_npz(path, device="cpu"):
    """Inverse of ``save_npz``: a nested tree of tensors on ``device``, each
    with the dtype it was saved with (a file without ``__dtypes__`` gives
    its arrays' own dtypes); a level whose keys are all 0..n-1 becomes a
    list."""
    root: dict = {}
    with np.load(path) as z:
        dtypes = json.loads(str(z[DTYPES_KEY])) if DTYPES_KEY in z.files else {}
        for name in z.files:
            if name == DTYPES_KEY:
                continue
            t = torch.from_numpy(z[name])
            if dtypes.get(name) == "bfloat16":
                t = t.view(torch.bfloat16)
            elif name in dtypes and str(t.dtype).removeprefix("torch.") != dtypes[name]:
                raise ValueError(f"{path}: {name} holds {t.dtype}, recorded as {dtypes[name]}")
            node = root
            *parents, leaf = name.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = t.to(device)

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)
