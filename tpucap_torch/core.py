"""Device and precision policy of the port, a small tree map and a tree
layout check.

Device: entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (as the tests do). Without a card and without an explicit
device they raise; they never fall back to the CPU silently.

``Config.precision`` maps onto PyTorch as follows:

====== ================================= ===================================
value  tensors                           matmul / convolution flags
====== ================================= ===================================
f32    params and activations in f32     ``torch.backends.cuda.matmul.
                                         allow_tf32`` and ``torch.backends.
                                         cudnn.allow_tf32`` both False: full
                                         f32, XLA's HIGHEST precision
bf16   params and activations cast to    TF32 allowed for the few f32
       bf16 (``_inference_params``)      matmuls left (XLA's DEFAULT); bf16
                                         GEMMs reduce in f32
mixed  params and activations in f32     TF32 allowed: the counterpart of
                                         XLA's DEFAULT bf16 MXU passes
====== ================================= ===================================

The flags are process-wide PyTorch settings; ``apply_precision`` sets all
three explicitly every time a pipeline is built, and a pipeline's encoder,
decode engines and ``score_captions`` run under its own flags
(``precision_flags``), as tpucap's programs set their matmul precision per
call: building another pipeline does not change an earlier one's numerics.

The flags are read when a kernel or library call is enqueued, so a thread's
flagged block must not see another thread's setting. ``precision_flags``
holds one process-wide re-entrant lock for its whole block, and
``apply_precision`` takes it too: two serving threads (a server's images and
features batchers, or an f32 and a bf16 model behind one port) enqueue their
flagged work one block at a time, each under the flags its own pipeline
asked for. Training takes a block of its own for every step (the training
precision's flags, ``CaptioningPipeline._train_flags``), so a fit and a
server in one process take turns between steps and leave no flag changed.
"""

from __future__ import annotations

import contextlib
import threading

import torch

PRECISIONS = ("f32", "bf16", "mixed")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CPU run must be asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: tpucap_torch runs on the GPU unless the "
                "caller passes device='cpu'"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


#: Held for the whole of every ``precision_flags`` block and by
#: ``apply_precision``: the process's one owner of the flags at a time.
_FLAGS_LOCK = threading.RLock()


def apply_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; have {PRECISIONS}")
    tf32 = precision != "f32"
    with _FLAGS_LOCK:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        # bf16 GEMMs accumulate and reduce in f32, as the JAX package's
        # preferred_element_type=f32 dots do.
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


@contextlib.contextmanager
def precision_flags(precision: str):
    """``apply_precision(precision)`` inside the block, the flags as they
    were after it (another pipeline or a training run may have set them).
    The block holds ``_FLAGS_LOCK``: another thread's block waits until this
    one ends (the same thread may nest blocks)."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    with _FLAGS_LOCK:
        prev = (m.allow_tf32, c.allow_tf32, m.allow_bf16_reduced_precision_reduction)
        apply_precision(precision)
        try:
            yield
        finally:
            m.allow_tf32, c.allow_tf32, m.allow_bf16_reduced_precision_reduction = prev


def infer_dtype(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision == "bf16" else torch.float32


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor leaf of nested dicts/lists/tuples; with
    more trees of the same structure, ``fn`` takes their leaves side by
    side. None (an optimizer without state) maps to None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)
        )
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path=()):
    """``tree_map`` of one tree where ``fn(path, leaf)`` also gets the
    leaf's key path, a tuple of dict keys and list indices from the root."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, (*path, i)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def refuse_int8(where: str):
    """int8 serving weights have no branch in the port yet."""
    raise NotImplementedError(
        f"{where}: int8 serving weights (tpucap's quantize_encoder / "
        "quantize_vocab_projection: an int8 kernel with its kernel_scale) are "
        "not ported to tpucap_torch (ROADMAP queue 1, item 6.10)"
    )


def check_float_params(tree, where: str = "params") -> None:
    """Refuse a param tree with a non-float leaf or a ``kernel_scale`` key:
    the port computes in float only, and an int8 kernel taken as float
    would lose its scale."""
    if isinstance(tree, dict):
        if "kernel_scale" in tree:
            refuse_int8(where)
        for k, v in tree.items():
            check_float_params(v, f"{where}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            check_float_params(v, f"{where}/{i}")
    elif not torch.as_tensor(tree).is_floating_point():
        refuse_int8(f"{where} ({torch.as_tensor(tree).dtype})")


def check_same_layout(old, new, where: str) -> None:
    """Raise ValueError where ``new`` differs from ``old`` in structure
    (dict keys, list lengths, a None where the other has a tree) or in a
    leaf's shape or dtype."""
    if old is None or new is None:
        if old is not new:
            raise ValueError(f"param tree structure differs at {where}")
    elif isinstance(old, dict) and isinstance(new, dict) and set(old) == set(new):
        for k in old:
            check_same_layout(old[k], new[k], f"{where}/{k}")
    elif (
        isinstance(old, (list, tuple))
        and isinstance(new, (list, tuple))
        and len(old) == len(new)
    ):
        for i, (o, n) in enumerate(zip(old, new)):
            check_same_layout(o, n, f"{where}/{i}")
    elif isinstance(old, (dict, list, tuple)) or isinstance(new, (dict, list, tuple)):
        raise ValueError(f"param tree structure differs at {where}")
    elif old.shape != new.shape or old.dtype != new.dtype:
        raise ValueError(
            f"param leaf {where} changed: {tuple(new.shape)}/{new.dtype} != "
            f"{tuple(old.shape)}/{old.dtype}"
        )
