"""Debug guards (port of ``tpucap.utils.debug``).

``debug_mode()`` raises ``FloatingPointError`` at the first op whose
floating output holds a NaN, for the scope of the block (what
``jax_debug_nans`` does). ``checked(fn)`` runs ``fn`` under that check and,
before each op runs, refuses an integer division by zero
(``ZeroDivisionError``) and an index outside its dimension
(``IndexError``), as tpucap's checkify wrapper does. The check before the
op matters on the card, where an index out of range is a device-side
assert that ends the CUDA context. Both are ``TorchDispatchMode``s: every
aten op of the block passes through them, so they cost a host check an op.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# Integer division and remainder (a true division of integers gives floats,
# as jnp.divide does, and is not checked).
_DIVISIONS = {
    aten.div.Tensor_mode, aten.div.Scalar_mode, aten.floor_divide.default, aten.floor_divide.Scalar,
    aten.remainder.Tensor, aten.remainder.Scalar, aten.fmod.Tensor, aten.fmod.Scalar,
}


def _int_tensor(x) -> bool:
    return isinstance(x, torch.Tensor) and not x.is_floating_point() and not x.is_complex()


def _out_of_range(index, size: int, negative: bool = False) -> bool:
    """Whether an integer index tensor leaves [0, size), or [-size, size)
    where the op counts from the end (``negative``)."""
    if not _int_tensor(index) or index.dtype == torch.bool or index.numel() == 0:
        return False
    return bool(((index < (-size if negative else 0)) | (index >= size)).any())


def _index_checks(func, args) -> list:
    """(index, size, negative) of each index tensor an index op takes: its
    dimension's size, and whether the op counts from the end."""
    packet = func.overloadpacket
    if packet in (aten.index_select, aten.gather, aten.scatter, aten.scatter_add,
                  aten.scatter_reduce, aten.index_add, aten.index_copy, aten.index_fill):
        return [(args[2], args[0].shape[args[1]] if args[0].dim() else 1, False)]
    if packet is aten.embedding:
        return [(args[1], args[0].shape[0], False)]
    if packet is aten.take:
        return [(args[1], args[0].numel(), True)]
    if packet in (aten.index, aten.index_put, aten.index_put_):
        return [(i, args[0].shape[d], True) for d, i in enumerate(args[1]) if i is not None]
    return []


def _check_division(func, args) -> None:
    if func in _DIVISIONS and _int_tensor(args[0]):
        den = args[1]
        zero = bool((den == 0).any()) if isinstance(den, torch.Tensor) else den == 0
        if zero:
            raise ZeroDivisionError(f"{func}: integer division by zero")


def _check_nans(func, out) -> None:
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for o in outs:
        if isinstance(o, torch.Tensor) and o.is_floating_point() and bool(o.isnan().any()):
            raise FloatingPointError(f"invalid value (nan) encountered in {func}")


class _Guard(TorchDispatchMode):
    def __init__(self, *, nan: bool, div: bool = False, oob: bool = False):
        super().__init__()
        self.nan, self.div, self.oob = nan, div, oob

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.div:
            _check_division(func, args)
        if self.oob:
            for index, size, negative in _index_checks(func, args):
                if _out_of_range(index, size, negative):
                    raise IndexError(f"{func}: an index leaves a dimension of size {size}")
        out = func(*args, **kwargs)
        if self.nan:
            _check_nans(func, out)
        return out


def checked(fn, *, div: bool = True, nan: bool = True, oob: bool = True):
    """``fn`` with the same signature, run under the checks asked for: a
    NaN output (FloatingPointError), an integer division by zero
    (ZeroDivisionError), an index out of range (IndexError)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _Guard(nan=nan, div=div, oob=oob):
            return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """NaN checking on every op of the block when ``nans``. ``disable_jit``
    is accepted for tpucap's signature: the port runs op by op anyway."""
    del disable_jit
    if not nans:
        yield
        return
    with _Guard(nan=True):
        yield
