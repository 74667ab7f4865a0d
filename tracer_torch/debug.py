"""Runtime sanitizers: NaN, Inf and out-of-range indices, caught where
they arise.

PyTorch counterpart of ``tracer/debug.py``. The reference C tracer has no
sanitizers (single-threaded C, no -fsanitize; Makefile:43); here
"sanitizing" means catching numeric poison and out-of-contract indices
early.

* ``TRACER_DEBUG=1`` in the environment (or :func:`enable_debug`) makes
  every torch operation that outputs a NaN raise :class:`DebugError`,
  naming the operation and the innermost line of the port that called it;
  ``TRACER_DEBUG=2`` does the same for Inf. ``python -m tracer_torch.cli``
  reads the variable at the start of each command (:func:`maybe_enable_debug`)
  and turns the check off when the command returns. The closest-hit
  contract uses +inf as the miss sentinel, so level 2 stops at the first
  miss, as ``jax_debug_infs`` does in the JAX package; parked rays
  (origin 1e18) stay finite and pass level 1.
* :func:`checked_nearest_hit` and :func:`checked_render` run the per-ray
  BVH walk and the wavefront integrator under the NaN check plus an index
  check (every integer index of a gather, scatter or indexing operation
  inside the tensor's bounds, tested before the operation runs, so an
  out-of-range index on the card is reported instead of ending the process
  with a device-side assert). They return ``(err, out)``; ``err.throw()``
  raises on the first violation, which also stopped the function (``out``
  is then None).

The check is a ``TorchDispatchMode``: it sees each operation's outputs as
they are made. Where ``jax_debug_nans`` checks what a jitted function
returns, this checks every intermediate of the eager program, so a NaN
that a later ``torch.where`` would mask also raises; the port's paths make
none (a miss substitutes 1 under the square root, and the culls replace
the NaN boxes of empty nodes before testing them). The device LBVH marks
nodes that cover only padding with NaN boxes, so a run that builds one
stops under level 1. The hand-written kernels, launched through ctypes,
are not torch operations: their outputs are checked where the next
operation reads them. Each check reads one flag back to the host, so a
checked run synchronises with the card after every operation.
"""

from __future__ import annotations

import os
import traceback
import weakref
from dataclasses import dataclass
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_PACKAGE = str(Path(__file__).resolve().parent)
_TORCH = str(Path(torch.__file__).resolve().parent)
_aten = torch.ops.aten
# Operations whose integer index tensors may be negative (they wrap).
_WRAPPING = {_aten.index, _aten.index_put, _aten.index_put_,
             _aten._index_put_impl_}
# Operations that index one dimension, given as (self, dim, index, ...).
_DIM_INDEXED = {_aten.gather, _aten.index_select, _aten.scatter,
                _aten.scatter_, _aten.scatter_add, _aten.scatter_add_,
                _aten.scatter_reduce, _aten.scatter_reduce_,
                _aten.index_add, _aten.index_add_}
# Operations whose output memory is not written (a kernel fills it later).
_UNINITIALISED = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                  _aten.new_empty, _aten.new_empty_strided}


class DebugError(RuntimeError):
    """A sanitizer found a NaN, an Inf or an out-of-range index."""


def _caller() -> str:
    """The innermost frame of the port outside this module (else the
    innermost outside torch) as "path:line (function)"."""
    stack = traceback.extract_stack()[:-2]
    ours = [f for f in stack if f.filename.startswith(_PACKAGE)
            and not f.filename.endswith("debug.py")]
    frames = ours or [f for f in stack
                      if not f.filename.startswith(_TORCH)]
    if not frames:
        return "an unknown caller"
    f = frames[-1]
    path = os.path.relpath(f.filename, os.path.dirname(_PACKAGE))
    return f"{path}:{f.lineno} ({f.name})"


def _index_bounds(func, args):
    """(index tensor, lowest allowed, size) for each integer index that
    ``func`` reads from ``args``."""
    packet = func.overloadpacket
    if packet in _WRAPPING:
        src, dim = args[0], 0
        for ix in args[1]:
            if ix is not None and ix.dtype == torch.bool:
                dim += ix.dim()
                continue
            if ix is not None:
                yield ix, -src.shape[dim], src.shape[dim]
            dim += 1
    elif packet in _DIM_INDEXED:
        src, dim, index = args[:3]
        size = src.shape[dim] if src.dim() else 1
        yield index, 0, size
    elif packet is _aten.take:
        yield args[1], -args[0].numel(), args[0].numel()
    elif packet is _aten.embedding:
        yield args[1], 0, args[0].shape[0]


def _floats(tree):
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)
            and x.is_floating_point() and x.numel()]


class Sanitizer(TorchDispatchMode):
    """Raise :class:`DebugError` at the first operation whose output holds
    a NaN, or an Inf with ``inf``, or, with ``index``, before an operation
    that would read an index outside its tensor.

    A NaN made from an infinite operand (inf - inf, 0 * inf) and what is
    computed from it pass: the port's paths use infinities as sentinels
    (a miss is t = +inf; the sentinel sphere at 3e37 squares to +inf) and
    mask the indeterminate lanes. Any other NaN raises where it first
    appears, a NaN read from outside the checked region included."""

    def __init__(self, inf: bool = False, index: bool = False):
        super().__init__()
        self.inf, self.index = inf, index
        self._from_inf = {}     # id -> weakref of outputs whose NaN passed

    def _passed(self, x) -> bool:
        for t in (x, x._base):
            ref = self._from_inf.get(id(t)) if t is not None else None
            if ref is not None and ref() is t:
                return True
        return False

    def _nan_from_inf(self, args, kwargs) -> bool:
        ins = _floats((args, kwargs))
        return any(self._passed(x) for x in ins) or any(
            bool(torch.isinf(x).any()) for x in ins)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.index:
            for ix, lo, hi in _index_bounds(func, args):
                if ix.numel():
                    mn, mx = torch.stack(torch.aminmax(ix)).tolist()
                    if mn < lo or mx >= hi:
                        raise DebugError(
                            f"index out of range: {func} reads indices "
                            f"[{mn}, {mx}] of a dimension of size {hi} at "
                            f"{_caller()}")
        out = func(*args, **kwargs)
        if func.is_view or func.overloadpacket in _UNINITIALISED:
            return out
        for x in _floats(out):
            if self.inf and bool(torch.isinf(x).any()):
                raise DebugError(f"inf produced by {func} at {_caller()}")
            if bool(torch.isnan(x).any()):
                if not self._nan_from_inf(args, kwargs):
                    raise DebugError(f"nan produced by {func} at "
                                     f"{_caller()}")
                key = id(x)
                self._from_inf[key] = weakref.ref(
                    x, lambda _, k=key: self._from_inf.pop(k, None))
        return out


_enabled: list = []     # the Sanitizer enable_debug entered, if any


def enable_debug(level: int = 1) -> None:
    """Turn NaN (level >= 1) and Inf (level >= 2) sanitizing on for every
    later torch operation of this thread; level 0 turns it off."""
    while _enabled:
        _enabled.pop().__exit__(None, None, None)
    if level >= 1:
        mode = Sanitizer(inf=level >= 2)
        mode.__enter__()
        _enabled.append(mode)


def maybe_enable_debug() -> int:
    """Enable the sanitizers from the TRACER_DEBUG variable; returns the
    level (0: left off)."""
    level = int(os.environ.get("TRACER_DEBUG", "0") or "0")
    if level:
        enable_debug(level)
    return level


@dataclass
class CheckError:
    """The first violation a checked call found (None: none)."""

    message: str | None = None

    def throw(self) -> None:
        if self.message is not None:
            raise DebugError(self.message)


def _checked(fn):
    try:
        with Sanitizer(index=True):
            out = fn()
    except DebugError as e:
        return CheckError(str(e)), None
    return CheckError(), out


def checked_nearest_hit(rays, scene, bvh):
    """The per-ray BVH walk (``intersect.traverse.nearest_hit_bvh``) under
    the NaN and index checks. Returns ``(err, HitRecord)``; ``err.throw()``
    raises on a NaN or an out-of-range index anywhere inside the walk
    (builder faults, corrupt escape indices, poisoned rays)."""
    from tracer_torch.intersect.traverse import nearest_hit_bvh
    return _checked(lambda: nearest_hit_bvh(rays, scene, bvh))


def checked_render(scene, camera, nearest_for, config, noise):
    """The wavefront integrator (``integrator.wavefront.render``) under the
    NaN and index checks. Returns ``(err, image)``."""
    from tracer_torch.integrator.wavefront import render
    return _checked(lambda: render(scene, camera, None, nearest_for, config,
                                   noise=noise))
