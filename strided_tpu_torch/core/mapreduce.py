"""Fused multi-operand map / reduce engine.

Counterpart of ``strided_tpu/core/mapreduce.py``. The central primitive,
:func:`fused_mapreduce`, keeps the reference's two encodings:

- **reduction dims are output dims with stride 0** (the output view is
  broadcast over the reduced dims);
- **``initop`` is applied exactly once per output element**, to its old
  value, before the reduction is folded in: ``out = op(initop(old), fold)``.

Dispatch: the tile executor K4 (``executor_cuda.py``) first, then the plain
PyTorch path here (materialize the operands, apply ``f``, reduce, scatter).
Partial reductions try the stream reduction K3 first
(``kernels_special.try_stream_reduce``).
"""

from __future__ import annotations

import logging
import math
import operator
from typing import Callable, Optional, Sequence, Tuple

import torch

from .view import StridedView, StridedLayoutError, broadcast_to, held_device, strided
from .regularize import materialize, scatter_into
from .lazy_expr import as_expr_parts, identity_f
from .ewise import result_dtype
from .kernels_special import pure
from ..utils.profiling import annotated

_dispatch_log = logging.getLogger("strided_tpu_torch.dispatch")

__all__ = [
    "fused_mapreduce",
    "smap",
    "map_into",
    "copy_into",
    "permutedims_into",
    "adjoint_into",
    "conj_into",
    "sreduce",
    "sreduce_dims",
    "mapreducedim_into",
    "reduce_identity",
    "ssum",
    "sprod",
    "smax",
    "smin",
    "smean",
]


def _is(op, *candidates) -> bool:
    return any(op is c for c in candidates)


def reduce_identity(op: Callable, dtype):
    """Identity element of a known reduction op as a Python scalar, or None
    for an op of unknown identity."""
    if _is(op, operator.add, torch.add):
        return 0
    if _is(op, operator.mul, torch.mul):
        return 1
    if _is(op, torch.minimum):
        return float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max
    if _is(op, torch.maximum):
        return float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min
    if _is(op, torch.logical_and):
        return True
    if _is(op, torch.logical_or):
        return False
    if _is(op, operator.and_, torch.bitwise_and):
        return -1
    if _is(op, operator.or_, torch.bitwise_or):
        return 0
    return None


def _native_reducer(op):
    """``red(vals_2d) -> reduced over the last dim`` for a known op, else None.
    Sums and products keep the operand dtype, as the reference does."""
    if _is(op, operator.add, torch.add):
        return lambda v: torch.sum(v, dim=-1, dtype=v.dtype)
    if _is(op, operator.mul, torch.mul):
        return lambda v: torch.prod(v, dim=-1, dtype=v.dtype)
    if _is(op, torch.minimum):
        return lambda v: torch.amin(v, dim=-1)
    if _is(op, torch.maximum):
        return lambda v: torch.amax(v, dim=-1)
    if _is(op, torch.logical_and):
        return lambda v: torch.all(v, dim=-1)
    if _is(op, torch.logical_or):
        return lambda v: torch.any(v, dim=-1)
    return None


def _reduce_vals(op: Callable, vals: torch.Tensor, axes: Tuple[int, ...]) -> torch.Tensor:
    """Reduce ``vals`` over ``axes`` with binary ``op`` (dims dropped).
    Unknown ops fold adjacent pairs in log depth (associativity only)."""
    keep = [i for i in range(vals.ndim) if i not in axes]
    v = vals.permute(keep + list(axes))
    v = v.reshape(tuple(v.shape[:len(keep)]) + (-1,))
    red = _native_reducer(op)
    if red is not None:
        return red(v)
    ident = reduce_identity(op, vals.dtype)
    if v.shape[-1] == 0:
        if ident is None:
            raise StridedLayoutError(
                "cannot reduce over empty dims with an op of unknown identity"
            )
        return torch.full(v.shape[:-1], ident, dtype=vals.dtype, device=vals.device)
    while v.shape[-1] > 1:
        k = v.shape[-1]
        m = k // 2
        folded = op(v[..., 0:2 * m:2], v[..., 1:2 * m:2])
        if k % 2:
            folded = torch.cat([folded, v[..., -1:]], dim=-1)
        v = folded
    return v[..., 0]


def fused_mapreduce(
    f: Callable,
    op: Optional[Callable],
    initop: Optional[Callable],
    dims: Tuple[int, ...],
    out: StridedView,
    ins: Sequence[StridedView],
) -> StridedView:
    """``out[I] = op(initop(out[I]), fold_op over reduced dims of f(ins[I]))``.

    ``dims`` is the full logical iteration space; reduction dims are those
    where ``out`` has stride 0 and size > 1; ``op=None`` is a pure map.
    Returns ``out`` over its (functionally) updated parent."""
    dims = tuple(int(d) for d in dims)
    dev = held_device(out, *ins)
    out = strided(out, dev)
    ins = [strided(v, dev) for v in ins]
    for v in ins:
        if tuple(v.shape) != dims:
            raise StridedLayoutError(f"input shape {v.shape} != iteration dims {dims}")
    if tuple(out.shape) != dims:
        raise StridedLayoutError(f"output shape {out.shape} != iteration dims {dims}")
    red = tuple(i for i in range(len(dims)) if out.strides[i] == 0 and dims[i] != 1)
    if any(d == 0 for d in dims):
        if initop is None:
            return out
        if any(dims[i] == 0 for i in red):
            out_read = _squeeze_view(out, red)
            new_parent = scatter_into(out_read, initop(materialize(out_read)))
            return StridedView(new_parent, out.shape, out.strides, out.offset, out.conj)
        return out

    from . import executor_cuda

    res = executor_cuda.try_fused_mapreduce(f, op, initop, dims, out, ins)
    if res is not None:
        _dispatch_log.debug("fused_mapreduce dims=%s reduce=%s -> tile_executor",
                            dims, bool(red))
        return res
    _dispatch_log.debug("fused_mapreduce dims=%s reduce=%s -> plain", dims, bool(red))
    return _plain_fused_mapreduce(f, op, initop, dims, out, ins, red)


def _squeeze_view(out: StridedView, red: Tuple[int, ...]) -> StridedView:
    """Output view with reduction dims collapsed to size 1."""
    shape = tuple(1 if i in red else d for i, d in enumerate(out.shape))
    return StridedView(out.parent, shape, out.strides, out.offset, out.conj)


@annotated("engine.plain")
def _plain_fused_mapreduce(f, op, initop, dims, out, ins, red) -> StridedView:
    vals = f(*[materialize(v) for v in ins]) if ins else f()
    vals = torch.as_tensor(vals, device=out.device)
    if tuple(vals.shape) != dims:
        vals = vals.expand(dims)
    out_read = _squeeze_view(out, red)
    if op is None:
        new_parent = scatter_into(out_read, vals.to(out.dtype))
        return StridedView(new_parent, out.shape, out.strides, out.offset, out.conj)
    partial = _reduce_vals(op, vals, red) if red else vals
    partial = partial.reshape(out_read.shape)
    old = materialize(out_read)
    seed = initop(old) if initop is not None else old
    final = op(seed.to(partial.dtype), partial)
    new_parent = scatter_into(out_read, final.to(out.dtype))
    return StridedView(new_parent, out.shape, out.strides, out.offset, out.conj)


# ---------------------------------------------------------------------------
# user-facing facades
# ---------------------------------------------------------------------------


def map_into(out, f: Callable, *ins) -> StridedView:
    """``out .= f.(ins...)``; shapes must match exactly. Inputs may be lazy
    expressions; an identity copy of a pair pattern reaches K2."""
    from .lazy_expr import flatten_operands, try_pattern_into
    from .broadcast import broadcast_views

    out = strided(out, held_device(*ins))
    hit = try_pattern_into(out, f, ins)
    if hit is not None:
        return hit
    shapes = {tuple(out.shape)} | {tuple(v.shape) for v in ins if getattr(v, "ndim", 0) > 0}
    if len(shapes) > 1:
        raise StridedLayoutError(f"shape mismatch across operands: {shapes}")
    if out.size == 0:
        return out
    g, views = flatten_operands(f, ins)
    return fused_mapreduce(g, None, None, out.shape, out, broadcast_views(out.shape, views))


def smap(f: Callable, *ins) -> StridedView:
    """Allocating map with dtype promotion (``Base.map``)."""
    from .lazy_expr import flatten_operands
    from .broadcast import broadcast_views

    shapes = {tuple(v.shape) for v in ins if getattr(v, "ndim", 0) > 0}
    if len(shapes) > 1:
        raise StridedLayoutError(f"shape mismatch across operands: {shapes}")
    shape = shapes.pop() if shapes else ()
    g, views = flatten_operands(f, ins)
    bviews = broadcast_views(shape, views)
    device = views[0].device if views else None
    out = strided(torch.empty(shape, dtype=result_dtype(g, [v.dtype for v in bviews]),
                              device=device))
    if math.prod(shape) == 0:
        return out
    return fused_mapreduce(g, None, None, shape, out, bviews)


def copy_into(out, src) -> StridedView:
    """``copy!(dst, src)`` = ``map!(identity, dst, src)``."""
    from .lazy_expr import identity_f

    return map_into(out, identity_f, src)


def permutedims_into(out, src, perm) -> StridedView:
    """Out-of-place permute: a lazy permute, then a fused strided copy."""
    from .view import permutedims as _p

    return copy_into(out, _p(strided(src, held_device(out)), perm))


def adjoint_into(out, src) -> StridedView:
    from .view import adjoint as _a

    return copy_into(out, _a(strided(src, held_device(out))))


def conj_into(out, src=None) -> StridedView:
    from .view import conj as _c

    return copy_into(out, _c(strided(out if src is None else src, held_device(out))))


def sreduce(f: Callable, op: Callable, v, init=None):
    """Complete reduction ``mapreduce(f, op, A)``; returns a 0-d tensor. ``v``
    may be a lazy expression (map + reduce in one pass)."""
    from .broadcast import broadcast_views
    from . import kernels_special
    from .regularize import is_full_bijection, decompose

    kernels_special.LAST_REDUCE_DISPATCH = "xla"  # until a kernel claims it
    g, leaves, shape = as_expr_parts(v)
    total_f = lambda *arrs: f(g(*arrs))  # noqa: E731
    ndim = len(shape)
    if math.prod(shape) == 0:
        if init is None:
            raise StridedLayoutError("reduction over empty view requires init")
        return torch.as_tensor(init)
    bviews = broadcast_views(shape, leaves)
    rdt = result_dtype(total_f, [b.dtype for b in bviews])
    device = bviews[0].device

    # A complete reduction with a known op over one bijective view visits
    # every parent element once: reduce the flat parent in its physical shape.
    if len(bviews) == 1 and reduce_identity(op, rdt) is not None and is_full_bijection(bviews[0]):
        leaf = bviews[0]
        arr = leaf.parent.conj().resolve_conj() if leaf.conj else leaf.parent
        dphys = decompose(leaf.shape, leaf.strides, leaf.offset)
        if dphys.sizes:
            arr = arr.reshape(dphys.sizes)
        partial = _reduce_vals(op, torch.as_tensor(total_f(arr)).expand(arr.shape),
                               tuple(range(arr.ndim)))
        if init is not None:
            partial = op(torch.as_tensor(init, dtype=rdt, device=device), partial)
        return partial.to(rdt)

    if init is None:
        ident = reduce_identity(op, rdt)
        if ident is None:
            vals = total_f(*[materialize(b) for b in bviews])
            return _reduce_vals(op, torch.as_tensor(vals).expand(shape), tuple(range(ndim)))
        initop = lambda x: torch.full_like(x, ident)  # noqa: E731
    else:
        initop = lambda x: torch.full_like(x, init, dtype=rdt)  # noqa: E731
    out = strided(torch.zeros((1,) * max(ndim, 1), dtype=rdt, device=device))
    out = StridedView(out.parent, shape, (0,) * ndim, 0, False)
    res = fused_mapreduce(total_f, op, initop, shape, out, bviews)
    return res.parent[0]


def sreduce_dims(f: Callable, op: Callable, v, axes, init=None) -> StridedView:
    """Partial reduction over ``axes``; returns a view with the reduced dims
    kept at size 1. ``v`` may be a lazy expression."""
    from .broadcast import broadcast_views
    from . import kernels_special

    kernels_special.LAST_REDUCE_DISPATCH = "xla"  # never stale
    g, leaves, shape = as_expr_parts(v)
    total_f = f if g is identity_f else lambda *arrs: f(g(*arrs))  # noqa: E731
    ndim = len(shape)
    if isinstance(axes, int):
        axes = (axes,)
    axes = tuple(sorted(range(ndim)[a] for a in axes))
    bviews = broadcast_views(shape, leaves)
    out_shape = tuple(1 if i in axes else d for i, d in enumerate(shape))
    device = bviews[0].device

    if len(bviews) == 1 and tuple(bviews[0].shape) == tuple(shape):
        res = kernels_special.try_stream_reduce(total_f, op, bviews[0], axes)
        if res is not None:
            _dispatch_log.debug("sreduce_dims axes=%s -> stream_reduce", axes)
            if init is not None:
                res = op(torch.as_tensor(init, dtype=res.dtype, device=device), res)
            return strided(res.reshape(out_shape))

    rdt = result_dtype(total_f, [b.dtype for b in bviews])
    ident = reduce_identity(op, rdt)
    if init is not None:
        initop = lambda x: torch.full_like(x, init, dtype=rdt)  # noqa: E731
    elif ident is not None:
        initop = lambda x: torch.full_like(x, ident)  # noqa: E731
    else:
        raise StridedLayoutError("partial reduction with unknown op identity requires init")
    out = strided(torch.zeros(out_shape, dtype=rdt, device=device))
    out_b = broadcast_to(out, shape) if out_shape != shape else out
    res = fused_mapreduce(total_f, op, initop, shape, out_b, bviews)
    return StridedView(res.parent, out_shape, out.strides, 0, False)


def mapreducedim_into(f, op, initop, out, *ins) -> StridedView:
    """Raw engine entry with an explicit ``initop``."""
    dev = held_device(out, *ins)
    out = strided(out, dev)
    views = [strided(v, dev) for v in ins]
    dims = views[0].shape if views else out.shape
    for v in views:
        if v.shape != dims:
            raise StridedLayoutError("input shape mismatch")
    if out.shape != dims:
        out = broadcast_to(out, dims)
    return fused_mapreduce(f, op, initop, dims, out, views)


def _identity(x):
    return x


pure(_identity, "identity")


def _conv_reduce(op, v, axis, init=None):
    if axis is None:
        return sreduce(_identity, op, v, init=init)
    return sreduce_dims(_identity, op, v, axis, init=init)


def ssum(v, axis=None):
    """``sum(A)`` / ``sum(A; dims=axis)``."""
    return _conv_reduce(torch.add, v, axis)


def sprod(v, axis=None):
    """``prod(A)`` / ``prod(A; dims=axis)``."""
    return _conv_reduce(torch.mul, v, axis)


def smax(v, axis=None):
    """``maximum(A)`` (NaN-propagating)."""
    return _conv_reduce(torch.maximum, v, axis)


def smin(v, axis=None):
    """``minimum(A)``."""
    return _conv_reduce(torch.minimum, v, axis)


def smean(v, axis=None):
    """``mean(A)`` in one fused pass: the ``1/n`` scale folds into the map."""
    _, _, shape = as_expr_parts(v)
    if axis is None:
        return ssum(v) / math.prod(shape)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(range(len(shape))[a] for a in axes)
    inv = 1.0 / math.prod(shape[a] for a in axes)
    return sreduce_dims(pure(lambda x: x * inv, ("scale", inv)), torch.add, v, axes)
