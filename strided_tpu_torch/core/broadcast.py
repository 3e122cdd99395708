"""Broadcast front end: numpy-style broadcasting lowered into one fused call.

Counterpart of ``strided_tpu/core/broadcast.py``. Every operand is promoted
into the iteration space with stride-0 broadcast dims (the reference's
``promoteshape``), so a broadcast operand is revisited, not copied. Python
operators on :class:`StridedView` are installed here and build lazy
:class:`StridedExpr` trees.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .view import StridedView, StridedLayoutError, broadcast_to, held_device, strided
from .mapreduce import fused_mapreduce
from .regularize import materialize
from .lazy_expr import (StridedExpr, broadcast_shape, flatten_operands, _install_operators,
                        _install_reductions)
from .ewise import result_dtype

__all__ = ["sbroadcast", "sbroadcast_into", "broadcast_views", "StridedExpr"]


def _broadcast_shape(*shapes):
    try:
        return broadcast_shape(*shapes)
    except ValueError as e:
        raise StridedLayoutError(
            f"operand shapes are not broadcast-compatible: {shapes}"
        ) from e


def broadcast_views(shape, views):
    """Promote each view to ``shape`` with stride-0 broadcast dims."""
    out = []
    for v in views:
        if v.shape != tuple(shape) and v.ndim < len(shape):
            lead = len(shape) - v.ndim
            v = StridedView(v.parent, (1,) * lead + v.shape, (0,) * lead + v.strides,
                            v.offset, v.conj)
        out.append(v if v.shape == tuple(shape) else broadcast_to(v, shape))
    return out


def _empty(shape, dtype, like: StridedView) -> StridedView:
    return strided(torch.empty(shape, dtype=dtype, device=like.device))


def sbroadcast(f: Callable, *args) -> StridedView:
    """Allocating fused broadcast ``f.(args...)``; view, expression, array
    and scalar arguments (scalars are embedded in the closure)."""
    g, views = flatten_operands(f, args)
    if not views:
        return strided(f(*args))
    shape = _broadcast_shape(*[v.shape for v in views])
    bviews = broadcast_views(shape, views)
    out = _empty(shape, result_dtype(g, [v.dtype for v in views]), views[0])
    if math.prod(shape) == 0:
        return out
    return fused_mapreduce(g, None, None, shape, out, bviews)


def sbroadcast_into(out, f: Callable, *args) -> StridedView:
    """Fused broadcast into ``out``: ``out .= f.(args...)``. Identity writes
    of a pattern-matching lazy expression reach K2."""
    from .lazy_expr import try_pattern_into

    out = strided(out, held_device(*args))
    hit = try_pattern_into(out, f, args)
    if hit is not None:
        return hit
    g, views = flatten_operands(f, args)
    shape = tuple(out.shape)
    if _broadcast_shape(shape, *[v.shape for v in views]) != shape:
        raise StridedLayoutError(
            f"broadcast result shape does not match output {shape}"
        )
    if math.prod(shape) == 0:
        return out
    return fused_mapreduce(g, None, None, shape, out, broadcast_views(shape, views))


_install_operators(StridedView)
_install_reductions(StridedView)
StridedView.__array__ = lambda self, dtype=None, copy=None: np.asarray(
    materialize(self).cpu(), dtype=dtype
)
