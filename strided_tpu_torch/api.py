"""User-facing sugar: ``to_array``, ``maybe_strided``, ``maybe_unstrided``
and ``strided_jit``.

Counterpart of ``strided_tpu/api.py``. PyTorch runs eagerly, so
:func:`strided_jit` keeps the reference's contract (tensor arguments enter
as lazy views, view and expression results leave as dense tensors) and
compiles nothing.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from .core.view import StridedView, strided
from .core.regularize import materialize
from .core.lazy_expr import StridedExpr

__all__ = ["strided_jit", "maybe_strided", "maybe_unstrided", "to_array"]


def maybe_strided(x):
    """A dense array (rank >= 1) becomes a StridedView; anything else passes."""
    if isinstance(x, StridedView):
        return x
    if isinstance(x, (torch.Tensor, np.ndarray)) and getattr(x, "ndim", 0) > 0:
        return strided(x)
    return x


def maybe_unstrided(x):
    """A view or lazy expression becomes a dense tensor; anything else passes."""
    if isinstance(x, (StridedView, StridedExpr)):
        return to_array(x)
    return x


def to_array(v, dtype=None) -> torch.Tensor:
    """Materialize a view or lazy expression, optionally converting dtype."""
    arr = v.materialize() if isinstance(v, StridedExpr) else materialize(strided(v))
    return arr if dtype is None else arr.to(dtype)


def _tree_map(fn, x):
    if isinstance(x, (list, tuple)) and not isinstance(x, StridedView):
        return type(x)(_tree_map(fn, y) for y in x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, y) for k, y in x.items()}
    return fn(x)


def strided_jit(fun: Optional[Callable] = None, **_unused):
    """Decorator: call ``fun`` with array arguments wrapped as lazy views and
    return its view/expression results as dense tensors (nested lists,
    tuples and dicts are walked). Runs eagerly."""

    def decorate(f: Callable) -> Callable:
        @functools.wraps(f)
        def inner(*args, **kwargs):
            args = _tree_map(maybe_strided, args)
            kwargs = _tree_map(maybe_strided, kwargs)
            return _tree_map(maybe_unstrided, f(*args, **kwargs))

        return inner

    return decorate(fun) if fun is not None else decorate
