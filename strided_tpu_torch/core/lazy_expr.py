"""Lazy fused-broadcast expression trees (the ``Broadcasted`` analog).

Counterpart of ``strided_tpu/core/lazy_expr.py``. Python operators on a
:class:`StridedView` (and on expressions) return a lazy
:class:`StridedExpr` that records the elementwise function and its operand
leaves; nested nodes are flattened at construction. Any consumer
(``materialize``, a reduction, ``copy_into``) collapses the whole tree into
one ``fused_mapreduce`` over all leaves, or, for the transpose-pair family
``ep(a*A + b*A.T)``, into the tile-pair kernel K2.
"""

from __future__ import annotations

import logging
import math
import numbers
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .view import StridedView, held_device, row_major_strides, strided

__all__ = ["StridedExpr", "flatten_operands", "as_expr_parts", "identity_f",
           "try_pattern_expr", "try_pattern_into"]

_log = logging.getLogger("strided_tpu_torch.dispatch")


def broadcast_shape(*shapes) -> Tuple[int, ...]:
    """numpy's broadcast of ``shapes``; raises ValueError if they do not
    broadcast. (``torch.broadcast_shapes`` runs Python reference code that
    costs tens of microseconds a call.)"""
    n = max((len(s) for s in shapes), default=0)
    out = [1] * n
    for s in shapes:
        for i, d in enumerate(s, n - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return tuple(out)


def flatten_operands(f: Callable, args: Sequence) -> Tuple[Callable, List[StridedView]]:
    """Flatten mixed operands (views, expressions, arrays, scalars) into
    ``(g, leaves)``: ``g(*dense_leaf_values)`` evaluates ``f`` with scalars
    embedded and child expressions applied, one closure for the tree."""
    leaves: List[StridedView] = []
    getters = []
    dev = held_device(*args)
    for a in args:
        if isinstance(a, StridedExpr):
            start = len(leaves)
            leaves.extend(a.leaves)
            getters.append(
                lambda vals, s=start, n=len(a.leaves), cf=a.f: cf(*vals[s:s + n])
            )
        elif isinstance(a, StridedView):
            leaves.append(a)
            getters.append(lambda vals, i=len(leaves) - 1: vals[i])
        elif isinstance(a, (torch.Tensor, np.ndarray)) and getattr(a, "ndim", 0) > 0:
            leaves.append(strided(a, dev))
            getters.append(lambda vals, i=len(leaves) - 1: vals[i])
        else:  # Python / 0-d scalar: embedded in the closure
            getters.append(lambda vals, a=a: a)

    def g(*vals):
        return f(*[get(vals) for get in getters])

    return g, leaves


def as_expr_parts(x) -> Tuple[Callable, List[StridedView], Tuple[int, ...]]:
    """``(f, leaves, shape)`` for a view or expression."""
    if isinstance(x, StridedExpr):
        return x.f, list(x.leaves), x.shape
    v = x if isinstance(x, StridedView) else strided(x)
    return identity_f, [v], v.shape


class StridedExpr:
    """A lazy elementwise expression over strided-view leaves. ``f`` takes
    one dense tensor per leaf (broadcast to ``shape``)."""

    __slots__ = ("f", "leaves", "shape", "raw_op", "raw_args")

    def __init__(self, f: Callable, args: Sequence):
        g, leaves = flatten_operands(f, args)
        if not leaves:
            raise ValueError("StridedExpr requires at least one array operand")
        self.f = g
        self.leaves = tuple(leaves)
        self.shape = broadcast_shape(*[v.shape for v in leaves])
        # the node's own op and un-flattened operands, for pattern dispatch
        self.raw_op = f
        self.raw_args = tuple(args)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        from .ewise import result_dtype

        return result_dtype(self.f, [v.dtype for v in self.leaves])

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"StridedExpr(shape={self.shape}, nleaves={len(self.leaves)})"

    def evaluate(self) -> StridedView:
        """Collapse into one fused pass; returns a dense view. Same-buffer
        transpose pairs (``(v + v.T)/2``, ``v - v.T``, ``3*v + 2*v.T``) go
        to K2 above its size gate; distinct-buffer pairs to the plain fused
        expression; everything else to the generic engine."""
        from .broadcast import sbroadcast

        res = try_pattern_expr(self)
        if res is not None:
            return res
        global LAST_EXPR_DISPATCH
        LAST_EXPR_DISPATCH = "generic"
        return sbroadcast(self.f, *self.leaves)

    def materialize(self) -> torch.Tensor:
        from .regularize import materialize

        return materialize(self.evaluate())

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.materialize().cpu(), dtype=dtype)


# Which path the last evaluate() took: "pair-kernel" (K2), "xla-pair" (the
# plain fused pair expression; the reference's name, kept so the dispatch
# tests read alike) or "generic" (the fused engine). Set to "pair-kernel"
# only after kernels_special.pair_kernel_tile has confirmed K2 will run.
LAST_EXPR_DISPATCH: str = ""


def identity_f(x):
    """Marker identity used by ``copy_into``/``.at[...].set``, so a pure
    copy of a lazy expression reaches the pattern dispatch."""
    return x


def _python_scalar(x):
    """A plain Python/numpy number the dispatch may bake in, else None."""
    if isinstance(x, bool) or not isinstance(x, numbers.Real):
        return None
    return float(x)


def _square_parent(v, n):
    """The parent as an (n, n) tensor when ``v`` covers it fully, else None."""
    if v.conj or v.ndim != 2 or v.shape != (n, n) or n == 0 or v.offset != 0:
        return None
    if v.parent.numel() != n * n:
        return None
    return v.parent.reshape(n, n)


def _linear_term(x):
    """One addend of the pair pattern: a bare view, ``scalar * view`` (either
    order) or ``-view``. Returns ``(coeff, view)`` or None."""
    if isinstance(x, StridedView):
        return 1.0, x
    if isinstance(x, StridedExpr) and len(x.raw_args) == 2 and x.raw_op is torch.mul:
        for s, e in (x.raw_args, x.raw_args[::-1]):
            sc = _python_scalar(s)
            if sc is not None and isinstance(e, StridedView):
                return sc, e
    if (isinstance(x, StridedExpr) and x.raw_op is torch.neg and len(x.raw_args) == 1
            and isinstance(x.raw_args[0], StridedView)):
        return -1.0, x.raw_args[0]
    return None


def _match_pair(expr: "StridedExpr"):
    """Recognise ``ep(c1*X (+|-) c2*Y)`` (one of X, Y a plain square view,
    the other a lazy transpose) or ``ep(c*Y.T)``, ``ep`` being nothing,
    ``* scalar`` or ``/ scalar``. Returns ``(A, C or None, alpha, beta,
    scale_mode, scale, plain_first)``; ``C`` is None when both terms view
    the same parent object; ``alpha == 0`` marks the single-term family."""
    scale_mode, scale = None, 1.0
    inner = expr
    op, args = expr.raw_op, expr.raw_args
    if op is torch.mul and len(args) == 2:
        for s, e in (args, args[::-1]):
            sc = _python_scalar(s)
            if sc is not None and isinstance(e, StridedExpr):
                scale_mode, scale, inner = "mul", sc, e
                break
        else:
            return _match_single_transposed(expr, None, 1.0)
    elif op is torch.true_divide and len(args) == 2:
        sc = _python_scalar(args[1])
        if sc in (None, 0.0) or not isinstance(args[0], StridedExpr):
            return None
        scale_mode, scale, inner = "div", sc, args[0]
    if not isinstance(inner, StridedExpr) or len(inner.raw_args) != 2:
        return _match_single_transposed(inner, scale_mode, scale)
    if inner.raw_op is torch.add:
        sign2 = 1.0
    elif inner.raw_op is torch.sub:
        sign2 = -1.0
    else:
        return _match_single_transposed(inner, scale_mode, scale)
    return _match_two_terms(inner, sign2, scale_mode, scale)


def _match_single_transposed(x, scale_mode, scale):
    t = _linear_term(x)
    if t is None:
        return None
    c, v = t
    n = v.shape[0] if v.ndim == 2 else 0
    p = _square_parent(v, n)
    if p is None or n < 2 or v.strides != (1, n):
        return None
    return p, None, 0.0, c, scale_mode, scale, True


def _match_two_terms(inner, sign2, scale_mode, scale):
    t1 = _linear_term(inner.raw_args[0])
    t2 = _linear_term(inner.raw_args[1])
    if t1 is None or t2 is None:
        return None
    (c1, v1), (c2, v2) = t1, t2
    c2 *= sign2
    n = v1.shape[0] if v1.ndim == 2 else 0
    row_major, col_major = (n, 1), (1, n)
    terms = []
    for c, v in ((c1, v1), (c2, v2)):
        p = _square_parent(v, n)
        if p is None or v.strides not in (row_major, col_major):
            return None
        terms.append((c, p, v.strides == col_major))
    (ca, pa, ta), (cb, pb, tb) = terms
    if ta == tb:
        return None  # exactly one plain and one transposed operand
    same = v1.parent is v2.parent
    if tb:
        alpha, A, beta, C = ca, pa, cb, pb
    else:
        alpha, A, beta, C = cb, pb, ca, pa
    return A, (None if same else C), alpha, beta, scale_mode, scale, tb


def try_pattern_expr(expr: "StridedExpr"):
    """Run ``expr`` through K2 when it is a same-buffer transpose pair and
    ``pair_kernel_tile`` confirms the kernel will run; a distinct-buffer
    pair through the plain fused pair expression (the reference's measured
    policy). Returns a dense view or None.

    The same-buffer match compares ``parent is``, as the reference does:
    two separate ``strided(x)`` wraps of one tensor are different parents
    and match only as a distinct-buffer pair."""
    from ..config import get_config

    if not get_config().expr_pattern_dispatch:
        return None
    m = _match_pair(expr)
    if m is None:
        return None
    A, C, alpha, beta, scale_mode, scale, plain_first = m
    if alpha == 0.0:
        return None  # single transposed term: the generic path (reference policy)
    if A.dtype not in (torch.float32, torch.bfloat16):
        return None
    if C is not None and C.dtype != A.dtype:
        return None
    from .kernels_special import pair_kernel_tile, pair_axpby, pair_fallback_call

    global LAST_EXPR_DISPATCH
    if C is not None:
        LAST_EXPR_DISPATCH = "xla-pair"
        _log.debug("evaluate: %g*A + %g*C.T (distinct buffers) -> plain fused pair",
                   alpha, beta)
        return strided(pair_fallback_call(A, C, alpha=alpha, beta=beta,
                                          scale_mode=scale_mode, scale=scale,
                                          plain_first=plain_first))
    n = A.shape[0]
    tile = pair_kernel_tile(n, n, A.dtype)
    if tile is None:
        return None
    LAST_EXPR_DISPATCH = "pair-kernel"
    _log.debug("evaluate: %g*A + %g*A.T (%s %g) -> pair_axpby kernel (n=%d)",
               alpha, beta, scale_mode, scale, n)
    return strided(pair_axpby(A, None, alpha=alpha, beta=beta, scale_mode=scale_mode,
                              scale=scale, plain_first=plain_first))


def try_pattern_into(out: StridedView, f, ins):
    """``copy_into(out, expr)`` / ``v.at[:].set(expr)`` through K2 when
    ``out`` is a full dense row-major view of its parent: the kernel's fresh
    buffer becomes the new parent. Returns the updated view or None."""
    if f is not identity_f or len(ins) != 1 or not isinstance(ins[0], StridedExpr):
        return None
    expr = ins[0]
    if tuple(expr.shape) != tuple(out.shape) or out.conj or out.offset != 0:
        return None
    if out.strides != row_major_strides(out.shape) or out.parent.numel() != out.size:
        return None
    if expr.dtype != out.dtype:
        return None  # checked before any launch
    res = try_pattern_expr(expr)
    if res is None:
        return None
    return StridedView(res.parent, out.shape, out.strides, 0, False)


def _expr_binop(f):
    def fwd(self, other):
        return StridedExpr(f, (self, other))

    def rev(self, other):
        return StridedExpr(f, (other, self))

    return fwd, rev


def _install_operators(cls):
    """Lazy operator overloads (shared by StridedView and StridedExpr)."""
    for name, fn in [("add", torch.add), ("sub", torch.sub), ("mul", torch.mul),
                     ("truediv", torch.true_divide), ("pow", torch.pow),
                     ("mod", torch.remainder)]:
        fwd, rev = _expr_binop(fn)
        setattr(cls, f"__{name}__", fwd)
        setattr(cls, f"__r{name}__", rev)
    for name, fn in [("lt", torch.lt), ("le", torch.le), ("gt", torch.gt),
                     ("ge", torch.ge)]:
        setattr(cls, f"__{name}__", _expr_binop(fn)[0])
    cls.__neg__ = lambda self: StridedExpr(torch.neg, (self,))
    cls.__abs__ = lambda self: StridedExpr(torch.abs, (self,))
    # numpy must not materialize a view through __array__ for `np.float64(3) * v`
    cls.__array_ufunc__ = None


def _install_reductions(cls):
    """``.sum/.prod/.max/.min/.mean`` (one fused map+reduce pass each) and
    ``@`` (``linalg.matmul``)."""

    def _method(name, reducer_name):
        def method(self, axis=None):
            from . import mapreduce

            return getattr(mapreduce, reducer_name)(self, axis)

        method.__name__ = name
        return method

    for name, reducer in [("sum", "ssum"), ("prod", "sprod"), ("max", "smax"),
                          ("min", "smin"), ("mean", "smean")]:
        setattr(cls, name, _method(name, reducer))

    def __matmul__(self, other):
        from ..linalg import matmul

        return matmul(self, other)

    def __rmatmul__(self, other):
        from ..linalg import matmul

        return matmul(other, self)

    cls.__matmul__ = __matmul__
    cls.__rmatmul__ = __rmatmul__


_install_operators(StridedExpr)
_install_reductions(StridedExpr)
