"""Linear algebra over strided views: vendor matmul and the generic path.

Counterpart of ``strided_tpu/linalg.py``.

- ``mul(C, A, B, alpha, beta)`` is full gemm, ``C = alpha * A @ B + beta * C``,
  with lazy transpose / conj operands and destinations. Equal floating or
  complex dtypes go to the vendor matmul (``torch.matmul``, cuBLAS on the
  card) when ``config.use_blas`` is on; exact dtypes (ints, complex ints)
  and mixed dtypes take the **generic path**: the matmul as a 3-D stride-0
  broadcast-reduce ``(m, n, k)`` through ``fused_mapreduce``, alpha folded
  into ``f`` and beta as the ``initop`` (applied once per output element).
- ``axpy``/``axpby``/``lmul``/``rmul``/``scale_into`` are fused broadcasts
  with the 0/1 special cases. ``axpby(alpha, A', beta, A)`` on a square
  lazy transpose is the transpose-pair workload, and :func:`_pair_route`
  sends it where the expression spelling goes (K2, or the plain fused pair
  for distinct buffers).
- ``contract`` is an einsum over the views. The vendor products read a
  dense view of the caller's storage as it lies, a lazy transpose included
  (``regularize.operand``: no copy before cuBLAS); a flipped, conjugated
  or gapped view is materialized first.
"""

from __future__ import annotations

import functools
import numbers

import torch

from .config import PRECISIONS, get_config, matmul as _matmul_at, precision_mode, single_pass
from .core.view import StridedView, StridedLayoutError, held_device, strided
from .core.regularize import materialize, operand, scatter_into
from .core.mapreduce import fused_mapreduce
from .core.broadcast import sbroadcast_into

__all__ = ["mul", "matmul", "axpy", "axpby", "lmul", "rmul", "scale_into", "contract"]


def _real_scalar(c):
    """``c`` as a float when it is a plain real number, else None."""
    if isinstance(c, bool) or not isinstance(c, numbers.Real):
        return None
    return float(c)


def _pair_route(out: StridedView, alpha, x, beta=None, y=None):
    """Run ``out .= alpha*x (+ beta*y)`` through the lazy expression's pair
    dispatch: ``axpby(alpha, A', beta, A)`` is the same workload as
    ``alpha*A.T + beta*A``, so it takes the same route (same buffer: K2
    above its gate; distinct buffers: the plain fused pair). Returns the
    updated view, or None when the call is not of that form.

    The expression is built explicitly (a numpy scalar on the left of ``*``
    would not reach the view's operator). Every precondition is checked
    here; nothing is caught, so a kernel build or launch error propagates."""
    from .core.lazy_expr import StridedExpr, identity_f, try_pattern_into

    a = _real_scalar(alpha)
    if a is None or not _same_layout_operand(x, out):
        return None
    expr = StridedExpr(torch.mul, (a, x))
    if y is not None:
        b = _real_scalar(beta)
        if b is None or not _same_layout_operand(y, out):
            return None
        expr = StridedExpr(torch.add, (expr, StridedExpr(torch.mul, (b, y))))
    return try_pattern_into(out, identity_f, (expr,))


def _same_layout_operand(v, out: StridedView) -> bool:
    return isinstance(v, StridedView) and v.shape == out.shape and v.dtype == out.dtype


# ---------------------------------------------------------------------------
# scalar multiplies
# ---------------------------------------------------------------------------


def _is_static_zero(a) -> bool:
    return isinstance(a, (int, float, complex)) and a == 0


def _is_static_one(a) -> bool:
    return isinstance(a, (int, float, complex)) and a == 1


def rmul(v, alpha) -> StridedView:
    """``A .= A * alpha``."""
    v = strided(v)
    if _is_static_one(alpha):
        return v
    if _is_static_zero(alpha):
        return sbroadcast_into(v, torch.zeros_like, v)
    return sbroadcast_into(v, lambda x: x * alpha, v)


def lmul(alpha, v) -> StridedView:
    """``A .= alpha * A``."""
    v = strided(v)
    if _is_static_one(alpha):
        return v
    if _is_static_zero(alpha):
        return sbroadcast_into(v, torch.zeros_like, v)
    return sbroadcast_into(v, lambda x: alpha * x, v)


def scale_into(dst, alpha, src) -> StridedView:
    """``dst .= alpha .* src``. A lazy-transposed ``src`` stays on the
    generic path: the reference's policy for the single-term family."""
    dst = strided(dst, held_device(src))
    src = strided(src, dst.device)
    if _is_static_one(alpha):
        return sbroadcast_into(dst, lambda x: x, src)
    return sbroadcast_into(dst, lambda x: alpha * x, src)


def axpy(alpha, x, y) -> StridedView:
    """``y .= alpha*x + y``; a lazy-transposed square ``x`` over ``y``
    takes the pair route."""
    y = strided(y, held_device(x))
    if _is_static_zero(alpha):
        return y
    hit = _pair_route(y, alpha, x, 1.0, y)
    if hit is not None:
        return hit
    return sbroadcast_into(y, lambda a, b: alpha * a + b, strided(x, y.device), y)


def axpby(alpha, x, beta, y) -> StridedView:
    """``y .= alpha*x + beta*y``; a lazy-transposed square ``x`` over ``y``
    takes the pair route, exactly like ``alpha*x.T + beta*y``."""
    y = strided(y, held_device(x))
    if _is_static_one(beta):
        return axpy(alpha, x, y)
    if _is_static_zero(beta):
        return scale_into(y, alpha, x)
    hit = _pair_route(y, alpha, x, beta, y)
    if hit is not None:
        return hit
    return sbroadcast_into(y, lambda a, b: alpha * a + beta * b, strided(x, y.device), y)


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------


def _precision(dtype=None) -> str:
    """The precision name of a vendor product, as the reference maps
    ``Config.matmul_precision`` to ``lax.Precision``: bf16 operands always
    run natively ("default": bf16 products with f32 accumulation lose
    nothing); otherwise the configured name, and a name outside
    ``PRECISIONS`` falls back to "highest" instead of raising."""
    if dtype == torch.bfloat16:
        return "default"
    name = get_config().matmul_precision
    return name if name in PRECISIONS else "highest"


def _blas_eligible(*dtypes) -> bool:
    """Equal floating or complex dtypes take the vendor matmul; exact and
    mixed dtypes the generic path (exactness kept)."""
    if not get_config().use_blas:
        return False
    first = dtypes[0]
    return all(d == first for d in dtypes) and (first.is_floating_point or first.is_complex)


def mul(C, A, B, alpha=1, beta=0) -> StridedView:
    """``C = alpha * A @ B + beta * C`` with lazy transpose/conj operands;
    returns ``C`` over its new parent."""
    dev = held_device(C, A, B)
    C, A, B = strided(C, dev), strided(A, dev), strided(B, dev)
    if A.ndim != 2 or B.ndim != 2 or C.ndim != 2:
        raise StridedLayoutError("mul expects rank-2 views")
    m, ka = A.shape
    kb, n = B.shape
    if ka != kb or C.shape != (m, n):
        raise StridedLayoutError(f"mul shape mismatch: C{C.shape} = A{A.shape} @ B{B.shape}")
    if m == 0 or n == 0:
        return C
    if ka == 0:
        return rmul(C, beta)  # no accumulation: C = beta * C
    if _blas_eligible(C.dtype, A.dtype, B.dtype):
        return _mul_blas(C, A, B, alpha, beta)
    return _mul_generic(C, A, B, alpha, beta)


def _mul_blas(C, A, B, alpha, beta) -> StridedView:
    """The vendor path, with the reference's accumulator rule: the product
    is taken in ``promote(C.dtype, f32)`` for real floating types (bf16
    operands are exact in f32, so this is bf16 products with f32
    accumulation), the epilogue applied there and the result rounded to
    ``C.dtype`` once. ``beta * old`` keeps ``C``'s dtype, as the reference's
    weakly typed scalar product does. The product runs at :func:`_precision`
    (``config.matmul``)."""
    acc = torch.promote_types(C.dtype, torch.float32) if C.dtype.is_floating_point else C.dtype
    a, b = operand(A), operand(B)
    res = _matmul_at(a.to(acc), b.to(acc), _precision(torch.promote_types(a.dtype, b.dtype)))
    if not _is_static_one(alpha):
        res = alpha * res
    if not _is_static_zero(beta):
        old = materialize(C)
        res = res + (old if _is_static_one(beta) else beta * old)
    new_parent = scatter_into(C, res.to(C.dtype))
    return StridedView(new_parent, C.shape, C.strides, C.offset, C.conj)


def _mul_generic(C, A, B, alpha, beta) -> StridedView:
    """The matmul as a 3-D stride-0 broadcast-reduce over ``(m, n, k)``,
    operand views built from metadata only:
      A(m, k) -> strides (sA_m, 0, sA_k); B(k, n) -> (0, sB_n, sB_k);
      C(m, n) -> (sC_m, sC_n, 0), so k is the reduced dim."""
    m, k = A.shape
    n = B.shape[1]
    dims = (m, n, k)
    A3 = StridedView(A.parent, dims, (A.strides[0], 0, A.strides[1]), A.offset, A.conj)
    B3 = StridedView(B.parent, dims, (0, B.strides[1], B.strides[0]), B.offset, B.conj)
    C3 = StridedView(C.parent, dims, (C.strides[0], C.strides[1], 0), C.offset, C.conj)
    if _is_static_one(alpha):
        f = lambda x, y: x * y  # noqa: E731
    else:
        f = lambda x, y: alpha * (x * y)  # noqa: E731
    if _is_static_zero(beta):
        initop = torch.zeros_like
    elif _is_static_one(beta):
        initop = None
    else:
        initop = lambda x: beta * x  # noqa: E731
    res = fused_mapreduce(f, torch.add, initop, dims, C3, [A3, B3])
    return StridedView(res.parent, C.shape, C.strides, C.offset, C.conj)


def contract(subscripts: str, *operands, alpha=1) -> torch.Tensor:
    """Tensor contraction (einsum) over lazy strided-view operands, in their
    promoted dtype, at :func:`_precision` of their common dtype (the
    configured name when they differ). At "default" f32 operands on the
    card are rounded to bf16 and contracted in IEEE FP32: the single-pass
    product's values (``config.bf16_matmul_reference``)."""
    dev = held_device(*operands)
    arrays = [operand(strided(o, dev)) for o in operands]
    dtypes = {a.dtype for a in arrays}
    rdt = functools.reduce(torch.promote_types, dtypes)
    name = _precision(dtypes.pop() if len(dtypes) == 1 else None)
    arrays = [a.to(rdt) for a in arrays]
    if single_pass(name, *arrays):
        arrays = [a.to(torch.bfloat16).float() for a in arrays]
        name = "highest"
    with precision_mode(name):
        out = torch.einsum(subscripts, *arrays)
    if not _is_static_one(alpha):
        out = alpha * out
    return out


def matmul(A, B, alpha=1) -> StridedView:
    """Allocating ``alpha * A @ B`` in the promoted dtype."""
    dev = held_device(A, B)
    A, B = strided(A, dev), strided(B, dev)
    rdt = torch.promote_types(A.dtype, B.dtype)
    C = strided(torch.zeros((A.shape[0], B.shape[1]), dtype=rdt, device=A.device))
    return mul(C, A, B, alpha=alpha, beta=0)
