"""The tile-pair kernel K2 and the stream-reduction dispatch.

Counterpart of ``strided_tpu/core/kernels_special.py``.

:func:`pair_axpby` computes ``B = ep(alpha*A + beta*C^T)`` for square
matrices: the reference's flagship ``(A + A^T)/2``, ``A - A^T``,
``3A + 2A^T`` and, in direct calls, ``A + C^T`` and ``3 * A^T``. On CUDA
tensors it launches ``csrc/pair_axpby.cu``, which reads each mirror tile
pair once and writes both output tiles (two passes over device memory when
``C is A``); on CPU tensors it runs the plain PyTorch version,
:func:`pair_reference`, which is also the arithmetic's single definition
(:func:`_pair_term`, :func:`_epilogue`). ``LAUNCHES`` counts launches of K2.

:func:`try_stream_reduce` decides whether a partial reduction goes to the
stream reduction K3 (``stream_reduce.py``) and records the decision in
``LAST_REDUCE_DISPATCH``.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import math
import operator

import torch

from ..config import get_config
from ..utils.profiling import annotated
from . import ewise, stream_reduce as sr
from .regularize import decompose

__all__ = ["symmetrize", "pair_axpby", "pair_reference", "pair_kernel_tile",
           "pair_fallback_call", "try_stream_reduce", "LAUNCHES"]

_log = logging.getLogger("strided_tpu_torch.dispatch")

LAUNCHES: int = 0  # launches of the K2 kernel
TILE = 32  # csrc/pair_axpby.cu: TILE
_OK_DTYPES = (torch.float32, torch.bfloat16)


def pair_kernel_tile(n: int, m: int, dtype, distinct: bool = False):
    """The one eligibility gate of K2, shared by :func:`pair_axpby` and the
    lazy-expression dispatch: the kernel's tile, or None when the caller
    must take the generic path. Any square n >= 1 of f32/bf16 above the
    ``pair_kernel_min_elements`` gate (the kernel masks ragged edges)."""
    cfg = get_config()
    if not cfg.use_kernels or n != m or n == 0 or dtype not in _OK_DTYPES:
        return None
    if n * n < cfg.pair_kernel_min_elements:
        return None
    return TILE


def _apply_coeff(t, c: float):
    # x*1 == x and -(x) == -1*x exactly in IEEE; the shortcuts skip multiplies
    if c == 1.0:
        return t
    if c == -1.0:
        return -t
    return t * c


def _coeff_mode(c: float) -> int:
    """:func:`_apply_coeff`'s branch, for the kernel (1, -1, or 2: multiply)."""
    return 1 if c == 1.0 else (-1 if c == -1.0 else 2)


def _epilogue(S, scale_mode, scale):
    """The top-level scale node of the source expression. Division is IEEE
    division by the f32 scale on every device (on the card, torch's eager
    ``x / python_scalar`` would multiply by the reciprocal instead)."""
    if scale_mode == "mul":
        return S * scale
    if scale_mode == "div":
        d = torch.tensor(scale, dtype=torch.float32, device=S.device)
        return (S.float() / d).to(S.dtype)
    return S


def _pair_term(a, ct, alpha: float, beta: float, plain_first: bool = True):
    """``alpha*a + beta*ct``; only ``alpha == 0`` (a source with no plain
    term) drops a term, and the source's term order is kept."""
    if alpha == 0.0:
        return _apply_coeff(ct, beta)
    ta, tb = _apply_coeff(a, alpha), _apply_coeff(ct, beta)
    return ta + tb if plain_first else tb + ta


def pair_reference(a, c=None, *, alpha=1.0, beta=1.0, scale_mode=None, scale=1.0,
                   plain_first=True) -> torch.Tensor:
    """Plain PyTorch version of K2, the same operations in the same order."""
    S = _pair_term(a, (a if c is None else c).T, alpha, beta, plain_first)
    return _epilogue(S, scale_mode, scale).contiguous()


pair_fallback_call = pair_reference  # the plain fused pair (distinct buffers)


@functools.cache
def _kernel_fn():
    from .._build import load_library

    fn = load_library().strided_pair_axpby
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_SCALE_MODE = {None: 0, "mul": 1, "div": 2}


@annotated("engine.launch")
def pair_axpby(a: torch.Tensor, c: torch.Tensor = None, *, alpha: float = 1.0,
               beta: float = 1.0, scale_mode=None, scale: float = 1.0, tile: int = None,
               plain_first: bool = True) -> torch.Tensor:
    """``ep(alpha*a + beta*c.T)`` for square ``a`` (``c`` defaults to ``a``:
    the two-pass same-buffer kernel). CUDA tensors launch K2 and must be
    contiguous f32/bf16 of one shape and dtype; CPU tensors take
    :func:`pair_reference`.

    ``tile``: the reference's tile edge, None or a positive int. K2 has one
    edge (``TILE``) and runs at it whatever ``tile`` names; the values do
    not depend on the tile. The reference's own refusals of an edge (not a
    multiple of 128, or past the matrix) send it to the plain expression,
    which computes the same values."""
    global LAUNCHES
    if tile is not None and (isinstance(tile, bool) or not isinstance(tile, int) or tile < 1):
        raise ValueError(f"pair_axpby: tile must be None or a positive int, got {tile!r}")
    kw = dict(alpha=alpha, beta=beta, scale_mode=scale_mode, scale=scale,
              plain_first=plain_first)
    cc = a if c is None else c
    if a.device.type == "cpu" and cc.device.type == "cpu":
        return pair_reference(a, c, **kw)
    if a.device.type != "cuda" or cc.device != a.device:
        raise ValueError(f"pair_axpby: tensors on {a.device} and {cc.device}")
    if a.ndim != 2 or a.shape[0] != a.shape[1] or cc.shape != a.shape:
        raise ValueError(f"pair_axpby: needs square matrices of one shape, got "
                         f"{tuple(a.shape)}, {tuple(cc.shape)}")
    if a.dtype not in _OK_DTYPES or cc.dtype != a.dtype:
        raise TypeError(f"pair_axpby: kernel takes f32 or bf16, got {a.dtype}, {cc.dtype}")
    if not (a.is_contiguous() and cc.is_contiguous()):
        raise ValueError("pair_axpby: kernel takes contiguous tensors")
    if scale_mode not in _SCALE_MODE:
        raise ValueError(f"pair_axpby: scale_mode {scale_mode!r}")
    n = a.shape[0]
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel_fn()(
            a.data_ptr(), cc.data_ptr(), out.data_ptr(), n,
            0 if a.dtype == torch.float32 else 1,
            0 if alpha == 0.0 else _coeff_mode(alpha), float(alpha),
            _coeff_mode(beta), float(beta),
            _SCALE_MODE[scale_mode], float(scale), int(bool(plain_first)), stream,
        )
    if err != 0:
        raise RuntimeError(f"pair_axpby: kernel launch failed, cudaError_t {err}")
    LAUNCHES += 1
    return out


def symmetrize(a: torch.Tensor, tile: int = None, alpha: float = 0.5) -> torch.Tensor:
    """``(a + a.T) * alpha`` through K2 (the reference's flagship); ``tile``
    as :func:`pair_axpby` takes it."""
    if alpha == 1.0:
        return pair_axpby(a, tile=tile)
    return pair_axpby(a, scale_mode="mul", scale=alpha, tile=tile)


# ---------------------------------------------------------------------------
# stream-reduction dispatch (K3)
# ---------------------------------------------------------------------------

# "stream-kernel" when the last partial reduction went to K3; reset to "xla"
# (the reference's name for its plain path) at every sreduce/sreduce_dims.
LAST_REDUCE_DISPATCH: str = ""


def _stream_red(op):
    for ops, code in (((operator.add, torch.add), sr.RED_SUM),
                      ((operator.mul, torch.mul), sr.RED_PROD),
                      ((torch.minimum,), sr.RED_MIN), ((torch.maximum,), sr.RED_MAX)):
        if any(op is o for o in ops):
            return code
    return None


def pure(f, key):
    """Mark ``f``, a map the engine builds, as a function of ``key`` alone
    (for example ``("scale", 0.5)`` for ``x * 0.5``): maps with equal keys
    compute the same values, so :func:`try_stream_reduce` plans a reduction
    of them once per key, fold, layout and gates, not once per call."""
    f.plan_key = key
    return f


_PLANS: dict = {}  # K3 plans of marked maps (pure), by map, fold, layout and gates


def try_stream_reduce(total_f, op, view, axes):
    """Run a partial reduction through K3 when the layout qualifies; returns
    the dense result in the logical kept shape (reduced dims dropped), of
    ``total_f``'s result dtype, or None.

    Qualifies: one view that is a bijective dense relabeling of its whole
    parent (lazy transposes and permutes included); the reduced logical axes
    are the leading physical block and at least one axis is kept; a known
    fold (sum/prod/min/max); f32/bf16/int32 operand and result; ``f`` traces
    to an elementwise program; at least ``min_stream_reduce_elements``. The
    TPU's relayout rules (a single 128-multiple minor kept dim, middle dims
    multiples of 8, a slab height dividing the row count) do not apply: the
    kernel takes any (N, M).

    The plan (the program traced, its result dtype and the operand's
    layout) depends on nothing else, so for a map the engine marked
    (:func:`pure`: ``smean``'s scale, the plain reductions' identity) it is
    made once per map, fold, layout and gates, and then only launched."""
    cfg = get_config()
    if not (cfg.use_kernels and cfg.stream_reductions):
        return None
    key = getattr(total_f, "plan_key", None)
    if key is None:
        plan = _stream_plan(total_f, op, view, axes, cfg)
    else:
        key = (key, op, view.shape, view.strides, view.offset, view.conj, view.dtype,
               view.parent.numel(), tuple(axes), cfg.min_stream_reduce_elements)
        plan = _PLANS.get(key)
        if plan is None:
            if len(_PLANS) > 4096:
                _PLANS.clear()
            plan = _PLANS[key] = _stream_plan(total_f, op, view, axes, cfg)
    if not plan:
        return None
    N, M, prog, red, kept_shape, order = plan
    out = sr.stream_reduce(view.parent.reshape(N, M), prog, red)
    # physical kept order -> ascending logical order (M elements, cheap)
    out = out.reshape(kept_shape)
    if order is not None:
        out = out.permute(order).contiguous()
    global LAST_REDUCE_DISPATCH
    LAST_REDUCE_DISPATCH = "stream-kernel"
    _log.debug("sreduce_dims: leading-axis reduction (N=%d, M=%d) -> stream_reduce", N, M)
    return out


def _stream_plan(total_f, op, view, axes, cfg):
    """``(N, M, program, fold, kept shape, kept permutation or None)`` of a
    reduction K3 takes (see :func:`try_stream_reduce`), else False."""
    ok = (torch.float32, torch.bfloat16, torch.int32)
    if view.conj or view.dtype not in ok or view.size < cfg.min_stream_reduce_elements:
        return False
    red = _stream_red(op)
    if red is None:
        return False
    rdt = ewise.result_dtype(total_f, [view.dtype])
    if rdt not in ok:
        return False
    try:
        prog = ewise.trace(total_f, [view.dtype], out_dtype=rdt)
    except ewise.Ineligible as e:
        _log.debug("stream reduction declined: %s", e)
        return False
    dec = decompose(view.shape, view.strides, view.offset)
    if dec.overlapping or any(dec.flipped) or dec.min_offset != 0:
        return False
    if len(dec.real_axes) != sum(1 for d in view.shape if d != 1):
        return False
    n = len(dec.sizes)
    if n == 0 or dec.strides[-1] != 1:
        return False
    for k in range(n - 1):
        if dec.strides[k] != dec.sizes[k + 1] * dec.strides[k + 1]:
            return False
    if math.prod(dec.sizes) != view.parent.numel():
        return False
    axes = set(axes)
    red_phys = [k for k, a in enumerate(dec.real_axes) if a in axes]
    kept_phys = [k for k, a in enumerate(dec.real_axes) if a not in axes]
    if not red_phys or not kept_phys or red_phys != list(range(len(red_phys))):
        return False
    N = math.prod(dec.sizes[k] for k in red_phys)
    M = math.prod(dec.sizes[k] for k in kept_phys)
    kept_axes = [dec.real_axes[k] for k in kept_phys]
    order = sorted(range(len(kept_axes)), key=lambda i: kept_axes[i])
    return (N, M, prog, red, tuple(dec.sizes[k] for k in kept_phys),
            None if order == list(range(len(order))) else order)
