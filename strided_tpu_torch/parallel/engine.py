"""Mesh-split engine ops: the multi-GPU tier of the strided engine.

Counterpart of ``strided_tpu/parallel/engine.py``. The reference's task
scheduler splits the loop dim with the largest ``(dims - 1) * costs``,
never a reduction dim, and combines complete reductions through
per-task accumulator slots. The JAX package hands the split to GSPMD; here
it is explicit:

- :func:`choose_split_dim`: the split-dim rule, verbatim;
- :func:`sharded_smap` / :func:`sharded_reduce`: the operands are
  materialized, each rank takes its block along the chosen dim
  (``mesh.shard``) and runs the map or reduction on it. A partial
  reduction splits a kept dim and needs no collective; a complete one
  splits the largest reduced dim and combines the ranks' partials with one
  collective;
- :func:`sharded_batched_pair` / :func:`sharded_stream_sum`: the tile-pair
  kernel K2 and the stream reduction K3 run per rank on its block.

Every operand is the global value that every rank holds.
"""

from __future__ import annotations

import operator
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core import kernels_special
from ..core.lazy_expr import as_expr_parts, broadcast_shape
from ..core.mapreduce import _reduce_vals
from ..core.regularize import materialize
from ..core.view import StridedView, strided
from .mesh import collective, shard

__all__ = [
    "choose_split_dim",
    "sharded_smap",
    "sharded_reduce",
    "sharded_batched_pair",
    "sharded_stream_sum",
]


def choose_split_dim(
    dims: Tuple[int, ...],
    all_strides: Tuple[Tuple[int, ...], ...],
    reduction_dims: Tuple[int, ...] = (),
) -> Optional[int]:
    """Pick the dim to split: largest ``(d - 1) * cost`` among non-reduction
    dims, last argmax on ties -- the task scheduler's split rule with
    reduction dims excluded by construction."""
    # cost = 2 * min nonzero |stride| (0 -> 1), evaluated in the ORIGINAL
    # axis order so the returned index is the original axis id.
    best, best_i = -1, None
    for i in range(len(dims)):
        if i in reduction_dims or dims[i] <= 1:
            continue
        mn = min(abs(s[i]) for s in all_strides)
        cost = 1 if mn == 0 else 2 * mn
        score = (dims[i] - 1) * cost
        if score >= best:
            best, best_i = score, i
    return best_i


def _full_strides(leaves, shape) -> Tuple[Tuple[int, ...], ...]:
    """The strides of the leaves of the full shape (all zero when none is)."""
    return tuple(tuple(v.strides) for v in leaves
                 if tuple(v.shape) == tuple(shape)) or ((0,) * len(shape),)


def _blocks(leaves, shape, mesh, split_dim, axis):
    """Each leaf materialized, broadcast to ``shape`` and, when ``split_dim``
    is set, cut to the rank's block along it."""
    out = []
    for v in leaves:
        arr = materialize(v).broadcast_to(shape)
        out.append(arr if split_dim is None else shard(arr, mesh, split_dim, axis))
    return out


def sharded_smap(f: Callable, mesh: DeviceMesh, *args, axis_name: str = "data",
                 split_dim: Optional[int] = None) -> StridedView:
    """Fused elementwise map over views/expressions, split over
    ``axis_name`` along the planner-chosen dim. Returns a
    :class:`StridedView` of the rank's block (the whole result when no dim
    can be split); no collective."""
    parts = [as_expr_parts(a) for a in args]
    shape = broadcast_shape(*[p[2] for p in parts])
    if split_dim is None:
        split_dim = choose_split_dim(
            shape, _full_strides([v for _, leaves, _ in parts for v in leaves], shape))
    dense = [g(*_blocks(leaves, shape, mesh, split_dim, axis_name)) for g, leaves, _ in parts]
    return strided(f(*dense))


# complete reductions whose combine is one all_reduce; any other op gathers
_REDUCE_OPS = (
    ((operator.add, torch.add), dist.ReduceOp.SUM),
    ((torch.maximum,), dist.ReduceOp.MAX),
    ((torch.minimum,), dist.ReduceOp.MIN),
    ((operator.mul, torch.mul, torch.multiply), dist.ReduceOp.PRODUCT),
)


def _combine(op: Callable, partial: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Fold the ranks' partial results with ``op``: one ``all_reduce`` for
    a known op, else one ``all_gather`` folded with ``op`` in rank order."""
    for ops, red in _REDUCE_OPS:
        if any(op is o for o in ops):
            return collective("all_reduce", partial.contiguous(), mesh, axis, op=red)
    parts = collective("all_gather", partial, mesh, axis)
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p)
    return acc


def sharded_reduce(f: Callable, op: Callable, v, mesh: DeviceMesh,
                   axes: Optional[Sequence[int]] = None, axis_name: str = "data",
                   split_dim: Optional[int] = None):
    """Fused map + reduce over a view/expression split over the mesh.
    Partial reductions split a KEPT dim (rank-disjoint outputs, race-free by
    construction, no collective); complete reductions split the largest
    reduced dim and combine the ranks' partials with one collective.

    Returns a :class:`StridedView` over the kept dims, the rank's block of
    them when a kept dim is split (as the local ``sreduce_dims`` drops the
    reduced dims), or a replicated 0-d tensor for a complete reduction (as
    the local ``sreduce``)."""
    g, leaves, shape = as_expr_parts(v)
    ndim = len(shape)
    if axes is None:
        axes = tuple(range(ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    axes = tuple(sorted(range(ndim)[a] for a in axes))
    kept = tuple(i for i in range(ndim) if i not in axes)
    if split_dim is None:
        if kept:
            split_dim = choose_split_dim(shape, _full_strides(leaves, shape), reduction_dims=axes)
        elif axes:
            # complete reduction: split the biggest reduced dim; the combine
            # is a collective, not a race.
            split_dim = max(axes, key=lambda i: shape[i])
    if split_dim is not None and shape[split_dim] <= 1:
        split_dim = None
    out = _reduce_vals(op, f(g(*_blocks(leaves, shape, mesh, split_dim, axis_name))), axes)
    if split_dim is not None and split_dim in axes:
        out = _combine(op, out, mesh, axis_name)  # each rank folded part of a reduced dim
    if not kept:
        return out  # complete reduction: 0-d tensor, like local sreduce
    return strided(out)


def sharded_batched_pair(x: torch.Tensor, mesh: DeviceMesh, *, alpha: float = 1.0,
                         beta: float = 1.0, scale_mode=None, scale: float = 1.0,
                         axis_name: str = "data") -> torch.Tensor:
    """Per-rank tile-pair kernels: ``x`` is ``(B, n, n)`` with B divisible
    by the axis size; each rank runs
    :func:`~..core.kernels_special.pair_axpby` (K2) on each matrix of its
    block. Returns the rank's block ``(B/ranks, n, n)``. On the card K2
    launches once a matrix, or raises."""
    if x.ndim != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"expected (B, n, n), got {tuple(x.shape)}")
    block = shard(x, mesh, 0, axis_name)
    return torch.stack([
        kernels_special.pair_axpby(m, alpha=alpha, beta=beta, scale_mode=scale_mode, scale=scale)
        for m in block.unbind(0)])


_IDENTITY = kernels_special.pure(lambda t: t, "identity")


def sharded_stream_sum(x: torch.Tensor, mesh: DeviceMesh, *,
                       axis_name: str = "data") -> torch.Tensor:
    """Leading-axis column sum of ``x`` ``(N, M)`` split by rows over the
    axis: each rank folds its ``(N/ranks, M)`` block through the stream
    reduction K3, and one ``all_reduce(SUM)`` combines the partials; the
    ``(M,)`` result is replicated. Where K3's gate declines the block (too
    small, or a dtype it does not take) the block is summed plainly, as the
    reference falls back to XLA's reduction; ``kernels_special.
    LAST_REDUCE_DISPATCH`` says which ran ("stream-kernel" or "xla") and
    ``stream_reduce.PATHS`` counts the kernel's launches by route."""
    if x.ndim != 2:
        raise ValueError(f"expected (N, M), got {tuple(x.shape)}")
    block = shard(x, mesh, 0, axis_name).contiguous()
    N, M = block.shape
    view = StridedView(block.reshape(-1), (N, M), (M, 1), 0, False)
    res = kernels_special.try_stream_reduce(_IDENTITY, torch.add, view, (0,))
    if res is None:
        kernels_special.LAST_REDUCE_DISPATCH = "xla"
        res = torch.sum(block, dim=0, dtype=block.dtype)
    return collective("all_reduce", res, mesh, axis_name)
