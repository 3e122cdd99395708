"""Planner: dimension fusion and loop order for the tile executor.

Counterpart of ``strided_tpu/core/planner.py:49-115``, ported verbatim:
these functions depend on strides alone, not on the hardware. The
reference's tile solver (``_padded_tile``, ``vmem_footprint``,
``compute_tiles``) models the TPU's (8, 128) VMEM tiling; the CUDA tile
executor (``csrc/tile_executor.cu``) uses fixed block shapes instead, so
it is not carried over.
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["fuse_dims", "index_order", "order_dims"]

Strides = Tuple[int, ...]


def index_order(strides: Strides) -> Tuple[int, ...]:
    """Rank of |stride| among nonzero strides; zero strides rank 1."""
    out = []
    for si in strides:
        a = abs(si)
        if a == 0:
            out.append(1)
            continue
        out.append(1 + sum(1 for s in strides if s != 0 and abs(s) < a))
    return tuple(out)


def fuse_dims(dims: Tuple[int, ...], all_strides: Tuple[Strides, ...]):
    """Merge adjacent dims (i, i+1) into i+1 when for EVERY operand
    ``s[i] == d[i+1] * s[i+1]``; the vacated dim becomes size 1."""
    dims = list(dims)
    all_strides = [list(s) for s in all_strides]
    for i in range(0, len(dims) - 1):
        if all(s[i] == dims[i + 1] * s[i + 1] for s in all_strides):
            dims[i + 1] = dims[i] * dims[i + 1]
            dims[i] = 1
    return tuple(dims), tuple(tuple(s) for s in all_strides)


def order_dims(dims: Tuple[int, ...], all_strides: Tuple[Strides, ...]):
    """Loop order, outermost to innermost: each dim scores
    ``1 << (g * (n - index_order))`` per operand, the output (operand 0)
    weighted 2x, size-1 dims 0; sorted ascending, so the most important dim
    is innermost. Returns ``(perm, dims, all_strides, costs)``, with
    ``costs`` = 2 * the smallest nonzero |stride| (1 where all are 0)."""
    m = len(all_strides)
    n = len(dims)
    g = (m + 1).bit_length()
    orders = [index_order(s) for s in all_strides]
    importance = []
    for i in range(n):
        score = 2 * (1 << (g * (n - orders[0][i])))
        for k in range(1, m):
            score += 1 << (g * (n - orders[k][i]))
        importance.append(0 if dims[i] <= 1 else score)
    perm = tuple(sorted(range(n), key=lambda i: (importance[i], -i)))
    dims_p = tuple(dims[i] for i in perm)
    strides_p = tuple(tuple(s[i] for i in perm) for s in all_strides)
    costs = []
    for i in range(n):
        mn = min(abs(s[i]) for s in strides_p)
        costs.append(1 if mn == 0 else mn * 2)
    return perm, dims_p, strides_p, tuple(costs)
