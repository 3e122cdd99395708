"""Tensor-parallel matmul over a mesh dimension.

Counterpart of ``strided_tpu/parallel/tp.py``, the multi-GPU analog of the
reference's divide-and-conquer threaded gemm. The same three splits:

- :func:`matmul_nsplit`: B's (and C's) columns over the axis; no collective;
- :func:`matmul_msplit`: A's (and C's) rows over the axis; no collective;
- :func:`matmul_ksplit`: the contraction dim over the axis; each rank's
  partial product is combined by one ``all_reduce(SUM)``.

Each takes the global A and B that every rank holds (``mesh.shard`` picks
the rank's block). Floating products run at ``precision``, a name of
``config.PRECISIONS`` (None: the configured one, pinned by
``matmul_precision_scope``), through ``config.matmul``.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import matmul, matmul_precision_scope
from .mesh import collective, shard

__all__ = ["matmul_nsplit", "matmul_msplit", "matmul_ksplit"]


def _dot(a: torch.Tensor, b: torch.Tensor, precision=None) -> torch.Tensor:
    """``a @ b``: floats accumulate in ``promote(dtype, f32)`` at
    ``precision``, ints stay in their dtype (wrapping as the reference's
    integer dot does); the result is cast to ``promote(a, b)``."""
    out = torch.promote_types(a.dtype, b.dtype)
    if out.is_floating_point or out.is_complex:
        acc = torch.promote_types(out, torch.float32)
        return matmul(a.to(acc), b.to(acc), precision).to(out)
    # integer products: CUDA has no integer matmul, so a broadcast product
    # summed in the dtype (wrapping, as an integer accumulator does)
    return (a.to(out).unsqueeze(-1) * b.to(out).unsqueeze(0)).sum(-2, dtype=out)


@matmul_precision_scope
def matmul_nsplit(A, B, mesh: DeviceMesh, axis: str = "data",
                  precision=None) -> torch.Tensor:
    """``C = A @ B`` with B's columns split over ``axis``: returns the
    rank's column block of C. A is used whole."""
    return _dot(A, shard(B, mesh, 1, axis), precision)


@matmul_precision_scope
def matmul_msplit(A, B, mesh: DeviceMesh, axis: str = "data",
                  precision=None) -> torch.Tensor:
    """``C = A @ B`` with A's rows split over ``axis``: returns the rank's
    row block of C. B is used whole."""
    return _dot(shard(A, mesh, 0, axis), B, precision)


@matmul_precision_scope
def matmul_ksplit(A, B, mesh: DeviceMesh, axis: str = "data",
                  precision=None) -> torch.Tensor:
    """``C = A @ B`` with the contraction dim split over ``axis``: each
    rank's partial product, combined by one ``all_reduce(SUM)``; C is
    replicated."""
    part = _dot(shard(A, mesh, 1, axis), shard(B, mesh, 0, axis), precision)
    return collective("all_reduce", part, mesh, axis)
