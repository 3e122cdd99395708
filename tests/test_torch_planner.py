"""Parity of the port's planner (strided_tpu_torch.core.planner) with the
JAX package's: ``index_order``, ``fuse_dims`` and ``order_dims`` must give
equal results (exact: they are integer functions) on the same stride sets."""

import numpy as np
import pytest

pytest.importorskip("torch")

from strided_tpu.core import planner as jpl  # noqa: E402
from strided_tpu_torch.core import planner as tpl  # noqa: E402


def _stride_sets(seed):
    """Random iteration dims and 1-4 operands' strides: dense permutations,
    broadcasts (stride 0), reversed and gapped layouts."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    dims = tuple(int(d) for d in rng.integers(1, 6, n))
    sets = []
    for _ in range(int(rng.integers(1, 5))):
        perm = rng.permutation(n)
        acc, strides = int(rng.choice([1, 2])), [0] * n
        for ax in reversed(perm):
            strides[ax] = acc
            acc *= dims[ax]
        for ax in range(n):
            r = rng.random()
            if r < 0.15:
                strides[ax] = 0
            elif r < 0.3:
                strides[ax] = -strides[ax]
        sets.append(tuple(strides))
    return dims, tuple(sets)


@pytest.mark.parametrize("seed", range(16))
def test_planner_matches_jax(seed):
    dims, sets = _stride_sets(seed)
    for s in sets:
        assert tpl.index_order(s) == jpl.index_order(s)
    assert tpl.fuse_dims(dims, sets) == jpl.fuse_dims(dims, sets)
    assert tpl.order_dims(dims, sets) == jpl.order_dims(dims, sets)
    fused = jpl.fuse_dims(dims, sets)
    assert tpl.order_dims(*fused) == jpl.order_dims(*fused)


def test_transpose_copy_plan_puts_output_minor_innermost():
    """The plan the tile executor relies on: for out (row-major) = in.T the
    output's unit-stride dim is the innermost loop dim."""
    dims = (64, 32)
    sets = ((32, 1), (1, 64))
    perm, dims_o, strides_o, _ = tpl.order_dims(dims, sets)
    assert strides_o[0][-1] == 1 and (perm, dims_o) == jpl.order_dims(dims, sets)[:2]
