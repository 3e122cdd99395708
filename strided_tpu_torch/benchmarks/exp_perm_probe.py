"""Rank-4 reversal formulations on the card: the port of
``benchmarks/exp_perm_probe.py``.

``y[j0, j1, j2, j3] = x[j3, j2, j1, j0]`` at ``D^4`` f32. The TPU probe
asked which in-kernel formulations its compiler accepts; every one is the
same data movement, so on the card each becomes ``rev4_tiles`` over its
block geometry. The variants keep the TPU names:

- ``_call3`` (J3J2 blocks, a ``B3``-run of j3 times a ``B2``-run of j2):
  ``direct_B3_B2``, ``3stage_B3_B2``, ``2stage_B3_B2`` (BLOCK staging:
  stages of 128 rows of the block) and
  ``loop_rank3_8_8`` (PLANE staging: one ``B3 x D`` (j3, j0) plane a stage,
  as the TPU's loop over j3);
- ``_call_m`` (the merged-out geometry, J2J1 blocks of a ``K2``-run of j2
  times a ``B1``-run of j1): ``direct_m_K2_B1``, ``2stage_m_K2_B1``,
  ``3stage_m_K2_B1`` (BLOCK). The TPU wrote a ``(D, D, D^2)`` view of the
  output; the result is the same reversal;
- ``engine`` (the TPU's ``engine_div2``: ``pallas_budget_divisor`` is a TPU
  field the port does not have): the port's ``permutedims_into``, whose
  route at 64^4 is the plain path (below ``map_min_elements``), recorded.

    python -m strided_tpu_torch.benchmarks.exp_perm_probe [variant,names] [D]

prints one JSON line per variant (``v``, ``D``, ``gbs`` over ``2 * D^4 * 4``
bytes, ``ok``, ``ms``), as ``exp_perm2``. The kernels need ``D = 64``.
"""

from __future__ import annotations

import functools

from . import cli
from .perm_kernels import (BLOCK, J2J1, J3J2, LAUNCHES, PLANE, rev4_tiles, reversal_reference,
                           run_reversal)

__all__ = ["variants", "run", "main", "LAUNCHES", "D"]

D = 64


def variants():
    """``{name: (fn, plain)}``: each variant and the plain result it must equal."""
    rev = reversal_reference
    call3 = functools.partial(rev4_tiles, geometry=J3J2)
    call_m = functools.partial(rev4_tiles, geometry=J2J1, staging=BLOCK)
    V = {"plain": (rev, rev)}
    for name, b3, b2 in (("direct", 8, 8), ("3stage", 8, 8), ("3stage", 16, 16),
                         ("3stage", 8, 64), ("3stage", 64, 8), ("2stage", 8, 8),
                         ("2stage", 16, 16)):
        V[f"{name}_{b3}_{b2}"] = (functools.partial(call3, ra=b3, rb=b2, staging=BLOCK), rev)
    V["loop_rank3_8_8"] = (functools.partial(call3, ra=8, rb=8, staging=PLANE), rev)
    for name, k2, b1 in (("direct_m", 4, 8), ("direct_m", 8, 16), ("2stage_m", 4, 8),
                         ("2stage_m", 8, 16), ("2stage_m", 16, 32), ("3stage_m", 4, 8),
                         ("3stage_m", 8, 16), ("3stage_m", 16, 32)):
        V[f"{name}_{k2}_{b1}"] = (functools.partial(call_m, ra=k2, rb=b1), rev)
    return V


def run(names=None, d: int = D, reps: int = 20, seed: int = 0):
    """Check and time ``names`` (default: all, and ``engine``) on a seeded
    ``d^4`` f32 tensor on the card; returns one dict per variant."""
    return run_reversal("exp_perm_probe", variants(), names, d, reps, seed, engine=True)


def main(argv=None) -> int:
    return cli(run, D, argv)


if __name__ == "__main__":
    raise SystemExit(main())
