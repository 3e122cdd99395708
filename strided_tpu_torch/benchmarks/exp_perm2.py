"""The rank-4 reversal over J2J1 blocks on the card: the port of
``benchmarks/exp_perm2.py``.

``y[d, c, b, a] = x[a, b, c, d]`` at ``D^4`` f32, with the TPU probe's
middle-dims block geometry: a block is a ``bb``-run of b (j2) times a
``cc``-run of c (j1), a and d whole (``perm_kernels.J2J1``). Variants keep
the TPU names:

- ``loop2d_BB_CC``: one (j3, j0) plane a stage of the shared-memory ring
  (``rev4_tiles``, PLANE), as the TPU's unrolled 2-D transposes;
- ``chain_8_8``, ``chain3_BB_CC``: the TPU's reshape/transpose chains, here
  stages of 128 rows of the block, transposed and written through the reversed
  index (``rev4_tiles``, BLOCK): the chain has no GPU meaning of its own;
- ``nocompute_8_8``: the same traffic with the planes copied untransposed,
  ``x.permute(0, 2, 1, 3)`` (``rev4_tiles``, PLANE copy);
- ``mxu_BB_CC``, ``mxu_default_8_8``: the identity product on the tensor
  cores (``rev4_mma``), exact at "highest", ``bf16(x)`` reversed at
  "default";
- ``plain`` (the TPU's ``xla``): ``x.permute(3, 2, 1, 0).contiguous()``;
- ``engine``: the port's ``permutedims_into``; at 64^4 = 2^24 elements it is
  below ``map_min_elements`` (2^26, where K4's maps stop losing to the
  plain path in eager time on the card: ``exp_mapgate``) and takes the
  plain path, as the JAX package's does below its 2^25; the row records the
  route.

    python -m strided_tpu_torch.benchmarks.exp_perm2 [variant,names] [D]

prints one JSON line per variant: ``v``, ``D``, ``gbs`` (``2 * D^4 * 4``
bytes over the time), ``ok`` (exact comparison with the plain result on the
card), ``ms`` (CUDA events after a warm-up). The kernels need ``D = 64``.
The TPU's slope timing is not carried over: CUDA events time the kernel
itself.
"""

from __future__ import annotations

import functools

from . import cli
from .perm_kernels import (J2J1, LAUNCHES, PLANE, BLOCK, mma_reference, plane_copy_reference,
                           rev4_mma, rev4_tiles, reversal_reference, run_reversal)

__all__ = ["variants", "run", "main", "LAUNCHES", "D"]

D = 64


def variants():
    """``{name: (fn, plain)}``: each variant and the plain result it must equal."""
    tiles = functools.partial(rev4_tiles, geometry=J2J1)
    mma = functools.partial(rev4_mma, geometry=J2J1)
    V = {"plain": (reversal_reference, reversal_reference)}
    for bb, cc in ((8, 8), (16, 8), (8, 16), (16, 16)):
        V[f"loop2d_{bb}_{cc}"] = (functools.partial(tiles, ra=bb, rb=cc, staging=PLANE),
                                  reversal_reference)
    for name, bb, cc in (("chain", 8, 8), ("chain3", 8, 8), ("chain3", 16, 16)):
        V[f"{name}_{bb}_{cc}"] = (functools.partial(tiles, ra=bb, rb=cc, staging=BLOCK),
                                  reversal_reference)
    V["nocompute_8_8"] = (functools.partial(tiles, ra=8, rb=8, staging=PLANE, copy=True),
                          plane_copy_reference)
    for bb, cc in ((8, 8), (16, 8), (8, 16)):
        V[f"mxu_{bb}_{cc}"] = (functools.partial(mma, ra=bb, rb=cc), reversal_reference)
    V["mxu_default_8_8"] = (functools.partial(mma, ra=8, rb=8, precision="default"),
                            functools.partial(mma_reference, precision="default"))
    return V


def run(names=None, d: int = D, reps: int = 20, seed: int = 0):
    """Check and time ``names`` (default: all, and ``engine``) on a seeded
    ``d^4`` f32 tensor on the card; returns one dict per variant."""
    return run_reversal("exp_perm2", variants(), names, d, reps, seed, engine=True)


def main(argv=None) -> int:
    return cli(run, D, argv)


if __name__ == "__main__":
    raise SystemExit(main())
