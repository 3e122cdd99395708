"""Rank-4 reversal kernels on the card: the port of ``benchmarks/exp_perm4.py``.

``y[j0, j1, j2, j3] = x[j3, j2, j1, j0]`` at ``D^4`` f32. The TPU question
was whether grouping a partial axis with whole trailing axes makes every
copy full-width; the variants keep the TPU names:

- ``grouped_j2_bB``: a block is a ``B``-run of j2 with j1 whole (J2J1 with
  runs (B, D)); ``grouped_j1j2_B1_B2``: a ``B2``-run of j2 times a ``B1``-run
  of j1 (J2J1 with runs (B2, B1)). ``rev4_tiles``, BLOCK staging. The TPU
  grid has 8-64 blocks; the kernel splits each over several CTAs;
- ``plain4d_B3_B2``: J3J2 blocks, a ``B3``-run of j3 times a ``B2``-run of
  j2: an output row holds only ``B3`` contiguous floats, kept on purpose
  (``rev4_tiles``, BLOCK);
- ``mxu_64_8``: the identity product on the tensor cores over J3J2 blocks
  (``rev4_mma``, exact);
- ``t2d_32x64``, ``t2d_64x32``: the 2-D transpose ceiling, the ``D^2 x D^2``
  matrix transposed by ``exp_sym.transpose_tiles``. The TPU's 256 and 512
  VMEM tiles have no meaning on the card, so the rows name the tile used
  (the two best at 8192^2 on the card, PERF.md);
- ``dma4d_cC``: the manual double-buffered DMA over ``C``-runs of j2, a
  ``cp.async`` ring of planes (``rev4_async``);
- ``plain``: ``x.permute(3, 2, 1, 0).contiguous()``.

    python -m strided_tpu_torch.benchmarks.exp_perm4 [variant,names] [D]

prints one JSON line per variant (``v``, ``D``, ``gbs`` over ``2 * D^4 * 4``
bytes, ``ok``, ``ms``), as ``exp_perm2``. The kernels need ``D = 64``.
"""

from __future__ import annotations

import functools

import torch

from . import cli, into
from .exp_sym import transpose_tiles
from .perm_kernels import (BLOCK, J2J1, J3J2, LAUNCHES, rev4_async, rev4_mma, rev4_tiles,
                           reversal_reference, run_reversal)

__all__ = ["variants", "run", "main", "LAUNCHES", "D", "T2D_TILES", "t2d", "t2d_reference"]

D = 64
T2D_TILES = ((32, 64), (64, 32))


def t2d(x: torch.Tensor, th: int = 64, tw: int = 32, out: torch.Tensor | None = None):
    """``v_2d_transpose_ref``: the ``(D^2, D^2)`` matrix of ``x`` transposed
    through ``th x tw`` tiles, returned in ``x``'s shape (written into
    ``out`` when given)."""
    m = x.shape[0] * x.shape[1]
    o = None if out is None else out.view(m, m)
    return transpose_tiles(x.reshape(m, m), th, tw, out=o).reshape(x.shape)


def t2d_reference(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    m = x.shape[0] * x.shape[1]
    return into(out, x.reshape(m, m).T.contiguous().reshape(x.shape))


def variants():
    """``{name: (fn, plain)}``: each variant and the plain result it must equal."""
    tiles = functools.partial(rev4_tiles, staging=BLOCK)
    rev = reversal_reference
    V = {"plain": (rev, rev)}
    for b2 in (4, 8):  # j1 whole
        V[f"grouped_j2_b{b2}"] = (lambda x, b2=b2, **kw: tiles(x, geometry=J2J1, ra=b2,
                                                               rb=x.shape[0], **kw), rev)
    for b1, b2 in ((8, 8), (16, 16)):
        V[f"grouped_j1j2_{b1}_{b2}"] = (functools.partial(tiles, geometry=J2J1, ra=b2, rb=b1),
                                        rev)
    for b3, b2 in ((8, 8), (16, 16), (8, 64), (64, 8)):
        V[f"plain4d_{b3}_{b2}"] = (functools.partial(tiles, geometry=J3J2, ra=b3, rb=b2), rev)
    V["mxu_64_8"] = (functools.partial(rev4_mma, geometry=J3J2, ra=64, rb=8), rev)
    for th, tw in T2D_TILES:
        V[f"t2d_{th}x{tw}"] = (functools.partial(t2d, th=th, tw=tw), t2d_reference)
    for c2 in (4, 8, 16):
        V[f"dma4d_c{c2}"] = (functools.partial(rev4_async, c2=c2), rev)
    return V


def run(names=None, d: int = D, reps: int = 20, seed: int = 0):
    """Check and time ``names`` (default: all) on a seeded ``d^4`` f32
    tensor on the card; returns one dict per variant."""
    return run_reversal("exp_perm4", variants(), names, d, reps, seed, engine=False)


def main(argv=None) -> int:
    return cli(run, D, argv)


if __name__ == "__main__":
    raise SystemExit(main())
