"""Rectangular supertile pairs on the card: the port of
``benchmarks/exp_pair_rect.py``.

Does the pair schedule gain from tiles with twice-longer rows? A supertile
``(i, k)`` with ``2k > i`` handles the column pair ``{2k, 2k+1}`` of tile
row ``i`` with one ``T x 2T`` rectangle and its ``2T x T`` mirror instead of
four square tiles. It covers the strictly upper band of tile pairs (and
their mirrors) only: the rest of the output is never written, as in the TPU
probe, so :func:`rect_pairs` writes into an output the caller gives
(NaN-filled once) and its plain version does the same.

    python -m strided_tpu_torch.benchmarks.exp_pair_rect [variant,names] [n]

prints one JSON line per variant (``v``, ``n``, ``gbs``, ``ok``, ``ms``) at
``n`` = 8064 by default, the TPU probe's size, a multiple of ``2T`` for both
of the card's supertile sizes T = 32 and 64. Traffic as in the TPU probe:
``nwork * 4 * T * 2T * 4`` bytes for the rectangles, and for the square
pair schedules (K2, ``exp_sym.pair_tiles``) reads of two tiles a pair and
writes of two tiles a pair, one on the diagonal.

The kernel is ``csrc/exp_pair_rect.cu``; ``LAUNCHES["rect_pairs"]`` counts
its launches; a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cli, same
from .exp_sym import pair_tiles, sym_reference

__all__ = ["rect_pairs", "rect_pairs_reference", "rect_worklist", "variants", "run", "main",
           "LAUNCHES"]

LAUNCHES = {"rect_pairs": 0}
TILES = (32, 64)  # csrc/exp_pair_rect.cu: T (the rectangles are T x 2T)
N = 8064


def rect_worklist(n: int, T: int):
    """The supertiles ``(i, k)``, ``2k > i``, in the TPU probe's order."""
    nb, nk = n // T, n // (2 * T)
    return [(i, k) for i in range(nb) for k in range(nk) if 2 * k > i]


@functools.lru_cache(maxsize=None)
def _device_worklist(n: int, T: int, device: torch.device):
    w = torch.tensor(rect_worklist(n, T), dtype=torch.int32).reshape(-1, 2)
    return w[:, 0].contiguous().to(device), w[:, 1].contiguous().to(device)


@functools.lru_cache(maxsize=None)
def band_mask(n: int, T: int, device: torch.device) -> torch.Tensor:
    """The ``n x n`` elements the supertiles write."""
    nb = n // T
    i = torch.arange(nb).reshape(-1, 1)
    j = torch.arange(nb).reshape(1, -1)
    direct = (j < 2 * (n // (2 * T))) & (2 * (j // 2) > i)  # tile (i, j) of supertile (i, j//2)
    tiles = direct | direct.T
    return tiles.repeat_interleave(T, 0).repeat_interleave(T, 1).to(device)


def _check(a: torch.Tensor, out: torch.Tensor, T: int) -> int:
    if T not in TILES:
        raise ValueError(f"rect_pairs: no kernel for T={T}")
    if a.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"rect_pairs: takes float32, got {a.dtype}, {out.dtype}")
    if (a.ndim != 2 or a.shape[0] != a.shape[1] or out.shape != a.shape
            or not (a.is_contiguous() and out.is_contiguous())):
        raise ValueError(f"rect_pairs: takes square contiguous matrices of one shape, got "
                         f"{tuple(a.shape)}, {tuple(out.shape)}")
    n = a.shape[0]
    if n == 0 or n % (2 * T):
        raise ValueError(f"rect_pairs: n={n} is not a multiple of 2T={2 * T}")
    if out.device != a.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rect_pairs: tensors on {a.device} and {out.device}")
    return n


def rect_pairs_reference(a: torch.Tensor, out: torch.Tensor, T: int = 32):
    """Plain version: ``(a + a.T) * 0.5`` written into ``out`` on the band
    the supertiles cover; returns ``(out, number of supertiles)``."""
    n = _check(a, out, T)
    torch.where(band_mask(n, T, a.device), sym_reference(a), out, out=out)
    return out, len(rect_worklist(n, T))


@functools.cache
def _kernel_fn():
    from .._build import load_library

    fn = load_library().strided_rect_pairs
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rect_pairs(a: torch.Tensor, out: torch.Tensor | None = None, T: int = 32):
    """``(a + a.T) * 0.5`` on the supertile band, written into ``out``
    (default: a NaN-filled new matrix); returns ``(out, number of
    supertiles)``, as the TPU probe's ``rect_pairs``."""
    out = torch.full_like(a, float("nan")) if out is None else out
    n = _check(a, out, T)
    if a.device.type == "cpu":
        return rect_pairs_reference(a, out, T)
    ii, kk = _device_worklist(n, T, a.device)
    with torch.cuda.device(a.device):
        err = _kernel_fn()(a.data_ptr(), out.data_ptr(), ii.data_ptr(), kk.data_ptr(),
                           ii.numel(), n, T, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rect_pairs: kernel launch failed, cudaError_t {err}")
    LAUNCHES["rect_pairs"] += 1
    return out, ii.numel()


def _square_bytes(n: int, T: int) -> int:
    """The square pair schedule's traffic: reads of 2 tiles a pair, writes
    of 2 tiles a pair, one on the diagonal."""
    nb = n // T
    pairs = nb * (nb + 1) // 2
    return (pairs * 2 + pairs * 2 - nb) * T * T * 4


def variants(n: int):
    """``{name: (fn(x, out), want(x, out), bytes)}``."""
    from ..core.kernels_special import TILE, symmetrize

    V = {"square_k2": (lambda x, o: symmetrize(x, alpha=0.5), lambda x, o: sym_reference(x),
                       _square_bytes(n, TILE))}
    for T in TILES:
        V[f"square_pair_{T}"] = (lambda x, o, T=T: pair_tiles(x, T), lambda x, o: sym_reference(x),
                                 _square_bytes(n, T))
    for T in TILES:
        V[f"rect_{T}x{2 * T}"] = (lambda x, o, T=T: rect_pairs(x, o, T)[0],
                                  lambda x, o, T=T: rect_pairs_reference(x, o.clone(), T)[0],
                                  len(rect_worklist(n, T)) * 4 * T * 2 * T * 4)
    return V


def run(names=None, n: int = N, reps: int = 20, seed: int = 0):
    """Check and time ``names`` (default: all) on a seeded ``n x n`` f32
    matrix on the card; returns one dict per variant."""
    from ..bench import cuda_ms

    if not torch.cuda.is_available():
        raise RuntimeError("exp_pair_rect measures the card; no CUDA device found")
    V = variants(n)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, n, device="cuda", generator=gen)
    nans = torch.full_like(x, float("nan"))
    rows = []
    for name in names or list(V):
        fn, want, nbytes = V[name]
        ok = same(fn(x, nans.clone()), want(x, nans))
        out = nans.clone()  # NaN-filled once, outside the timed loop
        ms = cuda_ms(lambda: fn(x, out), reps=reps)
        rows.append({"v": name, "n": n, "gbs": nbytes / ms / 1e6, "ok": ok, "ms": ms})
    return rows


def main(argv=None) -> int:
    return cli(run, N, argv)


if __name__ == "__main__":
    raise SystemExit(main())
