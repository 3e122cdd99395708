"""The streaming axis-0 sum on the card: the port of ``benchmarks/exp_reduce.py``.

``out[c] = sum_r A[r, c]`` over an ``n x n`` f32 matrix, the reduction
whose minor-dim output the TPU round found hardest. Variants:

- ``plain``: ``a.sum(0)``;
- ``k3``: the port's production kernel this probe prototyped
  (``core/stream_reduce.py``, K3);
- ``stream_RxC``: :func:`stream_sum_slabs` over (R, C) slabs, in the TPU
  probe's six shapes (``SLABS``): each slab folded into a C-vector partial,
  the partials folded in slab order by a second pass;
- ``nocompute_RxC``: the same reads with the add removed; the output is
  ``A[0]``: the schedule's speed of light.

The TPU probe timed a broadcast-back chain and a row-broadcast
``write_floor`` to work around its dispatch overhead; both are dropped,
since CUDA events time the kernel itself.

    python -m strided_tpu_torch.benchmarks.exp_reduce [variant,names] [n]

prints one JSON line per variant: ``v``, ``n``, ``gbs`` (``n * n * 4`` bytes
read over the time), ``ok`` and ``ms`` (CUDA events after a warm-up). ``ok``
holds a sum within K3's tolerance, ``1e-6 * n * max|a|``, of both the plain
sum and the f64 sum, and ``nocompute`` equal to ``A[0]``. ``n`` (default
8192) must be a multiple of every slab's R and C.

The kernel is ``csrc/exp_reduce.cu``; ``LAUNCHES["stream_sum_slabs"]``
counts its launches; a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cli

__all__ = ["stream_sum_slabs", "stream_sum_reference", "variants", "run", "main", "LAUNCHES",
           "SLABS", "ROWS", "SEG"]

LAUNCHES = {"stream_sum_slabs": 0}
SLABS = ((256, 2048), (512, 2048), (256, 4096), (512, 4096), (1024, 2048), (256, 8192))
ROWS = (128, 256, 512, 1024)  # csrc/exp_reduce.cu: R
SEG = 128  # csrc/exp_reduce.cu: columns a block covers; C must be a multiple


def stream_sum_reference(a: torch.Tensor, compute: bool = True) -> torch.Tensor:
    return a.sum(0) if compute else a[0].clone()


@functools.cache
def _kernel_fn():
    from .._build import load_library

    fn = load_library().strided_stream_sum_slabs
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stream_sum_slabs(a: torch.Tensor, R: int = 256, C: int = 2048,
                     compute: bool = True) -> torch.Tensor:
    """``a.sum(0)`` of an (n, m) f32 matrix through (R, C) slabs; with
    ``compute`` off, every slab is read and ``a[0]`` returned."""
    if a.dtype != torch.float32:
        raise TypeError(f"stream_sum_slabs: takes float32, got {a.dtype}")
    if a.ndim != 2 or not a.is_contiguous() or a.numel() == 0:
        raise ValueError(f"stream_sum_slabs: takes a contiguous matrix, got {tuple(a.shape)}")
    n, m = a.shape
    if R not in ROWS or C < SEG or C % SEG:
        raise ValueError(f"stream_sum_slabs: no kernel for the slab ({R}, {C})")
    if n % R or m % C:
        raise ValueError(f"stream_sum_slabs: ({n}, {m}) is not a multiple of the slab ({R}, {C})")
    if a.device.type == "cpu":
        return stream_sum_reference(a, compute)
    if a.device.type != "cuda":
        raise ValueError(f"stream_sum_slabs: tensor on {a.device}")
    out = torch.empty(m, dtype=torch.float32, device=a.device)
    partial = torch.empty(n // R, m, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _kernel_fn()(a.data_ptr(), out.data_ptr(), partial.data_ptr(), n, m, R, C,
                           int(compute), torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream_sum_slabs: kernel launch failed, cudaError_t {err}")
    LAUNCHES["stream_sum_slabs"] += 1
    return out


def _k3(a: torch.Tensor) -> torch.Tensor:
    from ..core import ewise
    from ..core.stream_reduce import RED_SUM, stream_reduce

    return stream_reduce(a, ewise.trace(lambda t: t, [a.dtype], out_dtype=a.dtype), RED_SUM)


def variants():
    """``{name: (fn, plain)}``: each variant and the plain result it is
    held to (a ``nocompute`` variant must equal it, the others within K3's
    tolerance)."""
    V = {"plain": (stream_sum_reference, stream_sum_reference),
         "k3": (_k3, stream_sum_reference)}
    for R, C in SLABS:
        V[f"stream_{R}x{C}"] = (functools.partial(stream_sum_slabs, R=R, C=C),
                                stream_sum_reference)
    for R, C in SLABS:
        V[f"nocompute_{R}x{C}"] = (functools.partial(stream_sum_slabs, R=R, C=C, compute=False),
                                   functools.partial(stream_sum_reference, compute=False))
    return V


def sum_error(got: torch.Tensor, a: torch.Tensor) -> tuple[float, float, float]:
    """``(|got - a.sum(0)|, |got - f64 sum|, tolerance)``, the tolerance
    ``1e-6 * rows * max|a|`` (K3's: the summation order differs)."""
    want = a.sum(0)
    e_plain = (got - want).abs().max().item()
    e64 = (got.double() - a.double().sum(0)).abs().max().item()
    return e_plain, e64, 1e-6 * a.shape[0] * a.abs().max().item()


def run(names=None, n: int = 8192, reps: int = 20, seed: int = 0):
    """Check and time ``names`` (default: all) on a seeded ``n x n`` f32
    matrix on the card; returns one dict per variant."""
    from ..bench import cuda_ms

    if not torch.cuda.is_available():
        raise RuntimeError("exp_reduce measures the card; no CUDA device found")
    V = variants()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(n, n, device="cuda", generator=gen)
    rows = []
    for name in names or list(V):
        fn, want = V[name]
        got = fn(a)
        if name.startswith("nocompute"):
            ok = torch.equal(got, want(a))
        else:
            e_plain, e64, tol = sum_error(got, a)
            ok = e_plain <= tol and e64 <= tol
        ms = cuda_ms(lambda: fn(a), reps=reps)
        rows.append({"v": name, "n": n, "gbs": a.numel() * 4 / ms / 1e6, "ok": bool(ok), "ms": ms})
    return rows


def main(argv=None) -> int:
    return cli(run, 8192, argv)


if __name__ == "__main__":
    raise SystemExit(main())
