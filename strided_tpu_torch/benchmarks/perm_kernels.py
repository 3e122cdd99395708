"""The rank-4 reversal kernels shared by the permute probes
(``exp_perm2``, ``exp_perm4``, ``exp_perm_probe``), with their plain
versions.

The reversal is ``y[j0, j1, j2, j3] = x[j3, j2, j1, j0]`` of a ``D^4`` f32
tensor, ``x.permute(3, 2, 1, 0)``. The TPU probes blocked it in one of two
geometries:

- ``J2J1``: a block is a run ``ra`` of j2 times a run ``rb`` of j1, with j3
  and j0 whole (``exp_perm2._call_mid``, ``exp_perm4``'s grouped forms,
  ``exp_perm_probe._call_m``);
- ``J3J2``: a block is a run ``ra`` of j3 times a run ``rb`` of j2, with j1
  and j0 whole (``exp_perm_probe._call3``, ``exp_perm4.v_plain4d``).

Two kernels, in ``csrc/exp_perm.cu``: ``rev4_tiles`` (16-byte ``cp.async``
copies through a three-stage ring in shared memory, a stage of one plane or
of 128 rows of the block, transposed in 4 x 4 sub-blocks and stored 16
bytes a thread; or the untransposed plane copy of ``v_loop2d_nocompute``,
float4 loads straight to float4 stores), behind :func:`rev4_tiles` and
:func:`rev4_async` (its J2J1 PLANE instance, one CTA a TPU block), and
``rev4_mma`` (an identity product on the tensor cores in bf16 parts),
behind :func:`rev4_mma`. The CUDA source alone decides each launch's
stages, threads, shared memory and grid. Each wrapper checks its input and
launches on the current stream for a CUDA tensor, raising on a non-zero
``cudaError_t``, and counts ``LAUNCHES[name]``; a CPU tensor takes the
plain version beside it. Each takes an optional ``out=``, a contiguous
tensor of the result's shape, dtype and device that does not overlap
``x``, writes the result there (on either path) and returns it. The kernels are built for ``D = 64``, the probes'
size; the plain versions take any ``D`` that the runs divide.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import check_out, into

__all__ = ["J2J1", "J3J2", "PLANE", "BLOCK", "KERNEL_D", "J3J2_HEIGHTS", "LAUNCHES",
           "TILES_INSTANCES", "tiles_instance", "reversal_reference",
           "plane_copy_reference", "mma_reference", "rev4_tiles", "rev4_mma", "rev4_async",
           "engine_reversal", "run_reversal"]

J2J1, J3J2 = 0, 1
PLANE, BLOCK = 0, 1
KERNEL_D = 64  # csrc/exp_perm.cu: D
J3J2_HEIGHTS = (8, 16, 64)  # csrc/exp_perm.cu: rev4_tiles' E3 for J3J2
LAUNCHES = {"rev4_tiles": 0, "rev4_mma": 0, "rev4_async": 0}


def tiles_instance(geometry: int, ra: int, staging: int = PLANE, copy: bool = False) -> tuple:
    """The ``rev4_tiles`` kernel instance ``(geometry, E3, staging, copy)``
    a call runs (``csrc/exp_perm.cu::rev4_tiles_kernel``'s template
    arguments): E3, the j3 rows of a plane, is D for J2J1 and the run
    ``ra`` for J3J2. ``rev4_async`` runs the J2J1 PLANE instance."""
    return geometry, KERNEL_D if geometry == J2J1 else ra, staging, bool(copy)


# every instance the wrapper dispatches to: both stagings of each
# geometry and height, and the plane copy
TILES_INSTANCES = (*(tiles_instance(J2J1, KERNEL_D, s) for s in (PLANE, BLOCK)),
                   tiles_instance(J2J1, KERNEL_D, PLANE, True),
                   *(tiles_instance(J3J2, e, s) for e in J3J2_HEIGHTS for s in (PLANE, BLOCK)))


def _check(x: torch.Tensor, what: str, *runs: int) -> int:
    """D of a contiguous ``D^4`` f32 tensor that every run divides."""
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: takes float32, got {x.dtype}")
    if x.ndim != 4 or len(set(x.shape)) != 1 or not x.is_contiguous():
        raise ValueError(f"{what}: takes a contiguous D^4 tensor, got {tuple(x.shape)}")
    d = x.shape[0]
    if d == 0 or any(r < 1 or d % r for r in runs):
        raise ValueError(f"{what}: D={d} is not a multiple of the runs {runs}")
    if x.device.type == "cuda" and d != KERNEL_D:
        raise ValueError(f"{what}: the kernel is built for D={KERNEL_D}, got D={d}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensor on {x.device}")
    return d


@functools.cache
def _lib():
    from .._build import load_library

    lib = load_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn, args in ((lib.strided_rev4_tiles, [P, P] + [I] * 6 + [P]),
                     (lib.strided_rev4_mma, [P, P] + [I] * 5 + [P]),
                     (lib.strided_rev4_async, [P, P, I, I, P])):
        fn.argtypes, fn.restype = args, I
    return lib


def _launch(name: str, x: torch.Tensor, out: torch.Tensor | None, call) -> torch.Tensor:
    out = torch.empty_like(x) if out is None else out
    with torch.cuda.device(x.device):
        err = call(out, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError_t {err}")
    LAUNCHES[name] += 1
    return out


def reversal_reference(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    return into(out, x.permute(3, 2, 1, 0).contiguous())


def plane_copy_reference(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """What ``v_loop2d_nocompute`` writes: each (j3, j0) plane untransposed
    at ``y[:, j1, j2, :]``."""
    return into(out, x.permute(0, 2, 1, 3).contiguous())


def mma_reference(x: torch.Tensor, precision: str = "highest",
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """The identity product's result: ``x`` reversed exactly at "highest",
    ``bf16(x)`` reversed at "default" (one bf16 product, as the TPU's
    DEFAULT)."""
    if precision == "default":
        x = x.to(torch.bfloat16).float()
    return reversal_reference(x, out)


def rev4_tiles(x: torch.Tensor, geometry: int, ra: int, rb: int, staging: int = PLANE,
               copy: bool = False, out: torch.Tensor | None = None) -> torch.Tensor:
    """The reversal (``copy``: the plane copy) through a ``cp.async`` ring
    in shared memory, over the TPU blocks of ``geometry`` with runs
    ``(ra, rb)``, a stage of one plane (``PLANE``) or of 128 rows of the
    block (``BLOCK``)."""
    if geometry not in (J2J1, J3J2) or staging not in (PLANE, BLOCK):
        raise ValueError(f"rev4_tiles: geometry {geometry}, staging {staging}")
    if copy and (geometry, staging) != (J2J1, PLANE):
        raise ValueError("rev4_tiles: the plane copy has the J2J1 PLANE kernel only")
    if geometry == J3J2 and ra not in J3J2_HEIGHTS:
        raise ValueError(f"rev4_tiles: no J3J2 kernel for a j3 run of {ra}")
    d = _check(x, "rev4_tiles", ra, rb)
    check_out("rev4_tiles", x, out)
    if x.device.type == "cpu":
        return plane_copy_reference(x, out) if copy else reversal_reference(x, out)
    return _launch("rev4_tiles", x, out, lambda y, s: _lib().strided_rev4_tiles(
        x.data_ptr(), y.data_ptr(), d, geometry, ra, rb, staging, int(copy), s))


def rev4_mma(x: torch.Tensor, geometry: int, ra: int, rb: int, precision: str = "highest",
             out: torch.Tensor | None = None) -> torch.Tensor:
    """The reversal as an identity product on the tensor cores (``v_mxu``):
    three bf16 parts at "highest" (exact), one at "default"."""
    if precision not in ("highest", "default") or geometry not in (J2J1, J3J2):
        raise ValueError(f"rev4_mma: precision {precision!r}, geometry {geometry}")
    d = _check(x, "rev4_mma", ra, rb)
    if geometry == J3J2 and ra != d:
        raise ValueError(f"rev4_mma: J3J2 takes whole (j3, j0) planes, ra={ra} != D={d}")
    check_out("rev4_mma", x, out)
    if x.device.type == "cpu":
        return mma_reference(x, precision, out)
    return _launch("rev4_mma", x, out, lambda y, s: _lib().strided_rev4_mma(
        x.data_ptr(), y.data_ptr(), d, geometry, ra, rb, int(precision == "highest"), s))


def rev4_async(x: torch.Tensor, c2: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """The reversal through a ``cp.async`` ring of planes, a CTA owning a
    run of ``c2`` of j2 (``v_dma4d``): ``rev4_tiles``' J2J1 PLANE kernel,
    one CTA a block of runs ``(c2, 16 / c2)``."""
    d = _check(x, "rev4_async", c2)
    check_out("rev4_async", x, out)
    if x.device.type == "cpu":
        return reversal_reference(x, out)
    return _launch("rev4_async", x, out, lambda y, s: _lib().strided_rev4_async(
        x.data_ptr(), y.data_ptr(), d, c2, s))


def engine_reversal(x: torch.Tensor) -> tuple[torch.Tensor, str]:
    """The port's engine on the reversal (``permutedims_into``), and the
    route its dispatch record shows: ``"tile-executor"`` (K4) or
    ``"plain"`` (below the map gate, or declined)."""
    from ..core import executor_cuda as ec
    from ..core.mapreduce import permutedims_into
    from ..core.view import strided

    ec.LAST_PLAN.clear()
    out = permutedims_into(strided(torch.empty_like(x)), strided(x), (3, 2, 1, 0))
    return out.parent.reshape(x.shape), "tile-executor" if ec.LAST_PLAN else "plain"


def run_reversal(script: str, V: dict, names, d: int, reps: int, seed: int, engine: bool):
    """Check and time the variants ``names`` of ``V`` (default: all, and
    ``engine`` when ``engine``) on a seeded ``d^4`` f32 tensor on the card:
    one dict per variant, ``gbs`` counting ``2 * d^4 * 4`` bytes. Each
    variant is checked as written through ``out=`` into a NaN-filled tensor
    made just before the call, so that no element a kernel skips can pass
    on what a freed buffer held; the timed calls allocate as usual."""
    from ..bench import cuda_ms

    if not torch.cuda.is_available():
        raise RuntimeError(f"{script} measures the card; no CUDA device found")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((d,) * 4, device="cuda", generator=gen)
    nbytes = 2 * x.numel() * 4
    rows = []
    for name in names or [*V, *(["engine"] if engine else [])]:
        row = {"v": name, "D": d}
        if name == "engine":
            got, row["route"] = engine_reversal(x)
            ok = torch.equal(got, reversal_reference(x))
            ms = cuda_ms(lambda: engine_reversal(x), reps=reps)
        else:
            fn, want = V[name]
            ok = torch.equal(fn(x, out=torch.full_like(x, float("nan"))), want(x))
            ms = cuda_ms(lambda: fn(x), reps=reps)
        rows.append({**row, "gbs": nbytes / ms / 1e6, "ok": bool(ok), "ms": ms})
    return rows
