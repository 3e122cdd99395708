"""The fused-ADMM kernel K1's tile designs, checked and timed on the card.

K1 (``csrc/fused_admm.cu``, ``mpc/fused_admm.py``) was redesigned for the
H100's FP32 pipes. This probe keeps the designs it was chosen over, built
from the same kernel template, so that each can be held against the plain
version and timed beside the kernel in one run:

- ``k1``: the kernel as the main path launches it: 8 x 8 thread tiles,
  64-row batch tiles, 7 warps at D = 200, g in registers;
- ``t8x4``: 8 x 4 thread tiles, 13 warps at D = 200, g re-read each
  iteration (the warp count leaves 128 registers a thread);
- ``t8x4_greg``: the same with g in registers (it spills);
- ``t8x8_gload``: 8 x 8 thread tiles with g re-read;
- ``t4x4``: the wide instance's 16-row tiles of 4 x 4 (D > 208 takes it);
- ``ring32``, ``ring64``: ``k1`` with S streamed through the ``cp.async``
  ring in panels of 32 or 64 rows instead of resident.

    python -m strided_tpu_torch.benchmarks.exp_admm [variant,names] [batch]

At the main path's QP (the quadrotor at horizon 50: D = 200; rho 8, alpha
1.6; batch 16384 unless given) each variant prints one JSON line: ``v``,
``B``, ``D``, ``ok`` (within 2e-4 of the plain version and no further from
the same iterations in f64 than twice the plain version plus 1e-6, as
``chip_smoke.py`` holds K1), ``ms`` (6 iterations, CUDA events after a
warm-up), ``ms12`` (12 iterations), ``iter_ms`` (``(ms12 - ms) / 6``: one
iteration), ``fixed_ms`` (``ms - 6 * iter_ms``: S copied in, the tiles
loaded and stored, the launch) and ``gflops`` (``2 * B * D^2 * 6 / ms``).
``LAUNCHES`` counts the launches through the design entry point by design
(the ring variants count as ``k1``; ``k1`` itself goes through the main
path's wrapper and counts in ``mpc.fused_admm.LAUNCHES``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cli

__all__ = ["DESIGNS", "LAUNCHES", "admm_design", "main_path_inputs", "variants", "run", "main"]

RHO, ALPHA, ITERS = 8.0, 1.6, 6
# csrc/fused_admm.cu::strided_fused_admm_design_f32
DESIGNS = {"k1": 0, "t8x4": 1, "t8x4_greg": 2, "t8x8_gload": 3, "t4x4": 4}
LAUNCHES = {name: 0 for name in DESIGNS}


@functools.cache
def _design_fn():
    from .._build import load_library

    fn = load_library().strided_fused_admm_design_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def admm_design(name: str, g, z0, S, lo, hi, *, iters: int = ITERS,
                panel_rows: int = 0) -> torch.Tensor:
    """K1's iterations through the design ``name`` of ``DESIGNS``: contiguous
    f32 CUDA tensors as :func:`~strided_tpu_torch.mpc.fused_admm.fused_admm`
    takes them. ``panel_rows`` > 0 streams S through the kernel's ring in
    panels of at most that many rows even where it would stay resident."""
    tensors = (g, z0, S, lo, hi)
    if any(t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError("admm_design: takes contiguous float32 CUDA tensors")
    B, D = g.shape
    out = torch.empty_like(g)
    with torch.cuda.device(g.device):
        err = _design_fn()(*(t.data_ptr() for t in tensors), out.data_ptr(), B, D, int(iters),
                           RHO, ALPHA, int(panel_rows), DESIGNS[name],
                           torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"admm_design {name}: kernel launch failed, cudaError_t {err}")
    LAUNCHES[name] += 1
    return out


def main_path_inputs(batch: int, seed: int = 0):
    """``(g, z0, S, lo, hi)`` of the main path's QP for ``batch`` random
    hover deviations, as ``qp_solve`` hands them to the kernel."""
    from ..entry import make_controller

    _model, ctrl = make_controller(horizon=50, dt=0.02, device="cuda")
    qp = ctrl.qp
    x = torch.as_tensor(np.random.default_rng(seed).uniform(-0.3, 0.3, (batch, 12)),
                        dtype=torch.float32, device="cuda")
    lo, hi = ctrl.u_min.repeat(qp.N), ctrl.u_max.repeat(qp.N)
    z0 = torch.minimum(torch.maximum(-x @ qp.K_lqr.T, lo), hi)
    return (x @ qp.M.T).contiguous(), z0.contiguous(), qp.solver, lo, hi


def variants():
    """``{name: fn(g, z0, S, lo, hi, iters)}``."""
    from ..mpc import fused_admm as fa

    def k1(*args, iters):
        return fa.fused_admm(*args, rho=RHO, alpha=ALPHA, iters=iters)

    V = {"k1": k1}
    V.update({name: functools.partial(admm_design, name) for name in DESIGNS if name != "k1"})
    V.update({f"ring{n}": functools.partial(admm_design, "k1", panel_rows=n) for n in (32, 64)})
    return V


def run(names=None, batch: int = 16384, reps: int = 50):
    """Check and time ``names`` (default: all) at the main path's QP on the
    card; returns one dict per variant."""
    from ..bench import cuda_ms
    from ..config import matmul_precision_scope
    from ..mpc.fused_admm import fused_admm_reference

    if not torch.cuda.is_available():
        raise RuntimeError("exp_admm measures the card; no CUDA device found")
    args = main_path_inputs(batch)
    B, D = args[0].shape
    kw = dict(rho=RHO, alpha=ALPHA, iters=ITERS)
    plain = matmul_precision_scope(fused_admm_reference)(*args, **kw)
    f64 = fused_admm_reference(*(a.double() for a in args), **kw)
    e_plain = (plain.double() - f64).abs().max().item()
    V = variants()
    rows = []
    for name in names or list(V):
        fn = V[name]
        got = fn(*args, iters=ITERS)
        ok = ((got - plain).abs().max().item() <= 2e-4
              and (got.double() - f64).abs().max().item() <= 2 * e_plain + 1e-6
              and bool(torch.isfinite(got).all()))
        ms = cuda_ms(lambda: fn(*args, iters=ITERS), reps=reps)
        ms12 = cuda_ms(lambda: fn(*args, iters=2 * ITERS), reps=reps)
        iter_ms = (ms12 - ms) / ITERS
        rows.append({"v": name, "B": B, "D": D, "ok": bool(ok), "ms": ms, "ms12": ms12,
                     "iter_ms": iter_ms, "fixed_ms": ms - ITERS * iter_ms,
                     "gflops": 2 * B * D * D * ITERS / ms / 1e6})
    return rows


def main(argv=None) -> int:
    return cli(run, 16384, argv)


if __name__ == "__main__":
    raise SystemExit(main())
