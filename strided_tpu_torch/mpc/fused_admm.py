"""Fused over-relaxed ADMM: the MPC solver's one kernel.

Replaces the Pallas kernel ``strided_tpu/mpc/qp.py::_fused_admm``: all
``iters`` ADMM iterations of the box-constrained condensed QP in one launch,
with the iterates kept on chip and only the final ``z`` written back. The
CUDA source is ``csrc/fused_admm.cu``.

What bounds it on an H100: at the main-path size (B=16384 scenarios,
D=N*m=200, 6 iterations) the iterations are 2*B*D^2*iters = 7.9 GFLOP of
FP32 products, which must stay IEEE FP32 (a TF32 product misses the 1e-4
accuracy gate), so the CUDA cores and not the tensor cores bound it; the
device traffic is only g + z0 + z = 39 MB. The design therefore feeds the
FMA pipe: each thread owns an 8-row x 8-column register tile, so 4 16-byte
shared-memory loads feed 64 FMAs; the operands of the next k-step are
loaded during this one's FMAs; one register an output carries both iterates
(v = u_rel + y; z = clip(v), y = v - z), and g stays in registers too; a
persistent grid, one block of 7 warps an SM at the main path's width,
copies S (160 KB at D=200) into shared memory once and keeps it for every
batch tile and iteration. Wider QPs whose S does not fit stream it from L2
through a two-panel ``cp.async`` ring. ``benchmarks/exp_admm.py`` measures
the designs this one was chosen over.

``fused_admm`` launches the kernel for CUDA tensors and raises if it cannot;
for CPU tensors it runs ``fused_admm_reference``, the same iterations in
plain PyTorch. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["fused_admm", "fused_admm_reference", "LAUNCHES", "MAX_D"]

LAUNCHES: int = 0
MAX_D = 512  # widest D the kernel is instantiated for (csrc/fused_admm.cu)


def fused_admm_reference(g, z0, S, lo, hi, *, rho: float, alpha: float,
                         iters: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``g``, ``z0`` ``(B, D)``, ``S``
    ``(D, D)``, ``lo``/``hi`` broadcastable to ``(B, D)``. Returns z."""
    z = z0
    y = torch.zeros_like(z0)
    for _ in range(iters):
        u = (rho * (z - y) - g) @ S
        u_rel = alpha * u + (1.0 - alpha) * z
        z_new = torch.minimum(torch.maximum(u_rel + y, lo), hi)
        y = y + u_rel - z_new
        z = z_new
    return z


@functools.cache
def _kernel_fn():
    from .._build import load_library

    fn = load_library().strided_fused_admm_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def fused_admm(g, z0, S, lo, hi, *, rho: float, alpha: float,
               iters: int) -> torch.Tensor:
    """All ``iters`` ADMM iterations in one kernel launch.

    ``g``, ``z0``: ``(B, D)``; ``S = (H + rho I)^-1``: ``(D, D)``; ``lo``,
    ``hi``: ``(D,)`` (or ``(1, D)``). CUDA tensors must be contiguous f32 on
    one device; CPU tensors go to :func:`fused_admm_reference`."""
    global LAUNCHES
    tensors = (g, z0, S, lo, hi)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_admm_reference(g, z0, S, lo, hi, rho=rho, alpha=alpha,
                                    iters=iters)
    dev = g.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"fused_admm: all tensors must be on one CUDA device or all on "
            f"the CPU, got {[str(t.device) for t in tensors]}"
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            f"fused_admm: kernel takes float32, got {[t.dtype for t in tensors]}"
        )
    if g.ndim != 2 or z0.shape != g.shape:
        raise ValueError(f"fused_admm: g, z0 must be (B, D), got "
                         f"{tuple(g.shape)}, {tuple(z0.shape)}")
    B, D = g.shape
    if S.shape != (D, D) or lo.numel() != D or hi.numel() != D:
        raise ValueError(
            f"fused_admm: S must be ({D}, {D}) and lo, hi hold {D} values, got "
            f"{tuple(S.shape)}, {tuple(lo.shape)}, {tuple(hi.shape)}"
        )
    if not 1 <= D <= MAX_D or B < 1:
        raise ValueError(f"fused_admm: kernel takes B >= 1 and 1 <= D <= "
                         f"{MAX_D}, got B={B}, D={D}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_admm: kernel takes contiguous tensors")
    out = torch.empty_like(g)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn()(
            g.data_ptr(), z0.data_ptr(), S.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), out.data_ptr(), B, D, int(iters), float(rho),
            float(alpha), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_admm: kernel launch failed, cudaError_t {err}")
    LAUNCHES += 1
    return out
