"""Runtime configuration for strided_tpu_torch.

Counterpart of ``strided_tpu/config.py``: the MPC path's two knobs (the
fused-ADMM kernel toggle and the f32 matmul precision) and the strided
engine's dispatch toggles and size gates. The TPU's tiling fields (VMEM
budget, lane/sublane, the Pallas budget divisor, interpret mode) have no
meaning on a GPU and are not carried over.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

__all__ = ["Config", "get_config", "set_config", "matmul_precision_scope"]


@dataclasses.dataclass(frozen=True)
class Config:
    # Route qp_solve's ADMM iterations through the hand-written CUDA kernel
    # (mpc/fused_admm.py) when the iterates are f32 CUDA tensors.
    fused_admm: bool = True
    # torch.set_float32_matmul_precision mode inside matmul_precision_scope.
    # "highest" keeps f32 matmuls in IEEE FP32: the ADMM accuracy gate (first
    # input within 1e-4 of a converged f64 oracle) fails with TF32 products.
    # K1 (fused_admm) computes in FP32 whatever the mode.
    matmul_precision: str = "highest"

    # -- strided engine (core/) ------------------------------------------
    # Send equal-dtype floating and complex ``linalg.mul`` to the vendor
    # matmul (cuBLAS on the card, through torch.matmul); off, every ``mul``
    # takes the generic stride-0 broadcast-reduce. The counterpart of
    # ``use_mxu``.
    use_blas: bool = True
    # Master toggle for the engine's CUDA kernels (K2 pair_axpby, K3
    # stream_reduce, K4 tile_executor); the analog of ``use_pallas``. Off,
    # every engine call takes the plain PyTorch path.
    use_kernels: bool = True
    # Recognise the transpose-pair family ``ep(a*A + b*A.T)`` in lazy
    # expressions and run it through K2.
    expr_pattern_dispatch: bool = True
    # Leading-physical-axis partial reductions through K3.
    stream_reductions: bool = True
    # Reductions (op given, reduced dims present) through K4; off by
    # default, as ``pallas_reductions`` is in the reference.
    kernel_reductions: bool = False
    # Maps whose operands need no transposed read through K4 (off: the
    # reference keeps them on its plain path).
    aligned_maps: bool = False
    # Size gates, in elements: each the smallest size from which the
    # kernel is no slower than the plain path in eager and device time at
    # every larger size measured, rounded up to a power of two
    # (``benchmarks/exp_crossover.py::pick_gate`` over two runs of
    # ``exp_crossover`` and ``exp_mapgate`` on an NVIDIA H100 80GB HBM3 at
    # 700.00 W; PERF.md, "The four size gates"). K2 (pair/sym, sym_bf16):
    # from 2048^2.
    # K3 (stream: ssum/smean, f32 and bf16): bf16 at 5793^2 (rows not
    # 16-byte aligned: one column a thread) is slower than plain in device
    # time, so from 8192^2. K4's maps (``exp_mapgate``): the engine's host
    # time a K4 call (~0.22 ms) loses in eager time up to 5793^2 for
    # 0.999*A.T; the rank-4 reversal's floor, 2^25, is min_kernel_elements.
    min_kernel_elements: int = 1 << 25
    map_min_elements: int = 1 << 26
    pair_kernel_min_elements: int = 1 << 22
    min_stream_reduce_elements: int = 1 << 26


_config = Config()


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    """Replace fields of the global config; returns the new config."""
    global _config
    _config = dataclasses.replace(_config, **kwargs)
    return _config


def matmul_precision_scope(fn):
    """Decorator: run ``fn`` with f32 matmuls pinned to the configured
    precision, restoring the caller's settings on exit. At "highest" TF32
    is off for cuBLAS; "high" and "medium" allow it, as the reference's
    scope follows ``Config.matmul_precision``.

    PyTorch's defaults are already IEEE FP32 for matmuls, but they are
    process-global and any caller may have switched TF32 on; ADMM converges
    to the fixed point of the *computed* ``g = x0 Mᵀ``, so a TF32-rounded
    product biases every iterate. The solver pins the mode itself instead of
    trusting the caller."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        old_prec = torch.get_float32_matmul_precision()
        old_tf32 = torch.backends.cuda.matmul.allow_tf32
        try:
            mode = get_config().matmul_precision
            torch.set_float32_matmul_precision(mode)
            if mode == "highest":
                torch.backends.cuda.matmul.allow_tf32 = False
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(old_prec)
            torch.backends.cuda.matmul.allow_tf32 = old_tf32

    return wrapped
