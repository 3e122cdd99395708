"""Runtime configuration for strided_tpu_torch.

Counterpart of ``strided_tpu/config.py``. Only the two knobs the ported MPC
path reads survive: the fused-ADMM kernel toggle and the f32 matmul precision.
The TPU tuning fields (VMEM budget, lane/sublane tiling, Pallas size gates)
have no meaning on a GPU and are not carried over.
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
    matmul_precision: str = "highest"


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
    precision and TF32 off for cuBLAS, restoring both settings on exit.

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
            torch.set_float32_matmul_precision(get_config().matmul_precision)
            torch.backends.cuda.matmul.allow_tf32 = False
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(old_prec)
            torch.backends.cuda.matmul.allow_tf32 = old_tf32

    return wrapped
