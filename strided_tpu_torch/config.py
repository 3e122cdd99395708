"""Runtime configuration for strided_tpu_torch.

Counterpart of ``strided_tpu/config.py``: the MPC path's two knobs (the
fused-ADMM kernel toggle and the f32 matmul precision) and the strided
engine's dispatch toggles and size gates. The TPU's tiling fields (VMEM
budget, lane/sublane, the Pallas budget divisor, interpret mode) have no
meaning on a GPU and are not carried over.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

__all__ = ["Config", "get_config", "set_config", "matmul_precision_scope", "PRECISIONS",
           "check_precision", "precision_mode", "single_pass", "matmul",
           "bf16_matmul_reference", "BF16_ROUTE"]

# The f32 product each ``matmul_precision`` name stands for:
#   "highest"  IEEE FP32, TF32 off;
#   "high"     TF32 on the tensor cores;
#   "default"  single pass in bf16: both operands rounded to bf16, products
#              accumulated in f32, an f32 result (what the TPU's DEFAULT
#              gives for f32 operands), through :func:`matmul` on the card;
#              IEEE FP32 on the CPU, as XLA:CPU computes the reference's
#              DEFAULT;
#   "medium"   torch's own mode of that name (TF32 on cuBLAS; oneDNN may
#              take bf16 passes on the CPU). Not a name of the reference.
PRECISIONS = ("highest", "high", "default", "medium")
_TORCH_MODE = {"highest": "highest", "high": "high", "default": "highest",
               "medium": "medium"}


@dataclasses.dataclass(frozen=True)
class Config:
    # Route qp_solve's ADMM iterations through the hand-written CUDA kernel
    # (mpc/fused_admm.py) when the iterates are f32 CUDA tensors.
    fused_admm: bool = True
    # The f32 products' precision, a name of ``PRECISIONS``, pinned by
    # matmul_precision_scope. "highest" keeps them IEEE FP32: the ADMM
    # accuracy gate (first input within 1e-4 of a converged f64 oracle)
    # fails with TF32 products. K1 (fused_admm) computes in FP32 whatever
    # the name, as the reference's fused kernel does.
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
    """Replace fields of the global config; returns the new config. A
    ``matmul_precision`` outside ``PRECISIONS`` raises ``ValueError``."""
    global _config
    if "matmul_precision" in kwargs:
        check_precision(kwargs["matmul_precision"])
    _config = dataclasses.replace(_config, **kwargs)
    return _config


def check_precision(name: str) -> str:
    """``name`` if it is one of ``PRECISIONS``, else ``ValueError``, as
    ``jax.default_matmul_precision`` refuses a name it does not know."""
    if name not in PRECISIONS:
        raise ValueError(f"matmul_precision {name!r} is not one of {PRECISIONS}")
    return name


@contextlib.contextmanager
def precision_mode(name: str):
    """Pin torch's f32 matmul mode to the one ``name`` stands for, and
    restore the caller's mode and TF32 flag on exit. At "highest" and
    "default" TF32 is off; "default"'s single pass is :func:`matmul`'s."""
    mode = _TORCH_MODE[check_precision(name)]
    old_prec = torch.get_float32_matmul_precision()
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.set_float32_matmul_precision(mode)
        if mode == "highest":
            torch.backends.cuda.matmul.allow_tf32 = False
        yield
    finally:
        torch.set_float32_matmul_precision(old_prec)
        torch.backends.cuda.matmul.allow_tf32 = old_tf32


def matmul_precision_scope(fn):
    """Decorator: run ``fn`` with f32 matmuls pinned to the configured
    precision (:func:`precision_mode`), restoring the caller's settings on
    exit; an unknown name raises ``ValueError``, as the reference's scope
    does through ``jax.default_matmul_precision``.

    PyTorch's defaults are already IEEE FP32 for matmuls, but they are
    process-global and any caller may have switched TF32 on; ADMM converges
    to the fixed point of the *computed* ``g = x0 Mᵀ``, so a TF32-rounded
    product biases every iterate. The solver pins the mode itself instead of
    trusting the caller."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with precision_mode(get_config().matmul_precision):
            return fn(*args, **kwargs)

    return wrapped


# How :func:`matmul` takes a "default" product on the card: on the tensor
# cores from bf16 operands into an f32 result where this torch has
# ``torch.mm(..., out_dtype=)``, else the rounded operands' product in IEEE
# FP32 (the same values up to summation order).
BF16_ROUTE = ("tensor cores (torch.mm out_dtype=float32)"
              if "dtype" in torch.ops.aten.mm.overloads()
              else "IEEE FP32 on bf16-rounded operands")


def bf16_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the single-pass product: the operands rounded to
    bf16, multiplied in IEEE FP32 (a product of two bf16 values is exact in
    f32), an f32 result."""
    with precision_mode("highest"):
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not BF16_ROUTE.startswith("tensor"):
        return bf16_matmul_reference(a, b)
    if b.ndim != 2:  # torch.mm takes one matrix on the right
        return bf16_matmul_reference(a, b)
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    out = torch.mm(a16.reshape(-1, a16.shape[-1]), b16, out_dtype=torch.float32)
    return out.reshape(*a16.shape[:-1], b16.shape[-1])


def single_pass(name: str, *operands: torch.Tensor) -> bool:
    """Whether a product of ``operands`` at ``name`` is the single pass in
    bf16: "default", on f32 CUDA tensors."""
    return name == "default" and all(t.is_cuda and t.dtype == torch.float32 for t in operands)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = None) -> torch.Tensor:
    """``a @ b`` at ``precision`` (a name of ``PRECISIONS``; None: the
    configured one, under the caller's :func:`matmul_precision_scope`).
    At "default" an f32 product of CUDA tensors is the single pass in bf16
    (``BF16_ROUTE``); any other product, and every one on the CPU, runs
    under the name's torch mode."""
    name = check_precision(get_config().matmul_precision if precision is None else precision)
    if single_pass(name, a, b):
        return _bf16_matmul(a, b)
    if precision is None:
        return torch.matmul(a, b)
    with precision_mode(name):
        return torch.matmul(a, b)
