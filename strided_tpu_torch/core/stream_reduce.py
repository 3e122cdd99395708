"""The stream reduction K3: ``out[c] = fold over r of f(A)[r, c]``.

Replaces the Pallas kernel ``strided_tpu/core/kernels_special.py::
_make_stream_reduce_kernel``; the CUDA source is ``csrc/stream_reduce.cu``.
:func:`stream_reduce` launches it for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs :func:`stream_reduce_reference`, the plain
PyTorch version. ``f`` arrives as an elementwise program (``ewise.py``).
``LAUNCHES`` counts launches.

What bounds it on an H100, and the design: see the CUDA source. The vector
width and the row chunk count (:func:`vector_width`, :func:`row_chunks`) are
chosen here from the shape, dtype and alignment, so a given operand always
folds in the same order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import ewise

__all__ = ["stream_reduce", "stream_reduce_reference", "row_chunks", "vector_width", "LAUNCHES",
           "RED_SUM", "RED_PROD", "RED_MIN", "RED_MAX"]

LAUNCHES: int = 0
RED_SUM, RED_PROD, RED_MIN, RED_MAX = 0, 1, 2, 3  # csrc/ewise.cuh: EW_RED_*
COLS = 32  # lanes of columns per block (csrc/stream_reduce.cu)
TARGET_BLOCKS = 4 * 132  # about four blocks per SM of an H100
MIN_ROWS_PER_CHUNK = 256


def vector_width(a: torch.Tensor) -> int:
    """Columns a thread reads at once: 4 (one 16-byte load) for a 4-byte
    type with M % 4 == 0 on a 16-byte aligned base, else 1."""
    ok = a.element_size() == 4 and a.shape[1] % 4 == 0 and a.data_ptr() % 16 == 0
    return 4 if ok else 1


def row_chunks(N: int, M: int, vec: int = 1) -> int:
    """Row chunks for an (N, M) reduction: enough blocks to fill the card,
    never fewer than MIN_ROWS_PER_CHUNK rows a chunk."""
    col_blocks = -(-M // (COLS * vec))
    want = -(-TARGET_BLOCKS // col_blocks)
    return max(1, min(want, N // MIN_ROWS_PER_CHUNK, 65535))


def _fold_ref(vals: torch.Tensor, red: int) -> torch.Tensor:
    if red == RED_SUM:
        return torch.sum(vals, dim=0, dtype=vals.dtype)
    if red == RED_PROD:
        return torch.prod(vals, dim=0, dtype=vals.dtype)
    if red == RED_MIN:
        return torch.amin(vals, dim=0)
    return torch.amax(vals, dim=0)


def stream_reduce_reference(a: torch.Tensor, prog: ewise.Program, red: int) -> torch.Tensor:
    """Plain PyTorch version: the program on every element, then the fold
    over the rows of ``a`` (N, M). Returns (M,) of the program's result type."""
    return _fold_ref(ewise.evaluate(prog, [a]), red)


@functools.cache
def _kernel_fn():
    from .._build import load_library

    fn = load_library().strided_stream_reduce
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ewise.CProgram), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stream_reduce(a: torch.Tensor, prog: ewise.Program, red: int) -> torch.Tensor:
    """Fold ``prog(a)`` over the rows of the (N, M) tensor ``a`` with ``red``
    (RED_SUM, RED_PROD, RED_MIN or RED_MAX)."""
    global LAUNCHES
    if a.device.type == "cpu":
        return stream_reduce_reference(a, prog, red)
    if a.device.type != "cuda":
        raise ValueError(f"stream_reduce: tensor on {a.device}")
    if a.ndim != 2 or a.numel() == 0 or not a.is_contiguous():
        raise ValueError(f"stream_reduce: kernel takes a non-empty contiguous (N, M) "
                         f"tensor, got {tuple(a.shape)}")
    if prog.in_dtypes != (a.dtype,) or prog.out_dtype not in (
            torch.float32, torch.bfloat16, torch.int32):
        raise TypeError(f"stream_reduce: program {prog.in_dtypes} -> {prog.out_dtype} "
                        f"does not fit a {a.dtype} operand")
    if red not in (RED_SUM, RED_PROD, RED_MIN, RED_MAX):
        raise ValueError(f"stream_reduce: fold {red}")
    N, M = a.shape
    vec = vector_width(a)
    chunks = row_chunks(N, M, vec)
    out = torch.empty(M, dtype=prog.out_dtype, device=a.device)
    scratch = torch.empty(chunks * M if chunks > 1 else 1, dtype=torch.int32, device=a.device)
    cprog = ewise.to_c(prog)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel_fn()(a.data_ptr(), out.data_ptr(), scratch.data_ptr(), N, M, chunks,
                           vec, red, ctypes.byref(cprog), stream)
    if err != 0:
        raise RuntimeError(f"stream_reduce: kernel launch failed, cudaError_t {err}")
    LAUNCHES += 1
    return out
