"""The stream reduction K3: ``out[c] = fold over r of f(A)[r, c]``.

Replaces the Pallas kernel ``strided_tpu/core/kernels_special.py::
_make_stream_reduce_kernel``; the CUDA source is ``csrc/stream_reduce.cu``.
:func:`stream_reduce` launches it for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs :func:`stream_reduce_reference`, the plain
PyTorch version. ``f`` arrives as an elementwise program (``ewise.py``).
``LAUNCHES`` counts launches.

What bounds it on an H100, and the design: see the CUDA source. The columns
a thread owns and the work split (:func:`vector_width`, :func:`row_chunks`)
are chosen here from the shape, dtype and alignment alone, so a given
operand always folds in the same order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import ewise

__all__ = ["stream_reduce", "stream_reduce_reference", "row_chunks", "vector_width", "LAUNCHES",
           "PATHS",
           "RED_SUM", "RED_PROD", "RED_MIN", "RED_MAX"]

LAUNCHES: int = 0
# launches by the kernel the launcher reports it ran: "identity" (no
# program), "amortized" (a program of at most ewise.CREG registers) or
# "scalar" (a wider one)
PATHS: dict = {"identity": 0, "amortized": 0, "scalar": 0}
_PATH_NAMES = ("identity", "amortized", "scalar")  # csrc/stream_reduce.cu: *path
RED_SUM, RED_PROD, RED_MIN, RED_MAX = 0, 1, 2, 3  # csrc/ewise.cuh: EW_RED_*
COLS = 32  # lanes of columns per block (csrc/stream_reduce.cu)
NV = 8  # columns a thread owns on the vector path (NV)
STEP = 64  # a chunk's rows are a multiple of this (STEP)
SMS = 132  # an H100's SMs
PER_SM = 4  # resident blocks an SM: csrc/stream_reduce.cu's __launch_bounds__
PER_SM_PROGRAM = 2  # the same for a kernel that runs a program
SLOTS = PER_SM * SMS


def vector_width(a: torch.Tensor) -> int:
    """Columns a thread owns: NV (16-byte loads) for a 4- or 2-byte type
    whose rows are whole 16-byte runs on a 16-byte aligned base, else 1.
    The kernel takes NV for the identity program only."""
    per16 = 16 // a.element_size()
    ok = a.element_size() in (2, 4) and a.shape[1] % per16 == 0 and a.data_ptr() % 16 == 0
    return NV if ok else 1


def row_chunks(N: int, M: int, vec: int = 1, slots: int = SLOTS) -> Tuple[int, int]:
    """``(chunks, rows)``: the N rows cut into chunks of ``rows`` rows (a
    multiple of STEP; the last chunk holds the rest), as few and as tall as
    keep every (column block, chunk) item in one wave of ``slots`` blocks.
    Past ``slots`` column blocks, one chunk."""
    col_blocks = -(-M // (COLS * vec))
    want = max(1, slots // col_blocks)
    rows = -(-N // want)
    rows = -(-rows // STEP) * STEP
    return -(-N // rows), rows


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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ewise.CProgram), ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


_TICKETS: dict = {}  # (device index, stream) -> that stream's tickets


def _tickets(device: torch.device, stream: int) -> torch.Tensor:
    """The chunked kernel's tickets, one per column block (at most SLOTS):
    zero between launches, since the block that takes a column block's last
    ticket wraps it back to 0. Launches on one stream run in order, so each
    stream keeps its own. Under CUDA graph capture each launch gets fresh
    ones, zeroed in the graph, so a replay shares nothing with eager calls."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(SLOTS, dtype=torch.int32, device=device)
    key = (device.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(SLOTS, dtype=torch.int32, device=device)
    return _TICKETS[key]


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
    cprog = ewise.to_c(prog)
    identity = cprog.n_instr == 0
    vec = vector_width(a) if identity else 1
    chunks, rows = row_chunks(N, M, vec, SLOTS if identity else PER_SM_PROGRAM * SMS)
    out = torch.empty(M, dtype=prog.out_dtype, device=a.device)
    path = ctypes.c_int(-1)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        scratch = tickets = None
        if chunks > 1:
            scratch = torch.empty(chunks * M, dtype=torch.int32, device=a.device)
            tickets = _tickets(a.device, stream)
        err = _kernel_fn()(a.data_ptr(), out.data_ptr(),
                           None if scratch is None else scratch.data_ptr(),
                           None if tickets is None else tickets.data_ptr(), SLOTS, N, M, chunks,
                           rows, vec, red, ctypes.byref(cprog), stream, ctypes.byref(path))
    if err != 0:
        raise RuntimeError(f"stream_reduce: kernel launch failed, cudaError_t {err}")
    LAUNCHES += 1
    PATHS[_PATH_NAMES[path.value]] += 1
    return out
