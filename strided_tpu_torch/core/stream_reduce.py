"""The stream reduction K3: ``out[c] = fold over r of f(A)[r, c]``.

Replaces the Pallas kernel ``strided_tpu/core/kernels_special.py::
_make_stream_reduce_kernel``; the CUDA source is ``csrc/stream_reduce.cu``.
:func:`stream_reduce` launches it for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs :func:`stream_reduce_reference`, the plain
PyTorch version. ``f`` arrives as an elementwise program (``ewise.py``).
``LAUNCHES`` counts launches.

What bounds it on an H100, and the design: see the CUDA source. The work
split (:func:`split`) depends on the shape, dtype, alignment and program
alone, so a given operand always folds in the same order: whether the rows
allow 16-byte loads is read here (:func:`vector_width`), the width and
blocks an SM of the kernel that will run come from the CUDA source
(``strided_stream_reduce_shape``), and the rows are cut into one wave of
those blocks here (:func:`row_chunks`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import ewise
from ..utils.profiling import annotated

__all__ = ["stream_reduce", "stream_reduce_reference", "row_chunks", "vector_width", "split",
           "kernel_shape", "path_name", "LAUNCHES", "PATHS", "RED_SUM", "RED_PROD", "RED_MIN",
           "RED_MAX"]

LAUNCHES: int = 0
# csrc/stream_reduce.cu's *path: the kernel (SR_IDENTITY = 0, SR_AMORTIZED,
# SR_SCALAR) with the SR_VECTOR bit set for 8 columns a thread
KERNELS = ("identity", "amortized", "scalar")
SR_VECTOR = 4
# launches by what the launcher reports it ran, "<kernel>/<width>": the
# kernel "identity" (no program), "amortized" (a program of at most
# ewise.CREG registers) or "scalar" (a wider one); the width "vector" (8
# columns a thread, 16-byte loads) or "column" (one)
PATHS: dict = {f"{k}/{w}": 0 for k in KERNELS for w in ("vector", "column")}
RED_SUM, RED_PROD, RED_MIN, RED_MAX = 0, 1, 2, 3  # csrc/ewise.cuh: EW_RED_*
COLS = 32  # lanes of columns per block (csrc/stream_reduce.cu)
NV = 8  # columns a thread owns on the vector path (NV)
STEP = 64  # a chunk's rows are a multiple of this (STEP)
SMS = 132  # an H100's SMs
# row_chunks' default wave, and the tickets a stream keeps: 4 blocks an SM,
# the most any K3 kernel keeps resident (the launcher refuses a chunked
# launch with more column blocks than tickets)
SLOTS = 4 * SMS


def vector_width(a: torch.Tensor) -> int:
    """Columns a thread owns: NV (16-byte loads) for a 4- or 2-byte type
    whose rows are whole 16-byte runs on a 16-byte aligned base, else 1."""
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


@functools.cache
def kernel_shape(n_instr: int, n_reg: int, vec_ok: bool) -> Tuple[int, int]:
    """``(columns a thread, blocks an SM)`` of the kernel the launcher runs
    for a program of ``n_instr`` instructions and ``n_reg`` registers, on
    rows that allow 16-byte loads (``vec_ok``) or not: the CUDA source's
    ``strided_stream_reduce_shape``, which reads the numbers its kernels'
    ``__launch_bounds__`` are built with."""
    fn = _kernel_fn("strided_stream_reduce_shape")
    vec, per_sm = ctypes.c_int(), ctypes.c_int()
    fn(n_instr, n_reg, int(vec_ok), ctypes.byref(vec), ctypes.byref(per_sm))
    return vec.value, per_sm.value


def split(a: torch.Tensor, n_instr: int, n_reg: int) -> Tuple[int, int, int]:
    """``(vec, chunks, rows)`` of the launch on the (N, M) tensor ``a`` for
    a program of ``n_instr`` instructions and ``n_reg`` registers: the
    columns a thread owns and one wave of the blocks an SM its kernel keeps
    resident (:func:`kernel_shape`), given whether ``a``'s rows allow
    16-byte loads (:func:`vector_width`)."""
    vec, per_sm = kernel_shape(n_instr, n_reg, vector_width(a) == NV)
    return (vec, *row_chunks(*a.shape, vec, per_sm * SMS))


def path_name(code: int) -> str:
    """The PATHS key of the launcher's ``*path`` report."""
    kernel = code & ~SR_VECTOR
    if not 0 <= kernel < len(KERNELS):
        raise RuntimeError(f"stream_reduce: the launcher reported path {code}")
    return f"{KERNELS[kernel]}/{'vector' if code & SR_VECTOR else 'column'}"


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


_ARGTYPES = {
    "strided_stream_reduce": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ewise.CProgram), ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    "strided_stream_reduce_shape": (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2, None),
}


@functools.cache
def _kernel_fn(name: str = "strided_stream_reduce"):
    from .._build import load_library

    fn = getattr(load_library(), name)
    fn.argtypes, fn.restype = _ARGTYPES[name]
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


@annotated("engine.launch")
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
    types = (torch.float32, torch.bfloat16, torch.int32)
    if prog.in_dtypes != (a.dtype,) or a.dtype not in types or prog.out_dtype not in types:
        raise TypeError(f"stream_reduce: program {prog.in_dtypes} -> {prog.out_dtype} "
                        f"does not fit a {a.dtype} operand")
    if red not in (RED_SUM, RED_PROD, RED_MIN, RED_MAX):
        raise ValueError(f"stream_reduce: fold {red}")
    N, M = a.shape
    cprog = ewise.to_c(prog)
    vec, chunks, rows = split(a, cprog.n_instr, cprog.n_reg)
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
    ran = path_name(path.value)
    LAUNCHES += 1
    PATHS[ran] += 1
    return out
