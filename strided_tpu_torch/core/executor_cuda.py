"""The tile executor K4: the engine's generic map / map-reduce kernel.

Counterpart of ``strided_tpu/core/executor_pallas.py``; the CUDA source is
``csrc/tile_executor.cu``. :func:`try_fused_mapreduce` decides eligibility
and plans (fuse and order the dims with ``planner.py``, reduction dims
innermost), then calls :func:`tile_executor`, which launches the kernel for
CUDA tensors and raises if it cannot, and runs
:func:`tile_executor_reference`, its plain PyTorch version, for CPU tensors.
``LAUNCHES`` counts launches.

Eligibility follows the reference where it is about the engine, and is
re-derived where it was about the TPU: every operand a pure reshape of its
parent (``_exact_nested``); f32/bf16/int32 (the reference also takes
uint32, which PyTorch's kernels barely cover); a known reduction op; ``f``
and ``initop`` traceable to elementwise programs (``ewise.py``); the size
gates; at most 5 dims after fusion and 8 inputs; fewer than 2^31
iteration elements. Maps whose operands all read in loop order stay on the
plain path unless ``aligned_maps`` (the reference's policy). The TPU's
lane/sublane tile alignment rules have no counterpart. A declined call
leaves ``LAST_PLAN`` empty and logs why on ``strided_tpu_torch.dispatch``.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import math
import operator
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from . import ewise, planner
from .regularize import decompose, Decomposition
from .view import StridedView
from ..config import get_config
from ..utils.profiling import annotated

__all__ = ["try_fused_mapreduce", "make_plan", "tile_executor", "tile_executor_reference",
           "LAST_PLAN", "LAUNCHES", "MAP_PATHS"]

_log = logging.getLogger("strided_tpu_torch.dispatch")

LAUNCHES: int = 0
# launches of a map by the kernel the launcher reports it ran: "amortized"
# (the body fits ewise.CREG registers), "scalar" (a wider body), "copy" (a
# transposed copy) or "multi_axis" (inputs staged along several dims)
MAP_PATHS: dict = {"amortized": 0, "scalar": 0, "copy": 0, "multi_axis": 0}
_MAP_PATH_NAMES = ("copy", "amortized", "scalar", "multi_axis")  # csrc/tile_executor.cu: *path
MAX_DIM = 5  # csrc/tile_executor.cu: TE_MAX_DIM
MAX_STAGING_DIMS = 3  # csrc/tile_executor.cu: launch_multi_axis
MAX_IN = ewise.MAX_IN
_OK_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
RED_SUM, RED_PROD, RED_MIN, RED_MAX, RED_ALL, RED_ANY = range(6)  # EW_RED_*

# The plan of the last call that took K4 (dims, n_par, each operand's
# physical axes, the reduction); emptied at every attempt, so it never
# describes a call that took the plain path.
LAST_PLAN: dict = {}


class _Ineligible(Exception):
    pass


def _demote(reason: str):
    _log.debug("tile executor declined: %s", reason)
    raise _Ineligible(reason)


def _reducer_for(op) -> Optional[int]:
    for ops, code in (((operator.add, torch.add), RED_SUM),
                      ((operator.mul, torch.mul), RED_PROD),
                      ((torch.minimum,), RED_MIN), ((torch.maximum,), RED_MAX),
                      ((torch.logical_and,), RED_ALL), ((torch.logical_or,), RED_ANY)):
        if any(op is o for o in ops):
            return code
    return None


def _exact_nested(dec: Decomposition, parent_len: int) -> bool:
    """The physical array is a free reshape of the flat parent."""
    if dec.overlapping or any(dec.flipped) or dec.min_offset != 0:
        return False
    n = len(dec.sizes)
    if n == 0:
        return parent_len == 1
    if dec.strides[-1] != 1:
        return False
    for k in range(n - 1):
        if dec.strides[k] != dec.sizes[k + 1] * dec.strides[k + 1]:
            return False
    return math.prod(dec.sizes) == parent_len


@dataclass(frozen=True)
class Plan:
    """What the kernel needs: loop dims (parallel first, then reduced),
    each operand's strides over them, and the programs."""

    dims: Tuple[int, ...]
    n_par: int
    out_strides: Tuple[int, ...]
    in_strides: Tuple[Tuple[int, ...], ...]
    body: ewise.Program  # f over the inputs
    init: Optional[ewise.Program]  # initop over the old output (reductions)
    red: Optional[int]  # RED_*, or None for a map
    part_dtype: torch.dtype  # the folded values' type
    tdim: int = -1  # a map's shared-memory tiled dim, or -1
    tmask: int = 0  # inputs staged through the tiles (bit k: input k)
    # each input's staging dim (-1: read directly) where the inputs stage
    # along two or more dims, else (): the multi-axis kernel's plan
    stage: Tuple[int, ...] = ()


def try_fused_mapreduce(
    f: Callable,
    op: Optional[Callable],
    initop: Optional[Callable],
    dims: Tuple[int, ...],
    out: StridedView,
    ins: Sequence[StridedView],
) -> Optional[StridedView]:
    plan = make_plan(f, op, initop, dims, out, ins)
    if plan is None:
        return None
    new_parent = tile_executor(plan, out.parent, [v.parent for v in ins])
    return StridedView(new_parent, out.shape, out.strides, out.offset, out.conj)


@annotated("engine.plan")
def make_plan(f, op, initop, dims, out, ins) -> Optional[Plan]:
    """The kernel's plan for ``fused_mapreduce``'s arguments, or None where
    the call is not eligible (see the module docstring). Sets LAST_PLAN."""
    LAST_PLAN.clear()
    cfg = get_config()
    if not cfg.use_kernels:
        return None
    try:
        return _plan(f, op, initop, dims, out, ins, cfg)
    except _Ineligible:
        return None


def _plan(f, op, initop, dims, out, ins, cfg) -> Plan:
    operands = [out] + list(ins)
    for v in operands:
        if v.dtype not in _OK_DTYPES or v.conj:
            _demote(f"dtype {v.dtype} or a conjugated view")
    if len({v.device for v in operands}) != 1:
        _demote("operands on several devices")
    n = math.prod(dims)
    if n < cfg.min_kernel_elements:
        _demote("below min_kernel_elements")
    if op is None and n < cfg.map_min_elements:
        _demote("map below map_min_elements")
    if n >= 2 ** 31:
        _demote("2^31 or more iteration elements")
    if len(ins) > MAX_IN:
        _demote(f"more than {MAX_IN} inputs")

    red0 = tuple(i for i in range(len(dims)) if out.strides[i] == 0 and dims[i] != 1)
    if op is None and red0:
        _demote("map into a broadcast output")
    red = None  # a map; with op given, op(initop(old), fold) over red0 (maybe empty)
    if op is not None:
        if red0 and not cfg.kernel_reductions:
            _demote("reductions go to the plain path (kernel_reductions off)")
        red = _reducer_for(op)
        if red is None:
            _demote("op outside sum/prod/min/max/all/any")

    # the closures, as programs
    try:
        if red is None:
            body = ewise.trace(f, [v.dtype for v in ins], out_dtype=out.dtype)
            init, part_dtype = None, out.dtype
        else:
            body = ewise.trace(f, [v.dtype for v in ins])
            part_dtype = torch.bool if red in (RED_ALL, RED_ANY) else body.out_dtype
            if body.out_dtype not in _OK_DTYPES:
                _demote(f"reduction of {body.out_dtype} values")
            init = ewise.trace(initop if initop is not None else (lambda x: x),
                               [out.dtype], out_dtype=part_dtype)
    except ewise.Ineligible as e:
        _demote(str(e))

    # fuse -> drop size-1 -> order, reduction dims innermost
    all_strides = tuple(tuple(v.strides) for v in operands)
    dims_f, strides_f = planner.fuse_dims(tuple(dims), all_strides)
    keep = [i for i in range(len(dims_f)) if dims_f[i] > 1]
    if not keep:
        _demote("no dim of size > 1")
    dims_k = tuple(dims_f[i] for i in keep)
    strides_k = tuple(tuple(s[i] for i in keep) for s in strides_f)
    red_k = tuple(j for j in range(len(keep)) if strides_k[0][j] == 0)
    perm, dims_o, strides_o, _costs = planner.order_dims(dims_k, strides_k)
    order = ([j for j in range(len(perm)) if perm[j] not in red_k]
             + [j for j in range(len(perm)) if perm[j] in red_k])
    perm = tuple(perm[j] for j in order)
    dims_o = tuple(dims_o[j] for j in order)
    strides_o = tuple(tuple(s[j] for j in order) for s in strides_o)
    n_par = sum(1 for p in perm if p not in red_k)
    if n_par == 0:  # complete reduction: one parallel dim of size 1
        dims_o, strides_o, n_par = (1,) + dims_o, tuple((0,) + s for s in strides_o), 1
    if len(dims_o) > MAX_DIM:
        _demote(f"more than {MAX_DIM} dims after fusion")

    decs = []
    for v, s in zip(operands, strides_o):
        dec = decompose(dims_o, s, v.offset)
        if not _exact_nested(dec, v.parent.numel()):
            _demote("an operand is not a pure reshape of its parent")
        decs.append(dec)
    if (op is None and not cfg.aligned_maps
            and all(list(d.real_axes) == sorted(d.real_axes) for d in decs)):
        _demote("aligned map (aligned_maps off)")
    if set(decs[0].real_axes) != {i for i in range(n_par) if dims_o[i] > 1}:
        _demote("the output does not own exactly the parallel dims")

    tdim, tmask, stage = _staging(red, dims_o, strides_o)
    LAST_PLAN.update(dims=dims_o, n_par=n_par, real_axes=[d.real_axes for d in decs],
                     reduction=red, body_ops=len(body.instrs), tiled_dim=tdim, staging=stage)
    return Plan(dims_o, n_par, strides_o[0], strides_o[1:], body, init, red, part_dtype,
                tdim, tmask, stage)


def _staging(red, dims, strides):
    """For a map whose output is unit-stride along the last loop dim: each
    input's unit-stride dim where that is another loop dim, then
    ``(tdim, tmask, stage)``. ``tdim`` is the first input's such dim and
    ``tmask`` the inputs that share it (tile_t2d_v stages them through its
    tiles); ``(-1, 0, ())`` if no input has one. ``stage`` gives each input
    its staging dim, or -1 for one read directly (unit-stride along the last
    dim, no unit-stride dim, or a broadcast), where the staging dims number
    2 to MAX_STAGING_DIMS (the multi-axis kernel), else ()."""
    last = len(dims) - 1
    if red is not None or last < 1 or strides[0][last] != 1:
        return -1, 0, ()
    unit = []  # on the host path of every K4 call: plain loops
    for s in strides[1:]:
        e = -1
        if s[last] != 1:
            for d in range(last):
                if s[d] == 1 and dims[d] > 1:
                    e = d
                    break
        unit.append(e)
    tdim = next((e for e in unit if e >= 0), -1)
    if tdim < 0:
        return -1, 0, ()
    tmask = 0
    stage, staged = [], set()
    for k, (s, e) in enumerate(zip(strides[1:], unit)):
        if e == tdim:
            tmask |= 1 << k
        if e >= 0 and 0 in s:
            e = -1
        stage.append(e)
        if e >= 0:
            staged.add(e)
    return tdim, tmask, (tuple(stage) if 2 <= len(staged) <= MAX_STAGING_DIMS else ())


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------


class _COperand(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("stride", ctypes.c_int64 * MAX_DIM),
                ("offset", ctypes.c_int64), ("type", ctypes.c_int32), ("pad", ctypes.c_int32)]


class _CParams(ctypes.Structure):
    _fields_ = [("rank", ctypes.c_int32), ("n_par", ctypes.c_int32),
                ("n_in", ctypes.c_int32), ("red", ctypes.c_int32),
                ("dims", ctypes.c_int64 * MAX_DIM),
                ("n_out", ctypes.c_int64), ("n_red", ctypes.c_int64),
                ("part_type", ctypes.c_int32), ("tdim", ctypes.c_int32),
                ("tmask", ctypes.c_int32), ("chunks", ctypes.c_int32),
                ("x_lanes", ctypes.c_int32), ("compact", ctypes.c_int32),
                ("stage", ctypes.c_int32 * MAX_IN),
                ("scratch", ctypes.c_void_p),
                ("out", _COperand), ("old", _COperand), ("ins", _COperand * MAX_IN),
                ("body", ewise.CProgram), ("init", ewise.CProgram)]


_NO_STAGE = (ctypes.c_int32 * MAX_IN)(*[-1] * MAX_IN)  # every input read directly


def _c_operand(t: torch.Tensor, strides) -> _COperand:
    st = (ctypes.c_int64 * MAX_DIM)(*strides, *([0] * (MAX_DIM - len(strides))))
    return _COperand(t.data_ptr(), st, 0, ewise.TYPE_CODE[t.dtype], 0)


@functools.cache
def _kernel_fn():
    from .._build import load_library

    fn = load_library().strided_tile_executor
    fn.argtypes = [ctypes.POINTER(_CParams), ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


THREADS = 256  # csrc/tile_executor.cu
TARGET_BLOCKS = 4 * 132  # about four blocks per SM of an H100


def reduction_split(n_out: int, n_red: int):
    """``(x_lanes, chunks)`` for a reduction: 32 outputs a block (1 below
    32 outputs), the reduced extent over the block's other threads and over
    enough chunks to fill the card, each thread folding at least 32 values."""
    x = 32 if n_out >= 32 else 1
    blocks = -(-n_out // x)
    chunks = -(-TARGET_BLOCKS // blocks)
    return x, max(1, min(chunks, n_red // (THREADS // x * 32), 65535))


def _logical(parent: torch.Tensor, dims, strides) -> torch.Tensor:
    return parent.as_strided(dims, strides, parent.storage_offset())


def tile_executor_reference(plan: Plan, out_parent: torch.Tensor,
                            in_parents: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version: every operand seen in loop order, the body
    program, the fold over the reduced (trailing) dims, ``op(init(old),
    partial)``; returns the new output parent."""
    from .mapreduce import _native_reducer

    ins = [_logical(p, plan.dims, s) for p, s in zip(in_parents, plan.in_strides)]
    vals = ewise.evaluate(plan.body, ins,
                          like=torch.empty(plan.dims, device=out_parent.device))
    new = torch.empty_like(out_parent)
    par = plan.dims[:plan.n_par]
    dst = _logical(new, par, plan.out_strides[:plan.n_par])
    if plan.red is None:
        dst.copy_(vals.expand(plan.dims))
        return new
    op = (torch.add, torch.mul, torch.minimum, torch.maximum,
          torch.logical_and, torch.logical_or)[plan.red]
    partial = _native_reducer(op)(vals.expand(plan.dims).reshape(par + (-1,)))
    old = _logical(out_parent, par, plan.out_strides[:plan.n_par])
    seed = ewise.evaluate(plan.init, [old.contiguous()])
    dst.copy_(op(seed, partial).to(out_parent.dtype))
    return new


@annotated("engine.launch")
def tile_executor(plan: Plan, out_parent: torch.Tensor,
                  in_parents: Sequence[torch.Tensor]) -> torch.Tensor:
    """Run a planned map / map-reduce; returns the new output parent (a
    fresh tensor: the old one is read, for a reduction, and kept)."""
    global LAUNCHES
    tensors = [out_parent, *in_parents]
    if all(t.device.type == "cpu" for t in tensors):
        return tile_executor_reference(plan, out_parent, in_parents)
    dev = out_parent.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"tile_executor: tensors on {[str(t.device) for t in tensors]}")
    if any(t.dtype not in _OK_DTYPES or not t.is_contiguous() for t in tensors):
        raise TypeError("tile_executor: kernel takes contiguous f32/bf16/int32 parents")
    new = torch.empty_like(out_parent)
    p = _CParams()
    p.rank, p.n_par, p.n_in = len(plan.dims), plan.n_par, len(in_parents)
    p.red = -1 if plan.red is None else plan.red
    p.dims = (ctypes.c_int64 * MAX_DIM)(*plan.dims, *([1] * (MAX_DIM - len(plan.dims))))
    p.n_out = math.prod(plan.dims[:plan.n_par])
    p.n_red = math.prod(plan.dims[plan.n_par:])
    p.part_type = ewise.TYPE_CODE[plan.part_dtype]
    p.tdim, p.tmask, p.chunks, p.x_lanes = plan.tdim, plan.tmask, 1, THREADS
    p.stage = (ctypes.c_int32 * MAX_IN)(*plan.stage, *_NO_STAGE[len(plan.stage):]) if plan.stage \
        else _NO_STAGE
    scratch = None
    if plan.red is not None and p.n_red > 1:
        p.x_lanes, p.chunks = reduction_split(p.n_out, p.n_red)
        if p.chunks > 1:
            scratch = torch.empty(p.chunks * p.n_out, dtype=torch.int32, device=dev)
            p.scratch = scratch.data_ptr()
    p.out = _c_operand(new, plan.out_strides)
    p.old = _c_operand(out_parent, plan.out_strides)
    for k, (t, s) in enumerate(zip(in_parents, plan.in_strides)):
        p.ins[k] = _c_operand(t, s)
    p.body = ewise.to_c(plan.body)
    if plan.init is not None:
        p.init = ewise.to_c(plan.init)
    if plan.red is None:
        # the amortized kernels: a body of at most CREG registers, and 32-bit offsets
        p.compact = int(p.body.n_reg <= ewise.CREG and len(in_parents) <= ewise.CREG
                        and all(t.numel() < 2 ** 31 for t in tensors))
    path = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn()(ctypes.byref(p), stream, ctypes.byref(path))
    if err != 0:
        raise RuntimeError(f"tile_executor: kernel launch failed, cudaError_t {err}")
    LAUNCHES += 1
    if path.value >= 0:
        MAP_PATHS[_MAP_PATH_NAMES[path.value]] += 1
    return new
