"""Elementwise programs: how an engine closure ``f`` reaches a CUDA kernel.

On the TPU the reference traces ``f`` into the Pallas kernel. A CUDA kernel
built once with nvcc cannot take a Python closure, so :func:`trace` runs
``f`` on placeholder leaves (:class:`_Sym`, which implements Python's
operators and ``__torch_function__``) and records a small flat **program**:
one instruction per operation, with an op code, a compute type, operand
registers and scalar constants. The kernels K3 and K4 interpret the program
per element in registers (``csrc/ewise.cuh``); :func:`evaluate` is its plain
PyTorch version. ``exp`` and ``sin`` (:data:`TRANSCENDENTAL`) run on K4's
streaming map alone; every other kernel declines a program that holds one
(:func:`transcendental`).

Types follow torch's own promotion, computed by running each operation on
one-element tensors once per operation and operand dtypes and scalars
(:func:`_dtype_of`); the program keeps f32, bf16, int32 and bool values. bf16
arithmetic is done in f32 and rounded after every operation, as eager
PyTorch does. A closure that captures a tensor, calls an operation outside
the table, or needs another dtype raises :class:`Ineligible`; the engine
then takes its plain path, as the reference's closure probe sends such
closures to XLA (``strided_tpu/core/executor_pallas.py:151-172``).

Two rules copy what eager PyTorch does on the card, so that a kernel agrees
with the plain path there bit for bit: a division by a Python scalar is a
multiplication by its f32 reciprocal (torch's CUDA ``div_true`` does this;
on the CPU torch divides), and a power with a scalar exponent of 2, 3,
0.5, -0.5, -1 or -2 takes torch's special forms. ``mod`` is floor-mod, as
``torch.remainder`` is. ``exp`` and ``sin`` promote an int32 operand to f32
first, as torch does, and are the accurate ``expf`` and ``sinf`` on the card,
the functions torch's own kernels call.
"""

from __future__ import annotations

import ctypes
import functools
import numbers
import struct
from dataclasses import dataclass, replace
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Ineligible", "Instr", "Program", "trace", "evaluate", "result_dtype",
           "CProgram", "to_c", "compact", "operand_slots", "transcendental", "TRANSCENDENTAL",
           "MAX_IN", "MAX_INSTR", "CREG", "IMM"]

MAX_IN = 8  # leaves (csrc/ewise.cuh: EW_MAX_IN)
MAX_INSTR = 32  # instructions (EW_MAX_INSTR)
CREG = 4  # registers of the amortized interpreter (EW_CREG)
IMM = -1  # an operand that is the instruction's own constant (EW_IMM)

# type codes (EW_F32 ...)
F32, BF16, I32, BOOL = 0, 1, 2, 3
TYPE_CODE = {torch.float32: F32, torch.bfloat16: BF16, torch.int32: I32, torch.bool: BOOL}
CODE_TYPE = {v: k for k, v in TYPE_CODE.items()}

# op codes (EW_CONST ...)
(CONST, CAST, ADD, SUB, MUL, DIV, DIVC, POW, POWC, MOD, MIN, MAX,
 LT, LE, GT, GE, EQ, NE, NEG, ABS, WHERE, EXP, SIN) = range(23)
_CMP = (LT, LE, GT, GE, EQ, NE)
TRANSCENDENTAL = (EXP, SIN)  # the ops only K4's streaming map runs


class Ineligible(Exception):
    """``f`` cannot be carried into a kernel as a program."""


@dataclass(frozen=True)
class Instr:
    op: int
    type: int  # compute type; for CAST the destination, for compares the operands'
    a: int = 0
    b: int = 0
    c: int = 0  # WHERE's third operand; CAST's source type
    cf: float = 0.0  # float constant (CONST, DIVC's reciprocal, POWC's exponent, IMM)
    ci: int = 0  # int constant
    cv: object = None  # the constant as written (plain evaluator)
    scalar: bool = False  # CONST from a Python scalar operand (not a fill)
    dst: int = 0  # result register (compacted programs; traced ones use n_in + index)


@dataclass(frozen=True)
class Program:
    in_dtypes: Tuple[torch.dtype, ...]
    instrs: Tuple[Instr, ...]
    out: int
    out_dtype: torch.dtype
    n_reg: int = 0  # registers of a compacted program (0: traced, one per value)


_BINARY = {
    torch.add: ADD, torch.sub: SUB, torch.subtract: SUB,
    torch.mul: MUL, torch.multiply: MUL,
    torch.true_divide: DIV, torch.div: DIV, torch.divide: DIV,
    torch.pow: POW, torch.remainder: MOD,
    torch.minimum: MIN, torch.maximum: MAX,
    torch.lt: LT, torch.less: LT, torch.le: LE, torch.less_equal: LE,
    torch.gt: GT, torch.greater: GT, torch.ge: GE, torch.greater_equal: GE,
    torch.eq: EQ, torch.ne: NE, torch.not_equal: NE,
}
_UNARY = {torch.neg: NEG, torch.negative: NEG, torch.abs: ABS, torch.absolute: ABS,
          torch.exp: EXP, torch.Tensor.exp: EXP, torch.sin: SIN, torch.Tensor.sin: SIN}
_FILLS = {torch.full_like: None, torch.zeros_like: 0, torch.ones_like: 1}
_TORCH_OF = {ADD: torch.add, SUB: torch.sub, MUL: torch.mul, DIV: torch.true_divide,
             DIVC: torch.true_divide, POW: torch.pow, POWC: torch.pow,
             MOD: torch.remainder, MIN: torch.minimum, MAX: torch.maximum,
             LT: torch.lt, LE: torch.le, GT: torch.gt, GE: torch.ge, EQ: torch.eq,
             NE: torch.ne, NEG: torch.neg, ABS: torch.abs, EXP: torch.exp, SIN: torch.sin}


def _is_scalar(x) -> bool:
    return isinstance(x, numbers.Real) and not isinstance(x, bool)


def _probe(dtype):
    """A one-element CPU tensor of ``dtype`` (ones, so no op on it fails for
    its value) that an operation runs on to give torch's result dtype.
    Eager CPU ops on one element cost microseconds; meta tensors go through
    Python reference implementations and cost a hundred times more."""
    return torch.ones(1, dtype=dtype)


@functools.lru_cache(maxsize=4096, typed=True)
def _dtype_of(func, *operands):
    """The dtype ``func`` gives on ``operands``: a dtype stands for a traced
    value of it (a probe), anything else for itself (a Python scalar).
    Cached, since the answer depends on these alone: a trace then runs no
    torch operation for an (op, operands) it has met (typed, so ``1`` and
    ``1.0`` are kept apart)."""
    r = func(*[_probe(o) if isinstance(o, torch.dtype) else o for o in operands])
    return r if isinstance(r, torch.dtype) else r.dtype


def _f32(x) -> float:
    return float(np.float32(x))


class _Builder:
    def __init__(self, in_dtypes):
        self.instrs: List[Instr] = []
        self.n_in = len(in_dtypes)

    def emit(self, dtype, **kw) -> "_Sym":
        if len(self.instrs) >= MAX_INSTR:
            raise Ineligible(f"more than {MAX_INSTR} operations")
        self.instrs.append(Instr(**kw))
        return _Sym(self, self.n_in + len(self.instrs) - 1, dtype)

    def cast(self, s: "_Sym", dtype) -> int:
        if s.dtype == dtype:
            return s.reg
        return self.emit(dtype, op=CAST, type=_code(dtype), a=s.reg,
                         c=_code(s.dtype)).reg

    def operand(self, x, ct) -> int:
        if isinstance(x, _Sym):
            return self.cast(x, ct)
        return self.const(x, ct, scalar=True).reg

    def const(self, v, dtype, scalar=False) -> "_Sym":
        code = _code(dtype)
        if code == I32:
            if int(v) != v or not -2**31 <= int(v) < 2**31:
                raise Ineligible(f"constant {v!r} is not an int32")
            return self.emit(dtype, op=CONST, type=code, ci=int(v), cv=v, scalar=scalar)
        if code == BOOL:
            return self.emit(dtype, op=CONST, type=code, ci=int(bool(v)), cv=v, scalar=scalar)
        # a scalar operand enters the op in f32 (torch's opmath); a fill is
        # a value of its own dtype
        cf = _f32(v) if scalar else float(torch.tensor(v, dtype=dtype))
        return self.emit(dtype, op=CONST, type=code, cf=cf, cv=v, scalar=scalar)


def _code(dtype) -> int:
    if dtype not in TYPE_CODE:
        raise Ineligible(f"dtype {dtype} is not modelled")
    return TYPE_CODE[dtype]


class _Sym:
    """A placeholder value while tracing: a register of the program."""

    __slots__ = ("b", "reg", "dtype")

    def __init__(self, b: _Builder, reg: int, dtype):
        self.b, self.reg, self.dtype = b, reg, dtype

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _dispatch(func, args, kwargs or {})

    def to(self, *args, **kwargs):
        dtype = kwargs.pop("dtype", None)
        for a in args:
            if isinstance(a, torch.dtype):
                dtype = a
            else:
                raise Ineligible(f".to({a!r}) is not modelled")
        if dtype is None or kwargs:
            raise Ineligible(".to() without a dtype, or with options")
        _code(dtype)
        return _Sym(self.b, self.b.cast(self, dtype), dtype)

    def float(self):
        return self.to(torch.float32)

    def int(self):
        return self.to(torch.int32)

    def bfloat16(self):
        return self.to(torch.bfloat16)

    def abs(self):
        return _unary(ABS, self)

    def neg(self):
        return _unary(NEG, self)

    def exp(self):
        return _unary(EXP, self)

    def sin(self):
        return _unary(SIN, self)

    __hash__ = object.__hash__
    __neg__ = neg
    __abs__ = abs


def _install_operators():
    pairs = [("add", torch.add), ("sub", torch.sub), ("mul", torch.mul),
             ("truediv", torch.true_divide), ("pow", torch.pow),
             ("mod", torch.remainder)]
    for name, fn in pairs:
        setattr(_Sym, f"__{name}__", lambda s, o, fn=fn: _binary(fn, s, o))
        setattr(_Sym, f"__r{name}__", lambda s, o, fn=fn: _binary(fn, o, s))
    # torch's ``scalar / tensor`` is ``tensor.reciprocal() * scalar``
    _Sym.__rtruediv__ = lambda s, o: _binary(torch.mul, _binary(torch.true_divide, 1, s), o)
    for name, fn in [("lt", torch.lt), ("le", torch.le), ("gt", torch.gt),
                     ("ge", torch.ge), ("eq", torch.eq), ("ne", torch.ne)]:
        setattr(_Sym, f"__{name}__", lambda s, o, fn=fn: _binary(fn, s, o))


_install_operators()


def _dispatch(func, args, kwargs):
    if func in _BINARY and len(args) == 2 and not kwargs:
        return _binary(func, *args)
    if func in _UNARY and len(args) == 1 and not kwargs:
        return _unary(_UNARY[func], args[0])
    if func in _FILLS and args and isinstance(args[0], _Sym):
        return _fill(func, args, kwargs)
    if func is torch.where and len(args) == 3 and not kwargs:
        return _where(*args)
    if func is torch.Tensor.to:
        return args[0].to(*args[1:], **kwargs)
    name = getattr(func, "__name__", repr(func))
    raise Ineligible(f"operation {name} is outside the elementwise program's table")


def _check_operand(x):
    if not isinstance(x, _Sym) and not _is_scalar(x):
        raise Ineligible(f"closure captures a {type(x).__name__}")


def _kind(x):
    """``x`` as :func:`_dtype_of` takes it: a traced value's dtype, or the scalar."""
    return x.dtype if isinstance(x, _Sym) else x


def _binary(func, x, y):
    _check_operand(x)
    _check_operand(y)
    op = _BINARY[func]
    b = x.b if isinstance(x, _Sym) else y.b
    try:
        rd = _dtype_of(func, _kind(x), _kind(y))
        ct = _dtype_of(torch.result_type, _kind(x), _kind(y)) if op in _CMP else rd
    except Exception as e:  # noqa: BLE001 - torch refuses the operands
        raise Ineligible(f"{func.__name__}: {e}") from e
    _code(rd)
    if _code(ct) == BOOL:
        raise Ineligible(f"{func.__name__} on bool operands is not modelled")
    code = _code(ct)
    if isinstance(x, _Sym) and _is_scalar(y) and op == DIV and code in (F32, BF16):
        with np.errstate(divide="ignore"):
            recip = float(np.float32(1.0) / np.float32(y))
        return b.emit(rd, op=DIVC, type=code, a=b.cast(x, ct), cf=recip, cv=y)
    if isinstance(x, _Sym) and _is_scalar(y) and op == POW:
        if code == I32 and (int(y) != y or y < 0):
            raise Ineligible("integer power with a negative or fractional exponent")
        return b.emit(rd, op=POWC, type=code, a=b.cast(x, ct), cf=_f32(y),
                      ci=int(y) if code == I32 else 0, cv=y)
    ra, rb = b.operand(x, ct), b.operand(y, ct)
    return b.emit(rd, op=op, type=code, a=ra, b=rb)


def _unary(op, x):
    _check_operand(x)
    if not isinstance(x, _Sym):
        raise Ineligible("unary op on a constant")
    if _code(x.dtype) == BOOL:
        raise Ineligible("unary op on bool is not modelled")
    if op in TRANSCENDENTAL:  # torch computes an int32 operand in f32
        rd = _dtype_of(_TORCH_OF[op], x.dtype)
        return x.b.emit(rd, op=op, type=_code(rd), a=x.b.cast(x, rd))
    return x.b.emit(x.dtype, op=op, type=_code(x.dtype), a=x.reg)


def _fill(func, args, kwargs):
    x = args[0]
    value = _FILLS[func]
    rest = list(args[1:])
    if value is None:
        if not rest:
            raise Ineligible("full_like without a value")
        value = rest.pop(0)
    dtype = kwargs.pop("dtype", None) or x.dtype
    if rest or kwargs or not (_is_scalar(value) or isinstance(value, bool)):
        raise Ineligible("fill with options or a non-scalar value")
    return x.b.const(value, dtype)


def _where(cond, x, y):
    for z in (cond, x, y):
        _check_operand(z)
    if not isinstance(cond, _Sym) or cond.dtype != torch.bool:
        raise Ineligible("where needs a traced bool condition")
    b = cond.b
    try:
        rd = _dtype_of(torch.where, torch.bool, _kind(x), _kind(y))
    except Exception as e:  # noqa: BLE001
        raise Ineligible(f"where: {e}") from e
    code = _code(rd)
    if code == BOOL:
        raise Ineligible("where on bool values is not modelled")
    ra, rb = b.operand(x, rd), b.operand(y, rd)
    return b.emit(rd, op=WHERE, type=code, a=cond.reg, b=ra, c=rb)


def trace(f: Callable, in_dtypes: Sequence[torch.dtype], out_dtype=None) -> Program:
    """Trace ``f`` on placeholder leaves of ``in_dtypes`` into a
    :class:`Program`. With ``out_dtype`` the result is cast to it. Raises
    :class:`Ineligible` (see the module docstring)."""
    in_dtypes = tuple(in_dtypes)
    if len(in_dtypes) > MAX_IN:
        raise Ineligible(f"more than {MAX_IN} operands")
    for d in in_dtypes:
        if _code(d) == BOOL:
            raise Ineligible("bool operands are not modelled")
    b = _Builder(in_dtypes)
    leaves = [_Sym(b, i, d) for i, d in enumerate(in_dtypes)]
    try:
        res = f(*leaves)
    except Ineligible:
        raise
    except Exception as e:  # noqa: BLE001 - anything f does outside the table
        raise Ineligible(f"f not traceable: {type(e).__name__}: {e}") from e
    if _is_scalar(res):
        res = b.const(res, torch.tensor(res).dtype)
    if not isinstance(res, _Sym):
        raise Ineligible(f"f returned a {type(res).__name__}")
    if out_dtype is not None and res.dtype != out_dtype:
        res = _Sym(b, b.cast(res, out_dtype), out_dtype)
    return Program(in_dtypes, tuple(b.instrs), res.reg, res.dtype)


def evaluate(prog: Program, leaves: Sequence[torch.Tensor], like=None) -> torch.Tensor:
    """The program's plain PyTorch version: each instruction as the torch
    operation it was traced from, on dense tensors of one shape (``like``
    gives the shape and device where there are no leaves)."""
    regs: list = list(leaves)
    like = leaves[0] if leaves else (like if like is not None else torch.empty(()))
    for ins in prog.instrs:
        if ins.op == CONST:
            v = ins.cv if ins.scalar else torch.full_like(like, ins.cv,
                                                          dtype=CODE_TYPE[ins.type])
        elif ins.op == CAST:
            v = regs[ins.a].to(CODE_TYPE[ins.type])
        elif ins.op in (DIVC, POWC):
            v = _TORCH_OF[ins.op](regs[ins.a], ins.cv)
        elif ins.op in (NEG, ABS, EXP, SIN):
            v = _TORCH_OF[ins.op](regs[ins.a])
        elif ins.op == WHERE:
            v = torch.where(regs[ins.a], regs[ins.b], regs[ins.c])
        else:
            v = _TORCH_OF[ins.op](regs[ins.a], regs[ins.b])
        regs.append(v)
    out = regs[prog.out]
    if not isinstance(out, torch.Tensor) or out.shape != like.shape:
        out = torch.as_tensor(out, device=like.device).to(prog.out_dtype).expand(like.shape)
    return out


_FOLD_BINARY = (ADD, SUB, MUL, DIV, POW, MOD, MIN, MAX) + _CMP


def operand_slots(ins: Instr) -> Tuple[str, ...]:
    """The fields of ``ins`` that name registers (or IMM)."""
    if ins.op == CONST:
        return ()
    if ins.op in (CAST, DIVC, POWC, NEG, ABS, EXP, SIN):
        return ("a",)
    if ins.op == WHERE:
        return ("a", "b", "c")
    return ("a", "b")


def transcendental(prog: Program) -> bool:
    """Whether ``prog`` holds an op of :data:`TRANSCENDENTAL`."""
    return any(i.op in TRANSCENDENTAL for i in prog.instrs)


def compact(prog: Program) -> Program:
    """The program as the kernels run it, computing the same values:

    - a scalar or fill ``CONST`` that a binary op (slots a, b) or ``where``
      (slots b, c) reads in its own compute type becomes that instruction's
      immediate (operand ``IMM``, value in ``cf``/``ci``), one a instruction;
    - instructions whose value nothing reads are dropped;
    - registers are reused: leaves sit in registers ``0 .. n_in``, and each
      result takes the lowest register free after its operands' last reads
      (a result may take the register of an operand read for the last time,
      since an instruction reads all its operands before it writes).

    ``n_reg`` is then the most registers live at once (at least ``n_in``);
    a program with ``n_reg <= CREG`` runs on the amortized interpreter."""
    if prog.n_reg:
        return prog
    n_in = len(prog.in_dtypes)
    ins = list(prog.instrs)
    for k, I in enumerate(ins):
        slots = ("b", "a") if I.op in _FOLD_BINARY else ("c", "b") if I.op == WHERE else ()
        for s in slots:
            r = getattr(I, s)
            c = ins[r - n_in] if r >= n_in else None
            if c is not None and c.op == CONST and c.type == I.type:
                ins[k] = replace(I, **{s: IMM}, cf=c.cf, ci=c.ci, cv=c.cv, scalar=c.scalar)
                break
    live, order = {prog.out}, []
    for k in reversed(range(len(ins))):
        if n_in + k in live:
            order.append(k)
            live.update(getattr(ins[k], s) for s in operand_slots(ins[k]))
    order.reverse()
    last = {prog.out: len(order)}
    for j, k in enumerate(order):
        for s in operand_slots(ins[k]):
            if getattr(ins[k], s) != IMM:
                last[getattr(ins[k], s)] = j
    reg = {i: i for i in range(n_in)}
    free = [i for i in range(n_in) if i not in last]
    n_reg, out = n_in, []
    for j, k in enumerate(order):
        I = ins[k]
        regs = {s: getattr(I, s) for s in operand_slots(I) if getattr(I, s) != IMM}
        free += sorted({reg[r] for r in regs.values() if last[r] == j})
        free.sort()
        d = free.pop(0) if free else n_reg
        n_reg = max(n_reg, d + 1)
        reg[n_in + k] = d
        out.append(replace(I, dst=d, **{s: reg[r] for s, r in regs.items()}))
    return Program(prog.in_dtypes, tuple(out), reg[prog.out], prog.out_dtype, max(n_reg, 1))


def result_dtype(f: Callable, dtypes: Sequence[torch.dtype]) -> torch.dtype:
    """Result dtype of elementwise ``f`` on dense operands of ``dtypes``
    (torch's promotion, on one-element CPU tensors)."""
    res = f(*[_probe(d) for d in dtypes])
    return res.dtype if isinstance(res, torch.Tensor) else torch.as_tensor(res).dtype


# -- the C layout (csrc/ewise.cuh) -------------------------------------------


class CInstr(ctypes.Structure):
    _fields_ = [("op", ctypes.c_int32), ("type", ctypes.c_int32),
                ("a", ctypes.c_int32), ("b", ctypes.c_int32), ("c", ctypes.c_int32),
                ("cf", ctypes.c_float), ("ci", ctypes.c_int32), ("dst", ctypes.c_int32)]


class CProgram(ctypes.Structure):
    _fields_ = [("n_in", ctypes.c_int32), ("n_instr", ctypes.c_int32),
                ("out", ctypes.c_int32), ("out_type", ctypes.c_int32),
                ("n_reg", ctypes.c_int32),
                ("in_type", ctypes.c_int32 * MAX_IN),
                ("ins", CInstr * MAX_INSTR)]


def to_c(prog: Program) -> CProgram:
    """The compacted program (:func:`compact`) in csrc/ewise.cuh's layout;
    cached, so a kernel launched again with the same closure packs nothing
    (callers copy it or pass it by reference, and never change it). The
    cache key holds each constant's bits: ``0.0 == -0.0`` would otherwise
    let one program take the other's packed immediate."""
    return _to_c(prog, tuple(struct.pack("<d", i.cf) for i in prog.instrs))


@functools.lru_cache(maxsize=1024)
def _to_c(prog: Program, _cf_bits: tuple) -> CProgram:
    prog = compact(prog)
    p = CProgram()
    p.n_in = len(prog.in_dtypes)
    p.n_instr = len(prog.instrs)
    p.out = prog.out
    p.out_type = TYPE_CODE[prog.out_dtype]
    p.n_reg = prog.n_reg
    for i, d in enumerate(prog.in_dtypes):
        p.in_type[i] = TYPE_CODE[d]
    for k, ins in enumerate(prog.instrs):
        p.ins[k] = CInstr(ins.op, ins.type, ins.a, ins.b, ins.c, ins.cf, ins.ci, ins.dst)
    return p
