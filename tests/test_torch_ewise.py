"""The compacted elementwise programs that K3 and K4 interpret, K3's work
split, and the C layouts the wrappers pack for the CUDA sources.

- Every program of the table in ``test_torch_engine_kernels.py`` (each op and
  dtype), compacted by ``ewise.compact`` (constants folded into immediates,
  dead values dropped, registers reused by liveness) and run by a plain
  evaluator of the compacted form that honours the register reuse, equals
  ``ewise.evaluate`` on the traced program bit for bit.
- ``row_chunks`` depends on the shape alone: one wave of blocks, chunks of
  a whole number of 64-row steps, every row in exactly one chunk.
- The ctypes structures (``ewise.CProgram``, ``executor_cuda._CParams``) put
  every field at the offset the C structures of ``csrc/ewise.cuh`` and
  ``csrc/tile_executor.cu`` give it.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from strided_tpu_torch.core import ewise
from strided_tpu_torch.core import executor_cuda as tec
from strided_tpu_torch.core import stream_reduce as tsr

from test_torch_engine_kernels import OPS, _leaves

CSRC = Path(tec.__file__).resolve().parents[1] / "csrc"


def run_compact(cp: ewise.Program, leaves, like):
    """A plain evaluator of the compacted form: registers are overwritten as
    the kernels overwrite them, and an IMM operand is the instruction's own
    constant."""
    regs = dict(enumerate(leaves))

    def operand(ins, slot):
        r = getattr(ins, slot)
        if r != ewise.IMM:
            return regs[r]
        if ins.scalar:
            return ins.cv
        return torch.full_like(like, ins.cv, dtype=ewise.CODE_TYPE[ins.type])

    for ins in cp.instrs:
        if ins.op == ewise.CONST:
            v = ins.cv if ins.scalar else torch.full_like(like, ins.cv,
                                                          dtype=ewise.CODE_TYPE[ins.type])
        elif ins.op == ewise.CAST:
            v = operand(ins, "a").to(ewise.CODE_TYPE[ins.type])
        elif ins.op in (ewise.DIVC, ewise.POWC):
            v = ewise._TORCH_OF[ins.op](operand(ins, "a"), ins.cv)
        elif ins.op in (ewise.NEG, ewise.ABS):
            v = ewise._TORCH_OF[ins.op](operand(ins, "a"))
        elif ins.op == ewise.WHERE:
            v = torch.where(operand(ins, "a"), operand(ins, "b"), operand(ins, "c"))
        else:
            v = ewise._TORCH_OF[ins.op](operand(ins, "a"), operand(ins, "b"))
        regs[ins.dst] = v
    out = regs[cp.out]
    if not isinstance(out, torch.Tensor) or out.shape != like.shape:
        out = torch.as_tensor(out).to(cp.out_dtype).expand(like.shape)
    return out


@pytest.mark.parametrize("name,dtype", [(n, d) for n, (_, ds) in OPS.items() for d in ds])
def test_compacted_program_equals_the_traced_one(name, dtype):
    f, _ = OPS[name]
    x, y = _leaves(dtype, seed=3)
    prog = ewise.trace(f, [dtype, dtype])
    cp = ewise.compact(prog)
    want = ewise.evaluate(prog, [x, y])
    got = run_compact(cp, [x, y], like=x)
    assert got.dtype == want.dtype == cp.out_dtype
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert len(cp.instrs) <= len(prog.instrs)
    regs = [ins.dst for ins in cp.instrs] + [cp.out]
    assert cp.n_reg >= 2 and all(0 <= r < cp.n_reg for r in regs)
    for ins in cp.instrs:  # operands name registers written before, or the immediate
        for s in ewise.operand_slots(ins):
            assert getattr(ins, s) == ewise.IMM or 0 <= getattr(ins, s) < cp.n_reg
    assert ewise.compact(cp) is cp


def test_compaction_folds_constants_and_reuses_registers():
    cp = ewise.compact(ewise.trace(lambda x, y: x * 3 + y, [torch.float32] * 2))
    assert [(i.op, i.dst, i.a, i.b) for i in cp.instrs] == [
        (ewise.MUL, 0, 0, ewise.IMM), (ewise.ADD, 0, 0, 1)]
    assert cp.instrs[0].cf == 3.0 and cp.out == 0 and cp.n_reg == 2
    ident = ewise.compact(ewise.trace(lambda x, y: y, [torch.int32] * 2))
    assert (ident.instrs, ident.out, ident.n_reg) == ((), 1, 2)
    wide = ewise.compact(ewise.trace(lambda t: (t + 1) * ((t + 2) * ((t + 3) * (t + 4))) + t,
                                     [torch.float32]))
    assert wide.n_reg == 5 > ewise.CREG  # the scalar interpreter's programs
    where = ewise.compact(ewise.trace(lambda x, y: torch.where(x < y, x * 2, 5),
                                      [torch.float32] * 2))
    assert where.n_reg == 2 and where.instrs[-1].c == ewise.IMM and where.instrs[-1].cf == 5.0


SPLIT_SHAPES = [(8192, 8192, 8), (8192, 8192, 1), (8192, 4096, 8), (100, 8192, 1),
                (65536, 64, 1), (1, 1, 1), (7, 33, 1), (300, 1, 1), (300, 520, 8),
                (1000, 24, 8), (8192, 1 << 20, 8), (123457, 999, 1)]


@pytest.mark.parametrize("N,M,vec", SPLIT_SHAPES)
def test_row_chunks_is_one_wave_of_whole_steps(N, M, vec):
    chunks, rows = tsr.row_chunks(N, M, vec)
    col_blocks = -(-M // (tsr.COLS * vec))
    assert rows % tsr.STEP == 0 and rows > 0
    assert (chunks - 1) * rows < N <= chunks * rows  # every row in one chunk, none empty
    if col_blocks <= tsr.SLOTS:
        assert col_blocks * chunks <= tsr.SLOTS  # every block resident in the one wave
        # as tall as that allows: one step shorter would need more blocks
        assert rows == tsr.STEP or -(-N // (rows - tsr.STEP)) * col_blocks > tsr.SLOTS
    else:
        assert chunks == 1
    assert tsr.row_chunks(N, M, vec) == (chunks, rows)


_SIZES = {"int32_t": (4, 4), "float": (4, 4), "int64_t": (8, 8), "void*": (8, 8),
          "EwVal*": (8, 8)}


def _c_layout(name, text, macros, layouts):
    """(field names, offsets, size, alignment) of C struct ``name`` in text."""
    body = re.search(r"struct %s \{(.*?)\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names, offsets, off, align = [], [], 0, 1
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        decl = decl.replace("const ", "")
        ctype, rest = re.match(r"([\w]+\s*\*?)\s+(.*)", decl).groups()
        ctype = ctype.replace(" ", "")
        for item in rest.split(","):
            item = item.strip()
            ptr = item.startswith("*")
            m = re.match(r"\*?(\w+)(?:\[(\w+)\])?", item)
            fname, count = m.group(1), m.group(2)
            n = int(macros.get(count, count)) if count else 1
            size, al = _SIZES["void*" if ptr else ctype] if (ptr or ctype in _SIZES) \
                else layouts[ctype][2:]
            off = -(-off // al) * al
            names.append(fname)
            offsets.append(off)
            off += size * n
            align = max(align, al)
    size = -(-off // align) * align
    layouts[name] = (names, offsets, size, align)
    return layouts[name]


def _ctypes_layout(cls):
    return [f[0] for f in cls._fields_], [getattr(cls, f[0]).offset for f in cls._fields_]


def test_c_layouts_match_the_cuda_sources():
    text = (CSRC / "ewise.cuh").read_text() + (CSRC / "tile_executor.cu").read_text()
    macros = dict(re.findall(r"#define (\w+) \(?(-?\d+)\)?", text))
    macros["TE_MAX_IN"] = macros["EW_MAX_IN"]  # #define TE_MAX_IN EW_MAX_IN
    assert (int(macros["EW_MAX_IN"]), int(macros["EW_MAX_INSTR"]), int(macros["EW_CREG"]),
            int(macros["EW_IMM"])) == (ewise.MAX_IN, ewise.MAX_INSTR, ewise.CREG, ewise.IMM)
    layouts = {}
    for cname, cls in (("EwInstr", ewise.CInstr), ("EwProgram", ewise.CProgram),
                       ("TeOperand", tec._COperand), ("TeParams", tec._CParams)):
        names, offsets, size, _ = _c_layout(cname, text, macros, layouts)
        pnames, poffsets = _ctypes_layout(cls)
        assert offsets == poffsets and size == ctypes.sizeof(cls), cname
        if cname == "TeParams":  # ``in`` is a Python keyword
            pnames = ["in" if n == "ins" else n for n in pnames]
        assert names == pnames, cname


def test_to_c_packs_the_compacted_program():
    prog = ewise.trace(lambda x, y: torch.where(x < 0, -x, y * 2), [torch.float32] * 2)
    cp, c = ewise.compact(prog), ewise.to_c(prog)
    assert (c.n_in, c.n_instr, c.out, c.n_reg) == (2, len(cp.instrs), cp.out, cp.n_reg)
    for k, ins in enumerate(cp.instrs):
        got = c.ins[k]
        assert (got.op, got.type, got.a, got.b, got.c, got.ci, got.dst) == (
            ins.op, ins.type, ins.a, ins.b, ins.c, ins.ci, ins.dst)
        assert got.cf == np.float32(ins.cf)
    raw = bytes(c)[ewise.CProgram.ins.offset + ctypes.sizeof(ewise.CInstr) - 4:][:4]
    assert int.from_bytes(raw, "little", signed=True) == cp.instrs[0].dst


def _cf_bits(c: ewise.CProgram, k: int) -> bytes:
    off = ewise.CProgram.ins.offset + k * ctypes.sizeof(ewise.CInstr) + ewise.CInstr.cf.offset
    return bytes(c)[off:off + 4]


@pytest.mark.parametrize("f", [lambda t, z: t * z, lambda t, z: torch.where(t < 1, t, z)],
                         ids=["mul", "where"])
def test_to_c_keeps_the_sign_of_a_zero_constant(f):
    """``0.0 == -0.0`` and both hash alike: the packed program of one must not
    be served for the other, or the kernel's result loses the sign eager
    PyTorch gives it."""
    progs = [ewise.trace(lambda t, z=z: f(t, z), [torch.float32]) for z in (0.0, -0.0, 0.0)]
    assert progs[0] == progs[1]  # equal as dataclasses: the cache key must see the bits
    packed = [_cf_bits(ewise.to_c(p), len(ewise.compact(p).instrs) - 1) for p in progs]
    assert packed[0] == packed[2] == np.float32(0.0).tobytes()
    assert packed[1] == np.float32(-0.0).tobytes()
