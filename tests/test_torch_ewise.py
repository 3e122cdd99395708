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


SPLIT_SHAPES = [pytest.param(N, M, vec, tsr.SLOTS, id=f"{N}-{M}-{vec}") for N, M, vec in (
    (8192, 8192, 8), (8192, 8192, 1), (8192, 4096, 8), (100, 8192, 1), (65536, 64, 1), (1, 1, 1),
    (7, 33, 1), (300, 1, 1), (300, 520, 8), (1000, 24, 8), (8192, 1 << 20, 8), (123457, 999, 1))]
SPLIT_SHAPES += [  # a program's kernels: fewer blocks an SM (3 on 8 columns a thread, 2 on one)
    pytest.param(N, M, vec, (3 if vec == tsr.NV else 2) * tsr.SMS, id=f"{N}-{M}-{vec}-program")
    for N, M, vec in ((8192, 8192, 8), (8192, 4096, 8), (1000, 3000, 8), (1000, 3001, 1),
                      (24, 3000, 8), (8192, 1 << 20, 8), (8192, 8192, 1))]


@pytest.mark.parametrize("N,M,vec,slots", SPLIT_SHAPES)
def test_row_chunks_is_one_wave_of_whole_steps(N, M, vec, slots):
    chunks, rows = tsr.row_chunks(N, M, vec, slots)
    col_blocks = -(-M // (tsr.COLS * vec))
    assert rows % tsr.STEP == 0 and rows > 0
    assert (chunks - 1) * rows < N <= chunks * rows  # every row in one chunk, none empty
    if col_blocks <= slots:
        assert col_blocks * chunks <= slots  # every block resident in the one wave
        # as tall as that allows: one step shorter would need more blocks
        assert rows == tsr.STEP or -(-N // (rows - tsr.STEP)) * col_blocks > slots
    else:
        assert chunks == 1
    assert tsr.row_chunks(N, M, vec, slots) == (chunks, rows)


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


def test_stream_reduce_path_report_matches_the_cuda_source():
    """The launcher's ``*path`` (csrc/stream_reduce.cu: SR_IDENTITY,
    SR_AMORTIZED, SR_SCALAR, | SR_VECTOR) names the kernel and the width in
    ``stream_reduce.PATHS``; a code the launcher cannot give raises."""
    text = (CSRC / "stream_reduce.cu").read_text()
    codes = dict((k, int(v)) for k, v in re.findall(r"\b(SR_\w+) = (\d+)", text))
    assert codes == {"SR_IDENTITY": 0, "SR_AMORTIZED": 1, "SR_SCALAR": 2, "SR_VECTOR": tsr.SR_VECTOR}
    names = {}
    for k, kernel in enumerate(tsr.KERNELS):
        assert codes["SR_" + kernel.upper()] == k
        for width, bit in (("column", 0), ("vector", codes["SR_VECTOR"])):
            names[k | bit] = f"{kernel}/{width}"
    assert {tsr.path_name(c) for c in names} == set(tsr.PATHS) and len(names) == 6
    assert all(tsr.path_name(c) == n for c, n in names.items())
    for bad in (-1, 3, 7, 8):
        with pytest.raises(RuntimeError):
            tsr.path_name(bad)


def test_stream_reduce_kernels_are_sized_by_their_launch_bounds():
    """One owner of K3's launch policy: every kernel's ``__launch_bounds__``
    promises the blocks an SM that ``launch_shape`` reports to
    ``stream_reduce.split`` (``IDENTITY_BLOCKS``, ``program_blocks`` of the
    register file the launcher picks), and the launcher picks the program
    kernel by that register file, so a change to either moves both."""
    text = re.sub(r"//[^\n]*", "", (CSRC / "stream_reduce.cu").read_text())
    bounds = dict((k, b) for b, k in re.findall(
        r"__launch_bounds__\(THREADS, (.*?)\)\s*\n\s*(reduce_\w+)\(", text))
    assert bounds == {"reduce_identity": "IDENTITY_BLOCKS",
                      "reduce_program": "program_blocks(R, VEC)"}
    shape = re.search(r"void launch_shape\(.*?\n\}", text, re.S).group(0)
    assert "IDENTITY_BLOCKS" in shape and "program_blocks(register_file(n_reg, " in shape
    launcher = re.search(r'extern "C" int strided_stream_reduce\(.*', text, re.S).group(0)
    assert "launch_shape(prog->n_instr, prog->n_reg" in launcher
    assert "const int r = register_file(prog->n_reg, vec == NV);" in launcher
    assert "pick_program<true>(r, vec == NV)" in launcher


def test_a_marked_map_is_traced_once_per_key_and_types(monkeypatch):
    """K3's plan of a map marked with ``kernels_special.pure`` (the traced
    program, its result dtype, the operand's layout) is made once per key,
    fold, operand type and layout, and served to every equal key after; an
    unmarked closure is planned on every call."""
    from strided_tpu_torch import config as tcfg, strided, transpose
    from strided_tpu_torch.core import kernels_special as tks

    traced = []
    trace = ewise.trace
    monkeypatch.setattr(ewise, "trace", lambda f, *a, **k: traced.append(f) or trace(f, *a, **k))
    monkeypatch.setattr(tks, "_PLANS", {})
    scale = lambda c: tks.pure(lambda x: x * c, ("scale", c))  # noqa: E731
    x = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    v = strided(x, device="cpu")
    old = tcfg.get_config().min_stream_reduce_elements
    tcfg.set_config(min_stream_reduce_elements=1)
    try:
        steps = [  # (map, view, reduced axis, want, traces so far)
            (scale(0.25), v, 0, (x * 0.25).sum(0), 1),
            (scale(0.25), v, 0, (x * 0.25).sum(0), 1),
            (scale(0.5), v, 0, (x * 0.5).sum(0), 2),
            (scale(0.25), strided(x.bfloat16(), device="cpu"), 0,
             (x.bfloat16() * 0.25).sum(0, dtype=torch.bfloat16), 3),
            (scale(0.25), transpose(v), 1, (x * 0.25).sum(0), 4),
            (scale(0.25), transpose(v), 1, (x * 0.25).sum(0), 4),
            (lambda t: t * 0.25, v, 0, (x * 0.25).sum(0), 5),
            (lambda t: t * 0.25, v, 0, (x * 0.25).sum(0), 6),
        ]
        for f, view, axis, want, n in steps:
            got = tks.try_stream_reduce(f, torch.add, view, (axis,))
            assert got.dtype == want.dtype and torch.equal(got, want)
            assert len(traced) == n
    finally:
        tcfg.set_config(min_stream_reduce_elements=old)


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
