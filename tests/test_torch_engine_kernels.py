"""The plain PyTorch versions of the engine's kernels against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs; and
the elementwise programs that carry ``f`` into the kernels.

- K2 ``pair_axpby`` against ``strided_tpu``'s tile-pair kernel (tile 128) at
  n in {256, 300}, same and distinct buffers, f32 and bf16. Exact where no
  coefficient multiplies (``(a + a.T)/2``, ``a - a.T``, ``* 0.5``); else one
  ulp of the terms' summed magnitude (f32: 2^-23, bf16: 2^-8), because XLA
  on the CPU may contract a product into an FMA, or keep bf16 values in
  f32 between fused operations, where eager PyTorch rounds every operation.
- K3 ``stream_reduce`` against ``_stream_reduce_2d`` at (512, 256): exact
  for max and for int32; f32 sums within 1e-6 * rows * max|a| and products
  within a relative 1e-6 * rows (the fold order differs).
- K4 ``tile_executor`` against the Pallas executor on the reference's two
  bench checks at small size: a scrambled-layout copy (exact) and the int32
  ``3*old + sum over axis 0`` reduction (exact).
- Each op of the program table through ``ewise.evaluate`` equals the
  direct torch op, bit for bit (``exp`` and ``sin`` too, an int32 operand
  promoted to f32 first); each ineligible closure is declined.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import strided_tpu as jst  # noqa: E402
from strided_tpu import config as jcfg  # noqa: E402
from strided_tpu.core import executor_pallas as jep  # noqa: E402
from strided_tpu.core import kernels_special as jks  # noqa: E402
import strided_tpu_torch as tst  # noqa: E402
from strided_tpu_torch import config as tcfg  # noqa: E402
from strided_tpu_torch.core import ewise  # noqa: E402
from strided_tpu_torch.core import executor_cuda as tec  # noqa: E402
from strided_tpu_torch.core import kernels_special as tks  # noqa: E402
from strided_tpu_torch.core import stream_reduce as tsr  # noqa: E402


@pytest.fixture(autouse=True)
def gates():
    jold, told = jcfg.get_config(), tcfg.get_config()
    jcfg.set_config(use_pallas=True, min_pallas_elements=1024, pallas_map_min_elements=1024,
                    pair_kernel_min_elements=1024, pallas_reductions=True)
    tcfg.set_config(use_kernels=True, min_kernel_elements=1024, map_min_elements=1024,
                    pair_kernel_min_elements=1024, kernel_reductions=True)
    yield
    jcfg.set_config(**dataclasses.asdict(jold))
    tcfg.set_config(**dataclasses.asdict(told))


PAIR_CASES = [  # (alpha, beta, scale_mode, scale, plain_first, exact)
    (1.0, 1.0, "div", 2.0, True, True),
    (1.0, -1.0, None, 1.0, True, True),
    (1.0, 1.0, "mul", 0.5, True, True),
    (3.0, 2.0, None, 1.0, True, False),
    (2.0, 3.0, "div", 3.0, False, False),
    (0.0, 3.0, None, 1.0, True, False),
    (1.0, 0.0, None, 1.0, True, True),
]


PAIR_GRID = ([(n, d, c, t) for n, d in ((256, False), (300, True)) for c in PAIR_CASES
              for t in ("float32", "bfloat16")]
             + [(n, d, PAIR_CASES[0], "float32") for n, d in ((300, False), (256, True))])


@pytest.mark.parametrize("n,distinct,case,dtype", PAIR_GRID)
def test_pair_axpby_plain_matches_pallas(n, distinct, case, dtype):
    alpha, beta, mode, scale, plain_first, exact = case
    rng = np.random.default_rng(n)
    a, c = (rng.standard_normal((n, n)).astype(np.float32) for _ in range(2))
    kw = dict(alpha=alpha, beta=beta, scale_mode=mode, scale=scale, plain_first=plain_first)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    ja, jc = jnp.asarray(a).astype(jdt), jnp.asarray(c).astype(jdt)
    want = jks.pair_axpby(ja, jc if distinct else None, tile=128, **kw)
    want = np.asarray(want.astype(jnp.float32))
    ta, tc = torch.from_numpy(a).to(tdt), torch.from_numpy(c).to(tdt)
    got = tks.pair_axpby(ta, tc if distinct else None, **kw)
    assert got.dtype == tdt and tks.LAUNCHES == 0
    got = got.float().numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        eps = 2.0 ** -23 if dtype == "float32" else 2.0 ** -8
        terms = (abs(alpha) + abs(beta)) * max(np.abs(a).max(), np.abs(c).max())
        atol = eps * terms * (1 if mode != "div" else 1 / scale) * 2
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_pair_kernel_gate():
    """K2's gate: square f32/bf16 matrices of any n >= 1 above the size gate
    (the TPU kernel also needed n >= 128 for its aligned core)."""
    tcfg.set_config(pair_kernel_min_elements=1)
    assert tks.pair_kernel_tile(5, 5, torch.float32) == tks.TILE
    assert tks.pair_kernel_tile(5, 6, torch.float32) is None
    assert tks.pair_kernel_tile(5, 5, torch.int32) is None
    tcfg.set_config(pair_kernel_min_elements=1 << 22, use_kernels=True)
    assert tks.pair_kernel_tile(2047, 2047, torch.float32) is None
    assert tks.pair_kernel_tile(2048, 2048, torch.float32) == tks.TILE
    tcfg.set_config(use_kernels=False)
    assert tks.pair_kernel_tile(4096, 4096, torch.float32) is None


_JRED = {tsr.RED_SUM: 0, tsr.RED_PROD: 1, tsr.RED_MIN: 2, tsr.RED_MAX: 3}


@pytest.mark.parametrize("red", [tsr.RED_SUM, tsr.RED_MAX, tsr.RED_PROD])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("with_f", [False, True])
def test_stream_reduce_plain_matches_pallas(red, dtype, with_f):
    rng = np.random.default_rng(red)
    shape = (512, 256)
    if red == tsr.RED_PROD:
        a = (rng.uniform(0.99, 1.01, shape) if dtype == "float32"
             else rng.choice([-1, 1], shape)).astype(dtype)
    elif dtype == "float32":
        a = rng.standard_normal(shape).astype(np.float32)
    else:
        a = rng.integers(-9, 9, shape).astype(np.int32)
    f = (lambda x: x * 2 - 1) if with_f and red != tsr.RED_PROD else (lambda x: x)
    _ops, slab_red, combine = jks._stream_reducers()[_JRED[red]]
    want = np.asarray(jks._stream_reduce_2d(jnp.asarray(a), f, slab_red, combine,
                                            jnp.dtype(dtype), 256, 128, True))
    tdt = getattr(torch, dtype)
    prog = ewise.trace(f, [tdt], out_dtype=tdt)
    got = tsr.stream_reduce(torch.from_numpy(a), prog, red).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == "int32" or red == tsr.RED_MAX:
        np.testing.assert_array_equal(got, want)
    elif red == tsr.RED_SUM:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * 512 * 3 * np.abs(a).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6 * 512)


def test_row_chunks_fill_the_card_and_stay_deterministic():
    """(chunks, rows a chunk): one wave of at most 132 x 4 blocks, chunks
    of whole 64-row steps, as tall as that allows."""
    assert tsr.row_chunks(8192, 8192) == (2, 4096)  # 256 column blocks of 32
    assert tsr.row_chunks(8192, 8192, vec=8) == (16, 512)  # 32 column blocks of 256
    assert tsr.row_chunks(8192, 4096, vec=8) == (32, 256)
    assert tsr.vector_width(torch.zeros(8, 64)) == 8
    assert tsr.vector_width(torch.zeros(8, 66)) == 1
    assert tsr.vector_width(torch.zeros(8, 64, dtype=torch.bfloat16)) == 8
    assert tsr.vector_width(torch.zeros(8, 68, dtype=torch.bfloat16)) == 1
    assert tsr.row_chunks(100, 8192) == (2, 64)  # one 64-row step and the rest
    assert tsr.row_chunks(65536, 64) == (256, 256)
    assert all(tsr.row_chunks(n, m)[0] >= 1 for n in (1, 7, 300) for m in (1, 33))
    # a program's kernel on 8 columns a thread (3 blocks an SM): one wave too
    assert tsr.row_chunks(8192, 8192, 8, 3 * tsr.SMS) == (12, 704)


@pytest.mark.parametrize("n_instr,n_reg", [(0, 1), (1, 1), (3, 2), (5, 3), (9, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_every_program_takes_sixteen_byte_loads_where_rows_allow(dtype, n_instr, n_reg,
                                                                 monkeypatch):
    """The launch split asks the CUDA source (``kernel_shape``, here a
    stand-in) for the width and blocks an SM of the kernel that will run,
    telling it that the rows allow 16-byte loads when they are whole 16-byte
    runs on an aligned base, for the identity program and any other alike,
    and that ragged rows or an unaligned base do not; then it cuts one wave
    of those blocks."""
    asked = []

    def shape(n_i, n_r, vec_ok):  # the launcher's answer: blocks vary with the program
        asked.append((n_i, n_r, vec_ok))
        return (tsr.NV if vec_ok else 1), 2 + n_r % 3

    monkeypatch.setattr(tsr, "kernel_shape", shape)
    per16 = 16 // dtype.itemsize
    slots = (2 + n_reg % 3) * tsr.SMS
    full = torch.zeros(1, 8192, dtype=dtype).expand(8192, 8192)
    assert tsr.split(full, n_instr, n_reg) == (8, *tsr.row_chunks(8192, 8192, 8, slots))
    assert tsr.split(torch.zeros(64, 2 * per16, dtype=dtype), n_instr, n_reg)[0] == 8
    assert tsr.split(torch.zeros(64, 2 * per16 + 2, dtype=dtype), n_instr, n_reg)[0] == 1
    unaligned = torch.zeros(64 * 2 * per16 + 1, dtype=dtype)[1:].view(64, 2 * per16)
    assert tsr.split(unaligned, n_instr, n_reg) == (1, *tsr.row_chunks(64, 2 * per16, 1, slots))
    assert asked == [(n_instr, n_reg, ok) for ok in (True, True, False, False)]


def test_tile_executor_scrambled_copy_matches_pallas():
    """bench.py's scrambled-map check at (512, 384): out = a.T."""
    a = np.random.default_rng(7).standard_normal((512, 384)).astype(np.float32)
    jout = jst.strided(jnp.zeros((384, 512), jnp.float32))
    want = jep.try_fused_mapreduce(lambda x: x, None, None, (384, 512), jout,
                                   [jst.transpose(jst.strided(jnp.asarray(a)))])
    assert want is not None
    tout = tst.strided(torch.zeros(384, 512))
    ins = [tst.transpose(tst.strided(torch.from_numpy(a)))]
    plan = tec.make_plan(lambda x: x, None, None, (384, 512), tout, ins)
    assert plan is not None and plan.tdim == 0 and plan.tmask == 1
    got = tec.tile_executor(plan, tout.parent, [ins[0].parent])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.parent))
    np.testing.assert_array_equal(got.numpy().reshape(384, 512), a.T)


P2, P3, P4 = (1, 2, 3, 0), (2, 3, 0, 1), (3, 0, 1, 2)  # the README's four-permute sum
ID3, ID4 = (0, 1, 2), (0, 1, 2, 3)


def _operand(shape, kind, dtype=torch.float32, seed=0):
    """An input view of ``shape``: a contiguous parent permuted by ``kind``
    (unit-stride along the dim d where ``kind[d]`` is the parent's last), or
    a broadcast ``"row"`` (unit-stride along the last dim) or ``"col"``
    (along the first). Returns (view, parent)."""
    rng = np.random.default_rng(seed)
    if kind in ("row", "col"):
        n = shape[-1] if kind == "row" else shape[0]
        pshape = [1] * len(shape)
        pshape[-1 if kind == "row" else 0] = n
    else:
        pshape = [0] * len(shape)
        for d, j in enumerate(kind):
            pshape[j] = shape[d]
    a = rng.standard_normal(pshape) * 4
    t = torch.from_numpy((a * 10).astype(np.int32) if dtype == torch.int32
                         else a.astype(np.float32)).to(dtype)
    v = tst.strided(t, device="cpu")
    if kind in ("row", "col"):
        return tst.broadcast_to(v, shape), t
    return tst.permutedims(v, kind), t


STAGING = {  # name: (shape, inputs, (tdim, tmask, stage))
    "four-permute sum 8^4": ((8,) * 4, [ID4, P2, P3, P4], (2, 0b0010, (-1, 2, 1, 0))),
    "four-permute sum 7^4, ragged": ((7,) * 4, [ID4, P2, P3, P4], (2, 0b0010, (-1, 2, 1, 0))),
    "four-permute sum 13^4, ragged": ((13,) * 4, [ID4, P2, P3, P4], (2, 0b0010, (-1, 2, 1, 0))),
    "four inputs 5x9x6x7": ((5, 9, 6, 7), [ID4, P2, P3, P4], (2, 0b0010, (-1, 2, 1, 0))),
    "the three views staged, A last": ((6, 7, 5, 9), [P4, P3, P2, ID4], (0, 0b0001, (0, 1, 2, -1))),
    "rank 3, A and two permutations": ((9, 12, 10), [ID3, (1, 2, 0), (2, 0, 1)],
                                       (1, 0b010, (-1, 1, 0))),
    "rank 3, two permutations": ((9, 12, 10), [(1, 2, 0), (2, 0, 1)], (1, 0b01, (1, 0))),
    "rank 3 and a broadcast row": ((9, 12, 10), [ID3, (1, 2, 0), (2, 0, 1), "row"],
                                   (1, 0b0010, (-1, 1, 0, -1))),
    "a broadcast column and two permutations": ((9, 12, 10), ["col", (1, 2, 0), (2, 0, 1)],
                                                (0, 0b101, (-1, 1, 0))),
    "a broadcast column and one permutation: one staging dim": (
        (9, 12, 10), ["col", (1, 2, 0)], (0, 0b01, ())),
    "rank 5, four staging dims: tile_t2d_v": (
        (4, 5, 3, 4, 6), [(4, 0, 1, 2, 3), (0, 4, 1, 2, 3), (0, 1, 4, 2, 3), (0, 1, 2, 4, 3)],
        (0, 0b0001, ())),
}


@pytest.mark.parametrize("name", list(STAGING))
def test_map_stages_each_input_along_its_own_unit_stride_dim(name):
    """K4's plan of a map into a contiguous output: each input's staging dim
    (its unit-stride loop dim, where that is not the output's) where two or
    three distinct ones occur, -1 for an input read directly (unit-stride
    along the output's dim, or a broadcast); otherwise no staging and
    tile_t2d_v's single tiled dim and mask, as before the multi-axis
    kernel. The plan's programs run exactly."""
    shape, kinds, (tdim, tmask, stage) = STAGING[name]
    views, parents = zip(*(_operand(shape, k, seed=j) for j, k in enumerate(kinds)))
    f = {2: lambda a, b: a + b, 3: lambda a, b, c: a + b + c,
         4: lambda a, b, c, d: a + b + c + d}[len(views)]
    out = tst.strided(torch.zeros(shape))
    plan = tec.make_plan(f, None, None, shape, out, list(views))
    assert plan is not None and plan.dims == shape
    assert (plan.tdim, plan.tmask, plan.stage) == (tdim, tmask, stage)
    assert tec.LAST_PLAN["staging"] == stage and tec.LAST_PLAN["tiled_dim"] == tdim
    got = tec.tile_executor(plan, out.parent, list(parents))
    want = f(*(v.parent.as_strided(v.shape, v.strides, v.offset) for v in views))
    assert torch.equal(got.reshape(shape), want)


@pytest.mark.parametrize("n", [7, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_four_permute_sum_plan_is_exact(n, dtype):
    """The README's ``A + permutedims(A,P2) + permutedims(A,P3) +
    permutedims(A,P4)`` through the engine takes the multi-axis plan (A
    read directly, the P2, P3 and P4 views staged along k, j and i), and its
    plain version equals the PyTorch expression bit for bit."""
    v, a = _operand((n,) * 4, ID4, dtype)
    tec.LAST_PLAN.clear()
    got = tst.to_array(v + tst.permutedims(v, P2) + tst.permutedims(v, P3) + tst.permutedims(v, P4))
    assert tec.LAST_PLAN["staging"] == (-1, 2, 1, 0)
    assert got.dtype == dtype
    assert torch.equal(got, a + a.permute(P2) + a.permute(P3) + a.permute(P4))
    out = tst.strided(torch.zeros((n,) * 4, dtype=dtype))
    views = [v, tst.permutedims(v, P2), tst.permutedims(v, P3), tst.permutedims(v, P4)]
    plan = tec.make_plan(lambda p, q, r, s: p + q + r + s, None, None, (n,) * 4, out, views)
    ref = tec.tile_executor_reference(plan, out.parent, [a] * 4)
    assert torch.equal(ref.reshape((n,) * 4), got)


def _single_tile_plans():
    a = torch.from_numpy(np.random.default_rng(9).standard_normal((512, 384)).astype(np.float32))
    v = tst.strided(a, device="cpu")
    w = tst.strided(torch.ones(384, 512), device="cpu")
    r = tst.strided(torch.ones(6, 7, 8, 9), device="cpu")
    rev = tuple(reversed(r.shape))
    return {  # name: (f, shape, inputs, tdim, tmask)
        "(384, 512) a.T": (lambda x: x, (384, 512), [tst.transpose(v)], 0, 1),
        "3 * A'": (lambda x: 3.0 * x, (384, 512), [tst.transpose(v)], 0, 1),
        "smap x*3 + y over (A', w)": (lambda x, y: x * 3 + y, (384, 512), [tst.transpose(v), w],
                                      0, 1),
        "rank-4 reversal": (lambda x: x, rev, [tst.permutedims(r, (3, 2, 1, 0))], 2, 1),
    }


@pytest.mark.parametrize("name", list(_single_tile_plans()))
def test_single_staging_dim_keeps_the_tiled_plan(name):
    """Maps whose staged inputs share one dim keep tile_t2d_v's and
    tile_copy_t2d's plan: one tiled dim, its mask, no per-input staging."""
    f, shape, ins, tdim, tmask = _single_tile_plans()[name]
    plan = tec.make_plan(f, None, None, shape, tst.strided(torch.zeros(shape)), ins)
    assert plan is not None and (plan.tdim, plan.tmask, plan.stage) == (tdim, tmask, ())


def test_map_path_report_matches_the_cuda_source():
    """The launcher's ``*path`` codes (csrc/tile_executor.cu) name the map
    kernels of ``MAP_PATHS`` in order: the copy, the amortized and scalar
    interpreters, the multi-axis form; the multi-axis launcher takes two and
    three staging dims, ``MAX_STAGING_DIMS`` at most."""
    import re
    from pathlib import Path

    src = (Path(tec.__file__).parents[1] / "csrc" / "tile_executor.cu").read_text()
    launcher = src[src.index('extern "C" int strided_tile_executor('):]
    codes = sorted({int(c) for c in re.findall(r"\*path = (\d+);", launcher)})
    assert codes == list(range(len(tec._MAP_PATH_NAMES)))
    assert set(tec._MAP_PATH_NAMES) == set(tec.MAP_PATHS)
    assert tec._MAP_PATH_NAMES[3] == "multi_axis"
    multi = re.search(r"int launch_multi_axis\(.*?\n\}", src, re.S).group(0)
    assert sorted(int(n) for n in re.findall(r"nu == (\d+)", multi)) == [2, tec.MAX_STAGING_DIMS]


def test_tile_executor_initop_reduction_matches_pallas():
    """bench.py's initop check at (512, 256), int32: out = 3*old + sum(x, 0)."""
    rng = np.random.default_rng(8)
    x = rng.integers(-9, 9, (512, 256)).astype(np.int32)
    old = rng.integers(-9, 9, (1, 256)).astype(np.int32)
    jov = jst.broadcast_to(jst.strided(jnp.asarray(old)), (512, 256))
    want = jep.try_fused_mapreduce(lambda v: v, jnp.add, lambda o: 3 * o, (512, 256), jov,
                                   [jst.strided(jnp.asarray(x))])
    assert want is not None
    tov = tst.broadcast_to(tst.strided(torch.from_numpy(old)), (512, 256))
    plan = tec.make_plan(lambda v: v, torch.add, lambda o: 3 * o, (512, 256), tov,
                         [tst.strided(torch.from_numpy(x))])
    assert plan is not None and plan.red == tec.RED_SUM and plan.n_par == 1
    got = tec.tile_executor(plan, tov.parent, [torch.from_numpy(x).reshape(-1)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.parent))
    np.testing.assert_array_equal(got.numpy(), (3 * old + x.sum(0, keepdims=True)).reshape(-1))


def test_reduction_split_fills_the_card():
    """K4 reductions: 32 outputs a block, chunks of the reduced extent over
    blocks where the outputs alone leave the SMs idle (deterministic: a
    function of the sizes only)."""
    assert tec.reduction_split(4096, 8192) == (32, 5)
    assert tec.reduction_split(1, 3_000_000) == (1, 366)
    assert tec.reduction_split(1 << 20, 64) == (32, 1)
    assert tec.reduction_split(7, 100) == (1, 1)


def test_wrappers_refuse_devices_they_cannot_serve():
    """A wrapper runs its plain version only for CPU tensors; anything else
    that is not a CUDA tensor raises rather than carrying on."""
    m = torch.empty(64, 64, device="meta")
    with pytest.raises(ValueError):
        tks.pair_axpby(m)
    with pytest.raises(ValueError):
        tsr.stream_reduce(m, ewise.trace(lambda x: x, [torch.float32]), tsr.RED_SUM)


# -- the elementwise program ---------------------------------------------------

_F32, _BF16, _I32 = torch.float32, torch.bfloat16, torch.int32
OPS = {
    "identity": (lambda x, y: x, (_F32, _BF16, _I32)),
    "add": (lambda x, y: x + y, (_F32, _BF16, _I32)),
    "sub scalar": (lambda x, y: 2 - x, (_F32, _BF16, _I32)),
    "mul": (lambda x, y: x * y * 3, (_F32, _BF16, _I32)),
    "truediv": (lambda x, y: x / (abs(y) + 1), (_F32, _BF16, _I32)),
    "div by scalar": (lambda x, y: x / 3, (_F32, _BF16, _I32)),
    "scalar / x": (lambda x, y: 7 / (abs(x) + 1), (_F32, _BF16, _I32)),
    "pow 2": (lambda x, y: x ** 2, (_F32, _BF16, _I32)),
    "pow 3": (lambda x, y: x ** 3, (_F32, _BF16, _I32)),
    "pow 0.5": (lambda x, y: abs(x) ** 0.5, (_F32, _BF16)),
    "pow -1": (lambda x, y: (abs(x) + 1) ** -1, (_F32, _BF16)),
    "pow tensor": (lambda x, y: (abs(x) + 1) ** (abs(y) * 0.5), (_F32,)),
    "mod scalar": (lambda x, y: x % 3, (_F32, _BF16, _I32)),
    "remainder": (lambda x, y: torch.remainder(x, abs(y) + 1), (_F32, _I32)),
    "compare": (lambda x, y: (x < y).int() + (x <= 0).int() * 2 + (x > y).int() * 4
                + (x >= 1).int() * 8, (_F32, _I32)),
    "eq ne": (lambda x, y: torch.where(x == y, x, y * 2) + (x != 0), (_F32, _I32)),
    "neg abs": (lambda x, y: -abs(x) + torch.neg(y), (_F32, _BF16, _I32)),
    "minimum maximum": (lambda x, y: torch.minimum(x, y) - torch.maximum(x, y * 0.5), (_F32, _BF16)),
    "int min max": (lambda x, y: torch.minimum(x, y) * torch.maximum(x, y), (_I32,)),
    "casts": (lambda x, y: x.to(torch.int32) * 2 + y.float(), (_F32, _BF16, _I32)),
    "to bf16": (lambda x, y: x.to(torch.bfloat16) * 3, (_F32, _I32)),
    "full_like inf": (lambda x, y: torch.full_like(x, float("inf")) if x.dtype.is_floating_point
                      else torch.full_like(x, 2 ** 31 - 1), (_F32, _BF16, _I32)),
    "zeros ones": (lambda x, y: torch.zeros_like(x) + torch.ones_like(y), (_F32, _I32)),
    "affine initop": (lambda x, y: 3 * x, (_F32, _BF16, _I32)),
    "where": (lambda x, y: torch.where(x < 0, -x, y), (_F32, _BF16, _I32)),
    "exp sin": (lambda x, y: torch.exp(x * 0.25) - torch.sin(y), (_F32, _BF16, _I32)),
    "exp sin methods, int32 promoted": (lambda x, y: x.exp() + y.sin(),
                                        (_F32, _BF16, _I32)),
    "the README broadcast": (lambda x, y: x * torch.exp(-2 * x) + torch.sin(x * x),
                             (_F32, _BF16, _I32)),
}


def _leaves(dtype, n=257, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == _I32:
        return [torch.from_numpy(rng.integers(-50, 50, n).astype(np.int32)) for _ in range(2)]
    return [torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 4).to(dtype)
            for _ in range(2)]


@pytest.mark.parametrize("name,dtype", [(n, d) for n, (_, ds) in OPS.items() for d in ds])
def test_program_evaluator_equals_direct_torch(name, dtype):
    f, _ = OPS[name]
    x, y = _leaves(dtype)
    prog = ewise.trace(f, [dtype, dtype])
    want = f(x, y)
    got = ewise.evaluate(prog, [x, y])
    assert prog.out_dtype == want.dtype == got.dtype
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    c, cp = ewise.to_c(prog), ewise.compact(prog)
    assert (c.n_in, c.n_instr, c.out, c.n_reg) == (2, len(cp.instrs), cp.out, cp.n_reg)


def test_mod_is_floor_mod_like_jax():
    for dtype, jdt in ((_F32, jnp.float32), (_I32, jnp.int32)):
        x, _ = _leaves(dtype)
        prog = ewise.trace(lambda v: v % 7, [dtype])
        got = ewise.evaluate(prog, [x]).numpy()
        np.testing.assert_array_equal(got, np.asarray(jnp.mod(jnp.asarray(x.numpy(), jdt), 7)))


_CAPTURED = torch.ones(257)
DECLINED = {
    "captured tensor": (lambda x: x * _CAPTURED, _F32),
    "captured numpy array": (lambda x: x * np.ones(3), _F32),
    "op outside the table": (lambda x: torch.tanh(x), _F32),
    "a reduction": (lambda x: x.sum(), _F32),
    "f64": (lambda x: x.double(), _F32),
    "rounding_mode": (lambda x: torch.div(x, 2, rounding_mode="floor"), _F32),
    "add with alpha": (lambda x: torch.add(x, x, alpha=2), _F32),
    "f64 operand": (lambda x: x, torch.float64),
    "bool operand": (lambda x: x, torch.bool),
    "too many ops": (lambda x: sum((x * k for k in range(20)), x), _F32),
    "int pow negative": (lambda x: x ** -1, _I32),
}


@pytest.mark.parametrize("name", list(DECLINED))
def test_ineligible_closures_are_declined(name):
    f, dtype = DECLINED[name]
    with pytest.raises(ewise.Ineligible):
        ewise.trace(f, [dtype])


def test_declined_closure_takes_the_plain_path_and_says_so(caplog):
    """The engine sends an ineligible closure to its plain path before any
    launch, logs why, and leaves LAST_PLAN empty."""
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 48)).astype(np.float32))
    v = tst.transpose(tst.strided(a))
    with caplog.at_level("DEBUG", logger="strided_tpu_torch.dispatch"):
        out = tst.smap(lambda x: torch.tanh(x), v)
    assert not tec.LAST_PLAN
    assert any("outside the elementwise program's table" in r.message for r in caplog.records)
    assert torch.equal(tst.materialize(out), torch.tanh(a.T))
