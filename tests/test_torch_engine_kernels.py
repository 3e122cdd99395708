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
  direct torch op, bit for bit; each ineligible closure is declined.
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
    "op outside the table": (lambda x: torch.sin(x), _F32),
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
        out = tst.smap(lambda x: torch.sin(x), v)
    assert not tec.LAST_PLAN
    assert any("outside the elementwise program's table" in r.message for r in caplog.records)
    assert torch.equal(tst.materialize(out), torch.sin(a.T))
