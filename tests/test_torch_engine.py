"""Parity of the port's strided engine with the JAX package's, on the same
numpy inputs, through the public entry points: lazy expressions, the
reductions, copies and permutes, ``mapreducedim_into`` with an ``initop``
and ``smap``. The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas.py does; both packages' size gates are lowered so the
kernels' dispatch engages at these small sizes (on the CPU the port's
kernel wrappers run their plain PyTorch versions). Besides the values, the
dispatch records must agree: ``LAST_EXPR_DISPATCH``, ``LAST_REDUCE_DISPATCH``
and whether ``LAST_PLAN`` is set.

Tolerances, per case: ``exact`` for views, copies, int32 and the f32
``(A + A^T)/2``, ``A - A^T``; ``ulp`` (one f32 ulp of the terms' summed
magnitude, 5 * max|a| * 2^-23) for two-coefficient spellings, which XLA on
the CPU may contract into an FMA while eager PyTorch does not; ``sum``
(1e-6 * reduced length * max|a|) for f32 sums, whose summation order
differs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import strided_tpu as jst  # noqa: E402
import strided_tpu_torch as tst  # noqa: E402
from strided_tpu import config as jcfg  # noqa: E402
from strided_tpu.core import executor_pallas as jep  # noqa: E402
from strided_tpu.core import kernels_special as jks  # noqa: E402
from strided_tpu.core import lazy_expr as jle  # noqa: E402
from strided_tpu_torch import config as tcfg  # noqa: E402
from strided_tpu_torch.core import executor_cuda as tec  # noqa: E402
from strided_tpu_torch.core import kernels_special as tks  # noqa: E402
from strided_tpu_torch.core import lazy_expr as tle  # noqa: E402

J_GATES = dict(use_pallas=True, min_pallas_elements=1024, pallas_map_min_elements=1024,
               pair_kernel_min_elements=1024, min_stream_reduce_elements=1024,
               stream_reductions=True, expr_pattern_dispatch=True,
               pallas_reductions=False, pallas_aligned_maps=False)
T_GATES = dict(use_kernels=True, min_kernel_elements=1024, map_min_elements=1024,
               pair_kernel_min_elements=1024, min_stream_reduce_elements=1024,
               stream_reductions=True, expr_pattern_dispatch=True,
               kernel_reductions=False, aligned_maps=False)


@pytest.fixture(autouse=True)
def gates():
    jold, told = jcfg.get_config(), tcfg.get_config()
    jcfg.set_config(**J_GATES)
    tcfg.set_config(**T_GATES)
    yield
    jcfg.set_config(**dataclasses.asdict(jold))
    tcfg.set_config(**dataclasses.asdict(told))


class _Pkg:
    """One package's surface for the cases: ``mk`` wraps a numpy array."""

    def __init__(self, mod, mk, add, mul, maximum, tensor):
        self.m, self.mk, self.add, self.mul, self.maximum, self.tensor = (
            mod, mk, add, mul, maximum, tensor)

    def __getattr__(self, name):
        return getattr(self.m, name)


JAX = _Pkg(jst, lambda a: jst.strided(jnp.asarray(a)), jnp.add, jnp.multiply, jnp.maximum,
           jnp.asarray)
TORCH = _Pkg(tst, lambda a: tst.strided(torch.from_numpy(np.array(a))), torch.add, torch.mul,
             torch.maximum, torch.from_numpy)


def _records(pkg):
    if pkg is JAX:
        return jle.LAST_EXPR_DISPATCH, jks.LAST_REDUCE_DISPATCH, bool(jep.LAST_PLAN)
    return tle.LAST_EXPR_DISPATCH, tks.LAST_REDUCE_DISPATCH, bool(tec.LAST_PLAN)


def _reset():
    jle.LAST_EXPR_DISPATCH = tle.LAST_EXPR_DISPATCH = ""
    jks.LAST_REDUCE_DISPATCH = tks.LAST_REDUCE_DISPATCH = ""
    jep.LAST_PLAN.clear()
    tec.LAST_PLAN.clear()


def _dense(pkg, res):
    if pkg is JAX:
        return np.asarray(res if isinstance(res, jnp.ndarray) else jst.to_array(res))
    out = res if isinstance(res, torch.Tensor) else tst.to_array(res)
    return out.numpy()


def _run(case, inputs):
    outs = []
    for pkg in (JAX, TORCH):
        _reset()
        res = case(pkg, *[pkg.mk(a) for a in inputs])
        outs.append((_dense(pkg, res), _records(pkg)))
    return outs


def _compare(got, want, tol, inputs):
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    if tol == "exact":
        np.testing.assert_array_equal(got, want)
    elif tol == "ulp":  # one f32 ulp of |3a| + |2b|, the largest term magnitudes here
        atol = np.finfo(np.float32).eps * 5 * max(np.abs(a).max() for a in inputs)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:  # "sum": 1e-6 * reduced length * max|a|
        n = max(a.size for a in inputs) // max(got.size, 1)
        atol = 1e-6 * n * max(np.abs(a).max() for a in inputs)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _inputs(dtype, *shapes, lo=-9, hi=9, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return [rng.integers(lo, hi, s).astype(np.int32) for s in shapes]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


EXPRS = {
    "(v + v.T) / 2": (lambda p, v: (v + p.transpose(v)) / 2, ("float32",), "exact"),
    "v - v.T": (lambda p, v: v - p.transpose(v), ("float32", "int32"), "exact"),
    "3*v + 2*v.T": (lambda p, v: 3 * v + 2 * p.transpose(v), ("float32", "int32"), "ulp"),
    "(v + v.T) * 0.5": (lambda p, v: (v + p.transpose(v)) * 0.5, ("float32",), "exact"),
    "(A + A.T)/2 - abs(A)": (lambda p, v: (v + p.transpose(v)) / 2 - abs(v), ("float32",), "exact"),
    "3 * v.T": (lambda p, v: 3 * p.transpose(v), ("float32", "int32"), "exact"),
}


@pytest.mark.parametrize("name,dtype", [(n, d) for n, (_, ds, _) in EXPRS.items() for d in ds])
def test_expressions_match_jax(name, dtype):
    fn, _, tol = EXPRS[name]
    inputs = _inputs(dtype, (256, 256))
    (want, jrec), (got, trec) = _run(fn, inputs)
    _compare(got, want, "exact" if dtype == "int32" else tol, inputs)
    assert trec == jrec


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_distinct_buffer_pair_matches_jax(dtype):
    inputs = _inputs(dtype, (256, 256), (256, 256))
    (want, jrec), (got, trec) = _run(lambda p, v, w: v + p.transpose(w), inputs)
    _compare(got, want, "exact", inputs)
    assert trec == jrec
    if dtype == "float32":
        assert trec[0] == "xla-pair"


def test_pair_same_buffer_needs_one_parent_object():
    """Two separate wraps of one tensor are different parents: the pair
    matches only as a distinct-buffer pair, as in the reference."""
    a = _inputs("float32", (256, 256))[0]
    t = torch.from_numpy(a)
    tle.LAST_EXPR_DISPATCH = ""
    (tst.strided(t) + tst.transpose(tst.strided(t))).materialize()
    assert tle.LAST_EXPR_DISPATCH == "xla-pair"
    v = tst.strided(t)
    (v + tst.transpose(v)).materialize()
    assert tle.LAST_EXPR_DISPATCH == "pair-kernel"


def test_copy_into_of_a_pair_expression_matches_jax():
    inputs = _inputs("float32", (256, 256), (256, 256))

    def case(p, v, out):
        return p.copy_into(out, (v + p.transpose(v)) / 2)

    (want, jrec), (got, trec) = _run(case, inputs)
    _compare(got, want, "exact", inputs)
    assert trec == jrec == ("pair-kernel", "", False)


REDUCTIONS = {
    "ssum axis 0": (lambda p, v: p.ssum(v, axis=0), (512, 256), "sum"),
    "ssum axis 1 of v.T": (lambda p, v: p.ssum(p.transpose(v), axis=1), (512, 256), "sum"),
    "smax axis 1 of v.T": (lambda p, v: p.smax(p.transpose(v), axis=1), (512, 256), "exact"),
    "smin axis 0": (lambda p, v: p.smin(v, axis=0), (512, 256), "exact"),
    "smean axis 0": (lambda p, v: p.smean(v, axis=0), (512, 256), "sum"),
    "ssum full": (lambda p, v: p.ssum(v), (64, 48), "sum"),
    "smax full of v.T": (lambda p, v: p.smax(p.transpose(v)), (64, 48), "exact"),
    "ssum axes (0, 1) rank 3": (lambda p, v: p.ssum(v, axis=(0, 1)), (8, 16, 128), "sum"),
    "ssum axis 1 of a permute": (lambda p, v: p.ssum(p.permutedims(v, (2, 0, 1)), axis=(1, 2)),
                                 (8, 16, 128), "sum"),
    "ssum axis 1 of v (kept dim leading)": (lambda p, v: p.ssum(v, axis=1), (256, 512), "sum"),
    "ssum of an expression": (lambda p, v: p.ssum(v * 2 + 1, axis=0), (512, 256), "sum"),
}


@pytest.mark.parametrize("name,dtype", [(n, d) for n in REDUCTIONS for d in ("float32", "int32")
                                        if not (d == "int32" and n.startswith("smean"))])
def test_reductions_match_jax(name, dtype):
    fn, shape, tol = REDUCTIONS[name]
    inputs = _inputs(dtype, shape)
    (want, jrec), (got, trec) = _run(fn, inputs)
    _compare(got, want, "exact" if dtype == "int32" else tol, inputs)
    assert trec == jrec


PROGRAM_REDUCTIONS = {  # one leaf, a map that is not the identity: K3's program kernels
    "smean axis 0": (lambda p, v: p.smean(v, axis=0), ("float32", "bfloat16")),
    "sreduce_dims t*3 + 1": (lambda p, v: p.sreduce_dims(lambda t: t * 3 + 1, p.add, v, (0,)),
                             ("float32", "bfloat16", "int32")),
}


@pytest.mark.parametrize("width", [256, 66, 257])
@pytest.mark.parametrize("name,dtype", [(n, d) for n, (_, ds) in PROGRAM_REDUCTIONS.items()
                                        for d in ds])
def test_program_reductions_match_jax(name, dtype, width):
    """A leading-axis reduction whose map is a program goes to K3 in the
    port at every width (on the card 8 columns a thread where rows are whole
    16-byte runs, 256; one column a thread at 66 and 257). The reference
    streams widths that are multiples of 128 and gives the rest to XLA.
    Tolerances: int32 exact; f32 1e-6 * rows * max|f(a)|; bf16 besides 4 bf16
    ulps of max|out|, since the reference sums each 256-row slab and the
    slabs in bf16 where the port sums in f32 and rounds once."""
    fn, _ = PROGRAM_REDUCTIONS[name]
    rows = 512
    a = _inputs("int32" if dtype == "int32" else "float32", (rows, width))[0]
    jv = jst.strided(jnp.asarray(a).astype(getattr(jnp, dtype)))
    tv = tst.strided(torch.from_numpy(a).to(getattr(torch, dtype)))
    _reset()
    want = np.asarray(jst.to_array(fn(JAX, jv)).astype(np.float32 if dtype != "int32" else np.int32))
    jrec = jks.LAST_REDUCE_DISPATCH
    got = tst.to_array(fn(TORCH, tv))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape == (1, width)
    assert tks.LAST_REDUCE_DISPATCH == "stream-kernel"
    assert jrec == ("stream-kernel" if width % 128 == 0 else "xla")
    got = got.numpy() if dtype == "int32" else got.float().numpy()
    if dtype == "int32":
        np.testing.assert_array_equal(got, want)
        return
    a_max = float(np.abs(a).max())
    f_max = a_max / rows if name.startswith("smean") else 3 * a_max + 1
    atol = 1e-6 * rows * f_max
    if dtype == "bfloat16":
        atol += 4 * 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_stream_plans_follow_layout_and_gates():
    """K3's dispatch of a marked map (``smean``'s scale) is decided once per
    map, fold, layout and gates: a transposed view, another size or a gate
    moved between calls still gets its own decision and its own values."""
    a = _inputs("float32", (512, 256))[0]
    v = tst.strided(torch.from_numpy(a))
    for view, axis, want in ((v, 0, a.mean(0)), (tst.transpose(v), 1, a.mean(0)),
                             (tst.transpose(v), 0, a.mean(1)), (v, 0, a.mean(0))):
        tks.LAST_REDUCE_DISPATCH = ""
        got = tst.to_array(tst.smean(view, axis)).reshape(-1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(a).max())
        assert tks.LAST_REDUCE_DISPATCH == ("stream-kernel" if want.size == 256 else "xla")
    tcfg.set_config(min_stream_reduce_elements=512 * 256 + 1)
    tst.smean(v, 0)
    assert tks.LAST_REDUCE_DISPATCH == "xla"
    tcfg.set_config(min_stream_reduce_elements=1024)
    tst.smean(v, 0)
    assert tks.LAST_REDUCE_DISPATCH == "stream-kernel"
    small = tst.strided(torch.from_numpy(a[:128].copy()))
    np.testing.assert_allclose(tst.to_array(tst.smean(small, 0)).reshape(-1).numpy(),
                               a[:128].mean(0), rtol=0, atol=1e-6 * np.abs(a).max())


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_sprod_matches_jax(dtype):
    rng = np.random.default_rng(5)
    if dtype == "int32":
        a = rng.choice(np.array([-1, 1], np.int32), (512, 256))
    else:
        a = rng.uniform(0.99, 1.01, (512, 256)).astype(np.float32)
    (want, jrec), (got, trec) = _run(lambda p, v: p.sprod(v, axis=0), [a])
    if dtype == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6 * 512)
    assert trec == jrec == ("", "stream-kernel", False)


def test_stream_reduction_takes_layouts_the_tpu_declines():
    """The TPU kernel needs the kept minor dim to be a multiple of 128; the
    CUDA kernel takes any (N, M): the port streams where the reference
    falls back to XLA, with equal values."""
    inputs = _inputs("int32", (64, 100))
    (want, jrec), (got, trec) = _run(lambda p, v: p.ssum(v, axis=0), inputs)
    np.testing.assert_array_equal(got, want)
    assert jrec[1] == "xla" and trec[1] == "stream-kernel"


PERMUTES = [((32, 48), (1, 0)), ((8, 16, 24), (2, 0, 1)), ((8, 16, 24), (1, 0, 2)),
            ((4, 8, 6, 16), (3, 1, 0, 2)), ((4, 8, 6, 16), (0, 2, 1, 3))]


@pytest.mark.parametrize("shape,perm", PERMUTES)
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_permutedims_into_matches_jax(shape, perm, dtype):
    src = _inputs(dtype, shape)[0]
    out = np.zeros(tuple(shape[p] for p in perm), src.dtype)
    (want, jrec), (got, trec) = _run(lambda p, s, o: p.permutedims_into(o, s, perm), [src, out])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.transpose(src, perm))
    assert trec == jrec


def test_copy_into_a_transposed_output_matches_jax():
    src, buf = _inputs("float32", (64, 128), (128, 64))

    def case(p, s, b):
        return p.copy_into(p.transpose(b), s)

    (want, jrec), (got, trec) = _run(case, [src, buf])
    np.testing.assert_array_equal(got, want)
    assert trec == jrec


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("kernel_reductions", [False, True])
def test_mapreducedim_into_initop_matches_jax(dtype, kernel_reductions):
    """``out = 3*old + sum over axis 0`` (the reference's bench check), with
    initop applied once to each old output value."""
    jcfg.set_config(pallas_reductions=kernel_reductions)
    tcfg.set_config(kernel_reductions=kernel_reductions)
    x, old = _inputs(dtype, (512, 256), (1, 256))

    def case(p, xv, ov):
        out = p.broadcast_to(ov, (512, 256))
        return p.mapreducedim_into(lambda t: t, p.add, lambda o: 3 * o, out, xv).parent

    (want, jrec), (got, trec) = _run(case, [x, old])
    _compare(got, want, "exact" if dtype == "int32" else "sum", [x, old])
    assert trec == jrec and trec[2] == kernel_reductions


def test_mapreducedim_into_map_with_op_matches_jax():
    """An op with no reduced dim: out = op(initop(old), f(x)) elementwise."""
    x, old = _inputs("int32", (128, 96), (128, 96))

    def case(p, xv, ov):
        return p.mapreducedim_into(lambda t: t * 2, p.maximum, lambda o: o - 1, ov, xv)

    (want, jrec), (got, trec) = _run(case, [x, old])
    np.testing.assert_array_equal(got, want)
    assert trec == jrec


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_smap_scrambled_matches_jax(dtype):
    a, b = _inputs(dtype, (128, 96), (96, 128))
    (want, jrec), (got, trec) = _run(lambda p, v, w: p.smap(lambda x, y: x * 3 + y, p.transpose(v), w),
                                     [a, b])
    _compare(got, want, "exact" if dtype == "int32" else "ulp", [a, b])
    assert trec == jrec == ("", "", True)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_smap_with_a_captured_tensor_is_declined_on_both_sides(dtype):
    a, c = _inputs(dtype, (128, 96), (96, 128))

    def case(p, v):
        cap = p.tensor(c)
        return p.smap(lambda x: x * cap, p.transpose(v))

    (want, jrec), (got, trec) = _run(case, [a])
    np.testing.assert_array_equal(got, want)
    assert trec == jrec == ("", "", False)


def test_broadcast_expression_matches_jax():
    a, b = _inputs("float32", (64, 128), (128,))
    (want, jrec), (got, trec) = _run(lambda p, v, w: (v * 2 - w).materialize(), [a, b])
    np.testing.assert_array_equal(got, want)


def test_strided_jit_returns_dense_tensors():
    a = _inputs("float32", (64, 64))[0]

    @tst.strided_jit
    def sym(x):
        return (x + x.T) / 2, {"t": x.T}

    got, extra = sym(torch.from_numpy(a))
    assert isinstance(got, torch.Tensor) and isinstance(extra["t"], torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jst.strided_jit(lambda x: (x + x.T) / 2)(
        jnp.asarray(a))))
