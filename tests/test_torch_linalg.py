"""Parity of the port's linalg layer with the JAX package's: the grids of
tests/test_linalg.py, each case feeding the same seeded numpy inputs to
``strided_tpu.linalg`` and ``strided_tpu_torch.linalg`` and comparing the
two results (and the port's with the numpy oracle).

Tolerances: ``exact`` for ints and complex ints (the generic path);
``rtol = atol = 1e-12`` for f64 and complex128, whose only difference is the
summation order of two BLAS libraries; the reference's own ``1e-4`` for
f32 and complex64; one bf16 ulp (``2^-7`` relative) for the bf16 product,
which both packages take in f32 and round once. The pair-route cases lower
both packages' pair gates, as tests/test_torch_engine.py does, and compare
the dispatch records.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import strided_tpu as jst  # noqa: E402
import strided_tpu_torch as tst  # noqa: E402
from strided_tpu import config as jcfg  # noqa: E402
from strided_tpu import linalg as jla  # noqa: E402
from strided_tpu.core import lazy_expr as jle  # noqa: E402
from strided_tpu_torch import config as tcfg  # noqa: E402
from strided_tpu_torch import linalg as tla  # noqa: E402
from strided_tpu_torch.core import executor_cuda as tec  # noqa: E402
from strided_tpu_torch.core import kernels_special as tks  # noqa: E402
from strided_tpu_torch.core import lazy_expr as tle  # noqa: E402

OPS = ["identity", "conj", "transpose", "adjoint"]
BLAS_DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
F64 = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def configs():
    jold, told = jcfg.get_config(), tcfg.get_config()
    yield
    jcfg.set_config(**dataclasses.asdict(jold))
    tcfg.set_config(**dataclasses.asdict(told))


def no_blas():
    jcfg.set_config(use_mxu=False)
    tcfg.set_config(use_blas=False)


def rand(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.complexfloating):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-10, 10, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


class Pkg:
    """One package's wrapping of numpy arrays and its view transforms."""

    def __init__(self, mod, la, wrap, out):
        self.m, self.la, self.wrap, self.out = mod, la, wrap, out

    def view(self, x):
        return self.m.strided(self.wrap(np.array(x)))

    def op(self, x, opname):
        v = self.view(x)
        return {"identity": v, "conj": self.m.conj(v), "transpose": self.m.transpose(v),
                "adjoint": self.m.adjoint(v)}[opname]

    def dst(self, c, opname):
        """op3(C) whose logical value is ``c``."""
        if opname == "identity":
            return self.view(c)
        if opname == "conj":
            return self.m.conj(self.view(np.conj(c)))
        if opname == "transpose":
            return self.m.transpose(self.view(c.T))
        return self.m.adjoint(self.view(np.conj(c.T)))

    def value(self, res):
        return self.out(self.m.materialize(res))

    def parent(self, res):
        return self.out(res.parent)


JAX = Pkg(jst, jla, jnp.asarray, np.asarray)
TORCH = Pkg(tst, tla, torch.from_numpy, lambda t: t.numpy())
BOTH = (JAX, TORCH)


def both(fn):
    """``fn(pkg)`` for each package, as numpy values."""
    return [fn(p) for p in BOTH]


def check(got_j, got_t, expect, **tol):
    if tol:
        np.testing.assert_allclose(got_t, got_j, **tol)
        np.testing.assert_allclose(got_t, expect, **tol)
    else:
        np.testing.assert_array_equal(got_t, got_j)
        np.testing.assert_array_equal(got_t, expect)


@pytest.mark.parametrize("op1", OPS)
@pytest.mark.parametrize("op2", OPS)
def test_generic_mul_int_exact_grid(op1, op2):
    a, b, c = (rand((7, 7), np.int64, s) for s in (1, 2, 3))
    got = both(lambda p: p.value(p.la.mul(p.view(c), p.op(a, op1), p.op(b, op2),
                                          alpha=3, beta=2)))
    check(*got, 3 * (_oracle(a, op1) @ _oracle(b, op2)) + 2 * c)


def _cint(rng, shape):
    return (rng.integers(-5, 5, size=shape) + 1j * rng.integers(-5, 5, size=shape)).astype(
        np.complex128)


def _ops_shapes(op1, op2, d, e):
    return ((d, e) if op1 in ("identity", "conj") else (e, d),
            (e, d) if op2 in ("identity", "conj") else (d, e))


def _oracle(x, opname):
    return {"identity": x, "conj": np.conj(x), "transpose": x.T, "adjoint": np.conj(x.T)}[opname]


@pytest.mark.parametrize("op3", OPS)
@pytest.mark.parametrize("op2", OPS)
@pytest.mark.parametrize("op1", OPS)
def test_generic_mul_complexint_op3_grid(op1, op2, op3):
    """Exact complex-int arithmetic through every destination op, the
    vendor matmul switched off in both packages."""
    rng = np.random.default_rng(11)
    sa, sb = _ops_shapes(op1, op2, 5, 7)
    a, b, c = _cint(rng, sa), _cint(rng, sb), _cint(rng, (5, 5))
    alpha, beta = 2 - 1j, 1 + 3j
    no_blas()
    got = both(lambda p: p.value(p.la.mul(p.dst(c, op3), p.op(a, op1), p.op(b, op2),
                                          alpha=alpha, beta=beta)))
    check(*got, alpha * (_oracle(a, op1) @ _oracle(b, op2)) + beta * c)


@pytest.mark.parametrize("op3", OPS)
@pytest.mark.parametrize("op2", OPS)
@pytest.mark.parametrize("op1", OPS)
def test_generic_mul_int_op3_grid(op1, op2, op3):
    sa, sb = _ops_shapes(op1, op2, 4, 6)
    a, b, c = rand(sa, np.int64, 21), rand(sb, np.int64, 22), rand((4, 4), np.int64, 23)
    got = both(lambda p: p.value(p.la.mul(p.dst(c, op3), p.op(a, op1), p.op(b, op2),
                                          alpha=3, beta=-2)))
    check(*got, 3 * (_oracle(a, op1) @ _oracle(b, op2)) - 2 * c)


@pytest.mark.parametrize("dt1", BLAS_DTYPES)
@pytest.mark.parametrize("dt2", BLAS_DTYPES)
def test_blasfloat_op3_grid(dt1, dt2):
    """Every dtype pair through the full op^3 grid with random alpha/beta:
    equal dtypes take the vendor matmul, mixed ones the generic path."""
    d, e = 33, 21
    rng = np.random.default_rng(4 * BLAS_DTYPES.index(dt1) + BLAS_DTYPES.index(dt2))
    cd = np.promote_types(dt1, dt2)
    tol = F64 if cd in (np.float64, np.complex128) else dict(rtol=1e-4, atol=1e-4)

    def scal():
        x = rng.standard_normal()
        return complex(x, rng.standard_normal()) if np.issubdtype(cd, np.complexfloating) else x

    for op1 in OPS:
        for op2 in OPS:
            for op3 in OPS:
                sa, sb = _ops_shapes(op1, op2, d, e)
                a = rand(sa, dt1, int(rng.integers(0, 2**31)))
                b = rand(sb, dt2, int(rng.integers(0, 2**31)))
                c = rand((d, d), cd, int(rng.integers(0, 2**31)))
                alpha, beta = scal(), scal()
                got = both(lambda p: p.value(p.la.mul(p.dst(c, op3), p.op(a, op1),
                                                      p.op(b, op2), alpha=alpha, beta=beta)))
                expect = alpha * (_oracle(a, op1).astype(cd) @ _oracle(b, op2).astype(cd)) + beta * c
                check(*got, expect, **tol)


@pytest.mark.parametrize("dt1", BLAS_DTYPES)
@pytest.mark.parametrize("dt2", [np.float64, np.complex128])
def test_eltype_promotion_grid(dt1, dt2):
    d = 103
    rng = np.random.default_rng(5)
    alpha, beta = rng.standard_normal(), rng.standard_normal()
    a, b = rand((d, d), dt1, 6), rand((d, d), dt2, 7)
    cd = np.promote_types(dt1, dt2)
    c = rand((d, d), cd, 8)
    op2 = "adjoint" if np.issubdtype(dt2, np.complexfloating) else "identity"
    got = both(lambda p: p.value(p.la.mul(p.view(c), p.op(a, "transpose"), p.op(b, op2),
                                          alpha=alpha, beta=beta)))
    expect = alpha * (a.T.astype(cd) @ _oracle(b, op2).astype(cd)) + beta * c
    check(*got, expect, **F64)


def test_outer_product():
    a, b = rand((9, 1), np.float64, 1), rand((1, 11), np.float64, 2)
    check(*both(lambda p: p.value(p.la.matmul(p.wrap(a), p.wrap(b)))), a @ b, **F64)


def test_inner_product():
    a, b, c = rand((1, 17), np.float64, 3), rand((17, 1), np.float64, 4), np.array([[2.0]])
    got = both(lambda p: p.value(p.la.mul(p.view(c), p.wrap(a), p.wrap(b), alpha=2.0, beta=3.0)))
    check(*got, 2.0 * (a @ b) + 3.0 * c, **F64)


def test_zero_inner_dim():
    c = rand((5, 5), np.float64, 9)
    z1, z2 = np.zeros((5, 0)), np.zeros((0, 5))
    got = both(lambda p: p.value(p.la.mul(p.view(c), p.wrap(z1), p.wrap(z2),
                                          alpha=1.0, beta=2.0)))
    check(*got, 2 * c, **F64)


def test_zero_size_output():
    got = both(lambda p: p.value(p.la.matmul(p.wrap(np.zeros((0, 4))), p.wrap(np.ones((4, 3))))))
    assert got[0].shape == got[1].shape == (0, 3)


def test_mul_shape_and_rank_errors():
    for p in BOTH:
        with pytest.raises(jst.StridedLayoutError if p is JAX else tst.StridedLayoutError):
            p.la.mul(p.view(np.zeros((3, 3))), p.wrap(np.ones((3, 4))), p.wrap(np.ones((5, 3))))
        with pytest.raises(jst.StridedLayoutError if p is JAX else tst.StridedLayoutError):
            p.la.mul(p.view(np.zeros(3)), p.wrap(np.ones((3, 4))), p.wrap(np.ones((4, 3))))


@pytest.mark.parametrize("special", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_alpha_beta_specials(special):
    alpha, beta = special
    a, b, c = (rand((8, 8), np.float64, s) for s in (1, 2, 3))
    got = both(lambda p: p.value(p.la.mul(p.view(c), p.wrap(a), p.wrap(b),
                                          alpha=alpha, beta=beta)))
    check(*got, alpha * (a @ b) + beta * c, **F64)


def test_mul_into_conj_dst():
    """Writing through a conj view stores the conjugate."""
    a, b, c = (rand((6, 6), np.complex128, s) for s in (1, 2, 3))
    res = both(lambda p: p.la.mul(p.m.conj(p.view(c)), p.wrap(a), p.wrap(b),
                                  alpha=1.0, beta=0.0))
    check(*(p.value(r) for p, r in zip(BOTH, res)), a @ b, **F64)
    check(*(p.parent(r).reshape(6, 6) for p, r in zip(BOTH, res)), np.conj(a @ b), **F64)


def test_mul_into_transposed_dst():
    a, b = rand((4, 6), np.float64, 1), rand((6, 5), np.float64, 2)
    res = both(lambda p: p.la.mul(p.m.transpose(p.view(np.zeros((5, 4)))), p.wrap(a), p.wrap(b)))
    check(*(p.value(r) for p, r in zip(BOTH, res)), a @ b, **F64)
    check(*(p.parent(r).reshape(5, 4) for p, r in zip(BOTH, res)), (a @ b).T, **F64)


def test_generic_forced_when_blas_disabled(monkeypatch):
    """``use_blas`` off (``use_mxu`` off in the JAX package): floats take
    the generic path, never the vendor matmul."""
    a, b = rand((12, 12), np.float64, 1), rand((12, 12), np.float64, 2)
    no_blas()

    def refuse(*args):
        raise AssertionError("the vendor matmul ran with use_blas off")

    monkeypatch.setattr(tla, "_mul_blas", refuse)
    check(*both(lambda p: p.value(p.la.matmul(p.wrap(a), p.wrap(b)))), a @ b, **F64)


def test_bf16_mul_rounds_once():
    """bf16 operands: an f32 product and epilogue, one rounding to bf16."""
    a, b, c = (rand((48, 40), np.float32, 1), rand((40, 32), np.float32, 2),
               rand((48, 32), np.float32, 3))
    jres = jla.mul(jst.strided(jnp.asarray(c, jnp.bfloat16)), jnp.asarray(a, jnp.bfloat16),
                   jnp.asarray(b, jnp.bfloat16), alpha=1.5, beta=-0.75)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    tres = tla.mul(tst.strided(bf(c)), bf(a), bf(b), alpha=1.5, beta=-0.75)
    got_t = tst.materialize(tres)
    assert got_t.dtype == torch.bfloat16
    got_j = np.asarray(jst.materialize(jres).astype(jnp.float32))
    want = (1.5 * (bf(a).float() @ bf(b).float()) + (-0.75 * bf(c))).to(torch.bfloat16)
    np.testing.assert_allclose(got_t.float().numpy(), got_j, rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(got_t.float().numpy(), want.float().numpy(), rtol=2**-7,
                               atol=1e-6)


def test_axpy_axpby_lmul_rmul():
    x, y = rand((7, 9), np.float64, 1), rand((7, 9), np.float64, 2)
    check(*both(lambda p: p.value(p.la.axpy(2.0, p.wrap(x), p.view(y)))), 2 * x + y, **F64)
    check(*both(lambda p: p.value(p.la.axpby(2.0, p.wrap(x), 3.0, p.view(y)))), 2 * x + 3 * y,
          **F64)
    check(*both(lambda p: p.value(p.la.lmul(0.5, p.view(y)))), 0.5 * y, **F64)
    check(*both(lambda p: p.value(p.la.rmul(p.view(y), 0.0))), 0 * y)
    check(*both(lambda p: p.value(p.la.rmul(p.view(y), 2.5))), 2.5 * y, **F64)
    check(*both(lambda p: p.value(p.la.scale_into(p.view(y), 3.0, p.wrap(x)))), 3 * x, **F64)
    check(*both(lambda p: p.value(p.la.axpby(2.0, p.wrap(x), 0, p.view(y)))), 2 * x, **F64)
    check(*both(lambda p: p.value(p.la.axpy(0, p.wrap(x), p.view(y)))), y)


def test_axpy_over_permuted_views():
    x, y = rand((3, 4, 5, 2), np.float64, 1), rand((5, 3, 2, 4), np.float64, 2)
    got = both(lambda p: p.value(p.la.axpy(1.5, p.m.permutedims(p.view(x), (2, 0, 3, 1)),
                                           p.view(y))))
    check(*got, 1.5 * np.transpose(x, (2, 0, 3, 1)) + y, **F64)


def test_contract_einsum_over_views():
    a, w = rand((4, 5, 6), np.float64, 11), rand((5, 6, 7), np.float64, 12)
    got = [np.asarray(jla.contract("acb,bcd->ad", jst.permutedims(JAX.view(a), (0, 2, 1)),
                                   jnp.asarray(w), alpha=2.0)),
           tla.contract("acb,bcd->ad", tst.permutedims(TORCH.view(a), (0, 2, 1)),
                        torch.from_numpy(w), alpha=2.0).numpy()]
    check(*got, 2.0 * np.einsum("acb,bcd->ad", np.transpose(a, (0, 2, 1)), w), **F64)


def test_contract_promotes_mixed_dtypes():
    a, b = rand((3, 4), np.float32, 1), rand((4, 5), np.float64, 2)
    got = [np.asarray(jla.contract("ij,jk->ik", jnp.asarray(a), jnp.asarray(b))),
           tla.contract("ij,jk->ik", torch.from_numpy(a), torch.from_numpy(b)).numpy()]
    assert got[1].dtype == got[0].dtype == np.float64
    check(*got, a.astype(np.float64) @ b, **F64)


@pytest.mark.parametrize("k_red", [False, True])
def test_generic_mul_int32_route(k_red):
    """The int32 generic ``mul`` (the check the card runs at full size):
    exact in both packages; with ``kernel_reductions`` on the port plans it
    for the tile executor K4 (on the CPU, K4's plain version runs)."""
    a, b, c = (rand(s, np.int32, k) for s, k in (((40, 24), 1), ((24, 36), 2), ((40, 36), 3)))
    jcfg.set_config(pallas_reductions=k_red, min_pallas_elements=1024)
    tcfg.set_config(kernel_reductions=k_red, min_kernel_elements=1024)
    got = both(lambda p: p.value(p.la.mul(p.view(c), p.wrap(a), p.wrap(b), alpha=3, beta=2)))
    assert bool(tec.LAST_PLAN) == k_red
    check(*got, (3 * (a.astype(np.int64) @ b) + 2 * c).astype(np.int32))


# ---------------------------------------------------------------------------
# the pair route (K2 through the linalg spellings)
# ---------------------------------------------------------------------------


def lower_pair_gates():
    jcfg.set_config(min_pallas_elements=1024, pair_kernel_min_elements=1024, use_pallas=True)
    tcfg.set_config(min_kernel_elements=1024, pair_kernel_min_elements=1024, use_kernels=True)


def _records_agree(fn):
    jle.LAST_EXPR_DISPATCH = tle.LAST_EXPR_DISPATCH = ""
    got = both(lambda p: np.asarray(p.m.to_array(fn(p))))
    assert tle.LAST_EXPR_DISPATCH == jle.LAST_EXPR_DISPATCH
    return got, tle.LAST_EXPR_DISPATCH


def test_linalg_pair_kernel_routes():
    """``axpby(alpha, A', beta, A)`` reaches K2 (record ``pair-kernel``),
    distinct buffers the plain fused pair (``xla-pair``), ``scale_into``
    of a transpose the generic path: in both packages alike, with the
    values of the expression spelling (exact)."""
    lower_pair_gates()
    rng = np.random.default_rng(21)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    b = rng.standard_normal((256, 256)).astype(np.float32)
    views = {JAX: JAX.view(a), TORCH: TORCH.view(a)}

    got, rec = _records_agree(lambda p: p.la.axpby(3.0, p.m.transpose(views[p]), 2.0,
                                                   p.view(b)))
    assert rec == "xla-pair"
    check(*got, 3.0 * a.T + 2.0 * b, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1], (3.0 * torch.from_numpy(a).T
                                           + 2.0 * torch.from_numpy(b)).numpy())

    got, rec = _records_agree(lambda p: p.la.axpy(3.0, p.m.transpose(views[p]), p.view(b)))
    assert rec == "xla-pair"
    check(*got, 3.0 * a.T + b, rtol=1e-6, atol=1e-6)

    got, rec = _records_agree(lambda p: p.la.scale_into(p.view(np.zeros_like(a)), 3.0,
                                                        p.m.transpose(views[p])))
    assert rec != "pair-kernel"
    check(*got, 3.0 * a.T)

    got, rec = _records_agree(lambda p: p.la.axpby(3.0, p.m.transpose(views[p]), 2.0, views[p]))
    assert rec == "pair-kernel"
    check(*got, 3.0 * a.T + 2.0 * a, rtol=1e-6, atol=1e-6)
    v = views[TORCH]
    np.testing.assert_array_equal(got[1], tst.to_array(3.0 * tst.transpose(v) + 2.0 * v).numpy())

    got, rec = _records_agree(lambda p: p.la.axpby(0.5, p.m.transpose(views[p]), 0.5, views[p]))
    assert rec == "pair-kernel"
    check(*got, (a.T + a) * np.float32(0.5), rtol=1e-6, atol=1e-6)


def test_linalg_pair_route_fallbacks_unchanged():
    """Non-matching calls take the generic fused broadcast in both packages:
    a rectangular transpose, a square operand that is not transposed, a
    scalar that is not a plain number, an int dtype."""
    lower_pair_gates()
    rng = np.random.default_rng(22)
    a = rng.standard_normal((64, 96)).astype(np.float32)
    b = rng.standard_normal((96, 64)).astype(np.float32)
    got, rec = _records_agree(lambda p: p.la.axpby(3.0, p.m.transpose(p.view(a)), 2.0, p.view(b)))
    assert rec != "pair-kernel"
    check(*got, 3.0 * a.T + 2.0 * b, rtol=1e-5, atol=1e-5)
    sq, sq2 = (rng.standard_normal((64, 64)).astype(np.float32) for _ in range(2))
    got, rec = _records_agree(lambda p: p.la.axpby(3.0, p.view(sq), 2.0, p.view(sq2)))
    check(*got, 3.0 * sq + 2.0 * sq2, rtol=1e-5, atol=1e-5)
    tle.LAST_EXPR_DISPATCH = ""
    v = TORCH.view(sq)
    got = tst.to_array(tla.axpby(torch.tensor(3.0), tst.transpose(v), 2.0, v)).numpy()
    assert tle.LAST_EXPR_DISPATCH != "pair-kernel"
    np.testing.assert_allclose(got, 3.0 * sq.T + 2.0 * sq, rtol=1e-5, atol=1e-5)
    ints = rng.integers(-9, 9, (64, 64))
    got, rec = _records_agree(lambda p: p.la.axpby(3, p.m.transpose(p.view(ints)), 2, p.view(ints)))
    assert rec != "pair-kernel"
    check(*got, 3 * ints.T + 2 * ints)


def test_pair_route_propagates_kernel_errors(monkeypatch):
    """A failure inside K2 reaches the caller; the route catches nothing."""
    lower_pair_gates()

    def broken(*args, **kwargs):
        raise RuntimeError("pair_axpby: kernel launch failed, cudaError_t 9")

    monkeypatch.setattr(tks, "pair_axpby", broken)
    v = TORCH.view(rand((64, 64), np.float32, 1))
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        tla.axpby(0.5, tst.transpose(v), 0.5, v)
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        tla.axpy(2.0, tst.transpose(v), v)


# ---------------------------------------------------------------------------
# @ on views and expressions
# ---------------------------------------------------------------------------


def test_matmul_operator_on_views_and_expressions():
    a, b = rand((6, 5), np.float64, 1), rand((5, 4), np.float64, 2)
    for got_fn, expect in (
        (lambda p: p.view(a) @ p.view(b), a @ b),
        (lambda p: p.m.transpose(p.view(b)) @ p.m.transpose(p.view(a)), (a @ b).T),
        (lambda p: (p.view(a) * 2 + 1) @ p.view(b), (a * 2 + 1) @ b),
        (lambda p: p.wrap(a) @ p.view(b), a @ b),
        (lambda p: p.view(a) @ (p.view(b) - 1), a @ (b - 1)),
    ):
        res = both(lambda p: p.value(got_fn(p)))
        check(*res, expect, **F64)
    assert isinstance(TORCH.view(a) @ TORCH.view(b), tst.StridedView)
    ai = rand((3, 4), np.int64, 3)
    check(*both(lambda p: p.value(p.view(ai) @ p.m.transpose(p.view(ai)))), ai @ ai.T)
