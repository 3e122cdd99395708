"""Slice B's iLQR in the PyTorch port against the JAX package: ``QuadCost``,
``ilqr`` and ``ilqr_batched`` on the cartpole and the unicycle, each batch
element keeping its own state, a singular Quu rejected by the line search,
``quad_cost_from_numpy``, the accuracy line and the benchmark's input and
refusals."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import strided_tpu.models as jm  # noqa: E402
import strided_tpu.mpc as jmpc  # noqa: E402
import strided_tpu_torch.models as tm  # noqa: E402
import strided_tpu_torch.mpc as tmpc  # noqa: E402
from strided_tpu_torch import bench as tbench  # noqa: E402
from strided_tpu_torch.benchmarks import ilqr_bench  # noqa: E402
from strided_tpu_torch.convert import COST_ARRAYS, quad_cost_from_numpy  # noqa: E402

DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}
CARTPOLE = dict(Q=[1.0, 10.0, 0.1, 0.1], R=[0.01], Qf=[10.0, 100.0, 1.0, 1.0],
                x_goal=[0.0, np.pi, 0.0, 0.0])
UNICYCLE = dict(Q=[1.0, 1.0, 0.1], R=[0.01, 0.01], Qf=[100.0, 100.0, 10.0],
                x_goal=[2.0, 1.0, 0.0])
# f64: the same arithmetic up to summation order; a line-search choice
# could flip only on a near tie, and none does on these problems. f32:
# inputs within 5e-6 of their largest entry (~86 on the cartpole, so a few
# f32 ulps of it), costs within 1e-6 relative.
US_TOL = {"f64": 1e-8, "f32": 5e-6}
COST_RTOL = {"f64": 1e-12, "f32": 1e-6}


def _np_cost(spec) -> dict:
    return {"Q": np.diag(spec["Q"]), "R": np.diag(spec["R"]), "Qf": np.diag(spec["Qf"]),
            "x_goal": np.array(spec["x_goal"])}


def _costs(spec, prec):
    """(JAX QuadCost, port QuadCost) of the same arrays, the port's through
    ``quad_cost_from_numpy``."""
    tdt, jdt = DTYPES[prec]
    d = _np_cost(spec)
    jc = jmpc.QuadCost(**{k: jnp.asarray(v, jdt) for k, v in d.items()})
    return jc, quad_cost_from_numpy(d, device="cpu", dtype=tdt)


def _jax_ilqr(model, cost, x0, us0, dt, **kw):
    return jax.jit(lambda x, u: jmpc.ilqr(model, cost, x, u, dt, **kw))(x0, us0)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_quad_cost_matches_jax(prec):
    """``stage``, ``terminal`` and ``total`` on one point and on a batch of
    trajectories, against the JAX cost (vmapped for the batch)."""
    tdt, jdt = DTYPES[prec]
    jc, tc = _costs(CARTPOLE, prec)
    rng = np.random.default_rng(0)
    xs, us = rng.uniform(-1, 1, (3, 11, 4)), rng.uniform(-1, 1, (3, 10, 1))
    xt, ut = torch.as_tensor(xs, dtype=tdt), torch.as_tensor(us, dtype=tdt)
    xj, uj = jnp.asarray(xs, jdt), jnp.asarray(us, jdt)
    tol = dict(rtol=COST_RTOL[prec], atol=0)
    got = tc.total(xt, ut)
    assert got.shape == (3,) and got.dtype == tdt
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.vmap(jc.total)(xj, uj)), **tol)
    np.testing.assert_allclose(tc.total(xt[1], ut[1]).numpy(), np.asarray(jc.total(xj[1], uj[1])),
                               **tol)
    np.testing.assert_allclose(tc.stage(xt[:, 0], ut[:, 0]).numpy(),
                               np.asarray(jax.vmap(jc.stage)(xj[:, 0], uj[:, 0])), **tol)
    np.testing.assert_allclose(tc.stage(xt[0, 2], ut[0, 2]).numpy(),
                               np.asarray(jc.stage(xj[0, 2], uj[0, 2])), **tol)
    np.testing.assert_allclose(tc.terminal(xt[:, -1]).numpy(),
                               np.asarray(jax.vmap(jc.terminal)(xj[:, -1])), **tol)


def test_quad_cost_from_numpy_reproduces_the_jax_cost():
    """A JAX cost's arrays carried across give the same tensors and the same
    cost; by default they land on the card."""
    jc = jmpc.QuadCost(**{k: jnp.asarray(v) for k, v in _np_cost(CARTPOLE).items()})
    d = {k: np.asarray(getattr(jc, k)) for k in COST_ARRAYS}
    tc = quad_cost_from_numpy(d, device="cpu", dtype=torch.float64)
    for k in COST_ARRAYS:
        got = getattr(tc, k)
        assert got.dtype == torch.float64 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), d[k])
    rng = np.random.default_rng(1)
    xs, us = rng.uniform(-1, 1, (21, 4)), rng.uniform(-1, 1, (20, 1))
    np.testing.assert_allclose(tc.total(torch.as_tensor(xs), torch.as_tensor(us)).numpy(),
                               np.asarray(jc.total(jnp.asarray(xs), jnp.asarray(us))),
                               rtol=1e-14, atol=0)
    assert quad_cost_from_numpy(d, device="cpu").Q.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
            quad_cost_from_numpy(d)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_ilqr_cartpole_matches_jax(prec):
    """The accuracy line's problem (x0 = 0, T=40, 15 iterations): inputs,
    states, final cost and the per-iteration cost trace."""
    tdt, jdt = DTYPES[prec]
    jc, tc = _costs(CARTPOLE, prec)
    us0 = np.random.default_rng(3).standard_normal((40, 1)) * 0.05
    res = tmpc.ilqr(tm.cartpole(), tc, torch.zeros(4, dtype=tdt),
                    torch.as_tensor(us0, dtype=tdt), 0.05, iters=15)
    ref = _jax_ilqr(jm.cartpole(), jc, jnp.zeros(4, jdt), jnp.asarray(us0, jdt), 0.05,
                    iters=15)
    assert isinstance(res, tmpc.ILQRResult)
    assert res.xs.shape == (41, 4) and res.us.shape == (40, 1)
    assert res.cost.shape == () and res.costs.shape == (15,)
    assert res.us.dtype == tdt and res.costs.dtype == tdt
    scale = np.abs(np.asarray(ref.us)).max()
    np.testing.assert_allclose(res.us.numpy(), np.asarray(ref.us), rtol=0,
                               atol=US_TOL[prec] * scale)
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(ref.costs),
                               rtol=COST_RTOL[prec] * 10, atol=0)
    assert float(res.cost) == float(res.costs[-1])


def test_ilqr_unicycle_matches_jax():
    """The vehicle family in f64: a unicycle driven to a pose goal."""
    jc, tc = _costs(UNICYCLE, "f64")
    us0 = np.full((40, 2), 0.1)
    res = tmpc.ilqr(tm.unicycle(), tc, torch.zeros(3, dtype=torch.float64),
                    torch.as_tensor(us0), 0.1, iters=20, mu=1e-2)
    ref = _jax_ilqr(jm.unicycle(), jc, jnp.zeros(3), jnp.asarray(us0), 0.1, iters=20, mu=1e-2)
    np.testing.assert_allclose(res.us.numpy(), np.asarray(ref.us), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.xs.numpy(), np.asarray(ref.xs), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(ref.costs), rtol=1e-11, atol=0)


def test_ilqr_batched_matches_jax_and_each_row_its_own_solve():
    """``ilqr_batched`` against the JAX package's (``jax.vmap`` of
    ``ilqr``), f64; every row equals the single solve of that row. Row 0
    starts from an already converged plan, so it is rejected at every
    iteration while the others improve: its ``mu`` grows as theirs shrink,
    and each must still match its own solve."""
    jc, tc = _costs(CARTPOLE, "f64")
    T, iters = 20, 8
    rng = np.random.default_rng(4)
    x0s = rng.uniform(-0.2, 0.2, (3, 4))
    us0 = rng.standard_normal((3, T, 1)) * 0.05
    first = tmpc.ilqr(tm.cartpole(), tc, torch.as_tensor(x0s[0]), torch.as_tensor(us0[0]),
                      0.05, iters=40)
    us0[0] = first.us.numpy()
    res = tmpc.ilqr_batched(tm.cartpole(), tc, torch.as_tensor(x0s), torch.as_tensor(us0), 0.05,
                            iters=iters)
    ref = jax.jit(lambda x, u: jmpc.ilqr_batched(jm.cartpole(), jc, x, u, 0.05, iters=iters))(
        jnp.asarray(x0s), jnp.asarray(us0))
    assert res.xs.shape == (3, T + 1, 4) and res.us.shape == (3, T, 1)
    assert res.cost.shape == (3,) and res.costs.shape == (3, iters)
    # Row 0 sits at its optimum, where a candidate's gain is at rounding
    # level and either package may take one: it is held to 1e-9 of its
    # largest input (~76); the others to 1e-8.
    ref_us = np.asarray(ref.us)
    np.testing.assert_allclose(res.us[0].numpy(), ref_us[0], rtol=0,
                               atol=1e-9 * np.abs(ref_us[0]).max())
    np.testing.assert_allclose(res.us[1:].numpy(), ref_us[1:], rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(ref.costs), rtol=1e-11, atol=0)
    # row 0 never improves (its trace is flat), the others do
    trace = res.costs.numpy()
    assert np.ptp(trace[0]) <= 1e-12 * trace[0, 0]
    assert (trace[1:, -1] < trace[1:, 0]).all()
    for b in range(3):  # batched and single solves differ only in summation order
        one = tmpc.ilqr(tm.cartpole(), tc, torch.as_tensor(x0s[b]), torch.as_tensor(us0[b]),
                        0.05, iters=iters)
        np.testing.assert_allclose(res.us[b].numpy(), one.us.numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(res.costs[b].numpy(), one.costs.numpy(), rtol=1e-12, atol=0)


def test_singular_quu_is_rejected_by_the_line_search():
    """With no input effect (B = 0), R = 0 and mu = 0, Quu is exactly zero:
    its inverse is non-finite, as ``jnp.linalg.inv``'s is, so every
    candidate's cost is non-finite and the line search keeps the initial
    plan. No exception, no host-side check; the JAX package agrees."""
    dyn_t = lambda x, u: torch.cat([x[..., 1:2], -x[..., 0:1]], dim=-1)
    dyn_j = lambda x, u: jnp.stack([x[..., 1], -x[..., 0]], axis=-1)
    tmodel = tm.Model("drift", 2, 1, dyn_t)
    jmodel = jm.Model("drift", 2, 1, dyn_j)
    d = {"Q": np.eye(2), "R": np.zeros((1, 1)), "Qf": np.eye(2), "x_goal": np.zeros(2)}
    tc = quad_cost_from_numpy(d, device="cpu", dtype=torch.float64)
    jc = jmpc.QuadCost(**{k: jnp.asarray(v) for k, v in d.items()})
    x0 = np.array([[1.0, 0.0], [0.5, -0.5]])
    us0 = np.random.default_rng(5).standard_normal((2, 10, 1))
    res = tmpc.ilqr(tmodel, tc, torch.as_tensor(x0), torch.as_tensor(us0), 0.1, iters=3, mu=0.0)
    xs0 = tmpc.rollout(tmodel, torch.as_tensor(x0), torch.as_tensor(us0), 0.1)
    c0 = tc.total(xs0, torch.as_tensor(us0))
    assert torch.equal(res.us, torch.as_tensor(us0)) and torch.equal(res.xs, xs0)
    assert torch.equal(res.costs, c0[:, None].expand(2, 3))
    assert torch.isfinite(res.costs).all()
    ref = jax.jit(lambda x, u: jmpc.ilqr_batched(jmodel, jc, x, u, 0.1, iters=3, mu=0.0))(
        jnp.asarray(x0), jnp.asarray(us0))
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(ref.costs), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(np.asarray(ref.us), us0)


def test_ilqr_accuracy_line_on_the_cpu():
    """The accuracy line at its size (T=40, 15 iterations), f32 against f64
    both on the CPU here; the card's run is held to the same 1e-3."""
    du, scale, c32, c64 = tbench.ilqr_accuracy(device="cpu")
    assert scale > 10.0
    assert du < 1e-3, f"iLQR inputs in f32 off f64 by {du:.2e}"
    assert abs(c32 - c64) < 1e-5 * c64


def test_ilqr_bench_problem_is_the_reference_input():
    """``ilqr_bench.problem`` draws ``benchmarks/ilqr_bench.py``'s inputs
    (``default_rng(0)``: x0 within 0.2, inputs at 0.05) and its cost."""
    model, cost, x0s, us0 = ilqr_bench.problem(batch=6, horizon=7, device="cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(x0s.numpy(), np.float32(rng.uniform(-0.2, 0.2, (6, 4))))
    np.testing.assert_array_equal(us0.numpy(), np.float32(rng.standard_normal((6, 7, 1)) * 0.05))
    d = _np_cost(CARTPOLE)
    for k in COST_ARRAYS:
        np.testing.assert_array_equal(getattr(cost, k).numpy(), np.float32(d[k]))
    assert model.name == "cartpole"


def test_ilqr_timings_refuse_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        ilqr_bench.run(batch=2, horizon=3, iters=1, device="cpu")


def test_ilqr_accuracy_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
        tbench.ilqr_accuracy(T=3, iters=1)
