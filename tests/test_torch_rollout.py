"""Slice B's models and rollouts in the PyTorch port against the JAX package:
the pendulum, cartpole and vehicle models (dynamics, RK4 step, Jacobians),
``rollout`` and ``rollout_final``, the double pendulum's bench input, and the
timing's refusal of the CPU."""

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

# f64: the same formulas in the same order, so agreement is at rounding
# level. f32: sin, cos and tan of the two libraries differ by an ulp or so.
# Dynamics values reach ~20 (g = 9.81 over unit lengths), so they are held
# to ten times the bound of the step and the Jacobians, whose entries are
# O(1).
TOL = {"f64": 1e-12, "f32": 1e-6}
DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}
MODELS = ["simple_pendulum", "double_pendulum", "cartpole", "unicycle", "bicycle"]


def _inputs(name, seed, batch=(5,)):
    model = getattr(tm, name)()
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (*batch, model.state_dim))
    u = rng.uniform(-0.5, 0.5, (*batch, model.input_dim))
    return x, u


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", MODELS)
def test_model_dynamics_and_step_match_jax(name, prec):
    tdt, jdt = DTYPES[prec]
    x, u = _inputs(name, 0)
    jmod, tmod = getattr(jm, name)(), getattr(tm, name)()
    xt, ut = torch.as_tensor(x, dtype=tdt), torch.as_tensor(u, dtype=tdt)
    xj, uj = jnp.asarray(x, jdt), jnp.asarray(u, jdt)
    f_t, s_t = tmod.dynamics(xt, ut), tmod.step(xt, ut, 0.05)
    assert f_t.dtype == tdt and s_t.dtype == tdt and s_t.shape == xt.shape
    assert (tmod.state_dim, tmod.input_dim) == (jmod.state_dim, jmod.input_dim)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(jmod.dynamics(xj, uj)),
                               rtol=0, atol=TOL[prec] * 10)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(jmod.step(xj, uj, 0.05)),
                               rtol=0, atol=TOL[prec])


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", MODELS)
def test_model_linearize_matches_jax_and_keeps_the_dtype(name, prec):
    """Batched Jacobians of the step against JAX's. In f32 they stay f32:
    under ``torch.func.jacfwd`` a 0-dim slice times a Python float would
    promote the Jacobian to float64, which the models avoid."""
    tdt, jdt = DTYPES[prec]
    x, u = _inputs(name, 1)
    jmod, tmod = getattr(jm, name)(), getattr(tm, name)()
    A_t, B_t = tm.linearize(tmod, torch.as_tensor(x, dtype=tdt),
                            torch.as_tensor(u, dtype=tdt), 0.05)
    A_j, B_j = jax.jit(lambda x, u: jm.linearize(jmod, x, u, 0.05))(
        jnp.asarray(x, jdt), jnp.asarray(u, jdt))
    n, m = tmod.state_dim, tmod.input_dim
    assert A_t.shape == (5, n, n) and B_t.shape == (5, n, m)
    assert A_t.dtype == tdt and B_t.dtype == tdt
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=0, atol=TOL[prec])
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), rtol=0, atol=TOL[prec])
    # one point: Model.linearize, unbatched
    A0, B0 = tmod.linearize(torch.as_tensor(x[3], dtype=tdt), torch.as_tensor(u[3], dtype=tdt),
                            0.05)
    assert A0.dtype == tdt and B0.dtype == tdt
    np.testing.assert_allclose(A0.numpy(), A_t[3].numpy(), rtol=0, atol=TOL[prec])
    np.testing.assert_allclose(B0.numpy(), B_t[3].numpy(), rtol=0, atol=TOL[prec])


def _rollout_inputs(batch, T=50):
    rng = np.random.default_rng(1)
    return (rng.standard_normal((*batch, 4)) * 0.1,
            rng.standard_normal((*batch, T, 2)) * 0.01)


@pytest.mark.parametrize("batch", [(), (16,), (2, 3)])
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_rollout_matches_jax(prec, batch):
    """Double-pendulum rollouts at the reference tests' amplitudes (0.1 rad
    states, 0.01 inputs; the system is chaotic) over 50 steps of 0.01 s,
    within the step's tolerance; ``rollout_final`` is the last state of
    ``rollout`` bit for bit."""
    tdt, jdt = DTYPES[prec]
    x0, us = _rollout_inputs(batch)
    xt, ut = torch.as_tensor(x0, dtype=tdt), torch.as_tensor(us, dtype=tdt)
    xs = tmpc.rollout(tm.double_pendulum(), xt, ut, 0.01)
    xs_j = jax.jit(lambda x, u: jmpc.rollout(jm.double_pendulum(), x, u, 0.01))(
        jnp.asarray(x0, jdt), jnp.asarray(us, jdt))
    assert xs.shape == (*batch, 51, 4) and xs.dtype == tdt
    assert torch.equal(xs[..., 0, :], xt)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), rtol=0, atol=TOL[prec])
    xT = tmpc.rollout_final(tm.double_pendulum(), xt, ut, 0.01)
    assert torch.equal(xT, xs[..., -1, :])
    xT_j = jax.jit(lambda x, u: jmpc.rollout_final(jm.double_pendulum(), x, u, 0.01))(
        jnp.asarray(x0, jdt), jnp.asarray(us, jdt))
    np.testing.assert_allclose(xT.numpy(), np.asarray(xT_j), rtol=0, atol=TOL[prec])


def test_rollout_problem_is_the_reference_bench_input():
    """``bench.rollout_problem`` draws BASELINE config 2's inputs as
    ``bench.py::bench_rollouts`` does (``default_rng(2)``, 0.1 and 0.01)."""
    model, x0, us = tbench.rollout_problem("cpu", batch=8, T=5)
    rng = np.random.default_rng(2)
    np.testing.assert_array_equal(x0.numpy(), np.float32(rng.standard_normal((8, 4)) * 0.1))
    np.testing.assert_array_equal(us.numpy(), np.float32(rng.standard_normal((8, 5, 2)) * 0.01))
    assert model.name == "double_pendulum" and x0.dtype == torch.float32


def test_rollout_times_refuse_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.rollout_times(device="cpu", batch=8, T=5)
