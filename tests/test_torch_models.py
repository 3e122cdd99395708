"""Parity of the PyTorch port's models (strided_tpu_torch.models) with the
JAX package: quadrotor dynamics, RK4 step and Jacobians on the same inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import strided_tpu.models as jm  # noqa: E402
import strided_tpu_torch.models as tm  # noqa: E402

# f64: the same formulas in the same order, so agreement is at rounding level.
# f32: sin, cos and tan of the two libraries differ by an ulp or so.
TOL = {"f64": 1e-12, "f32": 1e-6}
DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}


def _inputs(seed, batch=(8,)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (*batch, 12))
    u = np.array([9.81, 0.0, 0.0, 0.0]) + rng.uniform(-1.0, 1.0, (*batch, 4))
    return x, u


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_quadrotor_dynamics_and_step_match_jax(prec):
    tdt, jdt = DTYPES[prec]
    x, u = _inputs(0)
    jmod, tmod = jm.quadrotor(), tm.quadrotor()
    xt, ut = torch.as_tensor(x, dtype=tdt), torch.as_tensor(u, dtype=tdt)
    xj, uj = jnp.asarray(x, jdt), jnp.asarray(u, jdt)
    f_t = tmod.dynamics(xt, ut)
    s_t = tmod.step(xt, ut, 0.02)
    assert f_t.dtype == tdt and s_t.dtype == tdt
    np.testing.assert_allclose(f_t.numpy(), np.asarray(jmod.dynamics(xj, uj)),
                               rtol=0, atol=TOL[prec] * 10)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(jmod.step(xj, uj, 0.02)),
                               rtol=0, atol=TOL[prec])


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("dt", [0.02, 0.05])
def test_hover_linearization_matches_jax(prec, dt):
    tdt, jdt = DTYPES[prec]
    A_t, B_t = tm.quadrotor().linearize(
        tm.hover_state(tdt, "cpu"), tm.hover_input(dtype=tdt, device="cpu"), dt
    )
    A_j, B_j = jm.quadrotor().linearize(
        jm.hover_state(jdt), jm.hover_input(dtype=jdt), dt
    )
    assert A_t.shape == (12, 12) and B_t.shape == (12, 4)
    assert A_t.dtype == tdt and B_t.dtype == tdt
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=0, atol=TOL[prec])
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), rtol=0, atol=TOL[prec])


def test_batched_linearize_matches_jax():
    x, u = _inputs(1, batch=(4,))
    A_t, B_t = tm.linearize(tm.quadrotor(), torch.as_tensor(x), torch.as_tensor(u), 0.05)
    A_j, B_j = jm.linearize(jm.quadrotor(), jnp.asarray(x), jnp.asarray(u), 0.05)
    assert A_t.shape == (4, 12, 12) and B_t.shape == (4, 12, 4)
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), rtol=0, atol=1e-12)
    # each batch entry is the single-point linearization
    A0, B0 = tm.quadrotor().linearize(torch.as_tensor(x[2]), torch.as_tensor(u[2]), 0.05)
    np.testing.assert_allclose(A_t[2].numpy(), A0.numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(B_t[2].numpy(), B0.numpy(), rtol=0, atol=1e-14)


def test_rk4_step_is_exact_for_linear_dynamics():
    """RK4 integrates x' = a x to fourth order: one step equals the degree-4
    Taylor polynomial of exp(a dt)."""
    a, dt = -1.3, 0.1
    x = torch.tensor([1.0, -2.0], dtype=torch.float64)
    got = tm.rk4_step(lambda x, u: a * x, x, None, dt)
    h = a * dt
    want = x * (1 + h + h**2 / 2 + h**3 / 6 + h**4 / 24)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-15)


def test_hover_point_is_on_the_card_unless_asked():
    """``hover_state`` and ``hover_input`` go to the card unless ``device``
    is given (without CUDA: torch's own error); with ``device="cpu"`` they
    equal the JAX package's hover point."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    no_cuda = (AssertionError, RuntimeError)  # a CPU build of torch asserts, else it raises
    for make in (tm.hover_state, tm.hover_input):
        with pytest.raises(no_cuda, match="CUDA|NVIDIA"):
            make()
        with pytest.raises(no_cuda, match="CUDA|NVIDIA"):
            make(dtype=torch.float64)
    for tdt, jdt in DTYPES.values():
        xs, us = tm.hover_state(tdt, "cpu"), tm.hover_input(dtype=tdt, device="cpu")
        assert xs.device.type == us.device.type == "cpu"
        assert xs.dtype == us.dtype == tdt
        np.testing.assert_array_equal(xs.numpy(), np.asarray(jm.hover_state(jdt)))
        np.testing.assert_array_equal(us.numpy(), np.asarray(jm.hover_input(dtype=jdt)))
