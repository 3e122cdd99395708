"""The reference's behaviour tests of slice B, run on the PyTorch port:
``tests/test_models.py`` (equilibria, energy conservation, Jacobians against
finite differences, batched shapes, the vehicles) and ``tests/test_mpc.py``
(cartpole iLQR descent and swing-up), each with the reference's sizes and
bounds. The parity tests against the JAX package are in
``test_torch_rollout.py``, ``test_torch_riccati.py`` and
``test_torch_ilqr.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import strided_tpu_torch.models as tm  # noqa: E402
import strided_tpu_torch.mpc as tmpc  # noqa: E402
from strided_tpu_torch.convert import quad_cost_from_numpy  # noqa: E402


def _cost(Q, R, Qf, x_goal):
    d = {"Q": np.diag(Q), "R": np.diag(R), "Qf": np.diag(Qf), "x_goal": np.array(x_goal)}
    return quad_cost_from_numpy(d, device="cpu", dtype=torch.float64)


# --- tests/test_models.py ---


def test_simple_pendulum_equilibrium():
    m = tm.simple_pendulum()
    xd = m.dynamics(torch.zeros(2, dtype=torch.float64), torch.zeros(1, dtype=torch.float64))
    np.testing.assert_allclose(xd.numpy(), 0.0, atol=1e-12)


def test_double_pendulum_energy_conservation():
    """Passive double pendulum conserves energy under small-dt RK4."""
    m = tm.double_pendulum()
    x0 = torch.tensor([0.5, -0.3, 0.0, 0.0], dtype=torch.float64)
    xs = tmpc.rollout(m, x0, torch.zeros(2000, 2, dtype=torch.float64), dt=1e-3)

    def energy(x):
        th1, th2, w1, w2 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
        # m1=m2=l1=l2=1, g=9.81
        v2sq = w1**2 + w2**2 + 2 * w1 * w2 * torch.cos(th1 - th2)
        return 0.5 * w1**2 + 0.5 * v2sq - 9.81 * (2 * torch.cos(th1) + torch.cos(th2))

    e = energy(xs).numpy()
    assert abs(e[-1] - e[0]) < 1e-4 * max(1.0, abs(e[0]))


def test_cartpole_down_equilibrium():
    m = tm.cartpole()
    xd = m.dynamics(torch.zeros(4, dtype=torch.float64), torch.zeros(1, dtype=torch.float64))
    np.testing.assert_allclose(xd.numpy(), 0.0, atol=1e-12)


def test_quadrotor_hover_equilibrium():
    xd = tm.quadrotor().dynamics(tm.hover_state(device="cpu"), tm.hover_input(device="cpu"))
    np.testing.assert_allclose(xd.numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("name", ["quadrotor", "cartpole", "bicycle"])
def test_linearize_matches_finite_difference(name):
    """Forward differences of the f64 step (eps 1e-6) within 1e-5, as the
    reference's test holds the quadrotor."""
    m = getattr(tm, name)()
    n, k = m.state_dim, m.input_dim
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(n) * 0.1)
    u = torch.as_tensor(rng.standard_normal(k) * 0.1)
    if name == "quadrotor":
        u = u + tm.hover_input(dtype=torch.float64, device="cpu")
    A, B = m.linearize(x, u, 0.02)
    eps, base = 1e-6, m.step(x, u, 0.02)
    fd_A = torch.stack([(m.step(x + eps * e, u, 0.02) - base) / eps
                        for e in torch.eye(n, dtype=torch.float64)], dim=-1)
    fd_B = torch.stack([(m.step(x, u + eps * e, 0.02) - base) / eps
                        for e in torch.eye(k, dtype=torch.float64)], dim=-1)
    np.testing.assert_allclose(A.numpy(), fd_A.numpy(), atol=1e-5)
    np.testing.assert_allclose(B.numpy(), fd_B.numpy(), atol=1e-5)


def test_batched_rollout_shapes_and_consistency():
    m = tm.double_pendulum()
    B, T = 64, 50
    rng = np.random.default_rng(1)
    x0 = torch.as_tensor(rng.standard_normal((B, 4)) * 0.1)
    us = torch.as_tensor(rng.standard_normal((B, T, 2)) * 0.01)
    xs = tmpc.rollout(m, x0, us, dt=0.01)
    assert xs.shape == (B, T + 1, 4)
    # batched result row 0 == unbatched rollout of row 0
    xs0 = tmpc.rollout(m, x0[0], us[0], dt=0.01)
    np.testing.assert_allclose(xs[0].numpy(), xs0.numpy(), rtol=1e-6, atol=1e-8)
    xT = tmpc.rollout_final(m, x0, us, dt=0.01)
    np.testing.assert_allclose(xT.numpy(), xs[:, -1].numpy(), rtol=1e-6, atol=1e-8)


def test_batched_linearize_shapes():
    A, B = tm.linearize(tm.cartpole(), torch.zeros(8, 10, 4), torch.zeros(8, 10, 1), 0.02)
    assert A.shape == (8, 10, 4, 4) and B.shape == (8, 10, 4, 1)
    assert A.dtype == torch.float32 and B.dtype == torch.float32


def test_bicycle_rollout_straight_line():
    x0 = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)  # moving at 1 m/s
    xs = tmpc.rollout(tm.bicycle(), x0, torch.zeros(100, 2, dtype=torch.float64), dt=0.01)
    np.testing.assert_allclose(float(xs[-1, 0]), 1.0, rtol=1e-5)  # x advanced 1 m
    np.testing.assert_allclose(float(xs[-1, 1]), 0.0, atol=1e-9)


def test_unicycle_ilqr_tracks_goal():
    """Vehicle-family iLQR: drive a unicycle to a pose goal."""
    cost = _cost([1.0, 1.0, 0.1], [0.01, 0.01], [100.0, 100.0, 10.0], [2.0, 1.0, 0.0])
    res = tmpc.ilqr(tm.unicycle(), cost, torch.zeros(3, dtype=torch.float64),
                    torch.full((40, 2), 0.1, dtype=torch.float64), 0.1, iters=40, mu=1e-2)
    assert np.linalg.norm(res.xs[-1, :2].numpy() - np.array([2.0, 1.0])) < 0.1


# --- tests/test_mpc.py ---


def test_cartpole_ilqr_cost_descends():
    cost = _cost([1.0, 10.0, 0.1, 0.1], [0.01], [10.0, 100.0, 1.0, 1.0], [0.0, np.pi, 0.0, 0.0])
    T = 60
    x0, us0 = torch.zeros(4, dtype=torch.float64), torch.zeros(T, 1, dtype=torch.float64)
    res = tmpc.ilqr(tm.cartpole(), cost, x0, us0, 0.05, iters=40)
    trace = res.costs.numpy()
    assert res.cost < cost.total(x0.expand(T + 1, 4), us0)  # improved over doing nothing
    assert (np.diff(trace) <= 1e-6).all()  # the line search guards descent
    assert trace[-1] < 0.5 * trace[0]


def test_cartpole_ilqr_swingup_reaches_upright():
    cost = _cost([0.1, 1.0, 0.1, 0.1], [0.001], [10.0, 500.0, 10.0, 10.0], [0.0, np.pi, 0.0, 0.0])
    us0 = torch.as_tensor(np.random.default_rng(6).standard_normal((100, 1)) * 0.1)
    res = tmpc.ilqr(tm.cartpole(), cost, torch.zeros(4, dtype=torch.float64), us0, 0.04,
                    iters=60, mu=1e-2)
    assert abs(float(res.xs[-1, 1]) - np.pi) < 0.3  # near upright
