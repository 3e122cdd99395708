"""Slice B's Riccati recursion in the PyTorch port against the JAX package:
``lqr_gains``, ``lqr_apply`` and ``riccati_converge`` on the quadrotor's
hover linearization, the reference's two Riccati-versus-QP cross-checks run
against the port's own condensed QP, the converged gain against scipy's
discrete algebraic Riccati solution, and the accuracy line."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
scipy_linalg = pytest.importorskip("scipy.linalg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import strided_tpu.models as jm  # noqa: E402
import strided_tpu.mpc as jmpc  # noqa: E402
import strided_tpu_torch.models as tm  # noqa: E402
import strided_tpu_torch.mpc as tmpc  # noqa: E402
from strided_tpu_torch import bench as tbench  # noqa: E402
from strided_tpu_torch import config as tconfig  # noqa: E402
from strided_tpu_torch.capture import capture  # noqa: E402

Q_DIAG = [10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1]
DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}
# Gains reach ~9 and cost-to-go entries ~1e3 (at N=12), so the bounds are
# relative to each array's largest entry: f64 at rounding level, f32 a few
# hundred ulps after a dozen dependent solves.
REL = {"f64": 1e-12, "f32": 2e-5}


def _hover(dtype=torch.float64, dt=0.05):
    """Port side: (A, B, Q, R) of the quadrotor at hover."""
    A, B = tm.quadrotor().linearize(tm.hover_state(dtype), tm.hover_input(dtype=dtype), dt)
    Q = torch.diag(torch.tensor(Q_DIAG, dtype=dtype))
    return A, B, Q, torch.eye(4, dtype=dtype) * 0.1


def _jax_hover(dtype=jnp.float64, dt=0.05):
    A, B = jm.quadrotor().linearize(jm.hover_state(dtype), jm.hover_input(dtype=dtype), dt)
    return A, B, jnp.diag(jnp.array(Q_DIAG, dtype)), jnp.eye(4, dtype=dtype) * 0.1


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_lqr_gains_match_jax(prec):
    tdt, jdt = DTYPES[prec]
    N = 12
    Ks, Ps = tmpc.lqr_gains(*_hover(tdt), _hover(tdt)[2], N)
    A, B, Q, R = _jax_hover(jdt)
    Ks_j, Ps_j = jax.jit(lambda A, B: jmpc.lqr_gains(A, B, Q, R, Q, N))(A, B)
    assert Ks.shape == (N, 4, 12) and Ps.shape == (N + 1, 12, 12)
    assert Ks.dtype == tdt and Ps.dtype == tdt
    _close(Ks.numpy(), Ks_j, REL[prec], "Ks")
    _close(Ps.numpy(), Ps_j, REL[prec], "Ps")
    # time order: P_N is the terminal weight, and every P is symmetric
    assert torch.equal(Ps[-1], _hover(tdt)[2])
    assert torch.equal(Ps, Ps.mT)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_lqr_apply_matches_jax(prec):
    """The states before each step (N of them) and the inputs."""
    tdt, jdt = DTYPES[prec]
    N = 10
    A, B, Q, R = _hover(tdt)
    Ks, _ = tmpc.lqr_gains(A, B, Q, R, Q, N)
    x0 = np.random.default_rng(3).standard_normal(12) * 0.2
    xs, us = tmpc.lqr_apply(Ks, torch.as_tensor(x0, dtype=tdt), A, B)
    Aj, Bj, Qj, Rj = _jax_hover(jdt)
    Ks_j, _ = jmpc.lqr_gains(Aj, Bj, Qj, Rj, Qj, N)
    xs_j, us_j = jmpc.lqr_apply(Ks_j, jnp.asarray(x0, jdt), Aj, Bj)
    assert xs.shape == (N, 12) and us.shape == (N, 4) and xs.dtype == tdt
    np.testing.assert_array_equal(xs[0].numpy(), np.asarray(x0, xs.numpy().dtype))
    _close(xs.numpy(), xs_j, REL[prec], "xs")
    _close(us.numpy(), us_j, REL[prec], "us")


def test_riccati_converge_matches_jax_and_the_dare():
    """The fixpoint after 200 Riccati steps against JAX's, and against
    scipy's solution of the discrete algebraic Riccati equation (an oracle
    independent of both packages)."""
    A, B, Q, R = _hover(dt=0.1)
    K, P = tmpc.riccati_converge(A, B, Q, R)
    Aj, Bj, Qj, Rj = _jax_hover(dt=0.1)
    K_j, P_j = jax.jit(lambda A, B: jmpc.riccati_converge(A, B, Qj, Rj))(Aj, Bj)
    _close(K.numpy(), K_j, 1e-12, "K")
    _close(P.numpy(), P_j, 1e-12, "P")
    A_, B_, Q_, R_ = (t.numpy() for t in (A, B, Q, R))
    P_star = scipy_linalg.solve_discrete_are(A_, B_, Q_, R_)
    K_star = np.linalg.solve(R_ + B_.T @ P_star @ B_, B_.T @ P_star @ A_)
    _close(P.numpy(), P_star, 1e-8, "P vs DARE")
    _close(K.numpy(), K_star, 1e-8, "K vs DARE")


def test_riccati_first_input_matches_condensed_qp():
    """Two independent solvers of the same finite-horizon LQ problem (the
    port's Riccati recursion and its condensed-QP gain) give the same
    optimal first input (tests/test_mpc.py, run on the port)."""
    N = 12
    A, B, Q, R = _hover()
    qp = tmpc.build_condensed(A, B, Q, R, Q, N)
    Ks, _ = tmpc.lqr_gains(A, B, Q, R, Q, N)
    x0 = torch.as_tensor(np.random.default_rng(11).standard_normal(12) * 0.3)
    u_qp = tmpc.qp_solve_unconstrained(qp, x0)[0]
    u_ric = -(Ks[0] @ x0)
    np.testing.assert_allclose(u_qp.numpy(), u_ric.numpy(), rtol=1e-6, atol=1e-9)


def test_riccati_full_horizon_matches_qp_plan():
    N = 8
    A, B, Q, R = _hover()
    qp = tmpc.build_condensed(A, B, Q, R, Q, N)
    Ks, _ = tmpc.lqr_gains(A, B, Q, R, Q, N)
    x0 = torch.as_tensor(np.random.default_rng(12).standard_normal(12) * 0.2)
    U_qp = tmpc.qp_solve_unconstrained(qp, x0)
    _, us = tmpc.lqr_apply(Ks, x0, A, B)
    np.testing.assert_allclose(U_qp.numpy(), us.numpy(), rtol=1e-5, atol=1e-8)


def test_riccati_and_ilqr_run_under_the_precision_scope():
    """The solvers pin IEEE FP32 products as the reference does
    (``riccati.py:23,48``, ``ilqr.py:116``): each is wrapped by
    ``config.matmul_precision_scope``, which
    ``test_torch_mpc.py::test_matmul_precision_scope_pins_and_restores``
    checks. ``ilqr`` is captured (``capture.capture``) around its scoped
    body."""
    scope = tconfig.matmul_precision_scope(lambda: None).__code__
    assert tmpc.ilqr.__code__ is capture(lambda: None).__code__
    for fn in (tmpc.lqr_gains, tmpc.lqr_apply, tmpc.ilqr.__wrapped__):
        assert fn.__code__ is scope and callable(fn.__wrapped__)


def test_riccati_accuracy_line_on_the_cpu():
    """The accuracy line at its size (N=50), f32 against f64 both on the CPU
    here; the card's run is held to the same 1e-4."""
    dK, scale = tbench.riccati_accuracy(device="cpu")
    assert scale > 1.0
    assert dK < 1e-4, f"K_0 in f32 off the f64 gain by {dK:.2e}"


def test_riccati_accuracy_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
        tbench.riccati_accuracy(N=3)
