"""The port's MPC slice as a whole (strided_tpu_torch) against the JAX
package: converted controllers, the port's own controller construction, the
entry step, the closed loop, the accuracy gate, and the import boundary."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import strided_tpu.models as jm  # noqa: E402
import strided_tpu.mpc as jmpc  # noqa: E402
import strided_tpu_torch as stt  # noqa: E402
from strided_tpu_torch import bench as tbench  # noqa: E402
from strided_tpu_torch import config as tconfig  # noqa: E402
from strided_tpu_torch import entry as tentry  # noqa: E402
from strided_tpu_torch.convert import MPC_ARRAYS, QP_ARRAYS, linear_mpc_from_numpy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q_DIAG = [10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1]
U_MIN = [-5.0, -0.5, -0.5, -0.5]
U_MAX = [10.0, 0.5, 0.5, 0.5]


def linear_mpc_to_numpy(ctrl) -> dict:
    """The JAX controller's state as numpy arrays and scalars, the input of
    strided_tpu_torch.convert.linear_mpc_from_numpy."""
    qp = ctrl.qp
    d = {k: np.asarray(getattr(qp, k)) for k in QP_ARRAYS}
    d.update(rho=qp.rho, N=qp.N, n=qp.n, m=qp.m, use_chol=qp.use_chol)
    d.update({k: np.asarray(getattr(ctrl, k)) for k in MPC_ARRAYS})
    d.update(admm_iters=ctrl.admm_iters, constrained=ctrl.constrained)
    return d


def _jax_ctrl(N, dtype, dt=0.05, bound=0.5, iters=20, rho=1.0):
    Q = jnp.diag(jnp.array(Q_DIAG, dtype))
    R = jnp.eye(4, dtype=dtype) * 0.1
    return jmpc.make_hover_mpc(
        jm.quadrotor(), jm.hover_state(dtype), jm.hover_input(dtype=dtype), Q, R, Q,
        horizon=N, dt=dt,
        u_min=jnp.array([-5.0, -bound, -bound, -bound], dtype),
        u_max=jnp.array([10.0, bound, bound, bound], dtype),
        admm_iters=iters, rho=rho,
    )


def _torch_ctrl(N, dtype, dt=0.05, bound=0.5, iters=20, rho=1.0):
    Q = torch.diag(torch.tensor(Q_DIAG, dtype=dtype))
    R = torch.eye(4, dtype=dtype) * 0.1
    return stt.make_hover_mpc(
        stt.quadrotor(), stt.hover_state(dtype), stt.hover_input(dtype=dtype), Q, R, Q,
        horizon=N, dt=dt,
        u_min=torch.tensor([-5.0, -bound, -bound, -bound], dtype=dtype),
        u_max=torch.tensor([10.0, bound, bound, bound], dtype=dtype),
        admm_iters=iters, rho=rho,
    )


@pytest.mark.parametrize(
    "prec,N,batch,tol",
    # f64: identical data and operations, rounding-level agreement. f32 at
    # rho=8, ADMM-6: the JAX side runs its fused kernel (interpret mode), the
    # port its loop; only the f32 summation order differs.
    [("f64", 10, 16, 1e-12), ("f32", 8, 32, 1e-5)],
)
def test_converted_controller_matches_jax(prec, N, batch, tol):
    jdt, tdt = (jnp.float64, torch.float64) if prec == "f64" else (jnp.float32, torch.float32)
    jc = _jax_ctrl(N, jdt, iters=6, rho=8.0)
    tc = linear_mpc_from_numpy(linear_mpc_to_numpy(jc), device="cpu", dtype=tdt)
    assert tc.qp.solver.dtype == tdt and tc.admm_iters == 6 and tc.qp.N == N
    x = np.random.default_rng(batch).uniform(-0.3, 0.3, (batch, 12))
    u_j, U_j = jc.control(jnp.asarray(x, jdt))
    u_t, U_t = tc.control(torch.as_tensor(x, dtype=tdt))
    assert u_t.shape == (batch, 4) and U_t.shape == (batch, N, 4)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=tol)
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), rtol=0, atol=tol)
    np.testing.assert_allclose(tc.plan(torch.as_tensor(x, dtype=tdt)).numpy(),
                               np.asarray(jc.plan(jnp.asarray(x, jdt))), rtol=0, atol=tol)


def test_port_make_hover_mpc_matches_jax():
    """The port's own construction (torch.func linearization, f64 host
    condensing) gives the JAX controller, and the same control."""
    jc = _jax_ctrl(10, jnp.float64)
    tc = _torch_ctrl(10, torch.float64)
    for name in QP_ARRAYS:
        want = np.asarray(getattr(jc.qp, name))
        np.testing.assert_allclose(getattr(tc.qp, name).numpy(), want, rtol=1e-9,
                                   atol=1e-12 * np.abs(want).max(), err_msg=name)
    assert tc.constrained and tc.qp.use_chol == jc.qp.use_chol
    x = np.random.default_rng(2).uniform(-0.3, 0.3, (8, 12))
    np.testing.assert_allclose(tc.control(torch.as_tensor(x))[0].numpy(),
                               np.asarray(jc.control(jnp.asarray(x))[0]), rtol=0, atol=1e-9)


def test_unconstrained_controller_matches_jax():
    Q = np.diag(np.array(Q_DIAG, float))
    jc = jmpc.make_hover_mpc(jm.quadrotor(), jm.hover_state(jnp.float64),
                             jm.hover_input(dtype=jnp.float64), Q, np.eye(4) * 0.1, Q,
                             horizon=8, dt=0.05)
    tc = stt.make_hover_mpc(stt.quadrotor(), stt.hover_state(torch.float64),
                            stt.hover_input(dtype=torch.float64), Q, np.eye(4) * 0.1, Q,
                            horizon=8, dt=0.05)
    assert not tc.constrained and not jc.constrained
    x = np.random.default_rng(9).uniform(-0.3, 0.3, (4, 12))
    np.testing.assert_allclose(tc.plan(torch.as_tensor(x)).numpy(),
                               np.asarray(jc.plan(jnp.asarray(x))), rtol=0, atol=1e-10)


def _graft_entry():
    sys.path.insert(0, ROOT)
    import __graft_entry__

    return __graft_entry__


def test_entry_step_matches_jax():
    """One entry()-style closed-loop step (control, then RK4) at the headline
    size (N=50, ADMM-6, rho=8, f32, batch 256): the port's step on the JAX
    controller's data against the JAX step, and the port's own controller
    against the JAX one."""
    ge = _graft_entry()
    jfn, (xj,) = ge.entry()
    model, jc = ge._make_controller(horizon=50, dt=0.02)
    tfn, (xt,) = tentry.entry("cpu")
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    want = np.asarray(jfn(xj))

    tmodel = stt.quadrotor()
    tc = linear_mpc_from_numpy(linear_mpc_to_numpy(jc), device="cpu")
    got = tmodel.step(xt, tc.control(xt)[0], 0.02)
    assert got.shape == (256, 12) and got.dtype == torch.float32
    # f32 summation order only. At N=50 the ADMM output agrees to 1e-4 (|g|
    # reaches ~1.4e3), and one RK4 step maps a torque error du to
    # |dx| ~ dt |du| / J = 2 |du|.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)

    # the port's own controller: f32 linearizations of the two libraries
    # differ in the last ulps, which the f64 condensing carries into M, K, S
    _, tc_own = tentry.make_controller(horizon=50, dt=0.02, device="cpu")
    for name in ("M", "K_lqr", "solver"):
        a, b = getattr(tc_own.qp, name).numpy(), np.asarray(getattr(jc.qp, name))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(), err_msg=name)
    np.testing.assert_allclose(tfn(xt).numpy(), want, rtol=0, atol=2e-4)


def test_closed_loop_matches_jax_f64():
    jc = _jax_ctrl(10, jnp.float64, iters=30)
    tc = linear_mpc_from_numpy(linear_mpc_to_numpy(jc), device="cpu", dtype=torch.float64)
    x0 = np.random.default_rng(4).uniform(-0.3, 0.3, (3, 12))
    xs_j, us_j = jmpc.closed_loop(jc, jm.quadrotor(), jnp.asarray(x0), steps=20, dt=0.05)
    xs_t, us_t = stt.closed_loop(tc, stt.quadrotor(), torch.as_tensor(x0), steps=20, dt=0.05)
    assert xs_t.shape == (3, 21, 12) and us_t.shape == (3, 20, 4)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=0, atol=1e-9)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=0, atol=1e-9)


def test_quadrotor_mpc_stabilizes_hover():
    """Mirror of tests/test_mpc.py::test_quadrotor_mpc_stabilizes_hover on
    the port."""
    dt = 0.05
    ctrl = _torch_ctrl(15, torch.float64, dt=dt, iters=30)
    rng = np.random.default_rng(4)
    x0 = torch.as_tensor(np.concatenate([rng.uniform(-0.5, 0.5, 3), np.zeros(9)]))
    xs, us = stt.closed_loop(ctrl, stt.quadrotor(), x0, steps=80, dt=dt)
    assert xs.shape == (81, 12) and us.shape == (80, 4)
    final = xs[-1].numpy()
    assert np.linalg.norm(final[:3]) < 5e-2  # position regulated to origin
    assert np.linalg.norm(final[3:6]) < 5e-2


def test_quadrotor_mpc_batched_matches_single():
    """Mirror of tests/test_mpc.py::test_quadrotor_mpc_batched_matches_single
    on the port."""
    ctrl = _torch_ctrl(10, torch.float64, bound=0.2)
    x0s = torch.as_tensor(np.random.default_rng(5).uniform(-0.3, 0.3, (16, 12)))
    u_b, _ = ctrl.control(x0s)
    u_0, _ = ctrl.control(x0s[0])
    np.testing.assert_allclose(u_b[0].numpy(), u_0.numpy(), rtol=1e-8, atol=1e-10)


def test_bench_config_accuracy():
    """Mirror of tests/test_mpc.py::test_bench_config_accuracy on the port:
    the headline configuration (N=50, ADMM-6, rho=8, f32) against a
    converged f64 ADMM oracle on the same QP."""
    dev_first, dev_plan, uscale = tbench.mpc_accuracy(device="cpu", batch=64)
    assert uscale > 1.0
    assert dev_first < 1e-4, f"first applied input off by {dev_first:.2e}"
    assert dev_plan < 0.15, f"horizon plan off by {dev_plan:.2e}"


def test_timings_refuse_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.mpc_solves(device="cpu", batch=8)


def test_step_device_time_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.step_device_ms(device="cpu", batch=8)


def test_quadrotor_constants_follow_the_state_dtype():
    """The dynamics make their constants once per dtype and device (so a
    step copies nothing from the host and can be captured in a CUDA graph):
    an f32 call after an f64 one still stays f32, and repeated calls agree."""
    f = stt.quadrotor().dynamics
    x = torch.as_tensor(np.random.default_rng(4).uniform(-0.3, 0.3, (5, 12)))
    u = torch.as_tensor(np.random.default_rng(5).uniform(-1.0, 1.0, (5, 4)))
    d64 = f(x, u)
    d32 = f(x.float(), u.float())
    assert d64.dtype == torch.float64 and d32.dtype == torch.float32
    assert torch.equal(f(x.float(), u.float()), d32) and torch.equal(f(x, u), d64)
    np.testing.assert_allclose(d32.numpy(), d64.numpy(), rtol=1e-5, atol=1e-5)


def test_matmul_precision_scope_pins_and_restores():
    seen = []
    scoped = tconfig.matmul_precision_scope(
        lambda: seen.append((torch.get_float32_matmul_precision(),
                             torch.backends.cuda.matmul.allow_tf32)))
    old = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.set_float32_matmul_precision("high")
        scoped()
        assert seen == [("highest", False)]
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(old[0])
        torch.backends.cuda.matmul.allow_tf32 = old[1]


def test_import_does_not_load_jax():
    """Nor the JAX package. A multi-process worker checks its own
    ``sys.modules`` the same way before it prints ``MULTIPROC_OK``
    (``tests/test_torch_multiproc.py``)."""
    code = (
        "import sys\n"
        "import strided_tpu_torch, strided_tpu_torch.entry, strided_tpu_torch.bench\n"
        "import strided_tpu_torch.convert, strided_tpu_torch._build\n"
        "import strided_tpu_torch.api, strided_tpu_torch.ops\n"
        "from strided_tpu_torch.core import view, regularize, planner, broadcast, ewise\n"
        "from strided_tpu_torch.core import lazy_expr, mapreduce, kernels_special\n"
        "from strided_tpu_torch.core import stream_reduce, executor_cuda\n"
        "import strided_tpu_torch.benchmarks.exp_admm\n"
        "import strided_tpu_torch.mpc.riccati, strided_tpu_torch.mpc.rollout\n"
        "import strided_tpu_torch.mpc.ilqr, strided_tpu_torch.models.pendulum\n"
        "import strided_tpu_torch.models.cartpole, strided_tpu_torch.models.vehicles\n"
        "import strided_tpu_torch.benchmarks.ilqr_bench\n"
        "import strided_tpu_torch.parallel, strided_tpu_torch.parallel.multiproc\n"
        "import strided_tpu_torch.utils, strided_tpu_torch.benchmarks.scenario_mpc\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert not any(m.startswith('strided_tpu.') or m == 'strided_tpu' for m in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


NO_CUDA = (AssertionError, RuntimeError)  # torch's refusal: a CPU build asserts, else it raises


def test_mpc_entry_points_default_to_the_card():
    """``linear_mpc_from_numpy`` and ``mpc_accuracy`` run on the card unless
    asked for the CPU: without CUDA they raise torch's own error, never
    fall back to a silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    d = linear_mpc_to_numpy(_jax_ctrl(5, jnp.float32, iters=6))
    with pytest.raises(NO_CUDA, match="CUDA|NVIDIA"):
        linear_mpc_from_numpy(d)
    with pytest.raises(NO_CUDA, match="CUDA|NVIDIA"):
        tbench.mpc_accuracy(batch=2, horizon=5)
    assert linear_mpc_from_numpy(d, device="cpu").qp.H.device.type == "cpu"
