"""Parity of the port's condensed QP (strided_tpu_torch.mpc.qp) and of the
fused-ADMM kernel module's plain version (strided_tpu_torch.mpc.fused_admm)
with the JAX package, on the same numpy inputs. The JAX fused kernel runs in
Pallas interpret mode on the CPU, as the JAX package's own tests run it."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import strided_tpu.mpc.qp as jqp  # noqa: E402
import strided_tpu_torch.mpc.qp as tqp  # noqa: E402
from strided_tpu.config import get_config as jget, set_config as jset  # noqa: E402
from strided_tpu.models import hover_input, hover_state, quadrotor  # noqa: E402
from strided_tpu_torch.mpc import fused_admm as tfa  # noqa: E402

Q_DIAG = [10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1]
U_MIN = np.array([-5.0, -0.5, -0.5, -0.5])
U_MAX = np.array([10.0, 0.5, 0.5, 0.5])


def _quad_data(dt=0.05, r=0.1):
    """(A, B, Q, R) of the quadrotor at hover, as f64 numpy arrays."""
    A, B = quadrotor().linearize(hover_state(jnp.float64), hover_input(dtype=jnp.float64), dt)
    return np.asarray(A), np.asarray(B), np.diag(np.array(Q_DIAG, float)), np.eye(4) * r


def _both_qps(N, rho=1.0, dtype="f64", r=0.1, dt=0.05):
    A, B, Q, R = _quad_data(dt=dt, r=r)
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jq = jqp.build_condensed(jnp.asarray(A, jdt), jnp.asarray(B, jdt), Q, R, Q, N, rho)
        tq = tqp.build_condensed(torch.as_tensor(A, dtype=tdt), torch.as_tensor(B, dtype=tdt),
                                 Q, R, Q, N, rho)
    return jq, tq


@pytest.mark.parametrize("N", [5, 10])
def test_build_condensed_matches_jax(N):
    jq, tq = _both_qps(N, rho=8.0)
    for name in ("A", "B", "Sx", "Su", "H", "M", "K_lqr", "solver"):
        want = np.asarray(getattr(jq, name))
        got = getattr(tq, name)
        assert got.dtype == torch.float64 and tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max(), err_msg=name)
    assert (tq.rho, tq.N, tq.n, tq.m, tq.use_chol) == (jq.rho, jq.N, jq.n, jq.m, jq.use_chol)
    assert not tq.use_chol


def test_build_condensed_switches_to_cholesky_like_jax():
    """A tiny input weight, no ridge and N=20 leave cond(H + rho I) at about
    3e7, above the 1e7 switch: both packages take the Cholesky factor, and
    the port's solve through it matches the JAX one."""
    jq, tq = _both_qps(20, rho=0.0, r=1e-4)
    assert jq.use_chol and tq.use_chol
    np.testing.assert_allclose(tq.solver.numpy(), np.asarray(jq.solver), rtol=1e-10, atol=0)
    x0 = np.random.default_rng(7).standard_normal((3, 12)) * 0.2
    lim = np.array([2.0, 0.05, 0.05, 0.05])
    U_j = np.asarray(jqp.qp_solve(jq, jnp.asarray(x0), jnp.asarray(-lim), jnp.asarray(lim), iters=10))
    U_t = tqp.qp_solve(tq, torch.as_tensor(x0), torch.as_tensor(-lim), torch.as_tensor(lim), iters=10)
    np.testing.assert_allclose(U_t.numpy(), U_j, rtol=1e-9, atol=1e-9)


def test_chol_solve_matches_dense_solve():
    rng = np.random.default_rng(3)
    G = rng.standard_normal((6, 6))
    Hm = G @ G.T + 6 * np.eye(6)
    L = torch.as_tensor(np.linalg.cholesky(Hm))
    b = rng.standard_normal((2, 3, 6))
    z = tqp._chol_solve(L, torch.as_tensor(b))
    assert z.shape == (2, 3, 6)
    np.testing.assert_allclose(z.numpy(), np.linalg.solve(Hm, b.reshape(-1, 6).T).T.reshape(b.shape),
                               rtol=1e-12, atol=1e-12)


def test_qp_solve_unconstrained_matches_jax():
    jq, tq = _both_qps(8)
    x0 = np.random.default_rng(1).standard_normal((5, 12)) * 0.2
    U_t = tqp.qp_solve_unconstrained(tq, torch.as_tensor(x0))
    U_j = np.asarray(jqp.qp_solve_unconstrained(jq, jnp.asarray(x0)))
    assert U_t.shape == (5, 8, 4)
    np.testing.assert_allclose(U_t.numpy(), U_j, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("batch", [(), (7,), (2, 3)])
def test_qp_solve_loop_matches_jax(batch):
    jq, tq = _both_qps(8, rho=5.0)
    x0 = np.random.default_rng(3).standard_normal((*batch, 12)) * 0.5
    lim = np.array([2.0, 0.05, 0.05, 0.05])
    U_j = np.asarray(jqp.qp_solve(jq, jnp.asarray(x0), jnp.asarray(-lim), jnp.asarray(lim), iters=40))
    U_t = tqp.qp_solve(tq, torch.as_tensor(x0), torch.as_tensor(-lim), torch.as_tensor(lim), iters=40)
    assert tuple(U_t.shape) == (*batch, 8, 4)
    np.testing.assert_allclose(U_t.numpy(), U_j, rtol=0, atol=1e-10)
    flat = U_t.numpy().reshape(-1, 4)
    assert (flat <= lim + 1e-12).all() and (flat >= -lim - 1e-12).all()


def _admm_inputs(B, N, seed):
    """f32 numpy inputs of the fused-ADMM kernel for the hover QP at
    horizon N (rho=8): g, z0, S, lo, hi."""
    jq, _ = _both_qps(N, rho=8.0)
    x = np.random.default_rng(seed).uniform(-0.3, 0.3, (B, 12))
    M, K, S = (np.asarray(a) for a in (jq.M, jq.K_lqr, jq.solver))
    lo, hi = np.tile(U_MIN, N), np.tile(U_MAX, N)
    g = x @ M.T
    z0 = np.clip(-x @ K.T, lo, hi)
    return [a.astype(np.float32) for a in (g, z0, S, lo, hi)]


@pytest.mark.parametrize("B,N,tol", [(32, 8, 1e-5), (64, 50, 1e-4)])
def test_fused_admm_reference_matches_jax_kernel(B, N, tol):
    """The plain version against the JAX Pallas kernel (interpret mode), f32,
    rho=8, alpha=1.6, 6 iterations. At N=50 |g| reaches ~1.4e3, so f32
    rounding of the two libraries' products differs more (the same ADMM-6
    iterations in f32 vs f64 differ by ~5e-5 there)."""
    g, z0, S, lo, hi = _admm_inputs(B, N, seed=B + N)
    kw = dict(rho=8.0, alpha=1.6, iters=6)
    want = np.asarray(jqp._fused_admm(*(jnp.asarray(a, jnp.float32) for a in (g, z0, S, lo, hi)), **kw))
    args = [torch.as_tensor(a) for a in (g, z0, S, lo, hi)]
    got = tfa.fused_admm_reference(*args, **kw)
    assert got.dtype == torch.float32 and got.shape == (B, N * 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # the wrapper takes the plain version for CPU tensors, and counts no launch
    before = tfa.LAUNCHES
    np.testing.assert_array_equal(tfa.fused_admm(*args, **kw).numpy(), got.numpy())
    assert tfa.LAUNCHES == before


def _fused_vs_jax_loop(jq, x, u_min, u_max):
    """(port, JAX): the port's fused_admm (its plain version on the CPU), fed
    as qp_solve feeds it, and the JAX package's qp_solve on its loop path,
    on the same f32 QP ``jq`` and states ``x``; both ``(B, N, m)``."""
    old = jget()
    try:
        jset(fused_admm=False)
        want = np.asarray(jqp.qp_solve(jq, jnp.asarray(x), jnp.asarray(u_min, jnp.float32),
                                       jnp.asarray(u_max, jnp.float32), iters=6))
    finally:
        jset(**{k: getattr(old, k) for k in old.__dataclass_fields__})
    assert not jq.use_chol  # the kernel takes the explicit inverse
    xt = torch.as_tensor(x)
    M, K, S = (torch.as_tensor(np.asarray(a)) for a in (jq.M, jq.K_lqr, jq.solver))
    lo = torch.as_tensor(np.tile(u_min, jq.N), dtype=torch.float32)
    hi = torch.as_tensor(np.tile(u_max, jq.N), dtype=torch.float32)
    z0 = torch.minimum(torch.maximum(-xt @ K.T, lo), hi)
    got = tfa.fused_admm(xt @ M.T, z0, S, lo, hi, rho=8.0, alpha=1.6, iters=6)
    return got.numpy().reshape(want.shape), want


@pytest.mark.parametrize("B", [31, 33])
def test_fused_admm_ragged_batches_match_jax_loop(B):
    """Batches the JAX kernel cannot tile (it falls back to its scan): the
    port's fused_admm, fed as qp_solve feeds it, against the JAX loop path on
    the same f32 QP."""
    jq, _ = _both_qps(8, rho=8.0, dtype="f32")
    x = np.random.default_rng(B).uniform(-0.3, 0.3, (B, 12)).astype(np.float32)
    got, want = _fused_vs_jax_loop(jq, x, U_MIN, U_MAX)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _one_input_qp(N):
    """A 2-state, 1-input double integrator at horizon N (D = N), f32, rho 8."""
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    B = np.array([[0.005], [0.1]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jqp.build_condensed(jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.float32),
                                   np.diag([10.0, 1.0]), np.eye(1) * 0.1, np.diag([10.0, 1.0]),
                                   N, 8.0)


@pytest.mark.parametrize("case,B", [("D=1", 65), ("D=512", 33), ("D=200, B=8447", 8447)])
def test_fused_admm_reference_matches_jax_loop_at_the_kernel_edges(case, B):
    """The widths and batch at the kernel's tile edges that no other test
    holds against the JAX package: D = 1 (a one-input QP at horizon 1),
    D = MAX_D = 512 (the quadrotor at horizon 128: S streamed in panels on
    the card) and B = 8447 at D = 200 (one short of 64 x 132, a batch no
    Pallas tile divides). The port's plain version against the JAX loop
    path on the same f32 QP, within 1e-6 + 1e-7 * max|g|: about one f32
    rounding of the largest |g| (1.4e3 at horizon 50, 1.9e5 at 128), the
    scale of the right-hand sides whose products the two libraries sum in
    other orders."""
    if case == "D=1":
        jq = _one_input_qp(1)
        x = np.random.default_rng(5).uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
        u_min, u_max = np.array([-0.5]), np.array([0.5])
    else:
        # at the controller's dt (entry.make_controller); at 0.05, horizon 128
        # leaves cond(H + rho I) above the Cholesky switch
        jq, _ = _both_qps(128 if case == "D=512" else 50, rho=8.0, dtype="f32", dt=0.02)
        x = np.random.default_rng(B).uniform(-0.3, 0.3, (B, 12)).astype(np.float32)
        u_min, u_max = U_MIN, U_MAX
    assert jq.N * jq.m == int(case.split(",")[0][2:])
    got, want = _fused_vs_jax_loop(jq, x, u_min, u_max)
    assert got.shape == (B, jq.N, jq.m) and np.isfinite(got).all()
    assert (np.isclose(want, u_max) | np.isclose(want, u_min)).any()  # a bound binds
    g = x.astype(np.float64) @ np.asarray(jq.M, np.float64).T
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 + 1e-7 * np.abs(g).max())


def test_fused_admm_refuses_non_cpu_non_cuda_tensors():
    """The wrapper runs the plain version only for CPU tensors; anything else
    that is not CUDA raises instead of falling back."""
    g = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.fused_admm(g, g, torch.zeros((8, 8), device="meta"), torch.zeros(8, device="meta"),
                       torch.zeros(8, device="meta"), rho=8.0, alpha=1.6, iters=6)


def test_qp_solve_takes_loop_path_on_cpu():
    """On CPU tensors qp_solve runs its loop; the kernel gate needs CUDA."""
    _, tq = _both_qps(8, rho=8.0, dtype="f32")
    z2 = torch.zeros((4, 32), dtype=torch.float32)
    assert not tqp._fused_admm_eligible(tq, z2)
    before = tfa.LAUNCHES
    tqp.qp_solve(tq, torch.zeros((4, 12)), torch.as_tensor(U_MIN, dtype=torch.float32),
                 torch.as_tensor(U_MAX, dtype=torch.float32), iters=6)
    assert tfa.LAUNCHES == before


def test_fused_admm_gate_respects_the_kernel_width():
    """The kernel is instantiated for D <= MAX_D = 512. A wider QP (horizon
    150: D = 600) must take the loop path, as the JAX package's scan does
    for every D, instead of reaching the kernel and raising on the card. The
    size check runs without a CUDA tensor."""
    A, B, Q, R = _quad_data(dt=0.02)  # the controller's dt (entry.make_controller)
    qps = {N: (jqp.build_condensed(jnp.asarray(A), jnp.asarray(B), Q, R, Q, N, 8.0),
               tqp.build_condensed(torch.as_tensor(A.copy()), torch.as_tensor(B.copy()),
                                   Q, R, Q, N, 8.0))
           for N in (150, 50)}
    jq, tq = qps[150]
    assert not tq.use_chol and tq.N * tq.m == 600 > tfa.MAX_D
    z = torch.zeros(4, 600)  # f32 iterates, the kernel's type
    assert not tqp._fused_admm_fits(tq, z)
    assert tqp._fused_admm_fits(qps[50][1], z[:, :200])
    assert not tqp._fused_admm_eligible(qps[50][1], z[:, :200])  # a CPU tensor
    x0 = np.random.default_rng(2).uniform(-0.3, 0.3, (5, 12))
    U = tqp.qp_solve(tq, torch.as_tensor(x0), torch.as_tensor(U_MIN), torch.as_tensor(U_MAX),
                     iters=6, alpha=1.6)
    Uj = jqp.qp_solve(jq, jnp.asarray(x0), jnp.asarray(U_MIN), jnp.asarray(U_MAX),
                      iters=6, alpha=1.6)
    assert tuple(U.shape) == (5, 150, 4) and torch.isfinite(U).all()
    np.testing.assert_allclose(U.numpy(), np.asarray(Uj), rtol=0, atol=1e-8)  # f64 loop paths


def test_admm_design_probe_needs_the_card():
    """``benchmarks/exp_admm.py`` measures K1's tile designs on the card
    only: its run refuses without a CUDA device, its design wrapper refuses
    CPU tensors instead of falling back."""
    from strided_tpu_torch.benchmarks import exp_admm

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_admm.run(["k1"], batch=64)
    g, z0, S, lo, hi = (torch.as_tensor(a) for a in _admm_inputs(4, 8, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        exp_admm.admm_design("t8x4", g, z0, S, lo, hi)
    assert set(exp_admm.variants()) == {"k1", *exp_admm.DESIGNS, "ring32", "ring64"}
