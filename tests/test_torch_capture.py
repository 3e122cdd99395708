"""The port's captured calls (``strided_tpu_torch/capture.py``, the
counterpart of ``jax.jit``): the decorated ``closed_loop``, ``rollout``,
``rollout_final``, ``ilqr`` and the ``entry()`` step on CPU tensors against
the JAX package; the signature key and its cache as pure Python; and, on
the card only, captured against eager bit for bit, outputs that do not
alias, and a capture that fails raising instead of running eagerly."""

import gc
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import strided_tpu.models as jm  # noqa: E402
import strided_tpu.mpc as jmpc  # noqa: E402
import strided_tpu_torch as stt  # noqa: E402
import strided_tpu_torch.models as tm  # noqa: E402
import strided_tpu_torch.mpc as tmpc  # noqa: E402
from strided_tpu_torch import capture as cap  # noqa: E402
from strided_tpu_torch import config as tconfig  # noqa: E402
from strided_tpu_torch import entry as tentry  # noqa: E402
from strided_tpu_torch.convert import QP_ARRAYS, MPC_ARRAYS, linear_mpc_from_numpy  # noqa: E402
from strided_tpu_torch.convert import quad_cost_from_numpy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}
# The tolerances of the parity tests these entry points already have:
# closed loop f64 1e-9 (test_torch_mpc.py::test_closed_loop_matches_jax_f64);
# rollouts f64 1e-12, f32 1e-6 (test_torch_rollout.py: the same formulas,
# sin/cos/tan an ulp apart in f32); iLQR inputs within US_TOL of their
# largest entry and costs within 10x COST_RTOL (test_torch_ilqr.py); the
# entry step 2e-4 (test_torch_mpc.py::test_entry_step_matches_jax: f32
# summation order at N=50, |g| up to ~1.4e3, one RK4 step turning du into
# ~2 du).
LOOP_TOL = 1e-9
ROLLOUT_TOL = {"f64": 1e-12, "f32": 1e-6}
US_TOL = {"f64": 1e-8, "f32": 5e-6}
COST_RTOL = {"f64": 1e-12, "f32": 1e-6}
ENTRY_TOL = 2e-4
CARTPOLE = dict(Q=np.diag([1.0, 10.0, 0.1, 0.1]), R=np.diag([0.01]),
                Qf=np.diag([10.0, 100.0, 1.0, 1.0]), x_goal=np.array([0.0, np.pi, 0.0, 0.0]))


@pytest.fixture
def counts():
    """The capture counters before the test; the test asserts against them."""
    return cap.CAPTURES, cap.REPLAYS


def _not_captured(fn, counts):
    """``fn`` is a decorated entry point that ran on the CPU as it is."""
    assert hasattr(fn, "cache") and hasattr(fn, "__wrapped__")
    assert len(fn.cache) == 0
    assert (cap.CAPTURES, cap.REPLAYS) == counts


def _jax_ctrl(N=10, iters=30):
    Q = jnp.diag(jnp.array([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], jnp.float64))
    return jmpc.make_hover_mpc(
        jm.quadrotor(), jm.hover_state(jnp.float64), jm.hover_input(dtype=jnp.float64), Q,
        jnp.eye(4) * 0.1, Q, horizon=N, dt=0.05,
        u_min=jnp.array([-5.0, -0.5, -0.5, -0.5]), u_max=jnp.array([10.0, 0.5, 0.5, 0.5]),
        admm_iters=iters, rho=1.0,
    )


def _to_port(jc, dtype=torch.float64):
    qp = jc.qp
    d = {k: np.asarray(getattr(qp, k)) for k in QP_ARRAYS}
    d.update(rho=qp.rho, N=qp.N, n=qp.n, m=qp.m, use_chol=qp.use_chol)
    d.update({k: np.asarray(getattr(jc, k)) for k in MPC_ARRAYS})
    d.update(admm_iters=jc.admm_iters, constrained=jc.constrained)
    return linear_mpc_from_numpy(d, device="cpu", dtype=dtype)


# ---- the decorated entry points on the CPU, against the JAX package ----

def test_closed_loop_runs_through_capture_and_matches_jax(counts):
    """Batch 8, 20 steps, f64: the decorated ``closed_loop`` on CPU tensors
    runs as it is (no capture, no replay) and matches JAX's ``lax.scan``."""
    jc = _jax_ctrl()
    x0 = np.random.default_rng(5).uniform(-0.3, 0.3, (8, 12))
    xs_j, us_j = jmpc.closed_loop(jc, jm.quadrotor(), jnp.asarray(x0), steps=20, dt=0.05)
    xs, us = stt.closed_loop(_to_port(jc), stt.quadrotor(), torch.as_tensor(x0), 20, 0.05)
    assert xs.shape == (8, 21, 12) and us.shape == (8, 20, 4)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), rtol=0, atol=LOOP_TOL)
    np.testing.assert_allclose(us.numpy(), np.asarray(us_j), rtol=0, atol=LOOP_TOL)
    _not_captured(stt.closed_loop, counts)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", ["simple_pendulum", "double_pendulum"])
def test_rollouts_run_through_capture_and_match_jax(name, prec, counts):
    """``rollout`` and ``rollout_final`` over T=10 on a batch of 4."""
    tdt, jdt = DTYPES[prec]
    model_t, model_j = getattr(tm, name)(), getattr(jm, name)()
    rng = np.random.default_rng(6)
    x0 = rng.standard_normal((4, model_t.state_dim)) * 0.1
    us = rng.standard_normal((4, 10, model_t.input_dim)) * 0.01
    xt, ut = torch.as_tensor(x0, dtype=tdt), torch.as_tensor(us, dtype=tdt)
    xj, uj = jnp.asarray(x0, jdt), jnp.asarray(us, jdt)
    xs = tmpc.rollout(model_t, xt, ut, 0.01)
    xT = tmpc.rollout_final(model_t, xt, ut, 0.01)
    xs_j = jax.jit(lambda x, u: jmpc.rollout(model_j, x, u, 0.01))(xj, uj)
    xT_j = jax.jit(lambda x, u: jmpc.rollout_final(model_j, x, u, 0.01))(xj, uj)
    assert xs.shape == (4, 11, model_t.state_dim) and xs.dtype == tdt
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), rtol=0, atol=ROLLOUT_TOL[prec])
    np.testing.assert_allclose(xT.numpy(), np.asarray(xT_j), rtol=0, atol=ROLLOUT_TOL[prec])
    assert torch.equal(xT, xs[..., -1, :])
    _not_captured(tmpc.rollout, counts)
    _not_captured(tmpc.rollout_final, counts)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("batched", [False, True])
def test_ilqr_runs_through_capture_and_matches_jax(prec, batched, counts):
    """Cartpole iLQR, T=10, 3 iterations, one problem or a batch of 3
    (``ilqr_batched``): inputs, the cost trace and the final cost."""
    tdt, jdt = DTYPES[prec]
    jc = jmpc.QuadCost(**{k: jnp.asarray(v, jdt) for k, v in CARTPOLE.items()})
    tc = quad_cost_from_numpy(CARTPOLE, device="cpu", dtype=tdt)
    rng = np.random.default_rng(7)
    batch = (3,) if batched else ()
    x0 = rng.uniform(-0.2, 0.2, (*batch, 4))
    us0 = rng.standard_normal((*batch, 10, 1)) * 0.05
    solve_t = tmpc.ilqr_batched if batched else tmpc.ilqr
    solve_j = jmpc.ilqr_batched if batched else jmpc.ilqr
    res = solve_t(tm.cartpole(), tc, torch.as_tensor(x0, dtype=tdt),
                  torch.as_tensor(us0, dtype=tdt), 0.05, iters=3)
    ref = jax.jit(lambda x, u: solve_j(jm.cartpole(), jc, x, u, 0.05, iters=3))(
        jnp.asarray(x0, jdt), jnp.asarray(us0, jdt))
    assert isinstance(res, tmpc.ILQRResult)
    assert res.us.shape == (*batch, 10, 1) and res.costs.shape == (*batch, 3)
    scale = np.abs(np.asarray(ref.us)).max()
    np.testing.assert_allclose(res.us.numpy(), np.asarray(ref.us), rtol=0,
                               atol=US_TOL[prec] * scale)
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(ref.costs),
                               rtol=COST_RTOL[prec] * 10, atol=0)
    assert torch.equal(res.cost, res.costs[..., -1])
    _not_captured(tmpc.ilqr, counts)


def test_entry_step_is_captured_and_matches_jax(counts):
    """``entry()`` returns the step wrapped in ``capture``; on the CPU it
    runs as it is and matches the reference's step (N=50, ADMM-6, rho=8,
    f32, batch 256)."""
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge

    jfn, (xj,) = ge.entry()
    tfn, (xt,) = tentry.entry("cpu")
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_allclose(tfn(xt).numpy(), np.asarray(jfn(xj)), rtol=0, atol=ENTRY_TOL)
    _not_captured(tfn, counts)


# ---- the signature key and the cache, pure Python ----

def _call(**change):
    """The arguments of a ``closed_loop`` call, ``change`` applied."""
    base = dict(ctrl=_CTRL, model=_MODEL, x=torch.zeros(8, 12), steps=20, dt=0.05)
    base.update(change)
    return (base["ctrl"], base["model"], base["x"], base["steps"], base["dt"]), {}


_CTRL = tentry.make_controller(horizon=4, dt=0.05, device="cpu")[1]
_MODEL = tm.quadrotor()
CHANGES = {
    "shape": lambda: _call(x=torch.zeros(9, 12)),
    "dtype": lambda: _call(x=torch.zeros(8, 12, dtype=torch.float64)),
    "stride": lambda: _call(x=torch.zeros(12, 8).T),
    "steps": lambda: _call(steps=21),
    "dt": lambda: _call(dt=0.02),
    "dt_negative_zero": lambda: (_call(dt=-0.0)[0], {}),
    "controller": lambda: _call(ctrl=tentry.make_controller(horizon=4, dt=0.05,
                                                            device="cpu")[1]),
    "model": lambda: _call(model=tm.quadrotor()),
    "keyword": lambda: ((_CTRL, _MODEL, torch.zeros(8, 12), 20), {"dt": 0.05}),
    "alphas": lambda: (_call()[0], {"alphas": (1.0, 0.5)}),
}


@pytest.mark.parametrize("what", list(CHANGES))
def test_signature_tells_apart(what):
    """A new shape, dtype, stride, step count, time step (0.0 from -0.0
    too), controller, model, keyword or tuple gives a new entry."""
    key0, _ = cap.signature(*_call())
    if what == "dt_negative_zero":
        key0, _ = cap.signature(*_call(dt=0.0))
    key1, _ = cap.signature(*CHANGES[what]())
    assert key1 != key0
    cache = cap.Cache()
    cache.put(key0, [_CTRL, _MODEL], "entry")
    assert cache.get(key1) is None


@pytest.mark.parametrize("field,value", [("fused_admm", False), ("matmul_precision", "high"),
                                         ("use_kernels", False)])
def test_signature_holds_the_config(field, value):
    """The whole config is in the key: ``qp_solve`` reads ``fused_admm``
    while a call is captured, and the precision mode is frozen by it."""
    key0, _ = cap.signature(*_call())
    old = tconfig.get_config()
    try:
        tconfig.set_config(**{field: value})
        key1, _ = cap.signature(*_call())
    finally:
        tconfig.set_config(**{field: getattr(old, field)})
    assert key1 != key0
    assert cap.signature(*_call())[0] == key0  # restored


def test_signature_holds_the_matmul_mode():
    key0, _ = cap.signature(*_call())
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not old
        assert cap.signature(*_call())[0] != key0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_an_equal_call_finds_the_same_entry():
    """Other tensors of the same layout and equal scalars find the entry;
    the objects are held by identity and returned for the weak references."""
    key0, objects = cap.signature(*_call())
    assert objects[0] is _CTRL and objects[1] is _MODEL
    cache = cap.Cache()
    entry = object()
    cache.put(key0, objects, entry)
    args, _ = _call(x=torch.ones(8, 12), dt=float("0.05"), steps=int("20"))
    assert cache.get(cap.signature(args, {})[0]) is entry
    assert len(cache) == 1


def test_a_dead_controllers_entry_cannot_be_reached():
    """The entry goes with its controller, so a new object at the same
    address finds nothing."""
    ctrl = tentry.make_controller(horizon=4, dt=0.05, device="cpu")[1]
    key, objects = cap.signature(*_call(ctrl=ctrl))
    cache = cap.Cache()
    cache.put(key, objects, "entry")
    assert cache.get(key) == "entry"
    del ctrl, objects
    gc.collect()
    assert len(cache) == 0 and cache.get(key) is None


def test_an_object_without_weak_references_is_refused():
    key, objects = cap.signature((object(),), {})
    with pytest.raises(TypeError, match="weak reference"):
        cap.Cache().put(key, objects, "entry")


def test_a_tensor_inside_a_tuple_is_refused():
    with pytest.raises(TypeError, match="tensor inside a tuple"):
        cap.signature(((torch.zeros(2), 1.0),), {})


def test_disable_capture_nests_and_restores():
    assert cap._eager_depth == 0
    with cap.disable_capture():
        assert cap._eager_depth == 1
        with cap.disable_capture():
            assert cap._eager_depth == 2
        assert cap._eager_depth == 1
    assert cap._eager_depth == 0
    with pytest.raises(ValueError):
        with cap.disable_capture():
            raise ValueError("inside")
    assert cap._eager_depth == 0


def test_cpu_tensors_call_the_function_directly(counts):
    """No key is made for a call without CUDA tensors: an argument that
    could not be held by a weak reference passes, and each call runs."""
    calls = []

    @cap.capture
    def f(x, tag):
        calls.append(tag)
        return x * 2

    x = torch.arange(3.0)
    assert torch.equal(f(x, object()), x * 2) and torch.equal(f(x, object()), x * 2)
    assert len(calls) == 2
    _not_captured(f, counts)


def test_outputs_are_cloned_with_their_structure():
    res = tmpc.ILQRResult(*(torch.arange(3.0) + i for i in range(4)))
    got = cap._clone(res)
    assert type(got) is tmpc.ILQRResult
    assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr() for a, b in zip(got, res))
    pair = cap._clone((res.xs, res.us))
    assert type(pair) is tuple and torch.equal(pair[1], res.us)
    with pytest.raises(TypeError, match="returns tensors"):
        cap._clone((res.xs, 1.0))


# ---- on the card only ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: capture replays CUDA graphs (chip_smoke.py "
                    "phases 4-6 and 13 run these checks on the card)")
    return torch.device("cuda")


def _card_loop(card, batch=64, steps=20):
    model, ctrl = tentry.make_controller(horizon=50, dt=0.02, device=card)
    x0 = torch.as_tensor(np.random.default_rng(8).uniform(-0.3, 0.3, (batch, 12)),
                         dtype=torch.float32, device=card)
    return ctrl, model, x0, steps


def test_captured_equals_eager_bit_for_bit(card, counts):
    ctrl, model, x0, steps = _card_loop(card)
    xs, us = stt.closed_loop(ctrl, model, x0, steps, 0.02)
    with cap.disable_capture():
        xs_e, us_e = stt.closed_loop(ctrl, model, x0, steps, 0.02)
    assert torch.equal(xs, xs_e) and torch.equal(us, us_e)
    assert cap.CAPTURES == counts[0] + 1 and cap.REPLAYS == counts[1] + 1
    pend, x = tm.double_pendulum(), x0[:, :4].contiguous()
    u = torch.full((x0.shape[0], 10, 2), 0.01, device=card)
    assert torch.equal(tmpc.rollout(pend, x, u, 0.01),
                       tmpc.rollout.__wrapped__(pend, x, u, 0.01))


def test_captured_outputs_do_not_alias(card):
    ctrl, model, x0, steps = _card_loop(card)
    xs1, _ = stt.closed_loop(ctrl, model, x0, steps, 0.02)
    keep = xs1.clone()
    xs2, _ = stt.closed_loop(ctrl, model, xs1[:, -1].contiguous(), steps, 0.02)
    assert xs1.data_ptr() != xs2.data_ptr() and torch.equal(xs1, keep)
    assert not torch.equal(xs1, xs2)


def test_the_config_takes_a_new_entry_on_the_card(card):
    ctrl, model, x0, steps = _card_loop(card)
    stt.closed_loop(ctrl, model, x0, steps, 0.02)
    n = cap.CAPTURES
    try:
        tconfig.set_config(fused_admm=False)
        stt.closed_loop(ctrl, model, x0, steps, 0.02)
    finally:
        tconfig.set_config(fused_admm=True)
    assert cap.CAPTURES == n + 1 and len(stt.closed_loop.cache) >= 2


def test_a_failed_capture_raises_and_runs_nothing_eagerly(card, counts):
    @cap.capture
    def reads_the_host(x):
        return x * x.sum().item()

    with pytest.raises(RuntimeError):
        reads_the_host(torch.ones(4, device=card))
    assert len(reads_the_host.cache) == 0 and cap.CAPTURES == counts[0]
