"""Receding-horizon iLQR on the quadrotor (``mpc.ILQRMPC``,
``entry.make_ilqr_controller`` / ``make_ilqr_step``) on the CPU at small
sizes: the step against the benchmark's plain f64 reference
(``portbench/reference/quadrotor_ilqr.py``) under its tie rule, the shift
of the warm start, the plan kept where the step put it, two iterations a
period, ``QuadCost`` with no input reference bit for bit as before, the
spans and counters, and the plant kernel's operands on the line search's
candidates."""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference.quadrotor_ilqr import QuadrotorILQR
from strided_tpu_torch import entry
from strided_tpu_torch.models import quadrotor, quadrotor_rk4
from strided_tpu_torch.mpc import ILQRMPC, QuadCost, ilqr
from strided_tpu_torch.utils import profiling

ilqr_mod = importlib.import_module("strided_tpu_torch.mpc.ilqr")

CONFIG = Path(__file__).resolve().parents[1] / "portbench" / "configs" / "quadrotor_ilqr.json"
DT = 0.02
# the widest input gap (N, N m) against the f64 reference: f64 is the same
# arithmetic in another order; f32 rounds a 50-stage sweep and line search
# (about 3e-6 measured at batch 64), so 1e-4 leaves 30x
INPUT_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
# the widest gap of the plan handed back, over every stage (N, N m): f32
# reads up to about 7e-6 at batch 8-256, so 1e-4 leaves 14x
PLAN_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


def _config(horizon, iters=1):
    cfg = json.loads(CONFIG.read_text())
    cfg["controller"] = dict(cfg["controller"], horizon=horizon, iters=iters)
    return cfg


def _problem(batch, horizon, dtype, seed=0):
    """Seeded states near hover and a plan of hover inputs with noise."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(-0.3, 0.3, (batch, 12)), dtype=dtype)
    plan = np.tile([9.81, 0.0, 0.0, 0.0], (batch, horizon, 1))
    plan = plan + rng.normal(0.0, [0.5, 0.05, 0.05, 0.05], (batch, horizon, 4))
    return x, torch.as_tensor(plan, dtype=dtype)


def _controller(horizon, dtype, **kw):
    return entry.make_ilqr_controller(horizon, DT, "cpu", dtype=dtype, **kw)


def _gaps(ref, x, plan, x_next, plan_next):
    """Per quadrotor, the input gap and the whole plan's gap to the
    admitted outcome nearest by input gap, as the benchmark's check takes
    them."""
    scale = ref.plant.input_scale()
    plans, _own, admitted, _tied = ref.outcomes(x, plan)
    d = (x_next.double() - ref.next_states(x, plans[..., 0, :])).abs()
    gap_in = torch.where(admitted, (d * scale).amax(-1), torch.inf)
    near = gap_in.argmin(0, keepdim=True)
    gap_plan = (plan_next.double() - plans).abs().amax((-2, -1))
    return gap_in.gather(0, near)[0], gap_plan.gather(0, near)[0]


def _step_gaps(horizon, dtype, iters=1):
    x, plan = _problem(8, horizon, dtype)
    model, ctrl = _controller(horizon, dtype, iters=iters)
    step = entry.make_ilqr_step(model, ctrl, DT)
    x_next, plan_next = step(x, plan)
    assert x_next.shape == (8, 12) and plan_next.shape == (8, horizon, 4)
    assert x_next.dtype == plan_next.dtype == dtype
    # the applied input is the new plan's first stage
    np.testing.assert_array_equal(x_next.numpy(),
                                  model.step(x, plan_next[:, 0], DT).numpy())
    return _gaps(QuadrotorILQR(_config(horizon, iters)), x, plan, x_next, plan_next)


@pytest.mark.parametrize("horizon", [10, 50])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_step_against_the_reference(horizon, dtype):
    gap_in, gap_plan = _step_gaps(horizon, dtype)
    assert float(gap_in.max()) <= INPUT_TOL[dtype]
    # the whole plan handed back, which the next period starts from
    assert float(gap_plan.max()) <= PLAN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_two_iterations_a_period_against_the_reference(dtype):
    """``iters`` > 1: the reference forms the same iterations, ``mu``'s
    schedule included."""
    gap_in, gap_plan = _step_gaps(10, dtype, iters=2)
    assert float(gap_in.max()) <= INPUT_TOL[dtype]
    assert float(gap_plan.max()) <= PLAN_TOL[dtype]


def test_reference_own_outcome_is_the_controllers_first_input():
    """Its first input, and the whole plan it hands back."""
    x, plan = _problem(8, 10, torch.float64, seed=1)
    ref = QuadrotorILQR(_config(10))
    plans, own, admitted, tied = ref.outcomes(x, plan)
    assert plans.shape == (5, 8, 10, 4) and admitted[own, torch.arange(8)].all()
    assert not tied.any() and int(admitted.sum()) == 8
    _, ctrl = _controller(10, torch.float64)
    u_port, plan_port = ctrl.control(x, plan)
    mine = plans[own, torch.arange(8)]
    np.testing.assert_allclose(u_port.numpy(), mine[:, 0].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(plan_port.numpy(), mine.numpy(), rtol=0, atol=1e-9)


def test_shift_of_the_warm_start(monkeypatch):
    plan = torch.arange(2 * 5 * 4, dtype=torch.float64).reshape(2, 5, 4)
    shifted = ILQRMPC.shift(plan)
    assert torch.equal(shifted[:, :4], plan[:, 1:]) and torch.equal(shifted[:, 4], plan[:, 4])
    seen = []
    real = ilqr_mod._solve

    def spy(model, cost, x0, us_init, *args):
        seen.append(us_init.clone())
        return real(model, cost, x0, us_init, *args)

    monkeypatch.setattr(ilqr_mod, "_solve", spy)
    x, plan = _problem(4, 10, torch.float64, seed=2)
    model, ctrl = _controller(10, torch.float64)
    step = entry.make_ilqr_step(model, ctrl, DT)
    x1, plan1 = step(x, plan)
    step(x1, plan1)
    assert torch.equal(seen[0], ILQRMPC.shift(plan))
    assert torch.equal(seen[1], ILQRMPC.shift(plan1))


def test_initial_plan_holds_the_hover_input():
    _, ctrl = _controller(10, torch.float32)
    plan = ctrl.initial_plan((3,))
    assert plan.shape == (3, 10, 4) and plan.is_contiguous()
    assert torch.equal(plan, torch.tensor([9.81, 0.0, 0.0, 0.0]).expand(3, 10, 4))
    bare = ILQRMPC(ctrl.model, QuadCost(ctrl.cost.Q, ctrl.cost.R, ctrl.cost.Qf,
                                        ctrl.cost.x_goal), 10, DT)
    assert torch.equal(bare.initial_plan((2,)), torch.zeros(2, 10, 4))


def test_plan_stays_on_the_device_between_periods(monkeypatch):
    """In the benchmark's closed loop, each period hands the step the very
    plan tensor the last period returned: it never crosses to the host."""
    from portbench.generators import ilqr_loop
    from portbench.run import load_cell

    calls = []

    def make_step(model, ctrl, dt):
        step = entry.make_ilqr_step(model, ctrl, dt)

        def spied(x, plan):
            out = step(x, plan)
            calls.append((plan, out[1]))
            assert out[1].device == x.device
            return out

        return spied

    monkeypatch.setattr(ilqr_loop, "make_ilqr_step", make_step)
    cell = load_cell("quadrotor_ilqr.fleet4k")
    cell.config = _config(10)
    cell.traffic = dict(cell.traffic, batch=8, sample_span=3, samples=1)
    out = ilqr_loop.run(cell, 2 ** 31 + 5, 0.05, False, device="cpu")
    assert out.failed == 0 and len(calls) > ilqr_loop.WARMUP_PERIODS
    window = calls[ilqr_loop.WARMUP_PERIODS:]
    assert all(nxt[0] is prev[1] for prev, nxt in zip(window, window[1:]))


def _old_cost(Q, R, Qf, x_goal, xs, us):
    """``QuadCost.total`` and ``stage`` as they were before ``u_goal``."""
    dx = xs[..., :-1, :] - x_goal
    stage = 0.5 * torch.einsum("...ti,ij,...tj->...", dx, Q, dx)
    stage = stage + 0.5 * torch.einsum("...ti,ij,...tj->...", us, R, us)
    dxf = xs[..., -1, :] - x_goal
    total = stage + ((0.5 * dxf) @ Qf * dxf).sum(-1)
    dx0, u0 = xs[..., 0, :] - x_goal, us[..., 0, :]
    return total, ((0.5 * dx0) @ Q * dx0).sum(-1) + ((0.5 * u0) @ R * u0).sum(-1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_no_input_reference_gives_the_old_cost_bit_for_bit(dtype):
    rng = np.random.default_rng(3)
    Q, R, Qf = (torch.as_tensor(np.diag(rng.uniform(0.1, 10, n)), dtype=dtype)
                for n in (12, 4, 12))
    x_goal = torch.as_tensor(rng.uniform(-1, 1, 12), dtype=dtype)
    xs = torch.as_tensor(rng.uniform(-1, 1, (3, 11, 12)), dtype=dtype)
    us = torch.as_tensor(rng.uniform(-1, 12, (3, 10, 4)), dtype=dtype)
    cost = QuadCost(Q, R, Qf, x_goal)
    assert cost.u_goal is None and cost.du(us) is us
    total, stage = _old_cost(Q, R, Qf, x_goal, xs, us)
    assert torch.equal(cost.total(xs, us), total)
    assert torch.equal(cost.stage(xs[:, 0], us[:, 0]), stage)
    # the iteration with no input reference, and with a zero one, alike
    model = quadrotor()
    x0 = xs[:, 0] * 0.3
    a = ilqr(model, cost, x0, us, DT, iters=2)
    b = ilqr(model, QuadCost(Q, R, Qf, x_goal, u_goal=torch.zeros(4, dtype=dtype)), x0, us,
             DT, iters=2)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f))


def test_spans_and_counters_after_a_step():
    x, plan = _problem(4, 10, torch.float32, seed=4)
    model, ctrl = _controller(10, torch.float32, iters=2)
    step = entry.make_ilqr_step(model, ctrl, DT)
    solves = ilqr_mod.SOLVES
    profiling.reset()
    profiling.enable()
    try:
        step(x, plan)
        totals = profiling.totals()
    finally:
        profiling.disable()
        profiling.reset()
    for name in ("ilqr.linearize", "ilqr.backward", "ilqr.forward"):
        assert totals[name]["count"] == 2 and totals[name]["total_ns"] > 0
    assert ilqr_mod.SOLVES == solves + 1
    # the accepted steps, counted where the plan lives
    assert ctrl.accepted.device == x.device and 0 <= int(ctrl.accepted) <= 2 * 4
    before = int(ctrl.accepted)
    step(x, plan)
    assert int(ctrl.accepted) - before == before


def test_controller_numbers_are_the_configuration():
    cfg = json.loads(CONFIG.read_text())
    c = cfg["controller"]
    _, ctrl = entry.make_ilqr_controller(c["horizon"], cfg["dt"], "cpu", iters=c["iters"],
                                         alphas=c["alphas"], mu=c["mu"])
    assert (ctrl.horizon, ctrl.dt, ctrl.iters, ctrl.mu) == (c["horizon"], cfg["dt"], c["iters"],
                                                            c["mu"])
    assert ctrl.alphas == tuple(c["alphas"])
    assert torch.equal(ctrl.cost.Q, torch.diag(torch.tensor(c["Q_diag"], dtype=torch.float32)))
    assert torch.equal(ctrl.cost.Qf, torch.diag(torch.tensor(c["Qf_diag"], dtype=torch.float32)))
    assert torch.equal(ctrl.cost.R, c["R_scale"] * torch.eye(4))
    assert torch.equal(ctrl.cost.u_goal, torch.tensor(c["u_goal"]))
    assert not ctrl.cost.x_goal.any()


def test_line_search_candidates_reach_the_plant_kernel_as_rows():
    """The line search's first step hands the plant a stride-0 expand of the
    state, which ``operands`` copies into rows; every later step's state is
    the kernel's own contiguous output, and each input is a new tensor,
    both read in place."""
    B = 16
    x0 = torch.randn(B, 12)
    first = x0.expand(4, B, 12)
    xr, _ = quadrotor_rk4.operands(first, torch.randn(4, B, 4), DT)
    assert xr.shape == (4 * B, 12) and xr.data_ptr() != x0.data_ptr()
    later, u = torch.randn(4, B, 12), torch.randn(4, B, 4)
    xr, ur = quadrotor_rk4.operands(later, u, DT)
    assert xr.data_ptr() == later.data_ptr() and ur.data_ptr() == u.data_ptr()
    # the rollout's inputs are a strided stage of the plan: viewed, not copied
    plan = torch.randn(B, 10, 4)
    _, ur = quadrotor_rk4.operands(x0, plan[:, 3], DT)
    assert ur.data_ptr() == plan[:, 3].data_ptr() and ur.stride() == (40, 1)

