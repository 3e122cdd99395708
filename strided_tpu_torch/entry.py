"""Entry points: one closed-loop step of the scenario-batched quadrotor MPC,
one step of receding-horizon iLQR on the same quadrotor, and the multi-GPU
dry run.

Counterpart of ``__graft_entry__.py``'s ``_make_controller``, ``entry`` and
``dryrun_multichip``: the same controller (Q, R, input bounds, ADMM-6 at
rho=8), the same step (condensed-QP ADMM solve -> first input -> RK4 plant
step), and the multi-chip surface run by ``n`` processes, one rank each.
The reference returns the step for its caller to jit; here nothing else
would compile it, so ``entry`` returns it captured (``capture.py``).
``make_ilqr_controller`` and ``make_ilqr_step`` have no counterpart there:
nonlinear MPC by one warm-started iLQR iteration a period (``mpc/ilqr.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .capture import capture
from .models import hover_input, hover_state, quadrotor
from .mpc import ILQRMPC, QuadCost, make_hover_mpc

__all__ = ["make_controller", "make_step", "make_ilqr_controller", "make_ilqr_step", "entry",
           "dryrun_multichip"]


def _weights(dtype, device):
    """The hover controllers' state and input weights ``(Q, R)``."""
    Q = torch.diag(torch.tensor([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1],
                                dtype=dtype, device=device))
    return Q, torch.eye(4, dtype=dtype, device=device) * 0.1


def make_controller(horizon: int, dt: float, device, dtype=torch.float32):
    """(model, controller) for the 12-state quadrotor at hover."""
    model = quadrotor()
    Q, R = _weights(dtype, device)
    ctrl = make_hover_mpc(
        model,
        hover_state(dtype, device),
        hover_input(dtype=dtype, device=device),
        Q,
        R,
        Q,
        horizon=horizon,
        dt=dt,
        u_min=torch.tensor([-5.0, -0.5, -0.5, -0.5], dtype=dtype, device=device),
        u_max=torch.tensor([10.0, 0.5, 0.5, 0.5], dtype=dtype, device=device),
        admm_iters=6,
        rho=8.0,
    )
    return model, ctrl


def make_step(model, ctrl, dt):
    """The closed-loop step ``x -> x_next`` (solve, first input, RK4),
    captured: one CUDA-graph replay a call on the card."""

    def mpc_step(x):
        u, _plan = ctrl.control(x)
        return model.step(x, u, dt)

    return capture(mpc_step)


def make_ilqr_controller(horizon: int, dt: float, device, iters: int = 1,
                         alphas=(1.0, 0.5, 0.25, 0.1), mu: float = 1e-3,
                         dtype=torch.float32):
    """(model, controller): receding-horizon iLQR (:class:`mpc.ILQRMPC`)
    holding the 12-state quadrotor at hover, with ``make_controller``'s Q
    and R, Qf = Q, the hover thrust as the input reference and no input
    bounds."""
    model = quadrotor()
    Q, R = _weights(dtype, device)
    cost = QuadCost(Q, R, Q, hover_state(dtype, device),
                    u_goal=hover_input(dtype=dtype, device=device))
    ctrl = ILQRMPC(model, cost, horizon, dt, iters, mu, tuple(alphas))
    return model, ctrl


def make_ilqr_step(model, ctrl, dt):
    """The closed-loop step ``(x, plan) -> (x_next, plan_next)``: the
    controller's iterations from the shifted plan, the first input, the RK4
    plant step; captured, one CUDA-graph replay a call on the card. Start
    from ``ctrl.initial_plan(x.shape[:-1])`` and hand each call the plan the
    last one returned."""

    def ilqr_step(x, plan):
        u, plan = ctrl.control(x, plan)
        return model.step(x, u, dt), plan

    return capture(ilqr_step)


def entry(device="cuda"):
    """(fn, example_args): the scenario-batched MPC step at horizon 50,
    captured (``make_step``)."""
    dt = 0.02
    model, ctrl = make_controller(horizon=50, dt=dt, device=device)
    mpc_step = make_step(model, ctrl, dt)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-0.3, 0.3, (256, 12)), dtype=torch.float32,
                        device=device)
    return mpc_step, (x,)


def dryrun_multichip(n_devices: int, device="cuda", backend=None, timeout: float = 300):
    """The multi-chip surface over ``n_devices`` ranks, one process each
    (``parallel.multiproc.run_multiprocess_check``): the sharded step and
    the consensus all-reduce, the mesh-split engine ops with K2 and K3 per
    rank, the k-split matmul, and with 4 ranks or more a ``('data',
    'model')`` mesh. Returns the workers' outputs; raises if one fails."""
    from .parallel.multiproc import run_multiprocess_check

    return run_multiprocess_check(nproc=n_devices, device=device, backend=backend,
                                  timeout=timeout)
