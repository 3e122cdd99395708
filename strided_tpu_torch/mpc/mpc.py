"""Receding-horizon MPC controller: linearize -> condense -> solve -> step.

Counterpart of ``strided_tpu/mpc/mpc.py``. The controller linearizes the
model at hover once and builds the condensed QP once; each control step
solves the box-constrained QP for the current state deviation, batched over
scenarios. ``closed_loop`` runs on the card as one captured program, the
whole horizon in one CUDA graph (``capture.py``), as the reference's is one
``lax.scan``; ``LinearMPC.control`` and ``plan`` stay eager for one-off
batches (a caller captures them with ``capture(ctrl.plan)``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..capture import capture
from ..config import matmul_precision_scope
from ..models.base import Model
from .qp import CondensedQP, build_condensed, qp_solve, qp_solve_unconstrained

__all__ = ["LinearMPC", "make_hover_mpc", "closed_loop"]


@dataclasses.dataclass(frozen=True)
class LinearMPC:
    """MPC controller around an operating point (x_eq, u_eq)."""

    qp: CondensedQP
    x_eq: torch.Tensor
    u_eq: torch.Tensor
    u_min: torch.Tensor  # bounds on the *deviation* input
    u_max: torch.Tensor
    admm_iters: int = 20
    constrained: bool = True
    # the first admm_coarse_iters ADMM iterations take single-pass bf16
    # products ("default"), the rest the configured precision (qp_solve)
    admm_coarse_iters: int = 0

    def control(self, x, x_ref=None):
        """First-stage input for current state ``x`` ``(*batch, n)``, and
        the deviation plan ``(*batch, N, m)``.

        ``x_ref``: optional target state (defaults to the equilibrium)."""
        dx = x - (self.x_eq if x_ref is None else x_ref)
        if self.constrained:
            U = qp_solve(self.qp, dx, self.u_min, self.u_max, self.admm_iters,
                         coarse_iters=self.admm_coarse_iters)
        else:
            U = qp_solve_unconstrained(self.qp, dx)
        return U[..., 0, :] + self.u_eq, U

    def plan(self, x, x_ref=None):
        """Full horizon plan U ``(*batch, N, m)`` (deviation inputs)."""
        return self.control(x, x_ref)[1]


def make_hover_mpc(
    model: Model,
    x_eq,
    u_eq,
    Q,
    R,
    QN,
    horizon: int,
    dt: float,
    u_min=None,
    u_max=None,
    admm_iters: int = 20,
    rho: float = 1.0,
    admm_coarse_iters: int = 0,
) -> LinearMPC:
    """Linearize ``model`` at (x_eq, u_eq) and build the controller; all
    tensors keep the dtype and device of ``x_eq``/the linearization."""
    A, B = model.linearize(x_eq, u_eq, dt)
    qp = build_condensed(A, B, Q, R, QN, horizon, rho)
    as_a = lambda v: torch.as_tensor(v, dtype=A.dtype, device=A.device)
    big = torch.full((qp.m,), 1e9, dtype=A.dtype, device=A.device)
    return LinearMPC(
        qp=qp,
        x_eq=x_eq,
        u_eq=u_eq,
        u_min=as_a(u_min) if u_min is not None else -big,
        u_max=as_a(u_max) if u_max is not None else big,
        admm_iters=admm_iters,
        constrained=u_min is not None or u_max is not None,
        admm_coarse_iters=admm_coarse_iters,
    )


@capture
@matmul_precision_scope
def closed_loop(ctrl: LinearMPC, model: Model, x0, steps: int, dt: float):
    """Simulate the nonlinear plant under the MPC law for ``steps`` steps.

    x0 ``(*batch, n)``. Returns (states ``(*batch, steps+1, n)``,
    inputs ``(*batch, steps, m)``)."""
    xs, us = [x0], []
    x = x0
    for _ in range(steps):
        u, _U = ctrl.control(x)
        x = model.step(x, u, dt)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)
