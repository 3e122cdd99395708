"""Batched iLQR: rollout, linearization, Riccati backward sweep, line search.

Counterpart of ``strided_tpu/mpc/ilqr.py`` (BASELINE config 3: cartpole
iLQR). Each iteration:

1. linearizes the step along the trajectory (``models.base.linearize``:
   the model's ``fused_linearize`` where it has one and it does not
   decline, i.e. the quadrotor's one-launch kernel ``csrc/quadrotor_jac.cu``
   on CUDA tensors outside autodiff; else ``jacfwd`` vmapped over the batch
   and the horizon);
2. runs the Riccati backward sweep, a Python loop from ``t = T-1`` down to
   0 over (n, n) / (n, m) matmuls;
3. rolls out the affine policy at every line-search step size at once, the
   step sizes a leading dimension, and keeps the cheapest candidate when it
   improves on the current cost.

It is batch-native: ``x0`` ``(*batch, n)`` and ``us_init`` ``(*batch, T, m)``,
and each batch element keeps its own state as under the reference's
``jax.vmap`` (its cost, its acceptance, its Levenberg ``mu``). Fixed
iteration count and static shapes; nothing reads a value back from the card
(``inv_ex`` without its check, choices by ``torch.where`` and
``take_along_dim``), and on the card the whole solve runs as one captured
CUDA graph (``capture.py``), as the reference's scans run as one program. A
singular ``Quu`` gives non-finite gains, whose candidates the line search
rejects.

The three steps are the spans ``ilqr.linearize``, ``ilqr.backward`` and
``ilqr.forward`` (``utils/profiling.py``); ``SOLVES`` counts host calls of
the iteration loop (a warm-up's and a capture's; a CUDA-graph replay adds
none).

:class:`ILQRMPC` is receding-horizon iLQR in the real-time-iteration form
(Diehl, Bock & Schloeder, SIAM J. Control Optim. 43(5), 2005): each control
period shifts the previous plan by one stage, runs ``iters`` iterations
from the current state, and applies the plan's first input. The port has no
counterpart in the reference package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..capture import capture
from ..config import matmul_precision_scope
from ..models.base import Model, linearize
from ..utils.profiling import annotate, annotated
from .rollout import rollout

__all__ = ["QuadCost", "ILQRResult", "ilqr", "ilqr_batched", "ILQRMPC"]

SOLVES: int = 0
ALPHAS = (1.0, 0.5, 0.25, 0.1)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matrix times vector over leading dims: ``M`` (..., p, q), ``v`` (..., q)."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


@dataclasses.dataclass(frozen=True)
class QuadCost:
    """Quadratic tracking cost: 0.5(x-xg)'Q(x-xg) + 0.5(u-ug)'R(u-ug),
    terminal Qf. ``u_goal`` (m,) is the input reference, zero when None (a
    hover cost on the absolute thrust needs the hover thrust there). Every
    method takes ``(*batch, ...)`` tensors and returns ``(*batch,)``."""

    Q: torch.Tensor
    R: torch.Tensor
    Qf: torch.Tensor
    x_goal: torch.Tensor
    u_goal: Optional[torch.Tensor] = None

    def du(self, u):
        """``u`` less the input reference (``u`` itself when there is none)."""
        return u if self.u_goal is None else u - self.u_goal

    def stage(self, x, u):
        dx, du = x - self.x_goal, self.du(u)
        return ((0.5 * dx) @ self.Q * dx).sum(-1) + ((0.5 * du) @ self.R * du).sum(-1)

    def terminal(self, x):
        dx = x - self.x_goal
        return ((0.5 * dx) @ self.Qf * dx).sum(-1)

    def total(self, xs, us):
        # xs (*batch, T+1, n), us (*batch, T, m)
        dx, du = xs[..., :-1, :] - self.x_goal, self.du(us)
        stage = 0.5 * torch.einsum("...ti,ij,...tj->...", dx, self.Q, dx)
        stage = stage + 0.5 * torch.einsum("...ti,ij,...tj->...", du, self.R, du)
        return stage + self.terminal(xs[..., -1, :])


class ILQRResult(NamedTuple):
    xs: torch.Tensor  # (*batch, T+1, n)
    us: torch.Tensor  # (*batch, T, m)
    cost: torch.Tensor  # (*batch,)
    costs: torch.Tensor  # (*batch, iters): the cost after each iteration


@annotated("ilqr.backward")
def _backward(As, Bs, xs, us, cost: QuadCost, mu):
    """Riccati backward sweep -> feedforward ``ks`` (*batch, T, m) and
    feedback ``Ks`` (*batch, T, m, n), with ``mu`` (*batch,) on Quu."""
    lx = (xs[..., :-1, :] - cost.x_goal) @ cost.Q  # (*batch, T, n)
    lu = cost.du(us) @ cost.R  # (*batch, T, m)
    Vx = (xs[..., -1, :] - cost.x_goal) @ cost.Qf
    Vxx = cost.Qf
    muI = mu[..., None, None] * torch.eye(us.shape[-1], dtype=us.dtype, device=us.device)
    ks, Ks = [], []
    for t in reversed(range(us.shape[-2])):
        A, B = As[..., t, :, :], Bs[..., t, :, :]
        Qx = lx[..., t, :] + _mv(A.mT, Vx)
        Qu = lu[..., t, :] + _mv(B.mT, Vx)
        Qxx = cost.Q + A.mT @ Vxx @ A
        Quu = cost.R + B.mT @ Vxx @ B + muI
        Qux = B.mT @ Vxx @ A
        neg_inv = -torch.linalg.inv_ex(Quu, check_errors=False)[0]
        K = neg_inv @ Qux
        k = _mv(neg_inv, Qu)
        Vx = Qx + _mv(K.mT @ Quu, k) + _mv(K.mT, Qu) + _mv(Qux.mT, k)
        Vxx = Qxx + K.mT @ Quu @ K + K.mT @ Qux + Qux.mT @ K
        Vxx = 0.5 * (Vxx + Vxx.mT)
        ks.append(k)
        Ks.append(K)
    return torch.stack(ks[::-1], dim=-2), torch.stack(Ks[::-1], dim=-3)


@annotated("ilqr.forward")
def _forward(model, x0, xs, us, ks, Ks, alpha, dt, cost: QuadCost):
    """Closed-loop forward pass of the affine policy at every step size:
    ``alpha`` (A, *1s, 1) gives candidates ``(A, *batch, ...)``."""
    x = x0.expand(alpha.shape[0], *x0.shape)
    xs_new, us_new = [x], []
    for t in range(us.shape[-2]):
        u = us[..., t, :] + alpha * ks[..., t, :] + _mv(Ks[..., t, :, :], x - xs[..., t, :])
        x = model.step(x, u, dt)
        xs_new.append(x)
        us_new.append(u)
    xs_new, us_new = torch.stack(xs_new, dim=-2), torch.stack(us_new, dim=-2)
    return xs_new, us_new, cost.total(xs_new, us_new)


def _solve(model, cost, x0, us_init, dt, iters, mu, alphas):
    """``ilqr``'s iterations; returns the result and, for each iteration,
    whether each batch element took its line-search step (``(*batch,)``
    bool)."""
    global SOLVES
    SOLVES += 1
    batch = x0.shape[:-1]
    xs, us = rollout(model, x0, us_init, dt), us_init
    c = cost.total(xs, us)
    mu_c = x0.new_full(batch, mu)
    # the step sizes as a leading dimension, filled on the device
    alpha = torch.stack([x0.new_full((), a) for a in alphas])
    alpha = alpha.reshape(-1, *(1,) * len(batch), 1)
    trace = c.new_empty((*batch, iters))
    accepted = []
    for i in range(iters):
        with annotate("ilqr.linearize"):
            As, Bs = linearize(model, xs[..., :-1, :], us, dt)
        ks, Ks = _backward(As, Bs, xs, us, cost, mu_c)
        xs_c, us_c, costs = _forward(model, x0, xs, us, ks, Ks, alpha, dt, cost)
        # diverged candidates cost +inf, so the line search rejects them
        costs = torch.where(torch.isfinite(costs), costs, torch.inf)
        best = torch.argmin(costs, dim=0)  # the first minimum, as jnp.argmin
        c_new = torch.take_along_dim(costs, best[None], dim=0)[0]
        improved = c_new < c
        keep = improved[..., None, None]
        best = best.reshape(1, *batch, 1, 1)
        xs = torch.where(keep, torch.take_along_dim(xs_c, best, dim=0)[0], xs)
        us = torch.where(keep, torch.take_along_dim(us_c, best, dim=0)[0], us)
        c = torch.where(improved, c_new, c)
        # Levenberg schedule: shrink on success, grow on rejection
        mu_c = torch.where(improved, torch.clamp(mu_c * 0.5, min=mu), mu_c * 4.0)
        mu_c = torch.clamp(mu_c, max=1e6)
        trace[..., i] = c
        accepted.append(improved)
    return ILQRResult(xs, us, c, trace), accepted


@capture
@matmul_precision_scope
def ilqr(
    model: Model,
    cost: QuadCost,
    x0: torch.Tensor,
    us_init: torch.Tensor,
    dt: float,
    iters: int = 20,
    mu: float = 1e-3,
    alphas: Tuple[float, ...] = ALPHAS,
) -> ILQRResult:
    """Fixed-iteration iLQR from ``x0`` ``(*batch, n)`` with the initial
    inputs ``us_init`` ``(*batch, T, m)``; every batch element is its own
    problem, as under the reference's ``jax.vmap``."""
    return _solve(model, cost, x0, us_init, dt, iters, mu, alphas)[0]


def ilqr_batched(model, cost, x0s, us_init, dt, **kw) -> ILQRResult:
    """A batch of initial states (the scenario batch): ``ilqr`` itself, which
    treats every leading dimension as a batch (and is captured)."""
    return ilqr(model, cost, x0s, us_init, dt, **kw)


@dataclasses.dataclass(frozen=True, eq=False)
class ILQRMPC:
    """Receding-horizon iLQR over a plan of ``horizon`` stages, warm-started
    from the previous period's plan, which the caller keeps (on the card,
    between captured calls) and hands back each period; ``mu`` starts afresh
    each period, as ``ilqr`` starts it.

    ``accepted`` is a ``()`` int64 tensor on the cost's device to which each
    call adds the count of batch elements whose line-search step was taken,
    over its iterations; inside a captured call the graph adds it on the
    device, so it is read once, after many periods."""

    model: Model
    cost: QuadCost
    horizon: int
    dt: float
    iters: int = 1
    mu: float = 1e-3
    alphas: Tuple[float, ...] = ALPHAS
    accepted: torch.Tensor = dataclasses.field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "accepted",
                           torch.zeros((), dtype=torch.int64, device=self.cost.Q.device))

    def initial_plan(self, batch: Tuple[int, ...]) -> torch.Tensor:
        """``(*batch, horizon, m)``: the input reference (zero when the cost
        has none) at every stage."""
        u = self.cost.u_goal
        if u is None:
            u = torch.zeros_like(self.cost.R[0])
        return u.expand(*batch, self.horizon, u.shape[-1]).contiguous()

    @staticmethod
    def shift(plan: torch.Tensor) -> torch.Tensor:
        """The warm start for the next period: stages 1..N-1 of ``plan``
        ``(*batch, N, m)``, then its last stage again."""
        return torch.cat([plan[..., 1:, :], plan[..., -1:, :]], dim=-2)

    @matmul_precision_scope
    def control(self, x, plan):
        """``(u, plan_next)`` for states ``x`` ``(*batch, n)`` and the
        previous period's ``plan`` ``(*batch, N, m)``: ``iters`` iterations
        from ``shift(plan)``, the new plan's first input, and the new plan
        (unshifted)."""
        res, accepted = _solve(self.model, self.cost, x, self.shift(plan), self.dt, self.iters,
                               self.mu, self.alphas)
        self.accepted.add_(torch.stack(accepted).sum())
        return res.us[..., 0, :], res.us
