"""One control period of the quadrotor's receding-horizon iLQR in f64, from
the configuration's numbers alone.

Real-time iteration (Diehl, Bock & Schloeder, SIAM J. Control Optim. 43(5),
2005) by iLQR (Li & Todorov, ICINCO 2004): the previous plan shifted by one
stage (its last input repeated) is rolled out from the state; the RK4
step's Jacobians along that trajectory come by forward mode; the Riccati
backward sweep gives the feedforward and feedback gains, with ``mu`` added
to Quu; the affine policy is rolled out at each step size; the cheapest
candidate is kept where its cost is below the old one, else the shifted
plan stays; with several iterations a period, ``mu`` then halves (not below
its start) on a kept step and grows fourfold (to at most 1e6) on a
rejected one; the plan's first input is applied. The cost is
0.5(x-xg)'Q(x-xg) + 0.5(u-ug)'R(u-ug) a stage and 0.5(x-xg)'Qf(x-xg) at the
end, with xg hover and ug the configuration's input reference. The plant's
equations and RK4 step are ``quadrotor_mpc``'s reference's, used as they
are. Nothing is read from the port.

**The tie rule.** A program in f32 rounds each candidate's cost, a sum of
50 stages of quadratics along a rolled-out trajectory, by about 1e-6 of
its size. Where the reference's two cheapest candidates lie within
``TIE`` (1e-5) of their cost of each other, or its new cost and the old one
do, f32 cannot resolve the choice, and either outcome is right: the two
differ by a whole step of the line search, not by rounding. For such a
quadrotor :meth:`QuadrotorILQR.outcomes` admits both, and the check takes
the gap to the nearer. With several iterations a period the rule widens the
last iteration's choice only; the earlier ones take the reference's own.
"""

from __future__ import annotations

import contextlib

import torch
from torch.func import jacfwd, vmap

from .quadrotor_mpc import QuadrotorMPC

TIE = 1e-5


class Plant:
    """The configuration's quadrotor: ``quadrotor_mpc``'s equations
    (``dynamics``), its RK4 step at the configuration's ``dt`` (``step``)
    and its ``input_scale``, on ``device`` in f64."""

    dynamics = QuadrotorMPC.dynamics
    step = QuadrotorMPC.step
    input_scale = QuadrotorMPC.input_scale

    def __init__(self, cfg: dict, device="cpu"):
        p = cfg["plant"]
        self.device = device
        self.mass, self.g = float(p["mass"]), float(p["gravity"])
        self.J = torch.tensor(p["inertia"], dtype=torch.float64, device=device)
        self.dt = float(cfg["dt"])


@contextlib.contextmanager
def _ieee():
    """f32 products in IEEE FP32 (TF32 off) inside, the caller's flags
    restored after; the reference computes in f64, where TF32 never
    applies, and keeps them off all the same."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class QuadrotorILQR:
    """The configuration's controller, formed in f64 on ``device``."""

    def __init__(self, cfg: dict, device="cpu"):
        self.plant = Plant(cfg, device)
        c = cfg["controller"]
        f64 = dict(dtype=torch.float64, device=device)
        self.N, self.iters = int(c["horizon"]), int(c["iters"])
        self.mu = float(c["mu"])
        self.alphas = torch.tensor(c["alphas"], **f64)
        self.Q = torch.diag(torch.tensor(c["Q_diag"], **f64))
        self.Qf = torch.diag(torch.tensor(c["Qf_diag"], **f64))
        self.R = float(c["R_scale"]) * torch.eye(4, **f64)
        self.x_goal = torch.zeros(12, **f64)
        self.u_goal = torch.tensor(c["u_goal"], **f64)

    def rollout(self, x, us):
        """States ``(..., N+1, 12)`` from ``x`` ``(..., 12)`` under ``us``
        ``(..., N, 4)``."""
        xs = [x]
        for t in range(us.shape[-2]):
            xs.append(self.plant.step(xs[-1], us[..., t, :]))
        return torch.stack(xs, dim=-2)

    def cost(self, xs, us):
        """``(...,)``: the stage costs and the terminal cost of a trajectory."""
        dx, du = xs - self.x_goal, us - self.u_goal
        stage = 0.5 * ((dx[..., :-1, :] @ self.Q) * dx[..., :-1, :]).sum((-2, -1))
        stage = stage + 0.5 * ((du @ self.R) * du).sum((-2, -1))
        return stage + 0.5 * ((dx[..., -1, :] @ self.Qf) * dx[..., -1, :]).sum(-1)

    def jacobians(self, xs, us):
        """``(A, B)``, ``(b, N, 12, 12)`` and ``(b, N, 12, 4)``: the RK4
        step's Jacobians at each stage, by forward mode."""
        b, n = us.shape[0], us.shape[1]
        jac = vmap(jacfwd(self.plant.step, argnums=(0, 1)))
        A, B = jac(xs[:, :-1].reshape(b * n, 12), us.reshape(b * n, 4))
        return A.reshape(b, n, 12, 12), B.reshape(b, n, 12, 4)

    def sweep(self, A, B, xs, us, mu):
        """The Riccati backward sweep: feedforward ``k`` ``(b, N, 4)`` and
        feedback ``K`` ``(b, N, 4, 12)``, with ``mu`` ``(b,)`` on Quu."""
        Vx = (xs[:, -1] - self.x_goal) @ self.Qf
        Vxx = self.Qf.expand(xs.shape[0], 12, 12)
        ks, Ks = [None] * self.N, [None] * self.N
        for t in reversed(range(self.N)):
            At, Bt = A[:, t], B[:, t]
            AT, BT = At.transpose(1, 2), Bt.transpose(1, 2)
            Qx = (xs[:, t] - self.x_goal) @ self.Q + (AT @ Vx[..., None])[..., 0]
            Qu = (us[:, t] - self.u_goal) @ self.R + (BT @ Vx[..., None])[..., 0]
            Qxx = self.Q + AT @ Vxx @ At
            Quu = self.R + BT @ Vxx @ Bt + mu[:, None, None] * torch.eye(4, dtype=A.dtype,
                                                                         device=A.device)
            Qux = BT @ Vxx @ At
            Quu_inv = torch.linalg.inv(Quu)
            K = -Quu_inv @ Qux
            k = -(Quu_inv @ Qu[..., None])[..., 0]
            KT = K.transpose(1, 2)
            Vx = (Qx + (KT @ (Quu @ k[..., None]))[..., 0] + (KT @ Qu[..., None])[..., 0]
                  + (Qux.transpose(1, 2) @ k[..., None])[..., 0])
            Vxx = Qxx + KT @ Quu @ K + KT @ Qux + Qux.transpose(1, 2) @ K
            Vxx = 0.5 * (Vxx + Vxx.transpose(1, 2))
            ks[t], Ks[t] = k, K
        return torch.stack(ks, dim=1), torch.stack(Ks, dim=1)

    def candidates(self, x, xs, us, k, K):
        """The affine policy rolled out from ``x`` at every step size:
        states ``(A, b, N+1, 12)``, inputs ``(A, b, N, 4)`` and costs
        ``(A, b)``, +inf where not finite."""
        a = self.alphas[:, None, None]
        xc = x.expand(len(self.alphas), *x.shape)
        xs_c, us_c = [xc], []
        for t in range(self.N):
            u = us[:, t] + a * k[:, t] + (K[:, t] @ (xc - xs[:, t])[..., None])[..., 0]
            xc = self.plant.step(xc, u)
            xs_c.append(xc)
            us_c.append(u)
        xs_c, us_c = torch.stack(xs_c, dim=-2), torch.stack(us_c, dim=-2)
        costs = self.cost(xs_c, us_c)
        return xs_c, us_c, torch.where(torch.isfinite(costs), costs, torch.inf)

    def outcomes(self, x, plan):
        """One period from states ``x`` ``(b, 12)`` and the previous plan
        ``(b, N, 4)``, in f64: ``(plans, own, admitted, tied)``. ``plans``
        ``(A+1, b, N, 4)`` holds each candidate's inputs, then the plan the
        last iteration started from (the outcome of a rejected step); a
        plan's first stage is the input applied. ``own`` ``(b,)`` indexes
        the reference's own outcome; ``admitted`` ``(A+1, b)`` marks it
        and, under the tie rule (module docstring), the one f32 may take
        instead; ``tied`` ``(b,)`` marks the quadrotors the rule widened."""
        b = x.shape[0]
        rows = torch.arange(b, device=x.device)
        with _ieee():
            x, plan = x.to(torch.float64), plan.to(torch.float64)
            us = torch.cat([plan[:, 1:], plan[:, -1:]], dim=1)
            xs = self.rollout(x, us)
            old = self.cost(xs, us)
            mu = torch.full((b,), self.mu, dtype=torch.float64, device=x.device)
            for i in range(self.iters):
                k, K = self.sweep(*self.jacobians(xs, us), xs, us, mu)
                xs_c, us_c, costs = self.candidates(x, xs, us, k, K)
                if i == self.iters - 1:
                    break
                best = costs.argmin(0)
                keep = costs[best, rows] < old
                xs = torch.where(keep[:, None, None], xs_c[best, rows], xs)
                us = torch.where(keep[:, None, None], us_c[best, rows], us)
                old = torch.where(keep, costs[best, rows], old)
                mu = torch.where(keep, torch.clamp(mu * 0.5, min=self.mu), mu * 4.0)
                mu = torch.clamp(mu, max=1e6)
        n = len(self.alphas)
        # a stable sort puts the first of equal minima first, as argmin takes it
        order = torch.sort(costs, dim=0, stable=True).indices
        best, second = order[0], order[1]
        c1, c2 = costs[best, rows], costs[second, rows]
        accept = c1 < old
        own = torch.where(accept, best, n)
        tie_accept = (c1 - old).abs() <= TIE * old.abs()
        tie_best = ((c2 - c1).abs() <= TIE * c1.abs()) & (accept | tie_accept)
        admitted = torch.zeros(n + 1, b, dtype=torch.bool, device=x.device)
        admitted[own, rows] = True
        admitted[best, rows] |= tie_accept
        admitted[n] |= tie_accept
        admitted[second, rows] |= tie_best
        return torch.cat([us_c, us[None]], dim=0), own, admitted, tie_accept | tie_best

    def next_states(self, x, u):
        """``(A+1, b, 12)``: the plant's step from ``x`` under each outcome's
        first input ``u`` ``(A+1, b, 4)``, in f64."""
        x = x.to(torch.float64)
        return self.plant.step(x.expand(u.shape[0], *x.shape), u)
