"""The quadrotor MPC step in f64, from the configuration's numbers alone.

A frozen copy of the quadrotor's equations (12 states ``[p, v, phi theta
psi, omega]``, inputs ``[thrust, tau]``, ZYX Euler angles), the classic RK4
step, the linearisation at hover (forward-mode Jacobians of the RK4 step),
the condensed QP (``H = Su' Qbar Su + Rbar``, ``M = Su' Qbar Sx``, the
unconstrained gain ``K = H^-1 M`` and the ADMM factor ``(H + rho I)^-1``)
and over-relaxed ADMM at a fixed iteration count with the warm start
``clip(-K x)``. Nothing is read from the port: every matrix is formed here.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd


class QuadrotorMPC:
    """The configuration's controller, formed in f64 on ``device``."""

    def __init__(self, cfg: dict, device="cpu", dtype=torch.float64):
        self.cfg = cfg
        self.device, self.dtype = device, dtype
        p = cfg["plant"]
        self.mass, self.g = float(p["mass"]), float(p["gravity"])
        self.J = torch.tensor(p["inertia"], dtype=torch.float64, device=device)
        self.dt = float(cfg["dt"])
        c = cfg["controller"]
        self.N, self.iters = int(c["horizon"]), int(c["admm_iters"])
        self.rho, self.alpha = float(c["rho"]), float(c["alpha"])
        self.u_eq = torch.tensor([self.mass * self.g, 0.0, 0.0, 0.0], dtype=torch.float64,
                                 device=device)
        A, B = self.linearize()
        Q = np.diag(np.asarray(c["Q_diag"], np.float64))
        R = np.eye(4) * float(c["R_scale"])
        M, K, S = condense(A, B, Q, R, Q, self.N, self.rho)
        to = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
        self.M, self.K, self.S = to(M), to(K), to(S)
        self.lo = to(np.tile(np.asarray(c["u_min"], np.float64), self.N))
        self.hi = to(np.tile(np.asarray(c["u_max"], np.float64), self.N))

    def dynamics(self, x, u):
        J = self.J.to(x.dtype)
        v = x[..., 3:6]
        phi, th, psi = x[..., 6], x[..., 7], x[..., 8]
        w = x[..., 9:12]
        thrust, tau = u[..., 0:1], u[..., 1:4]
        cphi, sphi = torch.cos(phi), torch.sin(phi)
        cth, sth = torch.cos(th), torch.sin(th)
        cpsi, spsi = torch.cos(psi), torch.sin(psi)
        zb = torch.stack([cpsi * sth * cphi + spsi * sphi,
                          spsi * sth * cphi - cpsi * sphi,
                          cth * cphi], dim=-1)
        grav = torch.zeros(3, dtype=x.dtype, device=x.device)
        grav[2] = self.g
        acc = zb * (thrust / self.mass) - grav
        tth = torch.tan(th)
        p_, q_, r_ = w[..., 0], w[..., 1], w[..., 2]
        euld = torch.stack([p_ + sphi * tth * q_ + cphi * tth * r_,
                            cphi * q_ - sphi * r_,
                            (sphi * q_ + cphi * r_) / torch.clamp(cth, min=1e-6)], dim=-1)
        wdot = (tau - torch.linalg.cross(w, J * w, dim=-1)) / J
        return torch.cat([v, acc, euld, wdot], dim=-1)

    def step(self, x, u):
        """One RK4 step of the plant, zero-order hold on ``u``."""
        dt, f = self.dt, self.dynamics
        k1 = f(x, u)
        k2 = f(x + 0.5 * dt * k1, u)
        k3 = f(x + 0.5 * dt * k2, u)
        k4 = f(x + dt * k3, u)
        return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    def linearize(self):
        x0 = torch.zeros(12, dtype=torch.float64)
        u0 = self.u_eq.cpu()
        saved, self.J = self.J, self.J.cpu()
        try:
            A, B = jacfwd(self.step, argnums=(0, 1))(x0, u0)
        finally:
            self.J = saved
        return A.numpy(), B.numpy()

    def plan(self, x):
        """The deviation plan ``(batch, N * m)`` for states ``x`` (hover is
        the origin)."""
        x = x.to(self.dtype)
        g = x @ self.M.T
        z = torch.clamp(-x @ self.K.T, self.lo, self.hi)
        y = torch.zeros_like(z)
        for _ in range(self.iters):
            u = (self.rho * (z - y) - g) @ self.S
            u_rel = self.alpha * u + (1.0 - self.alpha) * z
            z_new = torch.clamp(u_rel + y, self.lo, self.hi)
            y = y + u_rel - z_new
            z = z_new
        return z

    def input_scale(self):
        """``(12,)``: what turns a gap of the next state into the input
        gap that would explain it over one step. A thrust gap moves a
        velocity by ``dt / m`` per newton and a torque gap a body rate by
        ``dt / J`` per newton metre, so the velocities take ``m / dt``, the
        rates ``J / dt``; positions and angles, which an input reaches only
        at ``dt^2``, take 0."""
        s = torch.zeros(12, dtype=torch.float64, device=self.device)
        s[3:6] = self.mass / self.dt
        s[9:12] = self.J / self.dt
        return s

    def first_input(self, x):
        """The applied input: the plan's first stage plus the hover thrust."""
        return self.plan(x)[:, :4] + self.u_eq.to(self.dtype)


def condense(A, B, Q, R, QN, N: int, rho: float):
    """``(M, K, S)`` of the condensed QP over ``N`` stages, in f64 numpy."""
    n, m = B.shape
    Apow = [np.eye(n)]
    for _ in range(N):
        Apow.append(A @ Apow[-1])
    Sx = np.concatenate(Apow[1:], axis=0)
    Su = np.zeros((N * n, N * m))
    for i in range(N):
        for j in range(i + 1):
            Su[i * n:(i + 1) * n, j * m:(j + 1) * m] = Apow[i - j] @ B
    Qbar = np.kron(np.eye(N), Q)
    Qbar[-n:, -n:] = QN
    H = Su.T @ Qbar @ Su + np.kron(np.eye(N), R)
    H = 0.5 * (H + H.T)
    M = Su.T @ Qbar @ Sx
    return M, np.linalg.solve(H, M), np.linalg.inv(H + rho * np.eye(N * m))


def blocks(n: int, rows: int):
    """Row slices of at most ``rows`` covering ``range(n)``."""
    return [slice(s, min(n, s + rows)) for s in range(0, n, rows)]
