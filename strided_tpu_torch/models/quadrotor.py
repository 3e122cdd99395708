"""Quadrotor, 12-state: the flagship MPC model.

Counterpart of ``strided_tpu/models/quadrotor.py``, same formulas. State
``[p(3), v(3), eul(3)=phi,theta,psi, omega(3)]``, input
``[thrust, tau_x, tau_y, tau_z]``; hover at ``u = [m*g, 0, 0, 0]``.
"""

from __future__ import annotations

import functools

import torch

from . import quadrotor_jac, quadrotor_rk4
from .base import Model

__all__ = ["quadrotor", "hover_state", "hover_input"]


def quadrotor(m=1.0, g=9.81, Jx=0.01, Jy=0.01, Jz=0.02) -> Model:
    consts = {}

    def dynamics(x, u):
        # constants in the state's dtype and device, so f32 never promotes;
        # made once per (dtype, device), so a step copies nothing from the
        # host and can be captured in a CUDA graph
        key = (x.dtype, x.device)
        if key not in consts:
            consts[key] = (torch.tensor([Jx, Jy, Jz], dtype=x.dtype, device=x.device),
                           torch.tensor([0.0, 0.0, g], dtype=x.dtype, device=x.device))
        J, grav = consts[key]
        v = x[..., 3:6]
        phi, th, psi = x[..., 6], x[..., 7], x[..., 8]
        w = x[..., 9:12]
        # thrust kept as a (..., 1) slice: forward-mode AD promotes the
        # tangent of a 0-dim tensor times a Python float to float64
        thrust = u[..., 0:1]
        tau = u[..., 1:4]

        cphi, sphi = torch.cos(phi), torch.sin(phi)
        cth, sth = torch.cos(th), torch.sin(th)
        cpsi, spsi = torch.cos(psi), torch.sin(psi)

        # Body-z axis in world frame (ZYX Euler):
        zb = torch.stack(
            [
                cpsi * sth * cphi + spsi * sphi,
                spsi * sth * cphi - cpsi * sphi,
                cth * cphi,
            ],
            dim=-1,
        )
        acc = zb * (thrust / m) - grav

        # Euler-angle kinematics (ZYX): eul_dot = E(eul) @ omega
        tth = torch.tan(th)
        p_, q_, r_ = w[..., 0], w[..., 1], w[..., 2]
        phid = p_ + sphi * tth * q_ + cphi * tth * r_
        thd = cphi * q_ - sphi * r_
        psid = (sphi * q_ + cphi * r_) / torch.clamp(cth, min=1e-6)
        euld = torch.stack([phid, thd, psid], dim=-1)

        # Rigid-body rotation: J w_dot = tau - w x (J w)
        wdot = (tau - torch.linalg.cross(w, J * w, dim=-1)) / J

        return torch.cat([v, acc, euld, wdot], dim=-1)

    fused = functools.partial(quadrotor_rk4.rk4, m=m, g=g, J=(Jx, Jy, Jz))
    jacobians = functools.partial(quadrotor_jac.jacobians, m=m, J=(Jx, Jy, Jz))
    return Model("quadrotor", 12, 4, dynamics, fused_step=fused, fused_linearize=jacobians)


def hover_state(dtype=torch.float32, device=None):
    """The hover equilibrium's state, on the card unless ``device`` is given
    (the reference's lands on JAX's default device)."""
    return torch.zeros(12, dtype=dtype, device="cuda" if device is None else device)


def hover_input(m=1.0, g=9.81, dtype=torch.float32, device=None):
    """The hover thrust ``[m*g, 0, 0, 0]``, on the card unless ``device`` is
    given."""
    return torch.tensor([m * g, 0.0, 0.0, 0.0], dtype=dtype,
                        device="cuda" if device is None else device)
