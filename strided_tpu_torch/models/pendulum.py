"""Pendulum family: simple pendulum and the chaotic double pendulum.

Counterpart of ``strided_tpu/models/pendulum.py``, same formulas. The double
pendulum is BASELINE config 2's rollout workload (4096 batched rollouts,
horizon 100). State ``[th1, th2, w1, w2]``, joint torques ``[tau1, tau2]``.

Every quantity is a ``(..., 1)`` slice, joined by ``torch.cat`` at the end:
under ``torch.func.jacfwd`` a 0-dim tensor times a Python float gets a
float64 tangent, so ``x[..., 0]`` would turn an f32 Jacobian into float64.
"""

from __future__ import annotations

import torch

from .base import Model

__all__ = ["simple_pendulum", "double_pendulum"]


def simple_pendulum(m=1.0, l=1.0, g=9.81, damping=0.0) -> Model:
    """1-link pendulum: state [theta, omega], input [torque]."""

    def dynamics(x, u):
        th, w = x[..., 0:1], x[..., 1:2]
        tau = u[..., 0:1]
        a = (tau - damping * w - m * g * l * torch.sin(th)) / (m * l * l)
        return torch.cat([w, a], dim=-1)

    return Model("simple_pendulum", 2, 1, dynamics)


def double_pendulum(m1=1.0, m2=1.0, l1=1.0, l2=1.0, g=9.81) -> Model:
    """2-link point-mass pendulum: state [th1, th2, w1, w2], input
    [tau1, tau2] (zero input = passive chaotic rollout)."""

    def dynamics(x, u):
        th1, th2, w1, w2 = x[..., 0:1], x[..., 1:2], x[..., 2:3], x[..., 3:4]
        t1, t2 = u[..., 0:1], u[..., 1:2]
        d = th1 - th2
        cd, sd = torch.cos(d), torch.sin(d)
        den = m1 + m2 * sd * sd
        a1 = (
            t1
            - m2 * l1 * w1 * w1 * sd * cd
            - m2 * l2 * w2 * w2 * sd
            - (m1 + m2) * g * torch.sin(th1)
            + m2 * g * torch.sin(th2) * cd
        ) / (l1 * den)
        a2 = (
            t2
            + (m1 + m2) * l1 * w1 * w1 * sd
            + m2 * l2 * w2 * w2 * sd * cd
            + (m1 + m2) * g * (torch.sin(th1) * cd - torch.sin(th2))
        ) / (l2 * den)
        return torch.cat([w1, w2, a1, a2], dim=-1)

    return Model("double_pendulum", 4, 2, dynamics)
