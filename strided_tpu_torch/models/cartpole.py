"""Cartpole: the iLQR benchmark model (BASELINE config 3).

Counterpart of ``strided_tpu/models/cartpole.py``, same formulas. State
``[p, th, pdot, thdot]`` with ``th`` measured from the downward position
(upright is ``th = pi``), input ``[force]``. Quantities are ``(..., 1)``
slices so that f32 Jacobians stay f32 (see ``pendulum.py``).
"""

from __future__ import annotations

import torch

from .base import Model

__all__ = ["cartpole"]


def cartpole(mc=1.0, mp=0.2, l=0.5, g=9.81) -> Model:
    def dynamics(x, u):
        th, pdot, thdot = x[..., 1:2], x[..., 2:3], x[..., 3:4]
        f = u[..., 0:1]
        s, c = torch.sin(th), torch.cos(th)
        den = mc + mp * s * s
        pddot = (f + mp * s * (l * thdot * thdot + g * c)) / den
        thddot = (-f * c - mp * l * thdot * thdot * c * s - (mc + mp) * g * s) / (
            l * den
        )
        return torch.cat([pdot, thdot, pddot, thddot], dim=-1)

    return Model("cartpole", 4, 1, dynamics)
