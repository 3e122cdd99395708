"""Ground-vehicle models: unicycle and kinematic bicycle.

Counterpart of ``strided_tpu/models/vehicles.py``, same formulas.
Quantities are ``(..., 1)`` slices so that f32 Jacobians stay f32 (see
``pendulum.py``).
"""

from __future__ import annotations

import torch

from .base import Model

__all__ = ["unicycle", "bicycle"]


def unicycle() -> Model:
    """State [x, y, theta], input [v, omega]."""

    def dynamics(x, u):
        th = x[..., 2:3]
        v, w = u[..., 0:1], u[..., 1:2]
        return torch.cat([v * torch.cos(th), v * torch.sin(th), w], dim=-1)

    return Model("unicycle", 3, 2, dynamics)


def bicycle(wheelbase=2.5) -> Model:
    """Kinematic bicycle: state [x, y, theta, v], input [accel, steer]."""

    def dynamics(x, u):
        th, v = x[..., 2:3], x[..., 3:4]
        a, delta = u[..., 0:1], u[..., 1:2]
        return torch.cat(
            [
                v * torch.cos(th),
                v * torch.sin(th),
                v * torch.tan(delta) / wheelbase,
                a,
            ],
            dim=-1,
        )

    return Model("bicycle", 4, 2, dynamics)
