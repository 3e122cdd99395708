"""Batched dynamics rollouts over (batch, horizon, state) tensors.

Counterpart of ``strided_tpu/mpc/rollout.py`` (BASELINE config 2: 4096
batched double-pendulum rollouts, horizon 100). The reference's ``lax.scan``
over the horizon becomes a Python loop of RK4 steps over the whole batch;
nothing in it reads back from the card, and on the card each call runs as
one captured CUDA graph (``capture.py``).
"""

from __future__ import annotations

import torch

from ..capture import capture
from ..models.base import Model

__all__ = ["rollout", "rollout_final"]


@capture
def rollout(model: Model, x0: torch.Tensor, us: torch.Tensor, dt) -> torch.Tensor:
    """Roll out ``us`` of shape ``(*batch, T, m)`` from ``x0`` ``(*batch, n)``.

    Returns states ``(*batch, T+1, n)`` (including ``x0``), time on axis -2."""
    xs = [x0]
    for t in range(us.shape[-2]):
        xs.append(model.step(xs[-1], us[..., t, :], dt))
    return torch.stack(xs, dim=-2)


@capture
def rollout_final(model: Model, x0: torch.Tensor, us: torch.Tensor, dt) -> torch.Tensor:
    """The final state ``(*batch, n)`` only, without keeping the trajectory."""
    x = x0
    for t in range(us.shape[-2]):
        x = model.step(x, us[..., t, :], dt)
    return x
