"""Dynamics-model base: continuous dynamics, RK4 step, linearization.

Counterpart of ``strided_tpu/models/base.py``. Jacobians use
``torch.func.jacfwd`` (forward mode: the state has few dimensions) and the
batched linearization is ``torch.func.vmap`` over every leading dimension.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from ..utils.profiling import annotated

__all__ = ["Model", "rk4_step", "linearize"]


def rk4_step(f: Callable, x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """Classic RK4 discretization of ``x' = f(x, u)`` (zero-order-hold u)."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


@dataclasses.dataclass(frozen=True)
class Model:
    """A dynamics model: ``dynamics(x, u) -> xdot`` on ``(*batch, n)`` /
    ``(*batch, m)`` tensors, ``step`` the RK4 map, ``linearize`` the
    Jacobians (A, B) of the discrete step.

    ``fused_step(x, u, dt)``, where a model has one, is the same RK4 step in
    one kernel; it returns ``None`` for a call it declines, which ``step``
    then runs eagerly."""

    name: str
    state_dim: int
    input_dim: int
    dynamics: Callable  # (x, u) -> xdot
    fused_step: Optional[Callable] = None  # (x, u, dt) -> x_next or None

    @annotated("model.step")
    def step(self, x, u, dt):
        if self.fused_step is not None:
            out = self.fused_step(x, u, dt)
            if out is not None:
                return out
        return rk4_step(self.dynamics, x, u, dt)

    def linearize(self, x, u, dt) -> Tuple[torch.Tensor, torch.Tensor]:
        # one forward-mode pass for both Jacobians: the n + m tangents ride
        # one RK4 step (the reference differentiates twice; the values are
        # the same, per tangent the same arithmetic)
        return jacfwd(lambda xx, uu: self.step(xx, uu, dt), argnums=(0, 1))(x, u)


def linearize(model: Model, xs, us, dt):
    """Batched linearization: ``vmap`` of :meth:`Model.linearize` over all
    leading dims of ``xs``/``us``."""
    f = lambda x, u: model.linearize(x, u, dt)
    for _ in range(xs.ndim - 1):
        f = vmap(f)
    return f(xs, us)
