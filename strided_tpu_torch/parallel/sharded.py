"""Scenario parallelism over a mesh dimension, and the consensus all-reduce.

Counterpart of ``strided_tpu/parallel/sharded.py``, with the reference's
two rules over ``torch.distributed`` ranks:

- the scenario (batch) dim is split over the axis, so each rank owns
  disjoint output rows and races are impossible by construction;
- reductions across ranks combine through collectives: the consensus
  ``pmean`` is one ``all_reduce(SUM)`` divided by the axis size.

Each function returned here takes the global batch that every rank holds
and computes on the rank's rows (``mesh.shard``); a batch that does not
divide by the axis size raises ``ValueError``, as ``shard_map`` does.
"""

from __future__ import annotations

from typing import Callable

from torch.distributed.device_mesh import DeviceMesh

from .mesh import axis_size, collective, shard

__all__ = [
    "shard_batch",
    "sharded_rollout",
    "sharded_mpc_step",
    "scenario_consensus_control",
]


def shard_batch(fn: Callable, mesh: DeviceMesh, axis: str = "data") -> Callable:
    """Wrap ``fn(batch_args...) -> batch_out`` so that it runs on the rank's
    rows (dim 0) of every argument: the result is the rank's block. ``fn``
    must be shape-polymorphic in the batch dim (batched code is)."""

    def local(*args):
        return fn(*(shard(a, mesh, 0, axis) for a in args))

    return local


def sharded_rollout(model, mesh: DeviceMesh, dt, axis: str = "data") -> Callable:
    """Scenario-split batched rollout: ``(B, n) x (B, T, m) -> `` the rank's
    block of ``(B, T+1, n)``."""
    from ..mpc.rollout import rollout

    return shard_batch(lambda x0, us: rollout(model, x0, us, dt), mesh, axis)


def sharded_mpc_step(ctrl, model, mesh: DeviceMesh, dt, axis: str = "data") -> Callable:
    """One closed-loop MPC step over a scenario-split batch: solve the
    condensed QP for the rank's rows (K1 where ``qp_solve`` takes it), apply
    the first input, step the plant. ``(B, n) -> (x_next, u)``, both the
    rank's row blocks; no collective."""

    def local(x):
        u, _ = ctrl.control(x)
        return model.step(x, u, dt), u

    return shard_batch(local, mesh, axis)


def scenario_consensus_control(ctrl, mesh: DeviceMesh, axis: str = "data") -> Callable:
    """Scenario-MPC consensus: each rank solves its scenarios' QPs, then the
    first-stage inputs are averaged over every scenario by one
    ``all_reduce(SUM)`` of the local means divided by the axis size (the
    reference's ``pmean``; the shards are of equal size, so this is the
    global mean). BASELINE.json config 5's 'QP-block all-reduce'.

    Returns a function ``(B, n) -> ((m,) consensus u, replicated;
    (B/ranks, N, m) the rank's plans)``."""

    def local(x):
        u0, U = ctrl.control(shard(x, mesh, 0, axis))
        u_cons = collective("all_reduce", u0.mean(0), mesh, axis)
        return u_cons / axis_size(mesh, axis), U

    return local
