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

The step and the consensus run through :func:`mesh_capture`, the
counterpart of ``jax.jit(shard_map(...))``: on the card one CUDA-graph
replay a call on each rank, K1 and (for the consensus) NCCL's
``all_reduce`` inside the graph. NCCL pairs collectives by the order the
ranks issue them, so every rank must capture on the same call and replay
on the others: a first call runs the collective twice (the warm-up and the
replay), a later one once. The design makes the ranks agree:

- a captured function of the layer takes tensors only (anything else is a
  ``TypeError``), so its cache key is their shapes, dtypes, strides and
  device plus the config and the f32 matmul mode (``capture.signature``),
  and no entry is held by a weak reference that a rank's garbage collector
  could drop at its own time;
- every rank is passed the same global batch, and the device is fixed for
  a rank; the config and the matmul mode are set by the same code on every
  rank;
- each returned function has a cache of its own, built by every rank in
  the same order.

A call made on one rank alone waits for its peers at the collective,
captured or not. A gloo group is refused before any capture
(``mesh.require_graph_backend``); inside ``capture.disable_capture()`` every
function runs eagerly on any backend. ``sharded_rollout`` is not captured
itself: it calls the captured ``rollout`` on the rank's rows.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..capture import capture
from .mesh import axis_size, collective, require_graph_backend, shard

__all__ = [
    "shard_batch",
    "mesh_capture",
    "sharded_rollout",
    "sharded_mpc_step",
    "scenario_consensus_control",
]


def shard_batch(fn: Callable, mesh: DeviceMesh, axis: str = "data") -> Callable:
    """Wrap ``fn(batch_args...) -> batch_out`` so that it runs on the rank's
    rows (dim 0) of every argument: the result is the rank's block. ``fn``
    must be shape-polymorphic in the batch dim (batched code is)."""

    @functools.wraps(fn)
    def local(*args):
        return fn(*(shard(a, mesh, 0, axis) for a in args))

    return local


def mesh_capture(fn: Callable, mesh: DeviceMesh, axis: str = "data") -> Callable:
    """``capture(fn)`` for a function whose collectives run over mesh
    dimension ``axis``: on the card one CUDA-graph replay a call, the
    collectives inside it. ``fn`` takes tensors only (the module docstring
    says why). A group other than NCCL's raises ``RuntimeError`` before any
    capture, where the call would be recorded; CPU tensors and calls inside
    ``capture.disable_capture()`` run ``fn`` as it is. The returned
    function's ``cache`` holds its entries."""
    captured = capture(fn)
    what = fn.__name__

    @functools.wraps(fn)
    def call(*args):
        for a in args:
            if not isinstance(a, torch.Tensor):
                raise TypeError(f"{what}: a captured function of the mesh takes tensors only, "
                                f"got {type(a).__name__}")
        require_graph_backend(mesh, axis, args, what)
        return captured(*args)

    call.cache = captured.cache
    return call


def sharded_rollout(model, mesh: DeviceMesh, dt, axis: str = "data") -> Callable:
    """Scenario-split batched rollout: ``(B, n) x (B, T, m) -> `` the rank's
    block of ``(B, T+1, n)``, through the captured ``rollout``."""
    from ..mpc.rollout import rollout

    return shard_batch(lambda x0, us: rollout(model, x0, us, dt), mesh, axis)


def sharded_mpc_step(ctrl, model, mesh: DeviceMesh, dt, axis: str = "data") -> Callable:
    """One closed-loop MPC step over a scenario-split batch: solve the
    condensed QP for the rank's rows (K1 where ``qp_solve`` takes it), apply
    the first input, step the plant. ``(B, n) -> (x_next, u)``, both the
    rank's row blocks; no collective. Captured (:func:`mesh_capture`)."""

    def mpc_step(x):
        u, _ = ctrl.control(x)
        return model.step(x, u, dt), u

    return mesh_capture(shard_batch(mpc_step, mesh, axis), mesh, axis)


def scenario_consensus_control(ctrl, mesh: DeviceMesh, axis: str = "data") -> Callable:
    """Scenario-MPC consensus: each rank solves its scenarios' QPs, then the
    first-stage inputs are averaged over every scenario by one
    ``all_reduce(SUM)`` of the local means divided by the axis size (the
    reference's ``pmean``; the shards are of equal size, so this is the
    global mean). BASELINE.json config 5's 'QP-block all-reduce'.
    Captured (:func:`mesh_capture`): the ``all_reduce`` is in the graph.

    Returns a function ``(B, n) -> ((m,) consensus u, replicated;
    (B/ranks, N, m) the rank's plans)``."""

    def consensus_control(x):
        u0, U = ctrl.control(shard(x, mesh, 0, axis))
        u_cons = collective("all_reduce", u0.mean(0), mesh, axis)
        return u_cons / axis_size(mesh, axis), U

    return mesh_capture(consensus_control, mesh, axis)
