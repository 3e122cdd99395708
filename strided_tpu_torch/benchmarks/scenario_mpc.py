"""Scenario-MPC benchmark on the card: BASELINE config 5, "16k rollouts
sharded over hosts, QP-block all-reduce, real-time budget 10 ms".

Counterpart of ``benchmarks/scenario_mpc.py``, with the same defaults and
JSON keys: the scenario-split MPC step (per-scenario condensed-QP ADMM
solves through K1, then the plant step) over the ranks of a ``('data',)``
mesh, timed over chained steps with CUDA events, and the consensus control
(one ``all_reduce``) checked finite. Run as one process, the mesh is one
rank (NCCL); under ``torchrun`` it spans the ranks.

The chained step (:func:`chained_step`: the split step, then over r > 1
ranks the ``all_gather`` of the next states) is one captured program, as
the reference's is one jitted step: on each rank one CUDA-graph replay a
step, NCCL's ``all_gather`` inside it. The reference's chain keeps the
sharded array and issues no collective a step; this one gathers, since
each function of the port takes the batch every rank holds.

    python3 -m strided_tpu_torch.benchmarks.scenario_mpc [--scenarios 16384]

prints the card's name and power limit, then one JSON line: the
reference's keys (``metric``, ``scenarios``, ``devices``, ``horizon``,
``admm_iters``, ``latency_ms`` (captured), ``budget_ms``,
``within_budget``, ``solves_per_s``), ``backend``, ``ranks`` and ``card``,
and the captured chain's ``eager_latency_ms`` (the same chain inside
``disable_capture()``), ``device_ms`` (``bench.graph_ms``),
``first_call_ms`` (warm-up, capture, instantiation and one replay, held
bit for bit against an eager step), ``capture_ms`` and ``captured``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..bench import card_label, cuda_ms, graph_ms, matches_eager
from ..capture import disable_capture
from ..models import hover_input, hover_state, quadrotor
from ..mpc import make_hover_mpc
from ..parallel import (axis_size, gather, init_distributed, make_mesh, mesh_capture,
                        scenario_consensus_control, sharded_mpc_step)

__all__ = ["controller", "states", "chained_step", "run", "main", "DT", "WARMUP", "REPS"]

DT = 0.02
WARMUP = 3  # untimed chained steps before the timed ones
REPS = 10  # timed chained steps


def controller(horizon: int = 50, admm_iters: int = 20, device="cuda", dtype=torch.float32):
    """``(model, ctrl)``: the reference benchmark's quadrotor controller
    (``entry.make_controller``'s costs and bounds, ADMM at the default
    rho=1)."""
    model = quadrotor()
    as_t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    Q = torch.diag(as_t([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1]))
    ctrl = make_hover_mpc(
        model, hover_state(dtype, device), hover_input(dtype=dtype, device=device),
        Q, torch.eye(4, dtype=dtype, device=device) * 0.1, Q,
        horizon=horizon, dt=DT,
        u_min=as_t([-5.0, -0.5, -0.5, -0.5]), u_max=as_t([10.0, 0.5, 0.5, 0.5]),
        admm_iters=admm_iters,
    )
    return model, ctrl


def states(scenarios: int = 16384, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """The scenarios' states, uniform in +-0.3 from ``default_rng(0)``."""
    x = np.random.default_rng(0).uniform(-0.3, 0.3, (scenarios, 12))
    return torch.as_tensor(x, dtype=dtype, device=device)


def chained_step(step, mesh):
    """The benchmark's chained step as one captured program
    (``parallel.mesh_capture``): ``step`` (a ``sharded_mpc_step``), then,
    over r > 1 ranks, the ``all_gather`` of the rank's next states, so that
    ``(B, n) -> (B, n)`` feeds the next call on every rank."""
    ranks = axis_size(mesh)

    def step_and_gather(x):
        xn, _u = step(x)
        return xn if ranks == 1 else gather(xn, mesh)

    return mesh_capture(step_and_gather, mesh)


def run(scenarios: int = 16384, horizon: int = 50, admm_iters: int = 20,
        budget_ms: float = 10.0, device="cuda") -> dict:
    """Check and time the captured chained step on the card over the ranks
    of the process group (one rank of a group of its own when there is
    none): its first call held bit for bit against the eager chain, then
    captured and eagerly (``cuda_ms``) and as device time (``graph_ms``).
    Every rank must call it together. Returns the JSON row."""
    if torch.device(device).type != "cuda":
        raise RuntimeError(f"scenario_mpc times a CUDA device, got {device!r}")
    mesh = make_mesh(device="cuda")
    ranks = axis_size(mesh)
    model, ctrl = controller(horizon, admm_iters, device)
    x = states(scenarios, device)
    chain = chained_step(sharded_mpc_step(ctrl, model, mesh, DT), mesh)
    cons = scenario_consensus_control(ctrl, mesh)
    _, first_ms, capture_ms = matches_eager(lambda: chain(x))
    state = [x]

    def chained():  # the next state feeds the next step
        state[0] = chain(state[0])

    ms = cuda_ms(chained, reps=REPS, warmup=WARMUP)
    with disable_capture():
        eager_ms = cuda_ms(chained, reps=REPS, warmup=WARMUP)
    device_ms = graph_ms(chained, reps=REPS, replays=3)
    if not torch.isfinite(state[0]).all():
        raise RuntimeError("scenario_mpc: the chained steps produced non-finite states")
    u_cons, _ = cons(x)
    if not torch.isfinite(u_cons).all():
        raise RuntimeError("scenario_mpc: the consensus control is not finite")
    return {
        "metric": "scenario-MPC step latency",
        "scenarios": scenarios,
        "devices": ranks,
        "horizon": horizon,
        "admm_iters": admm_iters,
        "latency_ms": ms,
        "budget_ms": budget_ms,
        "within_budget": ms <= budget_ms,
        "solves_per_s": scenarios / (ms * 1e-3),
        "eager_latency_ms": eager_ms,
        "device_ms": device_ms,
        "first_call_ms": first_ms,
        "capture_ms": capture_ms,
        "captured": True,
        "backend": torch.distributed.get_backend(mesh.get_group("data")),
        "ranks": ranks,
        "card": card_label(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=16384)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--admm-iters", type=int, default=20)
    ap.add_argument("--budget-ms", type=float, default=10.0)
    args = ap.parse_args(argv)
    init_distributed()  # torchrun's ranks, or the single-process no-op
    try:
        row = run(args.scenarios, args.horizon, args.admm_iters, args.budget_ms)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print(row["card"])
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
