"""Batched cartpole iLQR solves/s on the card: BASELINE config 3.

Counterpart of ``benchmarks/ilqr_bench.py``: a scenario batch of cartpole
swing-up problems (each solve ``iters`` iterations of linearization, Riccati
backward sweep and a 4-point line search), at the same sizes and seed. The
public ``ilqr`` runs captured (one CUDA-graph replay a solve); its first
call (warm-up, capture, instantiation) is held bit for bit against an eager
solve (``disable_capture()``), then the solve is timed captured, eagerly
(CUDA events) and as device time alone (``bench.graph_ms``); every cost
must be finite.

    python -m strided_tpu_torch.benchmarks.ilqr_bench [--batch 256] [--horizon 50] [--iters 10]

prints the card's name and power limit, then one JSON line: ``metric``,
``batch``, ``horizon``, ``ilqr_iters``, ``solves_per_s`` and ``latency_ms``
(eager, the reference's keys), ``captured_solves_per_s`` and
``captured_latency_ms`` (the public captured call), ``first_call_ms`` and
``capture_ms`` (its capture and instantiation), ``device_solves_per_s`` and
``device_latency_ms`` (``graph_ms``), and ``card``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..bench import CARTPOLE_DT, card_label, cartpole_cost, cuda_ms, graph_ms, matches_eager
from ..capture import disable_capture
from ..models import cartpole
from ..mpc import ilqr

__all__ = ["problem", "run", "main"]


def problem(batch: int = 256, horizon: int = 50, device="cuda", dtype=torch.float32):
    """``(model, cost, x0s, us0)``: initial states within 0.2 of hanging
    down and inputs at 0.05, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(rng.uniform(-0.2, 0.2, (batch, 4)), dtype=dtype, device=device)
    us0 = torch.as_tensor(rng.standard_normal((batch, horizon, 1)) * 0.05, dtype=dtype,
                          device=device)
    return cartpole(), cartpole_cost(dtype, device), x0s, us0


def run(batch: int = 256, horizon: int = 50, iters: int = 10, device="cuda",
        reps: int = 3) -> dict:
    """Solve, check and time the batch on the card; returns the JSON row."""
    if torch.device(device).type != "cuda":
        raise RuntimeError(f"ilqr_bench times a CUDA device, got {device!r}")
    model, cost, x0s, us0 = problem(batch, horizon, device)
    solve = lambda: ilqr(model, cost, x0s, us0, CARTPOLE_DT, iters=iters)  # noqa: E731
    res, first_ms, capture_ms = matches_eager(solve)
    if not torch.isfinite(res.cost).all():
        raise RuntimeError("ilqr_bench: a solve ended with a non-finite cost")
    captured_ms = cuda_ms(solve, reps=reps, warmup=1)
    with disable_capture():
        ms = cuda_ms(solve, reps=reps, warmup=1)
    dev_ms = graph_ms(solve, reps=1, replays=reps)
    return {
        "metric": "cartpole iLQR solves/s",
        "batch": batch,
        "horizon": horizon,
        "ilqr_iters": iters,
        "solves_per_s": batch / (ms * 1e-3),
        "latency_ms": ms,
        "captured_solves_per_s": batch / (captured_ms * 1e-3),
        "captured_latency_ms": captured_ms,
        "first_call_ms": first_ms,
        "capture_ms": capture_ms,
        "device_solves_per_s": batch / (dev_ms * 1e-3),
        "device_latency_ms": dev_ms,
        "card": card_label(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    row = run(args.batch, args.horizon, args.iters)
    print(row["card"])
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
