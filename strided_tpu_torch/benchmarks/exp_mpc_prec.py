"""The MPC solver's precision/speed frontier and batch scaling on the card:
the port of ``benchmarks/exp_mpc_prec.py``.

The TPU script's controller (the quadrotor at hover, horizon 50, ADMM-20 at
rho = 1, f32) under each ``Config.matmul_precision``: "highest" (IEEE
FP32), "high" (TF32), "default" (single-pass bf16 products,
``config.matmul``), the TPU's HIGHEST, HIGH and DEFAULT, and the port's own
"medium" (torch's bf16-allowed mode; on cuBLAS f32 products it runs TF32).
For each, with K1 (``fused_admm``) on and off:

- the first-input and plan error of the captured plan at batch 64 against
  the same ADMM run 2000 iterations in f64 (``bench.plan_deviation``, the
  TPU script's oracle), and whether the first input passes 1e-4;
- the closed-loop step's solves/s at batch 32768, captured
  (``entry.make_step``, chained steps, CUDA events).

K1 computes in FP32 FMAs whatever the mode, so with K1 on only the QP's
other products (``g = x0 M^T``, the warm start) follow the precision; with
K1 off the ADMM loop's products follow it too. The reference's fused kernel
hard-codes HIGHEST likewise (``strided_tpu/mpc/qp.py:190``). Then batches
16384 and 65536 at "highest" with K1. Then the reference's coarse frontier
(``admm_coarse_iters``): the first 0, 10, 12, 14 or 16 of the 20 iterations
at "default", the rest at "highest", at batch 16384: the errors, the
captured solves/s and the K1 launches of one eager plan (K1 runs only when
no iteration is coarse).

    python -m strided_tpu_torch.benchmarks.exp_mpc_prec

prints one JSON line a row. It needs a CUDA device.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

__all__ = ["PRECISIONS", "COARSE", "build", "rate", "k1_launches", "run", "main"]

PRECISIONS = ("highest", "high", "default", "medium")
COARSE = (0, 10, 12, 14, 16)  # of 20 iterations, as the reference's frontier
DT = 0.02


def build(device="cuda", admm_iters: int = 20, horizon: int = 50, dtype=torch.float32,
          admm_coarse_iters: int = 0):
    """``(model, ctrl)``: the TPU script's controller."""
    from ..models import hover_input, hover_state, quadrotor
    from ..mpc import make_hover_mpc

    f = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    Q = torch.diag(f([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1]))
    R = torch.eye(4, dtype=dtype, device=device) * 0.1
    model = quadrotor()
    ctrl = make_hover_mpc(model, hover_state(dtype, device),
                          hover_input(dtype=dtype, device=device), Q, R, Q, horizon=horizon,
                          dt=DT, u_min=f([-5.0, -0.5, -0.5, -0.5]),
                          u_max=f([10.0, 0.5, 0.5, 0.5]), admm_iters=admm_iters,
                          admm_coarse_iters=admm_coarse_iters)
    return model, ctrl


def rate(model, ctrl, batch: int, reps: int = 20) -> dict:
    """Solves/s of the captured closed-loop step at ``batch`` states from
    ``default_rng(0)``, chained (each step's output the next one's input)."""
    from ..bench import cuda_ms
    from ..entry import make_step

    mpc_step = make_step(model, ctrl, DT)
    state = [torch.as_tensor(np.random.default_rng(0).uniform(-0.3, 0.3, (batch, 12)),
                             dtype=torch.float32, device="cuda")]

    def step():
        state[0] = mpc_step(state[0])

    ms = cuda_ms(step, reps=reps, warmup=3)
    if not torch.isfinite(state[0]).all():
        raise RuntimeError(f"exp_mpc_prec: non-finite states at batch {batch}")
    return {"step_ms": ms, "solves_per_s": batch / (ms * 1e-3)}


def k1_launches(ctrl, batch: int = 64) -> int:
    """K1's launches in one eager plan of ``batch`` states."""
    from ..capture import disable_capture
    from ..mpc import fused_admm

    x = torch.zeros(batch, 12, dtype=ctrl.x_eq.dtype, device=ctrl.x_eq.device)
    before = fused_admm.LAUNCHES
    with disable_capture():
        ctrl.plan(x)
    torch.cuda.synchronize()
    return fused_admm.LAUNCHES - before


def run(batch: int = 32768) -> list:
    """The frontier, the batch scaling, then the coarse frontier; prints and
    returns the rows."""
    from ..bench import card_label, plan_deviation
    from ..config import get_config, set_config

    if not torch.cuda.is_available():
        raise RuntimeError("exp_mpc_prec measures the card; no CUDA device found")
    card = card_label()
    old = get_config()
    rows = []
    try:
        for prec in PRECISIONS:
            for k1 in (True, False):
                set_config(matmul_precision=prec, fused_admm=k1)
                model, ctrl = build()
                first, plan, _ = plan_deviation(ctrl)
                rows.append({"precision": prec, "fused_admm": k1, "first_input_dev": first,
                             "plan_dev": plan, "passes_gate_1e-4": first <= 1e-4,
                             "batch": batch, **rate(model, ctrl, batch), "card": card})
                print(json.dumps(rows[-1]), flush=True)
        set_config(matmul_precision="highest", fused_admm=True)
        for b in (16384, 65536):
            model, ctrl = build()
            rows.append({"precision": "highest", "fused_admm": True, "batch": b,
                         **rate(model, ctrl, b), "card": card})
            print(json.dumps(rows[-1]), flush=True)
        for coarse in COARSE:
            model, ctrl = build(admm_coarse_iters=coarse)
            first, plan, _ = plan_deviation(ctrl)
            rows.append({"precision": "highest", "coarse_iters": coarse, "iters": 20,
                         "first_input_dev": first, "plan_dev": plan,
                         "passes_gate_1e-4": first <= 1e-4, "k1_launches": k1_launches(ctrl),
                         "batch": 16384, **rate(model, ctrl, 16384), "card": card})
            print(json.dumps(rows[-1]), flush=True)
    finally:
        set_config(matmul_precision=old.matmul_precision, fused_admm=old.fused_admm)
    return rows


def main(argv=None) -> int:
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
