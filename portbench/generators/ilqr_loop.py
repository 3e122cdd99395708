"""A closed loop over a fleet under nonlinear MPC: the port's captured
receding-horizon iLQR step, one control period at a time, with the host
between periods.

Each period the host hands the fleet's states to ``entry.make_ilqr_step``'s
captured step (the previous plan shifted by one stage, one iLQR iteration
from the state, the first input, the RK4 plant step) with the plan the
last period returned, and reads back the next states. The plan stays on
the card from period to period; only states cross. The next period's
states are those plus a gust from ``mpc_loop``'s seeded bank, cycled, so
the host's own work a period is two copies and one add, as in
``mpc_loop``. A period's latency runs from the host handing its states
over to the host holding the answer.

The controller counts, on the card inside the graph, the quadrotors whose
line-search step was taken; the count is read once, after the window, and
its share goes into the notes (and a traced run's ``trace.extra``).

Correctness: after the window, for a sample of periods drawn from the seed
(and the last one), the state, the plan handed in, the next state and the
plan handed back are held against the f64 reference
(``reference/quadrotor_ilqr.py``), which runs the same iterations from the
same state and plan and steps the plant with its own first input. Two
readings are ``mpc_loop``'s: the widest gap of the next states, and the
input gap the next velocities and body rates imply (``input_scale``). The
third, ``plan_gap``, is the widest gap (N, N m) between the plan handed
back, which the next period starts from, and the reference's new plan at
every stage. Where the reference's line-search choice is a tie that f32
cannot resolve (the reference module's tie rule), the gaps are taken to
the admitted outcome nearest by input gap, and the count of such
quadrotors goes into the notes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# the parent commit has no iLQR step: the run fails here, at once
from strided_tpu_torch.entry import make_ilqr_controller, make_ilqr_step

from ..common import Outcome, Profiler, Span, per_second, percentile, steady
from ..reference.quadrotor_ilqr import QuadrotorILQR
from ..reference.quadrotor_mpc import blocks
from .mpc_loop import WARMUP_PERIODS, sample_periods, states

# quadrotors the reference takes at once in the check
CHECK_ROWS = 1024


def run(cell, seed: int, seconds: float, trace: bool, read_layers=None,
        device="cuda") -> Outcome:
    from strided_tpu_torch.config import set_config

    cfg, tr = cell.config, cell.traffic
    c = cfg["controller"]
    cuda = torch.device(device).type == "cuda"
    set_config(matmul_precision=cfg["matmul_precision"])
    dt = float(cfg["dt"])
    t_set = [time.perf_counter()]
    model, ctrl = make_ilqr_controller(int(c["horizon"]), dt, device, iters=int(c["iters"]),
                                       alphas=tuple(c["alphas"]), mu=float(c["mu"]))
    step = make_ilqr_step(model, ctrl, dt)
    t_set.append(time.perf_counter())

    x0, bank_np = states(tr, seed)
    B = x0.shape[0]
    pin = dict(pin_memory=True) if cuda else {}
    x_host = torch.empty(x0.shape, dtype=torch.float32, **pin)
    x_host.copy_(torch.from_numpy(x0))
    out_host = torch.empty_like(x_host, **pin)
    x_np, out_np = x_host.numpy(), out_host.numpy()
    plan0 = ctrl.initial_plan((B,))
    plan = plan0
    samples = sample_periods(tr, seed)
    kept = {}
    span = Span()
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def period():
        """One period; returns the plan it was handed (the plan it handed
        back is ``plan``)."""
        nonlocal plan
        with span("h2d"):
            xd = x_host.to(device, non_blocking=True)
        with span("step"):
            xn, plan_next = step(xd, plan)
        with span("d2h"):
            out_host.copy_(xn)
        plan_in, plan = plan, plan_next
        return plan_in

    def advance(k):
        with span("gust"):
            np.add(out_np, bank_np[k % len(bank_np)], out=x_np)

    for k in range(WARMUP_PERIODS):  # the capture, and steady clocks
        period()
        advance(k)
    x_host.copy_(torch.from_numpy(x0))
    plan = plan0
    ctrl.accepted.zero_()
    sync()
    steady()
    t_set.append(time.perf_counter())

    lat, ends, k = [], [], 0
    window_open = time.time()
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        plan_in = period()
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        ends.append(t1)
        last = t1 - t_start >= seconds
        if k in samples or last:
            kept[k] = (x_host.clone(), plan_in, out_host.clone(), plan)
        advance(k)
        k += 1
        if last:
            break
    window = time.perf_counter() - t_start
    accepted = int(ctrl.accepted) / (B * ctrl.iters * k)  # the one read of the counter
    metrics = {"solves_per_s": B * k / window, "latency_p95_ms": percentile(lat, 95) * 1e3}
    notes = [f"window {window:.3f} s, {k} periods of {B}, latency median "
             f"{percentile(lat, 50) * 1e3:.4f} ms (the period's budget: {dt * 1e3:g} ms)",
             f"periods a second: {per_second(ends, t_start, window)}",
             f"line-search steps taken: {100.0 * accepted:.4f}% of quadrotor iterations",
             f"set-up: controller {t_set[1] - t_set[0]:.3f} s, inputs, capture and "
             f"warm-up {t_set[2] - t_set[1]:.3f} s"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    out = Outcome(metrics, {}, k, 0, peak, window_open, notes=notes)
    if trace:  # after the window: the same periods, profiled
        prof = Profiler()
        prof.start()
        span.on = True
        n = int(tr["profile_periods"])
        for j in range(k, k + n):
            period()
            advance(j)
        span.on = False
        out.trace = prof.stop(n, extra={"accepted_share": accepted})
        out.layers = read_layers(out.trace) if read_layers else {}
        out.notes.append(f"device operations a period in the profiled tail: "
                         f"{len(out.trace.device_ops) / n:.1f}")
    del step, ctrl, model, plan, plan0
    if cuda:
        torch.cuda.empty_cache()
    out.checks, out.failed, tied = check(cfg, kept, device)
    out.notes.append(f"quadrotors whose line-search choice is a tie f32 cannot resolve: "
                     f"{tied} of {B * len(kept)} checked")
    return out


def check(cfg: dict, kept: dict, device) -> tuple:
    """``({"next_state_gap": widest gap, "input_gap": widest implied input
    gap, "plan_gap": widest gap of the plan handed back}, periods whose
    next states or plans are not finite, quadrotors under the tie rule)``
    over the kept periods, each against the f64 reference; a quadrotor's
    gaps are to its admitted outcome nearest by input gap."""
    ref = QuadrotorILQR(cfg, device=device)
    scale = ref.plant.input_scale()
    state, inp, whole, bad, tied = 0.0, 0.0, 0.0, 0, 0
    for x, plan, xn, plan_next in kept.values():
        if not all(torch.isfinite(t).all() for t in (xn, plan, plan_next)):
            bad += 1
            state = inp = whole = float("inf")
            continue
        for rows in blocks(x.shape[0], CHECK_ROWS):
            xr = x[rows].to(device, torch.float64)
            plans, _own, admitted, tie = ref.outcomes(xr, plan[rows].to(device))
            d = (xn[rows].to(device, torch.float64) - ref.next_states(xr, plans[..., 0, :])).abs()
            gap_in = torch.where(admitted, (d * scale).amax(-1), torch.inf)
            near = gap_in.argmin(0, keepdim=True)
            gap_plan = (plan_next[rows].to(device, torch.float64) - plans).abs().amax((-2, -1))
            state = max(state, float(d.amax(-1).gather(0, near).max()))
            inp = max(inp, float(gap_in.gather(0, near).max()))
            whole = max(whole, float(gap_plan.gather(0, near).max()))
            tied += int(tie.sum())
    return {"next_state_gap": state, "input_gap": inp, "plan_gap": whole}, bad, tied
