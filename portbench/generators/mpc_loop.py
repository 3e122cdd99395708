"""A closed loop over a fleet: the port's captured MPC step, one control
period at a time, with the host between periods.

Each period the host hands the fleet's states to ``entry.make_step``'s
captured step (the condensed-QP solve, the first input, the RK4 plant
step) and reads back the next states. The next period's states are those
plus a gust from a bank drawn from the seed in set-up and cycled, so the
host's own work a period is two copies and one add. A period's latency
runs from the host handing its states over to the host holding the
answer; the next period starts then.

Correctness: after the window, a sample of periods drawn from the seed
(and the last one) is held against the f64 reference
(``reference/quadrotor_mpc.py``): its own controller's first input on the
same states, then its own RK4 step. Two readings: the widest gap between
the port's next states and the reference's, and the input gap that the
next velocities and body rates imply (each state's gap over its
sensitivity to the input, ``QuadrotorMPC.input_scale``), in newtons and
newton metres: an input error on the thrust moves a velocity only by
``dt / m``, which the first reading alone would not see.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..common import Outcome, Profiler, Span, per_second, percentile, steady
from ..reference.quadrotor_mpc import QuadrotorMPC, blocks

WARMUP_PERIODS = 20


def states(traffic: dict, seed: int):
    """The fleet's first states and the gust bank, from ``seed``: every
    seed gives the same sizes, other values. Each quadrotor's gusts sum to
    zero over the bank, so that cycling it pushes no one steadily away
    (a steady push beyond the thrust bound would carry a quadrotor off
    for good)."""
    rng = np.random.default_rng(seed)
    B, G = int(traffic["batch"]), int(traffic["gust_bank"])
    x0 = rng.uniform(-traffic["initial"], traffic["initial"], (B, 12)).astype(np.float32)
    bank = np.zeros((G, B, 12), np.float32)
    bank[:, :, 3:6] = rng.uniform(-traffic["gust_velocity"], traffic["gust_velocity"], (G, B, 3))
    bank[:, :, 9:12] = rng.uniform(-traffic["gust_rate"], traffic["gust_rate"], (G, B, 3))
    return x0, bank - bank.mean(axis=0, keepdims=True)


def sample_periods(traffic: dict, seed: int) -> set:
    """Periods held against the reference, drawn from ``seed`` among the
    first ``sample_span`` (every window holds more); the last one is added
    when the window closes."""
    rng = np.random.default_rng([seed, 1])
    return set(rng.choice(int(traffic["sample_span"]), int(traffic["samples"]),
                          replace=False).tolist())


def run(cell, seed: int, seconds: float, trace: bool, read_layers=None,
        device="cuda") -> Outcome:
    from strided_tpu_torch import entry
    from strided_tpu_torch.config import set_config

    cfg, tr = cell.config, cell.traffic
    c = cfg["controller"]
    cuda = torch.device(device).type == "cuda"
    set_config(matmul_precision=cfg["matmul_precision"])
    dt = float(cfg["dt"])
    t_set = [time.perf_counter()]
    model, ctrl = entry.make_controller(horizon=int(c["horizon"]), dt=dt, device=device)
    step = entry.make_step(model, ctrl, dt)
    t_set.append(time.perf_counter())

    x0, bank_np = states(tr, seed)
    pin = dict(pin_memory=True) if cuda else {}
    x_host = torch.empty(x0.shape, dtype=torch.float32, **pin)
    x_host.copy_(torch.from_numpy(x0))
    out_host = torch.empty_like(x_host, **pin)
    x_np, out_np = x_host.numpy(), out_host.numpy()
    samples = sample_periods(tr, seed)
    kept = {}
    span = Span()
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def period():
        with span("h2d"):
            xd = x_host.to(device, non_blocking=True)
        with span("step"):
            xn = step(xd)
        with span("d2h"):
            out_host.copy_(xn)
        return xd

    def advance(k):
        with span("gust"):
            np.add(out_np, bank_np[k % len(bank_np)], out=x_np)

    for k in range(WARMUP_PERIODS):  # the capture, and steady clocks
        period()
        advance(k)
    x_host.copy_(torch.from_numpy(x0))
    sync()
    steady()
    t_set.append(time.perf_counter())

    lat, ends, k = [], [], 0
    window_open = time.time()
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        xd = period()
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        ends.append(t1)
        last = t1 - t_start >= seconds
        if k in samples or last:
            kept[k] = (x_host.clone(), out_host.clone())
        advance(k)
        k += 1
        if last:
            break
    window = time.perf_counter() - t_start
    B = x0.shape[0]
    metrics = {"solves_per_s": B * k / window, "latency_p95_ms": percentile(lat, 95) * 1e3}
    notes = [f"window {window:.3f} s, {k} periods of {B}, latency median "
             f"{percentile(lat, 50) * 1e3:.4f} ms",
             f"periods a second: {per_second(ends, t_start, window)}",
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
            xd = period()
            advance(j)
        span.on = False
        out.trace = prof.stop(n)
        out.trace.extra["qp"] = dict(qp=ctrl.qp, dx=xd - ctrl.x_eq, u_min=ctrl.u_min,
                                     u_max=ctrl.u_max, iters=ctrl.admm_iters)
        out.layers = read_layers(out.trace) if read_layers else {}
        out.trace.extra.clear()
    del step, ctrl, model, xd
    if cuda:
        torch.cuda.empty_cache()
    out.checks, out.failed = check(cfg, kept, device)
    return out


def check(cfg: dict, kept: dict, device) -> tuple:
    """``({"next_state_gap": widest gap, "input_gap": widest implied input
    gap}, periods whose states are not finite)`` over the kept periods,
    each against the f64 reference."""
    ref = QuadrotorMPC(cfg, device=device)
    scale = ref.input_scale()
    state, inp, bad = 0.0, 0.0, 0
    for x, xn in kept.values():
        if not torch.isfinite(xn).all():
            bad += 1
            state = inp = float("inf")
            continue
        for rows in blocks(x.shape[0], 8192):
            xr = x[rows].to(device, torch.float64)
            d = (xn[rows].to(device, torch.float64) - ref.step(xr, ref.first_input(xr))).abs()
            state = max(state, float(d.max()))
            inp = max(inp, float((d * scale).max()))
    return {"next_state_gap": state, "input_gap": inp}, bad
