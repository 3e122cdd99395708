"""Benchmark pieces for the ported MPC step: accuracy gate and solves/s.

Counterpart of ``bench.py``'s ``bench_mpc_accuracy`` and
``bench_mpc_solves``. The accuracy gate runs anywhere; the timings need a
CUDA device and refuse to run without one. Times come from CUDA events after
a warm-up.

    python -m strided_tpu_torch.bench      # gate, solves/s, device profile
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from .entry import make_controller

__all__ = ["mpc_accuracy", "mpc_solves", "step_device_ms", "profile_step", "cuda_ms",
           "card_label"]

DT = 0.02


def card_label() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn()`` on the current CUDA stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds per call of ``fn()``: ``reps`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events. No
    host work lies between the kernels, so this is the device's time alone
    (``cuda_ms`` also holds the host's, where the host is the slower)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream, as capture requires
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def mpc_accuracy(device="cuda", batch: int = 64, horizon: int = 50):
    """Accuracy of the headline configuration (ADMM-6, rho=8, f32) against
    the same over-relaxed ADMM run to convergence in f64 numpy on the same
    QP data. Returns ``(dev_first, dev_plan, u_scale)``: worst deviation of
    the first applied input, of the whole horizon plan, and the oracle's
    input magnitude for scale. The gate is first < 1e-4, plan < 0.15."""
    _model, ctrl = make_controller(horizon=horizon, dt=DT, device=device)
    x = np.random.default_rng(0).uniform(-0.3, 0.3, (batch, 12))
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    U = ctrl.plan(xt).double().cpu().numpy()  # (batch, N, m)

    f64 = lambda t: t.double().cpu().numpy()
    qp = ctrl.qp
    dx = f64(xt) - f64(ctrl.x_eq)
    H, Mm, K = f64(qp.H), f64(qp.M), f64(qp.K_lqr)
    rho, alpha = qp.rho, 1.6
    Hinv = np.linalg.inv(H + rho * np.eye(H.shape[0]))
    lo = np.tile(f64(ctrl.u_min), qp.N)
    hi = np.tile(f64(ctrl.u_max), qp.N)
    g = dx @ Mm.T
    z = np.clip(-dx @ K.T, lo, hi)
    y = np.zeros_like(z)
    for _ in range(2000):
        u = (rho * (z - y) - g) @ Hinv
        u_rel = alpha * u + (1 - alpha) * z
        z = np.clip(u_rel + y, lo, hi)
        y = y + u_rel - z
    U_star = z.reshape(batch, qp.N, qp.m)
    dev_first = float(np.max(np.abs(U[:, 0] - U_star[:, 0])))
    dev_plan = float(np.max(np.abs(U - U_star)))
    return dev_first, dev_plan, float(np.max(np.abs(U_star)))


def _stepper(device, batch: int, horizon: int):
    """A closed-loop step on ``batch`` scenarios that advances its own state:
    returns ``(step, state)``, where ``step()`` replaces ``state[0]``."""
    model, ctrl = make_controller(horizon=horizon, dt=DT, device=device)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.3, 0.3, (batch, 12)),
                         dtype=torch.float32, device=device)
    state = [x0]

    def step():
        x = state[0]
        state[0] = model.step(x, ctrl.control(x)[0], DT)

    return step, state


def mpc_solves(device="cuda", batch: int = 16384, horizon: int = 50,
               reps: int = 50):
    """Time the closed-loop MPC step (solve + RK4) at ``batch`` scenarios on
    the card. Returns ``(ms_per_step, solves_per_s)`` and prints both with
    the card's name and power limit."""
    if torch.device(device).type != "cuda":
        raise RuntimeError(f"mpc_solves times a CUDA device, got {device!r}")
    step, state = _stepper(device, batch, horizon)
    ms = cuda_ms(step, reps=reps)
    if not torch.isfinite(state[0]).all():
        raise RuntimeError("mpc_solves: closed loop produced non-finite states")
    solves = batch / (ms * 1e-3)
    print(f"mpc step batch={batch} N={horizon}: {ms:.4f} ms/step, "
          f"{solves:.0f} solves/s [{card_label()}]")
    return ms, solves


def step_device_ms(device="cuda", batch: int = 16384, horizon: int = 50,
                   reps: int = 20) -> float:
    """Device milliseconds of the closed-loop step: ``reps`` chained steps
    captured in one CUDA graph and replayed (``graph_ms``), so no host
    dispatch lies between its kernels. First one captured step is replayed
    on a state and held against the eager step on the same state: they must
    agree bit for bit, else this raises. The entry points stay eager."""
    if torch.device(device).type != "cuda":
        raise RuntimeError(f"step_device_ms times a CUDA device, got {device!r}")
    step, state = _stepper(device, batch, horizon)
    x = state[0].clone()
    step()  # warm-up: caches, cuBLAS handles
    state[0] = x.clone()
    step()
    eager = state[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        state[0] = x.clone()
        step()
    torch.cuda.current_stream().wait_stream(side)
    static = x.clone()
    state[0] = static
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    captured = state[0]
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(captured, eager):
        diff = (captured - eager).abs().max().item()
        raise RuntimeError(f"captured step differs from the eager step by {diff:.3e}")
    state[0] = x.clone()
    return graph_ms(step, reps=reps)


def profile_step(device="cuda", batch: int = 16384, horizon: int = 50,
                 steps: int = 20, top: int = 8):
    """Where the step's device time goes: ``torch.profiler`` over ``steps``
    closed-loop steps after a warm-up. Prints device ops and device
    milliseconds per step, the ``top`` kernels by device time, and the
    device's busy share of the (unprofiled, event-timed) step. Returns
    ``(device_ms_per_step, device_ops_per_step, busy_share)``."""
    from torch.profiler import ProfilerActivity, profile

    ms_step, _ = mpc_solves(device, batch=batch, horizon=horizon)
    step, _state = _stepper(device, batch, horizon)
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = sorted(
        ((e.self_device_time_total / 1e3 / steps, e.count / steps, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        reverse=True,
    )
    dev_ms = sum(r[0] for r in rows)
    ops = sum(r[1] for r in rows)
    busy = dev_ms / ms_step
    print(f"profile batch={batch} N={horizon}: {ops:.0f} device ops/step, "
          f"{dev_ms:.4f} device ms/step of {ms_step:.4f} ms/step, "
          f"busy share {busy:.3f} [{card_label()}]")
    for ms, n, name in rows[:top]:
        print(f"  {ms:.4f} ms/step  {n:5.1f}/step  {name[:90]}")
    return dev_ms, ops, busy


if __name__ == "__main__":
    first, plan, _ = mpc_accuracy("cuda")
    print(f"accuracy gate: first {first:.3e} (< 1e-4), plan {plan:.3e} (< 0.15)")
    if not (first < 1e-4 and plan < 0.15):
        raise SystemExit("accuracy gate failed")
    profile_step("cuda")
