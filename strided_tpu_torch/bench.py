"""Benchmark pieces for the ported MPC stack: accuracy lines and speed.

Counterpart of ``bench.py``'s ``bench_mpc_accuracy`` and
``bench_mpc_solves`` (the quadrotor MPC step), and of ``bench_rollouts``,
``bench_ilqr_accuracy`` and ``bench_riccati_accuracy`` (BASELINE configs 2
and 3), at the same sizes and seeds. The accuracy functions run on the card
unless given another device; their oracle is this package's own f64 run on
the CPU (the reference's is JAX's f64 CPU run). The timings need a CUDA
device and refuse to run without one. Times come from CUDA events after a
warm-up: eagerly (inside ``disable_capture()``), through the captured entry
points (``capture.py``: one CUDA-graph replay a call, first held bit for
bit against the eager call), with the first call's time (warm-up, capture,
instantiation), and as device time alone (``graph_ms``: many calls in one
graph). ``rotating_ms`` times an engine call on inputs that rotate through
copies larger than 4x the card's L2, so that no size measures L2-resident
reruns (the benchmark scripts in ``benchmarks/``).

    python -m strided_tpu_torch.bench

runs :func:`main`, the counterpart of ``bench.py::main``: two gates (the
kernels against their plain versions on three cases, :func:`smoke`; the
accuracy of the headline configuration, :func:`mpc_accuracy`), then the
headline, the captured step's solves/s at batch 16384, and diagnostics on
stderr: symmetrize's GB/s three ways at 8192^2 and the flagship at 4000^2,
the bf16 matmul rate, the step's device profile, Riccati and iLQR accuracy
and the rollouts. The last line of stdout is one JSON object
(:func:`headline`). A failed gate raises and prints no headline; a failed
diagnostic is printed and the script exits 1 after the JSON line.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from . import capture as _capture
from .capture import capture, disable_capture
from .entry import make_controller, make_step
from .models import cartpole, double_pendulum, hover_input, hover_state, quadrotor
from .mpc import QuadCost, ilqr, lqr_gains, rollout_final

__all__ = ["mpc_accuracy", "mpc_solves", "step_device_ms", "profile_step", "cuda_ms",
           "graph_ms", "l2_bytes", "rotation_count", "rotated", "rotating_ms", "rate_notes",
           "card_label", "device_profile", "print_profile", "plan_deviation",
           "matches_eager", "cartpole_cost", "rollout_problem", "rollout_times",
           "ilqr_accuracy", "riccati_accuracy", "headline", "smoke", "symmetrize_rates",
           "flagship_rate", "bf16_rate", "main"]

DT = 0.02
ROLLOUT_DT = 0.01  # bench.py::bench_rollouts
CARTPOLE_DT = 0.05  # bench.py::bench_ilqr_accuracy, benchmarks/ilqr_bench.py


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
    (``cuda_ms`` also holds the host's, where the host is the slower). The
    captured entry points inside ``fn`` run as they are, recorded into this
    graph: it holds no input copy and no output clone."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with disable_capture():
        with torch.cuda.stream(side):  # warm-up on a side stream, as capture requires
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):  # as capture.py
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


# NVIDIA H100 SXM data sheet: the L2 size (used where the card does not
# report its own), the HBM3 rate, FP32 off the tensor cores and dense bf16
# on them.
L2_BYTES_ASSUMED = 50 * 1024 * 1024
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# BASELINE.md: the rate the workload asks of the whole system (the
# 12-state, horizon-50 quadrotor MPC), a requirement and no measurement.
BASELINE_SOLVES_PER_S = 10_000


def l2_bytes() -> tuple:
    """``(bytes, how)``: the current card's L2 size as it reports it
    (``"read"``), else the H100 SXM's 50 MB (``"assumed"``)."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    n = int(getattr(props, "L2_cache_size", 0) or 0)
    return (n, "read") if n > 0 else (L2_BYTES_ASSUMED, "assumed")


def rotation_count(copy_bytes: int, l2: int, operands: int = 1) -> int:
    """How many copies of an input of ``copy_bytes`` a rotation needs: their
    sum exceeds 4x the L2 of ``l2`` bytes, so a call never finds its input
    in L2 from an earlier call. At least two calls' worth of copies; a
    multiple of ``operands`` (a call reads that many copies)."""
    m = max(2 * operands, 4 * l2 // max(1, copy_bytes) + 1)
    return -(-m // operands) * operands


def rotated(x: torch.Tensor, l2: int, operands: int = 1) -> list:
    """``x`` and enough clones of it for :func:`rotating_ms`."""
    m = rotation_count(x.numel() * x.element_size(), l2, operands)
    return [x] + [x.clone() for _ in range(m - 1)]


def rotating_ms(fn, inputs, min_calls: int = 20, replays: int = 3, operands: int = 1) -> dict:
    """Milliseconds a call of ``fn`` when each call reads other copies of
    its input than the call before it (``inputs``, from :func:`rotated`):
    call j reads ``inputs[j % m]``, or with ``operands=2`` the pair
    ``inputs[2j % m], inputs[(2j + 1) % m]``. Whole rotations of at least
    ``min_calls`` calls are timed; so no call reads what the one before
    left in L2. Returns ``eager_ms`` (CUDA events around the calls made
    from Python, host included) and ``device_ms`` (the same calls captured
    in one CUDA graph and replayed ``replays`` times, as :func:`graph_ms`
    does; None with ``device_error`` where the call cannot be captured), and
    ``copies``."""
    m = len(inputs)
    per = m // operands
    if per * operands != m or per < 2:
        raise ValueError(f"rotating_ms: {m} inputs for {operands} operand(s) a call")
    args = [tuple(inputs[k * operands:(k + 1) * operands]) for k in range(per)]
    calls = -(-min_calls // per) * per

    def rotation(n):
        for j in range(n):
            fn(*args[j % per])

    rotation(per)  # warm-up: builds, plans and caches
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    rotation(calls)
    end.record()
    torch.cuda.synchronize()
    row = {"eager_ms": start.elapsed_time(end) / calls, "copies": m}
    try:
        row["device_ms"] = graph_ms(lambda: rotation(calls), reps=1, replays=replays) / calls
    except RuntimeError as e:  # a call that reads the host cannot be captured
        row.update(device_ms=None, device_error=f"{type(e).__name__}: {str(e)[:160]}")
    return row


def rate_notes(gbs=None, tflops=None, unrotated_bytes: int = 0, l2: int = L2_BYTES_ASSUMED):
    """The checks a record carries: a rate above the card's peak (3.35 TB/s,
    or 67 TFLOP/s for an FP32 product) is no measurement; an operand that is
    not rotated and fits the L2 may be read from it."""
    notes = []
    if gbs is not None and gbs > HBM_BYTES_PER_S / 1e9:
        notes.append(f"no-measurement: {gbs:.0f} GB/s exceeds the HBM rate "
                     f"({HBM_BYTES_PER_S / 1e9:.0f})")
    if tflops is not None and tflops > FP32_OPS_PER_S / 1e12:
        notes.append(f"no-measurement: {tflops:.1f} TFLOP/s exceeds the FP32 peak "
                     f"({FP32_OPS_PER_S / 1e12:.0f})")
    if 0 < unrotated_bytes < l2:
        notes.append(f"an operand of {unrotated_bytes / 1e6:.1f} MB is not rotated and fits "
                     f"the L2 ({l2 / 1e6:.1f} MB): it may be read from L2")
    return notes


def matches_eager(fn):
    """Call ``fn()`` (whose inputs stay where they are) through its captured
    entry points, then inside ``disable_capture()``, and hold each output
    tensor (``fn`` returns a tensor or a tuple of them) of the one bit for
    bit against the other's; raises if one differs. The captured call comes
    first, so on a new signature it is the entry point's first call.
    Returns ``(outputs, first_ms, capture_ms)``: the captured outputs, the
    host milliseconds of that call to the end of its device work (warm-up,
    capture, instantiation and one replay) and of its capture and
    instantiation alone (``capture.LAST_CAPTURE_MS``)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    captured = fn()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    capture_ms = _capture.LAST_CAPTURE_MS
    with disable_capture():
        eager = fn()
    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
    for i, (c, e) in enumerate(zip(as_tuple(captured), as_tuple(eager))):
        if not torch.equal(c, e):
            diff = (c - e).abs().max().item()
            raise RuntimeError(f"captured output {i} differs from the eager call by {diff:.3e}")
    return captured, first_ms, capture_ms


def mpc_accuracy(device="cuda", batch: int = 64, horizon: int = 50):
    """Accuracy of the headline configuration (ADMM-6, rho=8, f32) against
    the same over-relaxed ADMM run to convergence in f64 numpy on the same
    QP data. Returns ``(dev_first, dev_plan, u_scale)``: worst deviation of
    the first applied input, of the whole horizon plan, and the oracle's
    input magnitude for scale. The gate is first < 1e-4, plan < 0.15. The
    plan runs captured (one CUDA-graph replay) on the card."""
    _model, ctrl = make_controller(horizon=horizon, dt=DT, device=device)
    return plan_deviation(ctrl, batch)


def plan_deviation(ctrl, batch: int = 64):
    """``(dev_first, dev_plan, u_scale)`` of ``ctrl``'s captured plan on
    ``batch`` states from ``default_rng(0)`` (uniform in +-0.3), against
    the same over-relaxed ADMM run 2000 iterations in f64 numpy on the same
    QP data (:func:`mpc_accuracy`'s oracle)."""
    device = ctrl.x_eq.device
    x = np.random.default_rng(0).uniform(-0.3, 0.3, (batch, 12))
    xt = torch.as_tensor(x, dtype=ctrl.x_eq.dtype, device=device)
    U = capture(ctrl.plan)(xt).double().cpu().numpy()  # (batch, N, m)

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
    """The captured closed-loop step on ``batch`` scenarios
    (``entry.make_step``) and a call that advances its own state: returns
    ``(mpc_step, step, state)``, where ``step()`` replaces ``state[0]`` by
    ``mpc_step(state[0])``."""
    model, ctrl = make_controller(horizon=horizon, dt=DT, device=device)
    mpc_step = make_step(model, ctrl, DT)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.3, 0.3, (batch, 12)),
                         dtype=torch.float32, device=device)
    state = [x0]

    def step():
        state[0] = mpc_step(state[0])

    return mpc_step, step, state


def mpc_solves(device="cuda", batch: int = 16384, horizon: int = 50,
               reps: int = 50) -> dict:
    """Time the closed-loop MPC step (solve + RK4) at ``batch`` scenarios on
    the card, captured (``entry.make_step``: one replay a step, its input
    copied in and its output cloned) and eagerly (``disable_capture()``),
    after the captured step's first call (warm-up, capture, instantiation).
    Returns ``captured_ms``, ``captured_solves_per_s``, ``eager_ms``,
    ``eager_solves_per_s`` and ``first_call_ms`` and prints them with the
    card's name and power limit."""
    if torch.device(device).type != "cuda":
        raise RuntimeError(f"mpc_solves times a CUDA device, got {device!r}")
    _mpc_step, step, state = _stepper(device, batch, horizon)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    row = {"first_call_ms": (time.perf_counter() - t0) * 1e3,
           "captured_ms": cuda_ms(step, reps=reps)}
    with disable_capture():
        row["eager_ms"] = cuda_ms(step, reps=reps)
    if not torch.isfinite(state[0]).all():
        raise RuntimeError("mpc_solves: closed loop produced non-finite states")
    for k in ("captured", "eager"):
        row[f"{k}_solves_per_s"] = batch / (row[f"{k}_ms"] * 1e-3)
    print(f"mpc step batch={batch} N={horizon}: captured {row['captured_ms']:.4f} ms/step "
          f"({row['captured_solves_per_s']:.0f} solves/s), eager {row['eager_ms']:.4f} ms/step "
          f"({row['eager_solves_per_s']:.0f} solves/s), first call {row['first_call_ms']:.1f} ms "
          f"[{card_label()}]")
    return row


def step_device_ms(device="cuda", batch: int = 16384, horizon: int = 50,
                   reps: int = 20) -> float:
    """Device milliseconds of the closed-loop step: ``reps`` chained steps
    captured in one CUDA graph and replayed (``graph_ms``), so no host
    dispatch lies between its kernels. First the captured step and the
    eager step are held bit for bit against each other on one state
    (``matches_eager``), else this raises."""
    if torch.device(device).type != "cuda":
        raise RuntimeError(f"step_device_ms times a CUDA device, got {device!r}")
    mpc_step, step, state = _stepper(device, batch, horizon)
    x = state[0].clone()
    matches_eager(lambda: mpc_step(x))
    return graph_ms(step, reps=reps)


def device_profile(fn, calls: int = 1, warmup: int = 3):
    """The device kernels of ``calls`` calls of ``fn()`` under
    ``torch.profiler``, after ``warmup`` calls. Returns ``(device_ms,
    kernels, rows)`` per call: the kernels' summed device time, their
    count, and ``(ms, count, name)`` for each kernel name, by time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = sorted(
        ((e.self_device_time_total / 1e3 / calls, e.count / calls, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        reverse=True,
    )
    return sum(r[0] for r in rows), sum(r[1] for r in rows), rows


def print_profile(what: str, unit: str, wall_ms: float, profiled, top: int = 8) -> float:
    """Print ``device_profile``'s result beside the call's (unprofiled)
    wall time: kernels and device ms per ``unit``, the device's busy share
    of the wall time, and the ``top`` kernels. Returns the busy share."""
    dev_ms, kernels, rows = profiled
    busy = dev_ms / wall_ms
    print(f"profile {what}: {kernels:.0f} device ops/{unit}, {dev_ms:.4f} device ms/{unit} "
          f"of {wall_ms:.4f} ms/{unit}, busy share {busy:.3f} [{card_label()}]")
    for ms, n, name in rows[:top]:
        print(f"  {ms:.4f} ms/{unit}  {n:7.1f}/{unit}  {name[:90]}")
    return busy


def profile_step(device="cuda", batch: int = 16384, horizon: int = 50,
                 steps: int = 20, top: int = 8):
    """Where the step's device time goes: ``torch.profiler`` over ``steps``
    closed-loop steps after a warm-up. Prints device ops and device
    milliseconds per step, the ``top`` kernels by device time, and the
    device's busy share of the (unprofiled, event-timed) step, eagerly and
    captured. Returns ``(device_ms_per_step, device_ops_per_step,
    busy_share)`` of the eager step."""
    row = mpc_solves(device, batch=batch, horizon=horizon)
    _mpc_step, step, _state = _stepper(device, batch, horizon)
    with disable_capture():
        profiled = device_profile(step, calls=steps, warmup=5)
    busy = print_profile(f"batch={batch} N={horizon}, eager", "step", row["eager_ms"],
                         profiled, top)
    print_profile(f"batch={batch} N={horizon}, captured", "step", row["captured_ms"],
                  device_profile(step, calls=steps, warmup=5), top)
    return profiled[0], profiled[1], busy


def cartpole_cost(dtype=torch.float32, device="cuda") -> QuadCost:
    """The swing-up cost of ``bench_ilqr_accuracy`` and ``ilqr_bench``."""
    f = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return QuadCost(
        Q=torch.diag(f([1.0, 10.0, 0.1, 0.1])),
        R=torch.eye(1, dtype=dtype, device=device) * 0.01,
        Qf=torch.diag(f([10.0, 100.0, 1.0, 1.0])),
        x_goal=f([0.0, np.pi, 0.0, 0.0]),
    )


def rollout_problem(device="cuda", batch: int = 4096, T: int = 100, dtype=torch.float32):
    """BASELINE config 2's rollouts (``bench_rollouts``): the double
    pendulum, ``x0`` (batch, 4) at 0.1 rad and inputs (batch, T, 2) at 0.01
    from ``default_rng(2)``. Returns ``(model, x0, us)``."""
    rng = np.random.default_rng(2)
    x0 = torch.as_tensor(rng.standard_normal((batch, 4)) * 0.1, dtype=dtype, device=device)
    us = torch.as_tensor(rng.standard_normal((batch, T, 2)) * 0.01, dtype=dtype, device=device)
    return double_pendulum(), x0, us


def rollout_times(device="cuda", batch: int = 4096, T: int = 100, reps: int = 5) -> dict:
    """Time ``rollout_final`` on BASELINE config 2 on the card: its first
    captured call (held bit for bit against an eager one,
    ``matches_eager``), then captured and eagerly (``cuda_ms``) and as
    device time (``graph_ms``). Returns ``first_call_ms``, ``capture_ms``,
    ``captured_ms``, ``eager_ms`` and ``device_ms`` and prints them with
    dynamics steps/s and the card's name and power limit."""
    if torch.device(device).type != "cuda":
        raise RuntimeError(f"rollout_times times a CUDA device, got {device!r}")
    model, x0, us = rollout_problem(device, batch, T)
    call = lambda: rollout_final(model, x0, us, ROLLOUT_DT)  # noqa: E731
    _, first_ms, capture_ms = matches_eager(call)
    row = {"first_call_ms": first_ms, "capture_ms": capture_ms,
           "captured_ms": cuda_ms(call, reps=reps, warmup=2)}
    with disable_capture():
        row["eager_ms"] = cuda_ms(call, reps=reps, warmup=2)
    row["device_ms"] = graph_ms(call, reps=reps, replays=3)
    rate = lambda k: f"{row[k]:.4f} ms ({batch * T / (row[k] * 1e-3):.6g} steps/s)"  # noqa: E731
    print(f"rollouts batch={batch} T={T}: captured {rate('captured_ms')}, eager "
          f"{rate('eager_ms')}, device {rate('device_ms')}; first call {first_ms:.1f} ms "
          f"(capture and instantiation {capture_ms:.1f}) [{card_label()}]")
    return row


def ilqr_accuracy(device="cuda", T: int = 40, iters: int = 15):
    """Cartpole iLQR in f32 on ``device`` against the same solve in f64 on
    the CPU (``bench_ilqr_accuracy``: x0 = 0, inputs at 0.05 from
    ``default_rng(3)``). Returns ``(max |du|, max |u64|, cost32, cost64)``."""

    def run(dtype, dev):
        x0 = torch.zeros(4, dtype=dtype, device=dev)
        us0 = torch.as_tensor(np.random.default_rng(3).standard_normal((T, 1)) * 0.05,
                              dtype=dtype, device=dev)
        res = ilqr(cartpole(), cartpole_cost(dtype, dev), x0, us0, CARTPOLE_DT, iters=iters)
        return res.us.double().cpu().numpy(), float(res.cost)

    us32, c32 = run(torch.float32, device)
    us64, c64 = run(torch.float64, "cpu")
    return float(np.max(np.abs(us32 - us64))), float(np.max(np.abs(us64))), c32, c64


def riccati_accuracy(device="cuda", N: int = 50):
    """The quadrotor's hover LQR gain K_0 over horizon ``N`` in f32 on
    ``device`` against f64 on the CPU (``bench_riccati_accuracy``). Returns
    ``(max |dK|, max |K64|)``."""

    def run(dtype, dev):
        A, B = quadrotor().linearize(hover_state(dtype, dev),
                                     hover_input(dtype=dtype, device=dev), DT)
        Q = torch.diag(torch.tensor([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], dtype=dtype,
                                    device=dev))
        R = torch.eye(4, dtype=dtype, device=dev) * 0.1
        return lqr_gains(A, B, Q, R, Q, N)[0][0].double().cpu().numpy()

    K32, K64 = run(torch.float32, device), run(torch.float64, "cpu")
    return float(np.max(np.abs(K32 - K64))), float(np.max(np.abs(K64)))


def headline(solves_per_s: float) -> dict:
    """The headline line's object: the captured step's solves/s and its
    ratio to ``BASELINE_SOLVES_PER_S``."""
    return {"metric": "quadrotor MPC solves/s/chip (12-state, N=50, condensed QP, ADMM-6 "
                      "rho=8, f32, batch 16384, captured step)",
            "value": solves_per_s, "unit": "solves/s/chip",
            "vs_baseline": solves_per_s / BASELINE_SOLVES_PER_S}


def _launched(module, call):
    """``(result, launches)``: ``call()``'s result and the launches it added
    to ``module.LAUNCHES``."""
    before = module.LAUNCHES
    out = call()
    torch.cuda.synchronize()
    return out, module.LAUNCHES - before


def smoke(device="cuda") -> list:
    """The kernels against their plain versions on ``bench.py::bench_smoke``'s
    three cases, on the card, the gates lowered: a transpose copy through K4
    (512x384 f32), the int32 initop reduction ``3*old + sum over axis 0``
    through K4 (512x256), and ``symmetrize(b, tile=256)`` through K2 (1024^2
    f32), each exact and each launching its kernel. Returns the cases'
    names; raises on a mismatch or a kernel not launched."""
    from . import config
    from .core import executor_cuda, kernels_special, mapreduce, view
    from .core.regularize import materialize

    old = config.get_config()
    checks = []
    try:
        config.set_config(min_kernel_elements=1024, map_min_elements=1024)
        a = torch.as_tensor(np.random.default_rng(7).standard_normal((512, 384)),
                            dtype=torch.float32, device=device)
        out = view.strided(torch.empty(384, 512, device=device))
        got, n = _launched(executor_cuda, lambda: materialize(
            mapreduce.permutedims_into(out, view.strided(a), (1, 0))))
        if n < 1 or not torch.equal(got, a.T):
            raise RuntimeError(f"smoke: K4 transpose copy launched {n}, equal "
                               f"{torch.equal(got, a.T)}")
        checks.append("scrambled-map")

        rng = np.random.default_rng(8)
        x = torch.as_tensor(rng.integers(-9, 9, (512, 256)), dtype=torch.int32, device=device)
        old_out = torch.as_tensor(rng.integers(-9, 9, (1, 256)), dtype=torch.int32,
                                  device=device)
        config.set_config(kernel_reductions=True)
        ov = view.broadcast_to(view.strided(old_out), (512, 256))
        res, n = _launched(executor_cuda, lambda: mapreduce.mapreducedim_into(
            lambda t: t, torch.add, lambda o: 3 * o, ov, view.strided(x)))
        want = 3 * old_out + x.sum(0, keepdim=True, dtype=torch.int32)
        if n < 1 or not torch.equal(res.parent.reshape(1, 256), want):
            raise RuntimeError(f"smoke: K4 initop reduction launched {n}, mismatch")
        checks.append("initop-reduce")

        b = torch.as_tensor(np.random.default_rng(9).standard_normal((1024, 1024)),
                            dtype=torch.float32, device=device)
        got, n = _launched(kernels_special, lambda: kernels_special.symmetrize(b, tile=256))
        if n != 1 or not torch.equal(got, (b + b.T) * 0.5):
            raise RuntimeError(f"smoke: K2 symmetrize launched {n}, mismatch")
        checks.append("symmetrize")
    finally:
        config.set_config(**{f: getattr(old, f) for f in old.__dataclass_fields__})
    return checks


def _gbs(n: int, ms: float) -> float:
    """Symmetrize's rate: one read and one write of an f32 n x n matrix."""
    return 2 * n * n * 4 / (ms * 1e-3) / 1e9


def symmetrize_rates(device="cuda", n: int = 8192) -> dict:
    """``bench.py::bench_symmetrize_bandwidth`` on the card: GB/s of
    ``symmetrize(x, tile=512)`` (K2 directly), of the flagship expression
    ``(v + transpose(v)) * 0.5`` through the pattern dispatch, and of the
    same expression on the generic engine (``expr_pattern_dispatch`` off),
    each through :func:`rotating_ms` (eager and device). The dispatch of
    each expression is checked."""
    from . import config
    from .api import to_array
    from .core import lazy_expr
    from .core.kernels_special import symmetrize
    from .core.view import strided, transpose

    x = torch.randn(n, n, device=device, generator=torch.Generator(device).manual_seed(1))
    inputs = rotated(x, l2_bytes()[0])

    def engine(t):
        v = strided(t)
        return to_array((v + transpose(v)) * 0.5)

    def timed(fn, route):
        lazy_expr.LAST_EXPR_DISPATCH = ""
        fn(x)
        if route is not None and (lazy_expr.LAST_EXPR_DISPATCH == "pair-kernel") != route:
            raise RuntimeError(f"symmetrize {n}^2: dispatch {lazy_expr.LAST_EXPR_DISPATCH!r}")
        row = rotating_ms(fn, inputs)
        return {"eager_gbs": _gbs(n, row["eager_ms"]), "device_gbs": _gbs(n, row["device_ms"])}

    rates = {"kernel": timed(lambda t: symmetrize(t, tile=512), None),
             "flagship": timed(engine, True)}
    old = config.get_config().expr_pattern_dispatch
    try:
        config.set_config(expr_pattern_dispatch=False)
        rates["generic"] = timed(engine, False)
    finally:
        config.set_config(expr_pattern_dispatch=old)
    return rates


def flagship_rate(device="cuda", n: int = 4000) -> dict:
    """``bench.py::bench_symmetrize_flagship_size`` on the card: at the
    reference's literal 4000^2, ``(v + transpose(v)) / 2`` must dispatch to
    K2 ("pair-kernel") and equal ``(x + x.T) / 2`` bit for bit; then its
    GB/s through :func:`rotating_ms`."""
    from .api import to_array
    from .core import lazy_expr
    from .core.view import strided, transpose

    x = torch.as_tensor(np.random.default_rng(4).standard_normal((n, n)), dtype=torch.float32,
                        device=device)

    def engine(t):
        v = strided(t)
        return to_array((v + transpose(v)) / 2)

    lazy_expr.LAST_EXPR_DISPATCH = ""
    got = engine(x)
    if lazy_expr.LAST_EXPR_DISPATCH != "pair-kernel":
        raise RuntimeError(f"4000^2 flagship took {lazy_expr.LAST_EXPR_DISPATCH!r}, "
                           "not the pair kernel")
    if not torch.equal(got, (x + x.T) / 2):
        raise RuntimeError("4000^2 flagship differs from (x + x.T) / 2")
    row = rotating_ms(engine, rotated(x, l2_bytes()[0]))
    return {"eager_gbs": _gbs(n, row["eager_ms"]), "device_gbs": _gbs(n, row["device_ms"])}


def bf16_rate(device="cuda", d: int = 4096, reps: int = 50) -> dict:
    """``bench.py::bench_bf16_mfu`` on the card: a chain of bf16 products at
    d^3, ``y = (x @ y) * (1/64)``, TFLOP/s (2 d^3 a call) eagerly
    (:func:`cuda_ms`) and as device time (:func:`graph_ms`). ``x`` is 64
    times a random orthogonal matrix (entries about N(0, 1) at d = 4096),
    so the chain keeps ``y``'s scale for any number of calls; the
    reference's ``(x @ x) * (1/64)`` squares its spectrum each call and
    overflows within a few dozen."""
    gen = torch.Generator(device).manual_seed(6)
    q = torch.linalg.qr(torch.randn(d, d, device=device, generator=gen))[0]
    x = (q * 64.0).to(torch.bfloat16)
    state = [torch.randn(d, d, device=device, generator=gen).to(torch.bfloat16)]

    def step():
        state[0] = (x @ state[0]) * (1.0 / 64.0)

    eager = cuda_ms(step, reps=reps)
    dev = graph_ms(step, reps=reps, replays=3)
    if not torch.isfinite(state[0]).all():
        raise RuntimeError("bf16 chain produced non-finite values")
    tf = lambda ms: 2 * d ** 3 / (ms * 1e-3) / 1e12  # noqa: E731
    return {"eager_tflops": tf(eager), "device_tflops": tf(dev)}


def _diagnostics(card: str) -> list:
    """Run each diagnostic, printing its line or its failure (with the
    traceback) on stderr; returns the names of those that failed."""
    failed = []

    def run(name, fn):
        try:
            fn()
        except Exception:  # a failed diagnostic is reported, and the rest still run
            print(f"[bench] diagnostic {name} failed:\n{traceback.format_exc()}", flush=True)
            failed.append(name)

    rates = {}

    def sym():
        r = rates["sym"] = symmetrize_rates()
        print(f"[bench] symmetrize 8192^2 f32, GB/s eager/device: K2 symmetrize(x, tile=512) "
              f"{r['kernel']['eager_gbs']:.1f}/{r['kernel']['device_gbs']:.1f}, flagship "
              f"(v + transpose(v)) * 0.5 via the pattern dispatch "
              f"{r['flagship']['eager_gbs']:.1f}/{r['flagship']['device_gbs']:.1f}, generic "
              f"engine {r['generic']['eager_gbs']:.1f}/{r['generic']['device_gbs']:.1f} [{card}]")

    def flagship():
        r = flagship_rate()
        print(f"[bench] symmetrize at the reference's flagship size 4000^2: pair-kernel, bit "
              f"for bit against (x + x.T) / 2; {r['eager_gbs']:.1f}/{r['device_gbs']:.1f} GB/s "
              f"eager/device [{card}]")

    def bf16():
        r = bf16_rate()
        peak = BF16_TENSOR_OPS_PER_S / 1e12
        print(f"[bench] bf16 matmul 4096^3 chained: {r['eager_tflops']:.1f}/"
              f"{r['device_tflops']:.1f} TFLOP/s eager/device = {r['device_tflops'] / peak:.1%} "
              f"of {peak:.0f} TFLOP/s (H100 SXM data sheet, dense bf16) [{card}]")
        if "sym" in rates:
            gbs = rates["sym"]["flagship"]["device_gbs"]
            print(f"[bench] efficiency: symmetrize flagship {gbs:.0f}/"
                  f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s = {gbs / (HBM_BYTES_PER_S / 1e9):.1%} of "
                  f"HBM3 (data sheet) [{card}]")

    def riccati():
        dK, K = riccati_accuracy("cuda")
        print(f"[bench] Riccati N=50: max |dK| {dK:.3e} (max |K| {K:.4f}), f32 card vs f64 CPU")

    def ilqr_line():
        du, u, c32, c64 = ilqr_accuracy("cuda")
        print(f"[bench] iLQR cartpole T=40: max |du| {du:.3e} (max |u| {u:.4f}), cost "
              f"{c32:.6f} vs {c64:.6f}")

    for name, fn in (("symmetrize", sym), ("flagship", flagship), ("bf16", bf16),
                     ("profile", lambda: profile_step("cuda")), ("riccati", riccati),
                     ("ilqr", ilqr_line), ("rollouts", lambda: rollout_times("cuda"))):
        run(name, fn)
    return failed


def main(argv=None) -> int:
    """Gates, headline, diagnostics (see the module docstring). Everything
    but the last line goes to stderr; returns 1 when a diagnostic failed."""
    if not torch.cuda.is_available():
        raise RuntimeError("strided_tpu_torch.bench measures the card; no CUDA device found")
    card = card_label()
    with contextlib.redirect_stdout(sys.stderr):
        print(f"[bench] {card}")
        print(f"[bench] smoke: ok ({', '.join(smoke())})")
        first, plan, uscale = mpc_accuracy("cuda")
        print(f"[bench] accuracy at the operating point (ADMM-6 rho=8 f32, captured plan, vs "
              f"the f64 oracle, input scale {uscale:.2f}): first {first:.3e} (gate 1e-4), plan "
              f"{plan:.3e} (gate 0.15)")
        if not (first < 1e-4 and plan < 0.15):
            raise RuntimeError(f"accuracy gate failed: first {first:.3e}, plan {plan:.3e}; "
                               "no headline")
        row = mpc_solves("cuda")
        failed = _diagnostics(card)
    print(json.dumps(headline(row["captured_solves_per_s"])), flush=True)
    if failed:
        print(f"[bench] diagnostics failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
