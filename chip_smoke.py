"""Smoke test of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main path, one closed-loop step of the scenario-batched
12-state quadrotor MPC per control period, on the card at the headline size
(horizon 50, D = N*m = 200, ADMM-6 at rho=8, f32, batch 16384). Phases:

1. device: a CUDA device is required; prints its name and power limit;
2. build: compiles the CUDA sources (strided_tpu_torch/csrc) with nvcc;
3. kernel vs plain: the fused-ADMM kernel against its plain PyTorch version
   on the same inputs (main-path QP at B in {16384, 33, 31, 1}; random QPs
   at D=12 and D=400), and both against the same iterations in f64;
4. accuracy gate: first applied input within 1e-4 and horizon plan within
   0.15 of a converged f64 ADMM oracle, through the kernel path;
5. main path: a 50-step closed loop at batch 16384 through
   ``strided_tpu_torch.entry.make_controller``; it must launch the kernel once
   per step, stay finite, shrink the state, and agree with the plain path;
6. times (CUDA events after warm-up): the step, the kernel and its plain
   version.

Any failure raises, so the exit code is non-zero. The last two lines are a
JSON object describing the kernels, then ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

ATOL_KERNEL = 2e-4  # f32 summation order differs from cuBLAS; |g| reaches ~1.4e3
ATOL_LOOP = 1e-3  # closed-loop states, kernel vs plain path, 50 steps (f32)


def _admm_inputs(ctrl, x):
    qp = ctrl.qp
    lo, hi = ctrl.u_min.repeat(qp.N), ctrl.u_max.repeat(qp.N)
    g = x @ qp.M.T
    z0 = torch.minimum(torch.maximum(-x @ qp.K_lqr.T, lo), hi)
    return g, z0, qp.solver, lo, hi


def _random_inputs(rng, B, D, device):
    """A random QP with the main path's structure: S = (H + rho I)^-1 of a
    random SPD H, bounds of +-1, |g| up to ~30."""
    G = rng.standard_normal((D, D))
    S = np.linalg.inv(G @ G.T / D + 8.0 * np.eye(D))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    g = f32(10.0 * rng.standard_normal((B, D)))
    lo, hi = f32(-np.ones(D)), f32(np.ones(D))
    return g, torch.zeros_like(g), f32(S), lo, hi


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs on the GPU only")

    from strided_tpu_torch import _build, closed_loop, config
    from strided_tpu_torch.bench import card_label, cuda_ms, mpc_accuracy, mpc_solves
    from strided_tpu_torch.entry import make_controller
    from strided_tpu_torch.mpc import fused_admm as fa  # the module

    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    card = card_label()
    print(f"[1 device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card)

    t = time.perf_counter()
    _build.load_library()
    print(f"[2 build] nvcc sm_90a: {time.perf_counter() - t:.1f} s")

    rho, alpha, iters = 8.0, 1.6, 6
    _model, ctrl = make_controller(horizon=50, dt=0.02, device=dev)

    @config.matmul_precision_scope
    def check(g, z0, S, lo, hi):
        before = fa.LAUNCHES
        k = fa.fused_admm(g, z0, S, lo, hi, rho=rho, alpha=alpha, iters=iters)
        torch.cuda.synchronize()
        if fa.LAUNCHES != before + 1:
            raise RuntimeError("fused_admm did not count its launch")
        p = fa.fused_admm_reference(g, z0, S, lo, hi, rho=rho, alpha=alpha, iters=iters)
        r = fa.fused_admm_reference(*(a.double() for a in (g, z0, S, lo, hi)),
                                    rho=rho, alpha=alpha, iters=iters)
        e_kp = (k - p).abs().max().item()
        e_k64 = (k.double() - r).abs().max().item()
        e_p64 = (p.double() - r).abs().max().item()
        B, D = g.shape
        print(f"[3 kernel] B={B} D={D}: |kernel-plain| {e_kp:.3e}, "
              f"|kernel-f64| {e_k64:.3e}, |plain-f64| {e_p64:.3e}")
        if not torch.isfinite(k).all():
            raise RuntimeError(f"fused_admm: non-finite output at B={B}, D={D}")
        if not e_kp <= ATOL_KERNEL:
            raise RuntimeError(f"fused_admm disagrees with plain: {e_kp:.3e} > {ATOL_KERNEL}")
        if not e_k64 <= 2 * e_p64 + 1e-6:
            raise RuntimeError(
                f"fused_admm less accurate than FP32 allows: |kernel-f64| {e_k64:.3e} "
                f"> 2 * |plain-f64| {e_p64:.3e} + 1e-6 (reduced-precision products?)"
            )
        return e_kp

    rng = np.random.default_rng(0)
    max_err = 0.0
    for B in (16384, 33, 31, 1):
        x = torch.as_tensor(rng.uniform(-0.3, 0.3, (B, 12)), dtype=torch.float32,
                            device=dev)
        max_err = max(max_err, check(*_admm_inputs(ctrl, x)))
    for B, D in ((33, 12), (33, 400)):
        check(*_random_inputs(rng, B, D, dev))

    first, plan, uscale = mpc_accuracy(dev, batch=64)
    print(f"[4 gate] first input {first:.3e} (< 1e-4), plan {plan:.3e} (< 0.15), "
          f"input scale {uscale:.3f}")
    if not (first < 1e-4 and plan < 0.15):
        raise RuntimeError("accuracy gate failed on the card")

    batch, steps, dt = 16384, 50, 0.02
    model, ctrl = make_controller(horizon=50, dt=dt, device=dev)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.3, 0.3, (batch, 12)),
                         dtype=torch.float32, device=dev)
    fa.LAUNCHES = 0
    xs, us = closed_loop(ctrl, model, x0, steps, dt)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES
    n0 = xs[:, 0].norm(dim=-1).mean().item()
    n1 = xs[:, -1].norm(dim=-1).mean().item()
    print(f"[5 main path] closed loop batch={batch} steps={steps}: "
          f"{launches} kernel launches, mean |x| {n0:.4f} -> {n1:.4f}")
    if launches != steps:
        raise RuntimeError(f"expected {steps} kernel launches, counted {launches}")
    if tuple(xs.shape) != (batch, steps + 1, 12) or tuple(us.shape) != (batch, steps, 4):
        raise RuntimeError(f"closed loop shapes {tuple(xs.shape)}, {tuple(us.shape)}")
    if not (torch.isfinite(xs).all() and torch.isfinite(us).all()):
        raise RuntimeError("closed loop produced non-finite values")
    if not n1 < n0:
        raise RuntimeError("closed loop did not regulate the state toward hover")
    config.set_config(fused_admm=False)
    try:
        xs_p, _ = closed_loop(ctrl, model, x0[:64], steps, dt)
    finally:
        config.set_config(fused_admm=True)
    e_loop = (xs[:64] - xs_p).abs().max().item()
    print(f"[5 main path] first 64 scenarios vs plain loop path: max |dx| {e_loop:.3e}")
    if not e_loop <= ATOL_LOOP:
        raise RuntimeError(f"closed loop off the plain path by {e_loop:.3e} > {ATOL_LOOP}")

    def step_ms(fused: bool) -> float:
        config.set_config(fused_admm=fused)
        try:
            return mpc_solves(dev, batch=batch)[0]
        finally:
            config.set_config(fused_admm=True)

    # in turns (kernel, plain, plain, kernel) so drift hits both sides alike
    s_k1, s_p1, s_p2, s_k2 = step_ms(True), step_ms(False), step_ms(False), step_ms(True)
    print(f"[6 times] step batch={batch}: kernel path {s_k1:.4f}/{s_k2:.4f} ms "
          f"({batch / (min(s_k1, s_k2) * 1e-3):.0f} solves/s), plain ADMM loop "
          f"{s_p1:.4f}/{s_p2:.4f} ms ({batch / (min(s_p1, s_p2) * 1e-3):.0f} solves/s) [{card}]")
    x = torch.as_tensor(rng.uniform(-0.3, 0.3, (batch, 12)), dtype=torch.float32, device=dev)
    args = _admm_inputs(ctrl, x)
    kw = dict(rho=rho, alpha=alpha, iters=iters)
    timed = config.matmul_precision_scope(cuda_ms)
    kernel = lambda: fa.fused_admm(*args, **kw)
    plain = lambda: fa.fused_admm_reference(*args, **kw)
    ms_k, ms_p, ms_p2, ms_k2 = (timed(f, reps=100) for f in (kernel, plain, plain, kernel))
    print(f"[6 times] fused_admm B={batch} D=200 iters=6: kernel {ms_k:.4f}/{ms_k2:.4f} ms, "
          f"plain {ms_p:.4f}/{ms_p2:.4f} ms [{card}]")

    print(json.dumps({"kernels": [{
        "name": "fused_admm",
        "route": "cuda",
        "source": "strided_tpu_torch/csrc/fused_admm.cu",
        "replaces": "strided_tpu/mpc/qp.py:157",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": min(ms_k, ms_k2),
        "plain_ms": min(ms_p, ms_p2),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
