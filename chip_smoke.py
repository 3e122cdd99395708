"""Card checks of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA sources on the card and holds every kernel and every
captured entry point there against its plain version. The card has no JAX,
so these checks are the port's correctness net on it. The rule: this file
holds card checks only; a kernel's time belongs in its script under
``strided_tpu_torch/benchmarks/`` or in the benchmark (``portbench/``).
Phases (numbers are cited by the tests, README, PERF.md and ROADMAP.md):

1. device: a CUDA device is required; prints its name and power limit.
2. build: nvcc for sm_90a; from ptxas's report, K1's main-path instance,
   the 14 K3 program kernels, K4's two ``tile_box_v`` and six
   ``tile_stream_v`` (registers 2-4, with and without exp and sin), every ``rev4_tiles``
   and ``pair_tiles`` instance, the plant kernel's and the plant Jacobian
   kernel's f32 and f64 instances built without spills; every ``rev4_mma``
   instance built.
3. K1 against its plain version, within 2e-4 and no further from the f64
   iterations than twice the plain version plus 1e-6: the main-path QP at
   B = 16384, 64 * #SMs +- 1, 65, 63, 33, 31, 1; random QPs at D = 1, 12,
   199, 201, 208, 209, 300, 400, 512 and with z0 outside the bounds; K1's
   tile designs (``benchmarks/exp_admm.py``) on the main-path QP at 16384.
4. accuracy gate: the captured plan (one replay) at batch 64, first input
   within 1e-4 and plan within 0.15 of the converged f64 ADMM oracle.
5. main path: the 50-step closed loop at batch 16384 captured (one graph)
   equal to the eager loop bit for bit; K1 and the plant kernel launched 50
   times eagerly and run 50 times in a profiled replay; finite, regulating,
   within 1e-3 of the plain path, whose config takes its own capture; a
   captured host read raises and leaves no entry.
6. the captured step (``entry.make_step``, batch 16384) with K1 on and
   off: its first call equal to the eager step bit for bit, 111 chained
   steps finite.
7. wide QP: ``qp_solve`` at D = 600 (above ``MAX_D``) takes the loop path,
   equal to it, finite.
8. the engine's main path at full size through its entry points: K2 on the
   flagship family (4000^2-8192^2, bf16, ragged), K3 on sums, max and
   ``smean`` at 8192^2, K4 on ``permutedims_into``, ``smap``, the README
   broadcast (f32 and bf16, streamed, bit for bit eager PyTorch) and an int32
   initop reduction; dispatch records, K3 and K4 paths and launches; then every
   program op, per-element maps and reductions through K4, every fold and
   program kernel of K3 on aligned, ragged and unaligned rows, and K4's
   multi-axis map (``multi_axis_checks``), each against its plain version
   (exact, except float sums: 1e-6 * rows * max|f(a)|).
9. off phase 8's cases at 8192^2: K3's folds, programs, instruction ladder
   and unaligned base with the path and width it ran (``reduce_checks``);
   K4's maps on the staged two-input layout with the interpreter they ran
   (``map_checks``).
10. linalg at 8192^2: ``mul`` under IEEE FP32 against plain and within
    1e-2 of f64 (transposed A too), bf16 ``mul`` within its bound, ``axpby``
    through K2 exact, ``v @ w``, the int32 generic ``mul`` at 512^3 with
    ``kernel_reductions`` off and on.
11. the transpose-pair probes: every variant of ``exp_sym`` (8192^2) and
    ``exp_pair_rect`` (8064^2) on the input their ``run`` draws, as
    ``run`` checks it, and their four kernels launched; each kernel at every
    tile shape written into NaNs, equal to its plain version.
12. the reduction and reversal probes: every variant of ``exp_reduce``
    (8192^2), ``exp_perm2``, ``exp_perm4`` and ``exp_perm_probe`` (64^4)
    and the engine's reversal on the inputs their ``run`` draws, and their
    kernels launched; ``stream_sum_slabs`` at every slab within K3's
    tolerance of the plain and the f64 sum (and ``a[0]`` with compute off);
    every reversal variant into NaNs, exact.
13. MPC stack: the Riccati gain within 1e-4 and 4096 rollouts within 1e-4
    of f64 on the CPU, ``rollout_final`` equal to ``rollout``'s last state,
    cartpole iLQR within 1e-3 of f64; the captured rollouts and
    ``benchmarks/ilqr_bench.py``'s solve equal to eager bit for bit, costs
    finite; ``entry.make_ilqr_step`` (4096 quadrotors, N = 50) captured
    equal to eager bit for bit, then one replay and no capture a period
    over ten chained periods, states and plans finite.
14. slice C at BASELINE config 5's size: on a 1-rank NCCL mesh the step and
    consensus against ``ctrl.control`` + ``model.step``, K1 launches, their
    captures equal to eager and K1 in their profiled replays, the sharded
    rollout replaying the captured ``rollout``, ``scenario_mpc``'s chained
    step (``scenario_checks``); then two ranks (``slice_c_ranks``: NCCL on
    two cards, else gloo, whose captured calls must be refused) with the
    dry-run surface and the full-size step, consensus, K2 and K3 checks.
15. the engine's four size gates: one size at each gate and one below
    through the public engine, route and result; ``sweeps --quick``'s own
    measurement checks; ``exp_contract`` (a process of its own): no copy
    of a lazy transpose before the product.
16. the precision name "default": the single-pass bf16 product within its
    bound, ``qp_solve``'s ``coarse_iters`` (K1 or not, the first coarse
    iteration's bound), the coarse closed loop captured equal to eager with
    no K1, ``mul`` at "default", ``symmetrize`` exact, and ``python -m
    strided_tpu_torch.bench`` exiting 0 with its headline keys.
17. the port's spans, in a process of its own (``--tracing-phase``): no
    marker with tracing off or in a caller's graph, each section's two
    markers once a traced replay, equal to the unmarked step; spans'
    counts and parents.
18. the RK4 plant kernel, in a process of its own (``--plant-phase``): the
    linearisation declines it once and stays bit for bit; the kernel within
    ``quadrotor_rk4.TOLERANCE`` of the eager step (f32 and f64, batches 1 to
    16384, another body, strided operands); the captured step launching it
    at warm-up and capture only, equal to eager, one plant kernel a replay.
19. the plant Jacobian kernel, in phase 18's process: ``make_controller``'s
    one-point linearisation never asks it and stays bit for bit; its worst
    gaps against ``jacfwd`` on ``quadrotor_rk4.stress_inputs`` rows (the
    trajectory slice ``xs[:, :-1]``, at the main path's 4096 x 50 too, a
    broadcast input, another body): f64 within 1e-12, f32 every element
    within ``quadrotor_rk4.TOLERANCE`` of f32 ``jacfwd`` and, on the rows at
    the clamp, no further from f64 ``jacfwd`` than twice f32 ``jacfwd``; the
    captured iLQR step (4096 x N = 50) launching it at warm-up and capture
    only, equal to eager, one Jacobian kernel a replay.

Any failure raises, so the exit code is non-zero. The last line is
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json

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


def _random_inputs(rng, B, D, device, z0_scale=0.0):
    """A random QP with the main path's structure: S = (H + rho I)^-1 of a
    random SPD H, bounds of +-1, |g| up to ~30; z0 = z0_scale * N(0, 1),
    which may lie outside the bounds (the first iteration takes it as
    given)."""
    G = rng.standard_normal((D, D))
    S = np.linalg.inv(G @ G.T / D + 8.0 * np.eye(D))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    g = f32(10.0 * rng.standard_normal((B, D)))
    lo, hi = f32(-np.ones(D)), f32(np.ones(D))
    return g, f32(z0_scale * rng.standard_normal((B, D))), f32(S), lo, hi


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs on the GPU only")

    from strided_tpu_torch import _build, config
    from strided_tpu_torch.bench import card_label
    from strided_tpu_torch.benchmarks import exp_admm
    from strided_tpu_torch.entry import make_controller
    from strided_tpu_torch.mpc import fused_admm as fa  # the module

    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card_label())

    _build.load_library()
    report = ptxas_report()
    main_k1 = [spill for src, name, _regs, spill in report
               if src == "fused_admm" and K1_MAIN_INSTANCE in name]
    if main_k1 != [0]:
        raise RuntimeError(f"ptxas: the main path's {K1_MAIN_INSTANCE} is missing or spills "
                           f"(spill stores {main_k1})")
    k3_programs = {name: spill for src, name, _regs, spill in report
                   if src == "stream_reduce" and "reduce_program" in name}
    if len(k3_programs) != K3_PROGRAM_INSTANCES or any(k3_programs.values()):
        raise RuntimeError(f"ptxas: expected {K3_PROGRAM_INSTANCES} reduce_program instances "
                           f"and no spills, got {k3_programs}")
    reversal_instances(report)
    pair_instances(report)
    box_instances(report)
    for src in ("quadrotor_rk4", "quadrotor_jac"):
        plant_k = [spill for source, _kernel, _regs, spill in report if source == src]
        if len(plant_k) != 2 or any(plant_k):
            raise RuntimeError(f"ptxas: expected {src}.cu's f32 and f64 instances without "
                               f"spills, got spill stores {plant_k}")

    rho, alpha, iters = 8.0, 1.6, 6
    _model, ctrl = make_controller(horizon=50, dt=0.02, device=dev)

    @config.matmul_precision_scope
    def check(g, z0, S, lo, hi, design=None):
        """K1 (or its tile design ``design`` of ``benchmarks/exp_admm.py``)
        against the plain version and both against f64."""
        before = fa.LAUNCHES
        if design is None:
            k = fa.fused_admm(g, z0, S, lo, hi, rho=rho, alpha=alpha, iters=iters)
        else:
            k = exp_admm.variants()[design](g, z0, S, lo, hi, iters=iters)
        torch.cuda.synchronize()
        if design is None and fa.LAUNCHES != before + 1:
            raise RuntimeError("fused_admm did not count its launch")
        p = fa.fused_admm_reference(g, z0, S, lo, hi, rho=rho, alpha=alpha, iters=iters)
        r = fa.fused_admm_reference(*(a.double() for a in (g, z0, S, lo, hi)),
                                    rho=rho, alpha=alpha, iters=iters)
        e_kp = (k - p).abs().max().item()
        e_k64 = (k.double() - r).abs().max().item()
        e_p64 = (p.double() - r).abs().max().item()
        B, D = g.shape
        print(f"[3 kernel] {design or 'fused_admm'} B={B} D={D}: |kernel-plain| {e_kp:.3e}, "
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

    rng = np.random.default_rng(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (16384, 64 * sms - 1, 64 * sms + 1, 65, 63, 33, 31, 1):
        x = torch.as_tensor(rng.uniform(-0.3, 0.3, (B, 12)), dtype=torch.float32,
                            device=dev)
        check(*_admm_inputs(ctrl, x))
    for B, D in ((65, 1), (33, 12), (65, 199), (65, 201), (65, 208), (65, 209),
                 (16 * sms + 1, 300), (33, 400), (65, 512)):
        check(*_random_inputs(rng, B, D, dev))
    check(*_random_inputs(rng, 65, 200, dev, z0_scale=2.0))
    # K1's tile designs on the QP exp_admm's run draws; its "k1" row is the
    # first B = 16384 case above (the same states, controller and limits)
    designs = exp_admm.main_path_inputs(16384)
    for name in exp_admm.variants():
        if name != "k1":
            check(*designs, design=name)

    main_path_phase(dev)
    step_checks(dev)
    wide_qp_check(dev)
    engine_phases(dev)
    linalg_phase(dev)
    probe_phases(dev)
    reduce_perm_phase(dev)
    mpc_stack_phase(dev)
    slice_c_phase(dev)
    gates_phase(dev)
    precision_phase(dev)
    tracing_process()
    plant_process()

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def main_path_phase(dev) -> None:
    """Phases 4 and 5: the accuracy gate through the captured plan, then the
    captured 50-step closed loop at batch 16384 held against the eager one
    (see the module docstring); raises on any failed check."""
    from strided_tpu_torch import capture as cap  # the module: its counters
    from strided_tpu_torch import closed_loop, config
    from strided_tpu_torch.bench import device_profile, mpc_accuracy
    from strided_tpu_torch.entry import make_controller
    from strided_tpu_torch.models import quadrotor_rk4 as qr
    from strided_tpu_torch.mpc import fused_admm as fa

    replays = cap.REPLAYS
    first, plan, uscale = mpc_accuracy(dev, batch=64)
    print(f"[4 gate] captured plan ({cap.REPLAYS - replays} replay): first input {first:.3e} "
          f"(< 1e-4), plan {plan:.3e} (< 0.15), input scale {uscale:.3f}")
    if cap.REPLAYS != replays + 1:
        raise RuntimeError("the gate's plan did not run as one captured replay")
    if not (first < 1e-4 and plan < 0.15):
        raise RuntimeError("accuracy gate failed on the card")

    batch, steps, dt = 16384, 50, 0.02
    model, ctrl = make_controller(horizon=50, dt=dt, device=dev)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.3, 0.3, (batch, 12)),
                         dtype=torch.float32, device=dev)
    loop = lambda: closed_loop(ctrl, model, x0, steps, dt)  # noqa: E731
    fa.LAUNCHES = qr.LAUNCHES = 0
    with cap.disable_capture():
        xs_e, us_e = loop()
    torch.cuda.synchronize()
    launches, plant_launches = fa.LAUNCHES, qr.LAUNCHES
    captures = cap.CAPTURES
    xs, us = loop()
    torch.cuda.synchronize()
    same = torch.equal(xs, xs_e) and torch.equal(us, us_e)
    _ms, _ops, rows = device_profile(loop, calls=1, warmup=1)  # one replay, profiled
    k1_replayed = sum(n for _t, n, name in rows if "fused_admm_kernel" in name)
    plant_replayed = sum(n for _t, n, name in rows if "quadrotor_rk4_kernel" in name)
    n0 = xs[:, 0].norm(dim=-1).mean().item()
    n1 = xs[:, -1].norm(dim=-1).mean().item()
    print(f"[5 main path] closed loop batch={batch} steps={steps}: captured == eager bit for "
          f"bit: {same}; {launches} K1 and {plant_launches} plant kernel launches eagerly, "
          f"{k1_replayed:.0f} fused_admm_kernel and {plant_replayed:.0f} quadrotor_rk4_kernel "
          f"in a profiled replay; mean |x| {n0:.4f} -> {n1:.4f}")
    if launches != steps or plant_launches != steps:
        raise RuntimeError(f"expected {steps} launches of K1 and of the plant kernel, counted "
                           f"{launches} and {plant_launches}")
    if cap.CAPTURES != captures + 1 or not same:
        raise RuntimeError("the closed loop did not run as one capture equal to the eager loop")
    if k1_replayed != steps or plant_replayed != steps:
        raise RuntimeError(f"a replay ran fused_admm_kernel {k1_replayed} times and "
                           f"quadrotor_rk4_kernel {plant_replayed} times, not {steps}")
    if tuple(xs.shape) != (batch, steps + 1, 12) or tuple(us.shape) != (batch, steps, 4):
        raise RuntimeError(f"closed loop shapes {tuple(xs.shape)}, {tuple(us.shape)}")
    if not (torch.isfinite(xs).all() and torch.isfinite(us).all()):
        raise RuntimeError("closed loop produced non-finite values")
    if not n1 < n0:
        raise RuntimeError("closed loop did not regulate the state toward hover")
    config.set_config(fused_admm=False)  # the same call: the config alone is new
    try:
        xs_p, _ = loop()
    finally:
        config.set_config(fused_admm=True)
    plain_captured = cap.CAPTURES == captures + 2 and not torch.equal(xs_p, xs)
    xs_k, _ = loop()  # the kernel's entry again
    e_loop = (xs[:64] - xs_p[:64]).abs().max().item()
    print(f"[5 main path] first 64 scenarios vs plain loop path: max |dx| {e_loop:.3e}; "
          f"the plain path took its own capture: {plain_captured}; the kernel's replays "
          f"again, equal: {torch.equal(xs_k, xs)}")
    if not e_loop <= ATOL_LOOP:
        raise RuntimeError(f"closed loop off the plain path by {e_loop:.3e} > {ATOL_LOOP}")
    if not plain_captured or cap.CAPTURES != captures + 2 or not torch.equal(xs_k, xs):
        raise RuntimeError("the config is not in the capture's key")

    @cap.capture
    def reads_the_host(x):
        return x * x.sum().item()

    try:
        reads_the_host(x0[:4])
    except RuntimeError as e:
        print(f"[5 main path] a captured .item() raises: {str(e).splitlines()[0][:100]}")
    else:
        raise RuntimeError("a capture that reads the host did not raise")
    if len(reads_the_host.cache) or cap.CAPTURES != captures + 2:
        raise RuntimeError("a failed capture left an entry")


def step_checks(dev) -> None:
    """Phase 6: ``entry.make_step``'s captured step at batch 16384 with K1
    on and off: its first call equal to the eager step bit for bit
    (``bench.matches_eager``), then 56 steps chained captured and 55 eagerly
    from there, the last state finite."""
    from strided_tpu_torch import config
    from strided_tpu_torch.bench import matches_eager
    from strided_tpu_torch.capture import disable_capture
    from strided_tpu_torch.entry import make_controller, make_step

    model, ctrl = make_controller(horizon=50, dt=0.02, device=dev)
    step = make_step(model, ctrl, 0.02)
    for fused in (True, False):
        x = torch.as_tensor(np.random.default_rng(0).uniform(-0.3, 0.3, (16384, 12)),
                            dtype=torch.float32, device=dev)
        config.set_config(fused_admm=fused)
        try:
            matches_eager(lambda: step(x))
            for _ in range(56):
                x = step(x)
            with disable_capture():
                for _ in range(55):
                    x = step(x)
            torch.cuda.synchronize()
        finally:
            config.set_config(fused_admm=True)
        finite = bool(torch.isfinite(x).all())
        print(f"[6 step] make_step batch 16384, K1 {'on' if fused else 'off'}: captured == "
              f"eager bit for bit, 111 chained steps finite: {finite}")
        if not finite:
            raise RuntimeError(f"the closed-loop step (K1 {fused}) produced non-finite states")


# the main path's K1 instance (8 x 8 thread tiles, g in registers), as ptxas names it
K1_MAIN_INSTANCE = "fused_admm_kernelILi8ELi8ELi8ELb1E"
# K3's program kernels: float or int results x the register file (1, 2, 4 or
# the scalar interpreter's) on 8 columns a thread, and (2, 4 or scalar) on one
K3_PROGRAM_INSTANCES = 14


def reversal_instances(report) -> None:
    """Phase 2's check of ``csrc/exp_perm.cu``: every ``rev4_tiles`` instance
    the wrapper dispatches to (``rev4_async`` runs one of them) and every
    ``rev4_mma`` instance is built, and no ``rev4_tiles`` instance spills."""
    from strided_tpu_torch.benchmarks import perm_kernels as pk

    built = {name: spill for src, name, _regs, spill in report if src == "exp_perm"}
    want = {f"rev4_tiles_kernelILi{g}ELi{e3}ELi{st}ELb{int(cp)}E": True
            for g, e3, st, cp in pk.TILES_INSTANCES}
    want.update({f"rev4_mma_kernelILi{g}ELb{int(h)}E": False
                 for g in (pk.J2J1, pk.J3J2) for h in (False, True)})
    for key, no_spill in want.items():
        found = [spill for name, spill in built.items() if key in name]
        if len(found) != 1 or (no_spill and found[0]):
            raise RuntimeError(f"ptxas: {key} is missing or spills (spill stores {found})")
    print(f"[2 build] exp_perm: {len(want)} rev4 instances built, no rev4_tiles spill")


def pair_instances(report) -> None:
    """Phase 2's check of ``csrc/exp_sym.cu``: every ``pair_tiles`` instance
    the wrapper dispatches to (tile x ``do_transpose`` x ``skip_diag``) is
    built and does not spill."""
    from strided_tpu_torch.benchmarks import exp_sym as es

    built = {name: spill for src, name, _regs, spill in report if src == "exp_sym"}
    want = [f"pair_tiles_kernelILi{t}ELb{d}ELb{k}E"
            for t in es.SQUARE_TILES for d in (0, 1) for k in (0, 1)]
    for key in want:
        found = [spill for name, spill in built.items() if key in name]
        if len(found) != 1 or found[0]:
            raise RuntimeError(f"ptxas: {key} is missing or spills (spill stores {found})")
    print(f"[2 build] exp_sym: {len(want)} pair_tiles instances built, no spill")


def box_instances(report) -> None:
    """Phase 2's check of K4's multi-axis map (``tile_box_v``) and streaming
    map (``tile_stream_v``): the box's two instances (three staging dims,
    and two) and the stream's six (register files of 2, 3 and 4, with and
    without exp and sin) are built and none spills; their registers and
    stack are in ptxas's lines."""
    built = {name: (regs, spill) for src, name, regs, spill in report
             if src == "tile_executor" and ("tile_box_v" in name or "tile_stream_v" in name)}
    want = [f"tile_box_vILi{nu}ELi{lx}EE" for nu, lx in ((3, 3), (2, 6))]
    want += [f"tile_stream_vILi{r}ELb{tr}EE" for r in (2, 3, 4) for tr in (0, 1)]
    for key in want:
        found = [v for name, v in built.items() if key in name]
        if len(found) != 1 or found[0][1]:
            raise RuntimeError(f"ptxas: {key} is missing or spills ({found})")
    print(f"[2 build] tile_executor: {len(want)} tile_box_v and tile_stream_v instances built, "
          f"no spill (registers {sorted(v[0] for name, v in built.items())})")


P2, P3, P4 = (1, 2, 3, 0), (2, 3, 0, 1), (3, 0, 1, 2)  # the README's four-permute sum


def _permuted_views(shape, perms, dtype, dev, gen):
    """One contiguous parent a permutation, each permuted to ``shape``:
    input k is unit-stride along the dim d where ``perms[k][d]`` is the
    parent's last. Returns (views, parents)."""
    import strided_tpu_torch as st

    views, parents = [], []
    for perm in perms:
        pshape = [0] * len(shape)
        for d, j in enumerate(perm):
            pshape[j] = shape[d]
        t = torch.randn(pshape, device=dev, generator=gen) * 4
        t = (t * 10).int() if dtype == torch.int32 else t.to(dtype)
        views.append(st.permutedims(st.strided(t), perm))
        parents.append(t)
    return views, parents


def multi_axis_checks(dev, gen) -> None:
    """Phase 8, K4's multi-axis map against its plain version, limit 0: the
    README's four-permute sum at 96^4 through the engine (f32, bf16, int32,
    also against the PyTorch expression) and four distinct inputs at
    37x96x45x70 through the planner; a three-input rank-3 map at 200x130x150
    and 101x67x93 (two staging dims), a two-input one (a body of two
    registers), and the three inputs with a broadcast row as a fourth
    (read directly); a rank-5 map with four staging dims, which
    stays on tile_t2d_v. Each with the path ``MAP_PATHS`` records."""
    import strided_tpu_torch as st
    from strided_tpu_torch.core import executor_cuda as ec

    old_cfg = st.get_config()
    st.set_config(map_min_elements=1, min_kernel_elements=1)
    try:
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            (v, *_), (a, *_) = _permuted_views((96,) * 4, [(0, 1, 2, 3)], dt, dev, gen)
            before = ec.MAP_PATHS["multi_axis"]
            ec.LAST_PLAN.clear()
            got = st.to_array(v + st.permutedims(v, P2) + st.permutedims(v, P3)
                              + st.permutedims(v, P4))
            want = a + a.permute(P2) + a.permute(P3) + a.permute(P4)
            torch.cuda.synchronize()
            e = _max_err(got, want)
            ran = ec.MAP_PATHS["multi_axis"] - before
            print(f"[8 multi-axis] four-permute sum 96^4 {dt}: staging "
                  f"{ec.LAST_PLAN.get('staging')}, multi_axis x{ran}, "
                  f"|kernel - torch| {e:.3e} (limit 0)")
            if e != 0.0 or ran != 1 or ec.LAST_PLAN.get("staging") != (-1, 2, 1, 0):
                raise RuntimeError(f"four-permute sum {dt}: off by {e:.3e} or not multi-axis")
        four = [(0, 1, 2, 3), P2, P3, P4]
        three = [(0, 1, 2), (1, 2, 0), (2, 0, 1)]
        cases = [(f"four inputs 37x96x45x70 {dt}", (37, 96, 45, 70), four, dt, False, "multi_axis")
                 for dt in (torch.float32, torch.bfloat16, torch.int32)]
        cases += [(f"three inputs {'x'.join(map(str, sh))} f32", sh, three, torch.float32, False,
                   "multi_axis") for sh in ((200, 130, 150), (101, 67, 93))]
        cases += [("two inputs 101x67x93 f32", (101, 67, 93), three[1:], torch.float32, False,
                   "multi_axis"),
                  ("three inputs and a broadcast row 101x67x93 f32", (101, 67, 93), three,
                   torch.float32, True, "multi_axis"),
                  ("rank 5, four staging dims 12x10x9x11x13 f32", (12, 10, 9, 11, 13),
                   [(4, 0, 1, 2, 3), (0, 4, 1, 2, 3), (0, 1, 4, 2, 3), (0, 1, 2, 4, 3)],
                   torch.float32, False, "amortized")]
        for name, shape, perms, dt, row, path in cases:
            views, parents = _permuted_views(shape, perms, dt, dev, gen)
            if row:
                r = torch.randn(shape[-1], device=dev, generator=gen)
                views.append(st.broadcast_to(st.strided(r.reshape((1,) * (len(shape) - 1) + (-1,))),
                                             shape))
                parents.append(r)
            f = {2: lambda a, b: a * 3 - b, 3: lambda a, b, c: a + b + c,
                 4: lambda a, b, c, d: a + b + c + d}[len(views)]
            out = st.strided(torch.empty(shape, device=dev, dtype=dt))
            plan = ec.make_plan(f, None, None, shape, out, views)
            if plan is None:
                raise RuntimeError(f"multi-axis {name}: the tile executor declined")
            before = dict(ec.MAP_PATHS)
            k = ec.tile_executor(plan, out.parent, parents)
            p = ec.tile_executor_reference(plan, out.parent, parents)
            torch.cuda.synchronize()
            e = _max_err(k, p)
            ran = [q for q in ec.MAP_PATHS if ec.MAP_PATHS[q] != before[q]]
            print(f"[8 multi-axis] {name}: staging {plan.stage}, {ran}, "
                  f"|kernel - plain| {e:.3e} (limit 0)")
            if e != 0.0 or ran != [path]:
                raise RuntimeError(f"multi-axis {name}: off by {e:.3e}, or path {ran} "
                                   f"(expected {path})")
    finally:
        st.set_config(map_min_elements=old_cfg.map_min_elements,
                      min_kernel_elements=old_cfg.min_kernel_elements)


def wide_qp_check(dev) -> None:
    """Phase 7: D = 600 > MAX_D must take the loop path, not raise."""
    from strided_tpu_torch import config, qp_solve
    from strided_tpu_torch.entry import make_controller
    from strided_tpu_torch.mpc import fused_admm as fa

    _model, ctrl = make_controller(horizon=150, dt=0.02, device=dev)
    qp = ctrl.qp
    x = torch.as_tensor(np.random.default_rng(3).uniform(-0.3, 0.3, (256, 12)),
                        dtype=torch.float32, device=dev)
    before = fa.LAUNCHES
    U = qp_solve(qp, x, ctrl.u_min, ctrl.u_max, iters=6, alpha=1.6)
    config.set_config(fused_admm=False)
    try:
        U_loop = qp_solve(qp, x, ctrl.u_min, ctrl.u_max, iters=6, alpha=1.6)
    finally:
        config.set_config(fused_admm=True)
    torch.cuda.synchronize()
    err = (U - U_loop).abs().max().item()
    print(f"[7 wide QP] N={qp.N} D={qp.N * qp.m} (MAX_D {fa.MAX_D}): kernel launches "
          f"{fa.LAUNCHES - before}, |U - loop path| {err:.3e}, finite "
          f"{bool(torch.isfinite(U).all())}")
    if fa.LAUNCHES != before or not torch.isfinite(U).all() or err != 0.0:
        raise RuntimeError("qp_solve at D=600 did not take the loop path cleanly")


def _max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in f64; NaNs must sit in the same places."""
    g, w = got.double(), want.double()
    if got.shape != want.shape or not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise RuntimeError(f"shape or NaN pattern differs: {tuple(got.shape)} vs "
                           f"{tuple(want.shape)}")
    return (g - w).nan_to_num().abs().max().item()


def _bf16_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise bound between two f32 summation orders of the product of
    ``a`` and ``b`` rounded to bf16: each within (k - 1) 2^-24 sum|a_i b_i|
    of the exact sum, so 2 k 2^-24 (|a| @ |b|) apart."""
    from strided_tpu_torch import config

    return 2 * a.shape[-1] * 2.0 ** -24 * config.bf16_matmul_reference(
        a.to(torch.bfloat16).abs(), b.to(torch.bfloat16).abs())


def precision_phase(dev) -> None:
    """Phase 16: the precision name "default" and what takes it (see the
    module docstring)."""
    import dataclasses
    import subprocess
    import sys

    import strided_tpu_torch as st
    from strided_tpu_torch import capture as cap, closed_loop, config, qp_solve
    from strided_tpu_torch.bench import matches_eager
    from strided_tpu_torch.entry import make_controller
    from strided_tpu_torch.mpc import fused_admm as fa

    gen = torch.Generator(device=dev).manual_seed(16)
    randn = lambda *shape: torch.randn(*shape, device=dev, generator=gen)  # noqa: E731

    def bounded(what, got, want, limit):
        e = (got - want).abs()
        share = (e / limit).max().item()
        print(f"[16 precision] {what}: max |got - plain| {e.max().item():.3e}, worst share of "
              f"its bound {share:.3f}")
        if not (e <= limit).all():
            raise RuntimeError(f"{what}: off the plain single-pass product past its bound")

    print(f"[16 precision] the single-pass product's route: {config.BF16_ROUTE}")
    for m, k, n in ((16384, 200, 200), (4096, 4096, 4096)):
        a, b = randn(m, k), randn(k, n)
        got = config.matmul(a, b, "default")
        if got.dtype != torch.float32:
            raise RuntimeError(f"the single-pass product returned {got.dtype}")
        bounded(f"config.matmul(a, b, 'default') {m}x{k} @ {k}x{n}", got,
                config.bf16_matmul_reference(a, b), _bf16_bound(a, b))

    model, ctrl = make_controller(horizon=50, dt=0.02, device=dev)
    qp, alpha = ctrl.qp, 1.6
    x = torch.as_tensor(np.random.default_rng(16).uniform(-0.3, 0.3, (16384, 12)),
                        dtype=torch.float32, device=dev)
    solve = lambda iters, c: qp_solve(qp, x, ctrl.u_min, ctrl.u_max, iters,  # noqa: E731
                                      coarse_iters=c)
    g, z0, S, lo, hi = config.matmul_precision_scope(_admm_inputs)(ctrl, x)
    want = fa.fused_admm(g, z0, S, lo, hi, rho=qp.rho, alpha=alpha, iters=20)
    runs = {}
    for c in (0, 12):
        fa.LAUNCHES = 0
        runs[c] = solve(20, c).reshape(16384, -1)
        torch.cuda.synchronize()
        runs[c, "k1"] = fa.LAUNCHES
    print(f"[16 precision] qp_solve 20 iterations at batch 16384: coarse 0 K1 x{runs[0, 'k1']}, "
          f"equal to K1 on the IEEE FP32 g and warm start: {torch.equal(runs[0], want)}; "
          f"coarse 12 K1 x{runs[12, 'k1']}, max |U12 - U0| "
          f"{(runs[12] - runs[0]).abs().max().item():.3e}")
    if runs[0, "k1"] != 1 or not torch.equal(runs[0], want) or runs[12, "k1"] != 0:
        raise RuntimeError("coarse 0 must run K1 once as before, coarse 12 no K1")
    rhs = qp.rho * z0 - g  # the first iteration's right-hand side (y = 0)
    u_rel = alpha * config.bf16_matmul_reference(rhs, S) + (1 - alpha) * z0
    # alpha times the product's bound, and two f32 roundings of u_rel
    bounded("qp_solve's first coarse iteration (1 of 1)", solve(1, 1).reshape(16384, -1),
            torch.minimum(torch.maximum(u_rel, lo), hi),
            alpha * _bf16_bound(rhs, S) + 2.0 ** -22 * u_rel.abs())

    coarse = dataclasses.replace(ctrl, admm_iters=20, admm_coarse_iters=12)
    fa.LAUNCHES = 0
    captures = cap.CAPTURES
    (xs, _us), _, _ = matches_eager(
        lambda: closed_loop(coarse, model, x, 10, 0.02))
    print(f"[16 precision] closed_loop batch 16384, 10 steps, admm_coarse_iters 12 of 20: "
          f"captured == eager bit for bit, {cap.CAPTURES - captures} capture, K1 "
          f"x{fa.LAUNCHES}")
    if fa.LAUNCHES != 0 or cap.CAPTURES != captures + 1 or not torch.isfinite(xs).all():
        raise RuntimeError("the coarse closed loop launched K1, took no capture or diverged")

    old = st.get_config().matmul_precision
    a, b = randn(2048, 2048), randn(2048, 2048)
    try:
        st.set_config(matmul_precision="default")
        got = st.materialize(st.mul(st.strided(torch.zeros(2048, 2048, device=dev)),
                                    st.strided(a), st.strided(b)))
    finally:
        st.set_config(matmul_precision=old)
    bounded("mul at 'default' 2048^2", got, config.bf16_matmul_reference(a, b),
            _bf16_bound(a, b))

    a = randn(4000, 4000)
    want = (a + a.T) / 2
    for what, call in (("symmetrize(x, 256)", lambda: st.symmetrize(a, 256)),
                       ("symmetrize(x, tile=64)", lambda: st.symmetrize(a, tile=64))):
        got = call()
        print(f"[16 precision] {what} 4000^2 == (x + x.T) / 2 bit for bit: "
              f"{torch.equal(got, want)}")
        if not torch.equal(got, want):
            raise RuntimeError(f"{what} differs from (x + x.T) / 2")

    proc = subprocess.run([sys.executable, "-m", "strided_tpu_torch.bench"],
                          capture_output=True, text=True, timeout=400)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    head = json.loads(last) if last.startswith("{") else {}
    print(f"[16 precision] python -m strided_tpu_torch.bench exit {proc.returncode}; its last "
          f"line's keys {sorted(head)}")
    if proc.returncode != 0 or sorted(head) != ["metric", "unit", "value", "vs_baseline"]:
        raise RuntimeError(f"python -m strided_tpu_torch.bench failed or printed no headline:\n"
                           f"{proc.stderr[-3000:]}")


def wide_body(a, b):
    """A body of 5 live values, more than ewise.CREG: the scalar interpreter."""
    return (a + 1) * ((a + 2) * ((a + 3) * (b + 4))) + a * b


def coverage_checks(dev, gen) -> None:
    """Phase 8, off the main path (not counted): the kernels on cases the
    main path does not reach, each against its plain version: K4 on every
    op of the elementwise program's table, on a two-input reduction and on
    bf16; K3 with a program and in bf16; K2 on distinct buffers. Exact,
    except where stated: a general ``powf`` and ``rsqrtf`` within 2 ulp."""
    import strided_tpu_torch as st
    from strided_tpu_torch.core import ewise, executor_cuda as ec
    from strided_tpu_torch.core import kernels_special as ks, stream_reduce as sr

    old_cfg = st.get_config()
    st.set_config(map_min_elements=1, min_kernel_elements=1)  # 3M elements: below the map gate
    try:
        _coverage(dev, gen)
    finally:
        st.set_config(map_min_elements=old_cfg.map_min_elements,
                      min_kernel_elements=old_cfg.min_kernel_elements,
                      kernel_reductions=old_cfg.kernel_reductions,
                      aligned_maps=old_cfg.aligned_maps)
    torch.cuda.synchronize()


def _coverage(dev, gen) -> None:
    import strided_tpu_torch as st
    from strided_tpu_torch.core import ewise, executor_cuda as ec
    from strided_tpu_torch.core import kernels_special as ks, stream_reduce as sr

    x = torch.randn(1000, 3000, device=dev, generator=gen) * 4
    y = torch.randn(1000, 3000, device=dev, generator=gen)
    ops = {"x + y": lambda a, b: a + b, "2 - x": lambda a, b: 2 - a,
           "x * y * 3": lambda a, b: a * b * 3, "x / (|y| + 1)": lambda a, b: a / (abs(b) + 1),
           "x / 3": lambda a, b: a / 3, "7 / (|x| + 1)": lambda a, b: 7 / (abs(a) + 1),
           "x ** 2": lambda a, b: a ** 2, "x ** 3": lambda a, b: a ** 3,
           "|x| ** 0.5": lambda a, b: abs(a) ** 0.5, "(|x|+1) ** -1": lambda a, b: (abs(a) + 1) ** -1,
           "(|x|+1) ** 1.7": lambda a, b: (abs(a) + 1) ** 1.7, "x % 3": lambda a, b: a % 3,
           "compare": lambda a, b: (a < b).int() + (a >= 1).int() * 8,
           "min max": lambda a, b: torch.minimum(a, b) - torch.maximum(a, b * 0.5),
           "-|x| + y": lambda a, b: -abs(a) + b, "where": lambda a, b: torch.where(a < 0, -a, b),
           "cast": lambda a, b: a.to(torch.int32) * 2 + b.float(),
           "int ops": lambda a, b: (a * 10).int() % 7 - (b * 10).int() * 3,
           "wide (scalar interpreter)": wide_body}
    for dtype in (torch.float32, torch.bfloat16):
        xs, ys = x.to(dtype), y.to(dtype)
        xv, yv = st.transpose(st.strided(xs)), st.strided(ys.T.contiguous())
        for name, f in ops.items():
            if dtype == torch.bfloat16 and name in ("int ops", "cast", "compare"):
                continue
            out = st.strided(torch.empty(3000, 1000, device=dev, dtype=ewise.result_dtype(f, [dtype] * 2)))
            plan = ec.make_plan(f, None, None, (3000, 1000), out, [xv, yv])
            if plan is None:
                raise RuntimeError(f"coverage {name}: the tile executor declined")
            k = ec.tile_executor(plan, out.parent, [xv.parent, yv.parent])
            p = ec.tile_executor_reference(plan, out.parent, [xv.parent, yv.parent])
            e = _max_err(k, p)
            approx = name in ("(|x|+1) ** 1.7",)
            lim = 2 * torch.finfo(dtype).eps * p.abs().max().item() if approx else 0.0
            print(f"[8 coverage] tile_executor {name} {dtype}: |kernel - plain| {e:.3e} (limit {lim:g})")
            if not e <= lim:
                raise RuntimeError(f"coverage {name} {dtype}: {e:.3e} > {lim:g}")
    # maps with no transposed read (one element a thread, 8 at a time), with
    # a body that fits ewise.CREG registers and a wider one
    st.set_config(aligned_maps=True)
    row = st.broadcast_to(st.strided(y[:1]), (1000, 3000))
    for name, f in (("x*3 + row", lambda a, b: a * 3 + b), ("wide", wide_body)):
        out = st.strided(torch.empty(1000, 3000, device=dev))
        plan = ec.make_plan(f, None, None, (1000, 3000), out, [st.strided(x), row])
        if plan is None or plan.tdim >= 0:
            raise RuntimeError(f"coverage {name}: not a per-element tile-executor map")
        pars = [x.reshape(-1), y[:1].reshape(-1)]
        k = ec.tile_executor(plan, out.parent, pars)
        e = _max_err(k, ec.tile_executor_reference(plan, out.parent, pars))
        print(f"[8 coverage] tile_executor per-element map {name}: |kernel - plain| {e:.3e} (limit 0)")
        if e != 0.0:
            raise RuntimeError(f"coverage per-element map {name}: off by {e:.3e}")
    # a two-input reduction: out = max(old - 1, max over axis 0 of x * y)
    st.set_config(kernel_reductions=True)
    old = torch.randn(1, 3000, device=dev, generator=gen)
    ov = st.broadcast_to(st.strided(old), (1000, 3000))
    ins = [st.strided(x), st.strided(y)]
    plan = ec.make_plan(lambda a, b: a * b, torch.maximum, lambda o: o - 1, (1000, 3000), ov, ins)
    k = ec.tile_executor(plan, ov.parent, [x.reshape(-1), y.reshape(-1)])
    p = ec.tile_executor_reference(plan, ov.parent, [x.reshape(-1), y.reshape(-1)])
    e = _max_err(k, p)
    print(f"[8 coverage] tile_executor two-input max-reduction: |kernel - plain| {e:.3e} (limit 0)")
    if e != 0.0:
        raise RuntimeError("two-input reduction off its plain version")
    # a complete int32 reduction (one output: the extent in chunks over blocks)
    xi = (x * 10).int()
    one = torch.randint(-9, 9, (1, 1), device=dev, dtype=torch.int32, generator=gen)
    ov1 = st.broadcast_to(st.strided(one), (1000, 3000))
    plan = ec.make_plan(lambda a: a, torch.add, lambda o: 2 * o, (1000, 3000), ov1, [st.strided(xi)])
    k = ec.tile_executor(plan, ov1.parent, [xi.reshape(-1)])
    e = _max_err(k, ec.tile_executor_reference(plan, ov1.parent, [xi.reshape(-1)]))
    print(f"[8 coverage] tile_executor complete int32 sum: |kernel - plain| {e:.3e} (limit 0)")
    if e != 0.0:
        raise RuntimeError("complete reduction off its plain version")
    _k3_coverage(dev, gen)
    a, c = torch.randn(2, 3001, 3001, device=dev, generator=gen)
    k = ks.pair_axpby(a, c, alpha=2.0, beta=-3.0, scale_mode="mul", scale=0.25)
    p = ks.pair_reference(a, c, alpha=2.0, beta=-3.0, scale_mode="mul", scale=0.25)
    e = _max_err(k, p)
    print(f"[8 coverage] pair_axpby distinct 3001^2: |kernel - plain| {e:.3e} (limit 0)")
    if e != 0.0:
        raise RuntimeError("pair_axpby distinct buffers off its plain version")


def _k3_coverage(dev, gen) -> None:
    """Phase 8, K3 off the main path: every fold on f32, bf16 and int32
    operands whose rows are whole 16-byte runs (3000 columns: 8 columns a
    thread) and whose rows are not (3001: one column a thread); then every
    program kernel: bodies of 1, 2, 3 and 5 registers (register files of 1
    (8 columns a thread only), 2 and 4, and the scalar interpreter) on
    f32, bf16 and int32 leaves, float- and int-valued, with every fold, on 8
    columns a thread (3000 columns) and one (3001 columns, and 3000 on a
    base that is not 16-byte aligned). Each against its plain version, with
    the kernel and width the launcher reports it ran. Exact for min, max and
    int32 (wrapping, so any order); a float sum within 1e-6 * rows *
    max|f(a)| and a product within 1e-6 * rows * max|result| (another
    order), plus two bf16 roundings of the result for bf16. Products take
    the first 24 rows of operands near 1, so that they stay finite."""
    from strided_tpu_torch.core import ewise, stream_reduce as sr

    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    folds = {"sum": sr.RED_SUM, "prod": sr.RED_PROD, "min": sr.RED_MIN, "max": sr.RED_MAX}
    z = torch.randn(1000, 3001, device=dev, generator=gen)

    def check(what, a, prog, red, path):
        before = dict(sr.PATHS)
        k, p = sr.stream_reduce(a, prog, red), sr.stream_reduce_reference(a, prog, red)
        torch.cuda.synchronize()
        ran = [q for q in sr.PATHS if sr.PATHS[q] != before[q]]
        e = _max_err(k, p)
        lim = 0.0
        if prog.out_dtype != i32 and red in (sr.RED_SUM, sr.RED_PROD):
            vals = ewise.evaluate(prog, [a]).float().abs().max().item()
            lim = 1e-6 * a.shape[0] * (vals if red == sr.RED_SUM else p.float().abs().max().item())
            if prog.out_dtype == bf16:
                lim += 2 * torch.finfo(bf16).eps * p.float().abs().max().item()
        print(f"[8 coverage] stream_reduce {what} [{', '.join(ran)}]: |kernel - plain| {e:.3e} "
              f"(limit {lim:g})")
        if not e <= lim or ran != [path]:
            raise RuntimeError(f"stream_reduce {what}: off by {e:.3e} (limit {lim:g}), or ran {ran}")

    for cols in (3000, 3001):
        width = "vector" if cols == 3000 else "column"
        for fold, red in folds.items():
            # factors near 1 keep a float product of 1000 rows finite; odd
            # ints keep an int32 product from collapsing to 0
            zf = (1 + z[:, :cols] / 64) if fold == "prod" else z[:, :cols] * 4
            for a in (zf.contiguous(), zf.to(bf16), (z[:, :cols] * 4).int() * 2 + 1):
                prog = ewise.trace(lambda t: t, [a.dtype], out_dtype=a.dtype)
                check(f"{fold} identity 1000x{cols} {a.dtype}", a, prog, red, f"identity/{width}")
    bodies = [("t*3 + 1", lambda t: t * 3 + 1), ("(t*3 + 1)*t", lambda t: (t * 3 + 1) * t),
              ("(t+1)*(t+2) + t*3", lambda t: (t + 1) * (t + 2) + t * 3),
              ("wide", lambda t: wide_body(t, t))]
    leaves = [  # (what, operand, near 1 for products, float-valued body on it)
        ("f32", z * 4, z / 8, lambda f: f),
        ("bf16", (z * 4).to(bf16), (z / 8).to(bf16), lambda f: f),
        ("int32 -> f32", (z * 10).int(), (z * 2).int(), lambda f: lambda t: f(t * 0.0625)),
        ("int32", (z * 10).int(), (z * 10).int() | 1, lambda f: f),
    ]
    layouts = [("1000x3000", lambda x: x[:, :3000].contiguous(), "vector"),
               ("1000x3001", lambda x: x, "column"),
               ("1000x3000 unaligned", lambda x: _unaligned(x[:, :3000]), "column")]
    for lname, layout, width in layouts:
        for leaf, x, x1, valued in leaves:
            a, a1 = layout(x), layout(x1)[:24]
            for name, f in bodies:
                prog = ewise.trace(valued(f), [a.dtype])
                n_reg = ewise.compact(prog).n_reg
                kernel = "amortized" if n_reg <= ewise.CREG else "scalar"
                for fold, red in folds.items():
                    check(f"{fold} of {name} ({n_reg} registers) {lname} {leaf} -> "
                          f"{prog.out_dtype}", a1 if fold == "prod" else a, prog, red,
                          f"{kernel}/{width}")


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """x's values in a contiguous tensor whose base is one element past a
    16-byte boundary: K3 takes one column a thread there."""
    out = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    out.copy_(x)
    return out


def engine_phases(dev) -> None:
    """Phases 8 and 9: the strided engine's main path and its three kernels
    (see the module docstring)."""
    import strided_tpu_torch as st
    from strided_tpu_torch.core import ewise, executor_cuda as ec
    from strided_tpu_torch.core import kernels_special as ks, lazy_expr as le
    from strided_tpu_torch.core import stream_reduce as sr

    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, device=dev, generator=gen)  # noqa: E731
    randi = lambda *shape: torch.randint(-9, 9, shape, device=dev, dtype=torch.int32,  # noqa: E731
                                         generator=gen)

    def check(what, got, want, atol=0.0):
        torch.cuda.synchronize()
        e = _max_err(got, want)
        print(f"[8 engine] {what}: |kernel - plain| {e:.3e} (limit {atol:g})")
        if not e <= atol:
            raise RuntimeError(f"{what}: kernel off its plain version by {e:.3e} > {atol:g}")

    def expect(what, record, want):
        if record != want:
            raise RuntimeError(f"{what}: dispatch went to {record!r}, expected {want!r}")

    ks.LAUNCHES = sr.LAUNCHES = ec.LAUNCHES = 0
    for paths in (sr.PATHS, ec.MAP_PATHS):
        for k in paths:
            paths[k] = 0
    # K2, through the lazy expression: the reference's flagship and family
    pairs = [(4000, torch.float32, "(v + v.T) / 2"), (8192, torch.float32, "(v + v.T) / 2"),
             (4000, torch.float32, "3*v + 2*v.T"), (4000, torch.float32, "v - v.T"),
             (4096, torch.bfloat16, "(v + v.T) / 2"), (4001, torch.float32, "(v + v.T) / 2")]
    plain_kw = {"(v + v.T) / 2": dict(scale_mode="div", scale=2.0),
                "3*v + 2*v.T": dict(alpha=3.0, beta=2.0), "v - v.T": dict(beta=-1.0)}
    for n, dt, spelling in pairs:
        a = randn(n, n).to(dt)
        v = st.strided(a)
        expr = {"(v + v.T) / 2": lambda: (v + st.transpose(v)) / 2,
                "3*v + 2*v.T": lambda: 3 * v + 2 * st.transpose(v),
                "v - v.T": lambda: v - st.transpose(v)}[spelling]()
        le.LAST_EXPR_DISPATCH = ""
        got = st.to_array(expr)
        expect(spelling, le.LAST_EXPR_DISPATCH, "pair-kernel")
        check(f"{spelling} {n}^2 {dt}", got, ks.pair_reference(a, **plain_kw[spelling]))
    # K3, through the reductions: the identity sums and max, and smean, whose
    # 1/n rides in the map (a program); each with the kernel the launcher
    # reports it ran
    n = 8192
    a = randn(n, n)
    v = st.strided(a)
    ai = randi(8192, 8192)  # at K3's gate, 2^26
    tol = 1e-6 * n * a.abs().max().item()
    mean = sr.stream_reduce_reference(a, ewise.trace(lambda x: x * (1.0 / n), [torch.float32],
                                                     out_dtype=torch.float32), sr.RED_SUM)
    for what, call, want, atol, path in (
        ("ssum(v, axis=0) 8192^2 f32", lambda: st.ssum(v, axis=0), a.sum(0, keepdim=True), tol,
         "identity/vector"),
        ("smax(transpose(v), axis=1) 8192^2 f32", lambda: st.smax(st.transpose(v), axis=1),
         a.amax(0).reshape(n, 1), 0.0, "identity/vector"),
        ("ssum(int32 8192x8192, axis=0)", lambda: st.ssum(st.strided(ai), axis=0),
         ai.sum(0, keepdim=True, dtype=torch.int32), 0.0, "identity/vector"),
        ("smean(v, 0) 8192^2 f32", lambda: st.smean(v, 0), mean.reshape(1, n),
         1e-6 * n * (a.abs().max().item() / n), "amortized/vector"),
    ):
        ks.LAST_REDUCE_DISPATCH = ""
        before = dict(sr.PATHS)
        got = st.materialize(call())
        expect(what, ks.LAST_REDUCE_DISPATCH, "stream-kernel")
        check(what, got, want, atol)
        expect(f"{what}: K3's path", [q for q in sr.PATHS if sr.PATHS[q] != before[q]], [path])
    # K4, through permutedims_into, smap and (forced) mapreducedim_into
    out = st.strided(torch.empty(n, n, device=dev))
    ec.LAST_PLAN.clear()
    got = st.materialize(st.permutedims_into(out, v, (1, 0)))
    expect("permutedims_into 8192^2", bool(ec.LAST_PLAN), True)
    check("permutedims_into(8192^2, (1, 0))", got, a.T)
    y = randn(64, 128, 64, 128)
    perm = (1, 3, 0, 2)
    out4 = st.strided(torch.empty(tuple(y.shape[p] for p in perm), device=dev))
    got = st.materialize(st.permutedims_into(out4, st.strided(y), perm))
    expect("rank-4 permute", bool(ec.LAST_PLAN), True)
    check(f"permutedims_into(64x128x64x128, {perm})", got, y.permute(perm))
    w = randn(n, n)
    got = st.materialize(st.smap(lambda p, q: p * 3 + q, st.transpose(v), st.strided(w)))
    expect("smap(x*3 + y, v.T, w)", bool(ec.LAST_PLAN), True)
    check("smap(x*3 + y, v.T, w) 8192^2", got, a.T * 3 + w)
    readme = lambda t: t * torch.exp(-2 * t) + torch.sin(t * t)  # noqa: E731
    for dt in (torch.float32, torch.bfloat16):
        x = a.to(dt)
        before = dict(ec.MAP_PATHS)
        got = st.to_array(st.sbroadcast(readme, st.strided(x)))
        torch.cuda.synchronize()
        expect(f"the README broadcast 8192^2 {dt}: K4's path",
               [q for q in ec.MAP_PATHS if ec.MAP_PATHS[q] != before[q]], ["stream"])
        check(f"A.*exp.(-2A) .+ sin.(A.*A) 8192^2 {dt}, against eager", got, readme(x))
    old_cfg = st.get_config()
    st.set_config(kernel_reductions=True)
    try:
        xi, old = randi(8192, 4096), randi(1, 4096)
        ov = st.broadcast_to(st.strided(old), (8192, 4096))
        res = st.mapreducedim_into(lambda t: t, torch.add, lambda o: 3 * o, ov, st.strided(xi))
        expect("initop reduction", bool(ec.LAST_PLAN), True)
        check("3*old + sum(int32 8192x4096, axis=0)", res.parent.reshape(1, 4096),
              3 * old + xi.sum(0, keepdim=True, dtype=torch.int32))
    finally:
        st.set_config(kernel_reductions=old_cfg.kernel_reductions)
    torch.cuda.synchronize()
    launches = {"pair_axpby": ks.LAUNCHES, "stream_reduce": sr.LAUNCHES,
                "tile_executor": ec.LAUNCHES}
    print(f"[8 engine] launches on the main path: {launches}; K3 by path {sr.PATHS}, "
          f"K4 maps by interpreter {ec.MAP_PATHS}")
    if (sr.PATHS["identity/vector"] < 1 or sr.PATHS["amortized/vector"] < 1
            or ec.MAP_PATHS["amortized"] < 1 or ec.MAP_PATHS["stream"] < 1):
        raise RuntimeError("the main path did not run K3's identity and vector program kernels "
                           "or K4's amortized and streaming maps")
    for name, count in launches.items():
        if count < 1:
            raise RuntimeError(f"{name} was not launched on the engine's main path")

    coverage_checks(dev, gen)
    multi_axis_checks(dev, gen)

    reduce_checks(dev, gen)
    map_checks(dev, gen, w)


def reduce_checks(dev, gen, n=8192):
    """Phase 9, K3 at 8192^2 off phase 8's cases: the f32 axis-0 sum and
    max, the int32 and bf16 sums; then programs: ``smean(v, 0)`` in f32 and
    bf16 through the public entry point, the wrapper on ``t*0.5 + 1``, bodies
    of 3 and 5 registers (the scalar interpreter), an int32 ``t*3 + 1``, and
    an instruction ladder (bodies of 1, 2, 3 and 9 instructions); then
    ``t*0.5 + 1``, the 3-register body, the 9-instruction rung and the
    5-register body once more on the same values on a base one element past
    a 16-byte boundary, where the kernel takes one column a thread. Each is
    checked against its plain version, with the kernel and width the
    launcher reports it ran (8 columns a thread wherever
    ``stream_reduce.split`` gives them, and for ``t*0.5 + 1`` and
    ``st.smean`` in f32 always)."""
    import strided_tpu_torch as st
    from strided_tpu_torch.core import ewise, stream_reduce as sr

    a = torch.randn(n, n, device=dev, generator=gen)
    a16 = a.bfloat16()
    ai = torch.randint(-9, 9, (n, n // 2), device=dev, dtype=torch.int32, generator=gen)
    va, va16 = st.strided(a), st.strided(a16)
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    prog = lambda f, d=f32: ewise.trace(f, [d], out_dtype=d)  # noqa: E731
    ident = {d: prog(lambda t: t, d) for d in (f32, bf16, i32)}
    mean = {d: prog(lambda t: t * (1.0 / n), d) for d in (f32, bf16)}
    ladder = {1: ("t*0.5", lambda t: t * 0.5), 2: ("t*0.5 + 1", lambda t: t * 0.5 + 1),
              3: ("(t*0.5 + 1)*t", lambda t: (t * 0.5 + 1) * t),
              9: ("((t*3 + 1)*t - t*2) * (|t| + 1) + 1",
                  lambda t: ((t * 3 + 1) * t - t * 2) * (abs(t) + 1) + 1)}
    cases = [  # (name, operand, program, fold, entry-point call or None)
        (f"sum axis 0, {n}^2 f32", a, ident[f32], sr.RED_SUM, None),
        (f"max axis 0, {n}^2 f32", a, ident[f32], sr.RED_MAX, None),
        (f"sum axis 0, int32 {n}x{n // 2}", ai, ident[i32], sr.RED_SUM, None),
        (f"sum axis 0, {n}^2 bf16", a16, ident[bf16], sr.RED_SUM, None),
        (f"sum axis 0 of t*0.5 + 1, {n}^2 f32", a, prog(ladder[2][1]), sr.RED_SUM, None),
        (f"st.smean(v, 0), {n}^2 f32", a, mean[f32], sr.RED_SUM, lambda: st.smean(va, 0)),
        (f"st.smean(v, 0), {n}^2 bf16", a16, mean[bf16], sr.RED_SUM,
         lambda: st.smean(va16, 0)),
        (f"sum axis 0 of (t+1)*(t+2) + t*3, {n}^2 f32", a,
         prog(lambda t: (t + 1) * (t + 2) + t * 3), sr.RED_SUM, None),
        (f"sum axis 0 of the wide body, {n}^2 f32", a, prog(lambda t: wide_body(t, t)),
         sr.RED_SUM, None),
        (f"sum axis 0 of t*3 + 1, int32 {n}x{n // 2}", ai, prog(lambda t: t * 3 + 1, i32),
         sr.RED_SUM, None),
    ] + [(f"sum axis 0 of {name}, {n}^2 f32 (ladder)", a, prog(f), sr.RED_SUM, None)
         for k, (name, f) in ladder.items() if k != 2]
    au = _unaligned(a)
    cases += [(f"sum axis 0 of {name}, {n}^2 f32, one column a thread (unaligned base)", au,
               prog(f), sr.RED_SUM, None)
              for name, f in (("t*0.5 + 1", ladder[2][1]),
                              ("(t+1)*(t+2) + t*3", lambda t: (t + 1) * (t + 2) + t * 3),
                              (ladder[9][0], ladder[9][1]),
                              ("the wide body", lambda t: wide_body(t, t)))]
    for name, x, p, red, call in cases:
        before = dict(sr.PATHS)
        k = call() if call else sr.stream_reduce(x, p, red)
        k = k if isinstance(k, torch.Tensor) else st.materialize(k).reshape(-1)
        want = sr.stream_reduce_reference(x, p, red)
        torch.cuda.synchronize()
        ran = [q for q in sr.PATHS if sr.PATHS[q] != before[q]]
        e = _max_err(k, want)
        # exact for max and int32; a float sum within 1e-6 * rows * max|f(a)|
        # (another order), and a bf16 result within two roundings of it
        lim = 0.0
        if red != sr.RED_MAX and p.out_dtype != i32:
            lim = 1e-6 * x.shape[0] * ewise.evaluate(p, [x]).float().abs().max().item()
            if p.out_dtype == bf16:
                lim += 2 * torch.finfo(bf16).eps * want.float().abs().max().item()
        cp = ewise.compact(p)
        vec = sr.split(x, len(cp.instrs), cp.n_reg)[0]
        path = ("identity" if not cp.instrs else "amortized" if cp.n_reg <= ewise.CREG
                else "scalar") + ("/vector" if vec == sr.NV else "/column")
        if x is a and ("t*0.5 + 1" in name or name == f"st.smean(v, 0), {n}^2 f32") \
                and path != "amortized/vector":
            raise RuntimeError(f"stream_reduce {name}: split gives {path}, not 16-byte loads")
        print(f"[9 stream_reduce] {name}: {len(cp.instrs)} instructions, {cp.n_reg} registers, "
              f"ran {ran}: |kernel - plain| {e:.3e} (limit {lim:g})")
        if not e <= lim or ran != [path]:
            raise RuntimeError(f"stream_reduce {name}: off its plain version by {e:.3e}, or ran "
                               f"{ran}, not {path}")


def map_checks(dev, gen, w, n=8192):
    """Phase 9, K4's maps on the staged two-input 8192^2 layout (v.T, w):
    the instruction ladder (bodies of 0, 1, 2, 3 and 9 instructions), a bf16
    and an int32 ``where`` map, the wide body (more than ewise.CREG
    registers: the scalar interpreter), each exact against its plain version
    on the interpreter its body needs."""
    import strided_tpu_torch as st
    from strided_tpu_torch.core import ewise, executor_cuda as ec

    a = torch.randn(n, n, device=dev, generator=gen)
    bodies = [  # (name, f, instructions after compaction)
        ("p (0 instructions)", lambda p, q: p),
        ("p + q (1)", lambda p, q: p + q),
        ("p*3 + q (2: the smap)", lambda p, q: p * 3 + q),
        ("(p*3 + q) * 0.5 (3)", lambda p, q: (p * 3 + q) * 0.5),
        ("((p*3 + q)*p - q*2) * (|q| + 1) + 1 (9)",
         lambda p, q: ((p * 3 + q) * p - q * 2) * (abs(q) + 1) + 1),
        ("wide: (p+1)*((p+2)*((p+3)*(q+4))) + p*q (scalar interpreter)",
         lambda p, q: (p + 1) * ((p + 2) * ((p + 3) * (q + 4))) + p * q),
    ]
    cases = [(name, f, a, w, torch.float32) for name, f in bodies]
    cases += [("bf16 p*3 + q", lambda p, q: p * 3 + q, a.bfloat16(), w.bfloat16(), torch.bfloat16),
              ("int32 where(p < q, p*2, q)", lambda p, q: torch.where(p < q, p * 2, q),
               (a * 100).int(), (w * 100).int(), torch.int32)]
    for name, f, x, y, dt in cases:
        out = st.strided(torch.empty(n, n, device=dev, dtype=dt))
        vx, vy = st.strided(x), st.strided(y)
        plan = ec.make_plan(f, None, None, out.shape, out, [st.transpose(vx), vy])
        if plan is None or plan.tdim < 0:
            raise RuntimeError(f"map {name}: not a staged tile-executor map")
        body = ewise.compact(plan.body)
        path = "amortized" if body.n_reg <= ewise.CREG else "scalar"
        parents = [vx.parent, vy.parent]
        before = dict(ec.MAP_PATHS)
        k = ec.tile_executor(plan, out.parent, parents)
        e = _max_err(k, ec.tile_executor_reference(plan, out.parent, parents))
        torch.cuda.synchronize()
        ran = [p for p in ec.MAP_PATHS if ec.MAP_PATHS[p] != before[p]]
        print(f"[9 tile_executor] map {name}: {len(body.instrs)} instructions, {body.n_reg} "
              f"registers, {ran} interpreter: |kernel - plain| {e:.3e} (limit 0)")
        if e != 0.0 or ran != [path]:
            raise RuntimeError(f"map {name}: off its plain version by {e:.3e}, or path {ran}")


def ptxas_report(sources=("fused_admm", "stream_reduce", "tile_executor", "exp_sym",
                         "exp_perm", "quadrotor_rk4", "quadrotor_jac")) -> list:
    """Registers, stack frame and spills of each kernel of ``sources``, from
    the ptxas report (``-Xptxas -v``) the build keeps beside the library.
    Returns ``(source, kernel, registers, spill bytes stored)`` for each."""
    import re

    from strided_tpu_torch import _build

    from pathlib import Path

    path = Path(_build.load_library()._name).with_suffix(".log")
    log = path.read_text() if path.is_file() else ""
    found = []
    for section in re.split(r"\n(?=\S*nvcc )", log):
        src = next((x for x in sources if section.split("\n", 1)[0].endswith(f"/{x}.cu")), None)
        if src is None:
            continue
        for w in [ln for ln in section.splitlines() if "warning" in ln][:5]:
            print(f"[ptxas] {src}.cu: {w.strip()[-200:]}")
        for m in re.finditer(r"Compiling entry function '(\w+)'.*?Function properties for \w+\n"
                             r"\s*(.*?)\n.*?Used (\d+) registers", section, re.S):
            name, frame, regs = m.groups()
            print(f"[ptxas] {src}.cu {name}: {regs} registers, {frame.strip()}")
            spill = re.search(r"(\d+) bytes spill stores", frame)
            found.append((src, name, int(regs), int(spill.group(1)) if spill else 0))
    return found


ATOL_MUL64 = 1e-2  # f32 mul 8192^2 vs f64: IEEE ~2e-3 at most, TF32 ~4e-2 typical


def linalg_phase(dev) -> None:
    """Phase 10: the linalg layer at full size, through its entry points."""
    import strided_tpu_torch as st
    from strided_tpu_torch import config
    from strided_tpu_torch.core import executor_cuda as ec
    from strided_tpu_torch.core import kernels_special as ks, lazy_expr as le

    gen = torch.Generator(device=dev).manual_seed(1)
    n, alpha, beta = 8192, 1.5, -0.5
    a, b, c = (torch.randn(n, n, device=dev, generator=gen) for _ in range(3))
    ieee = config.matmul_precision_scope

    def check(what, got, want, limit=0.0):
        torch.cuda.synchronize()
        e = _max_err(got, want)
        print(f"[10 linalg] {what}: |got - plain| {e:.3e} (limit {limit:g})")
        if not e <= limit:
            raise RuntimeError(f"{what}: off its plain counterpart by {e:.3e} > {limit:g}")

    ks.LAUNCHES = ec.LAUNCHES = 0
    mul = lambda A, B, C, **kw: st.materialize(st.mul(st.strided(C), A, B, **kw))  # noqa: E731
    got = mul(st.strided(a), st.strided(b), c, alpha=alpha, beta=beta)
    check("mul f32 8192^2 (cuBLAS)", got, ieee(lambda: alpha * (a @ b) + beta * c)())
    want64 = alpha * (a.double() @ b.double()) + beta * c.double()
    check("mul f32 8192^2 vs the f64 product (IEEE FP32, no TF32)", got.double(), want64,
          ATOL_MUL64)
    del want64
    got = mul(st.transpose(st.strided(a)), st.strided(b), c, alpha=alpha, beta=beta)
    want64 = alpha * (a.double().T @ b.double()) + beta * c.double()
    check("mul f32 8192^2, transposed A, vs the f64 product", got.double(), want64, ATOL_MUL64)
    check("mul f32 8192^2, transposed A, vs plain a.T @ b", got,
          ieee(lambda: alpha * (a.T @ b) + beta * c)(), ATOL_MUL64)
    del want64
    a16, b16, c16 = a.bfloat16(), b.bfloat16(), c.bfloat16()
    got = mul(st.strided(a16), st.strided(b16), c16, alpha=alpha, beta=beta)
    if got.dtype != torch.bfloat16:
        raise RuntimeError(f"bf16 mul returned {got.dtype}")
    # bf16 operands run natively (the single-pass product): the plain f32
    # product of the same values within the summation-order bound, then one
    # rounding to bf16 (half an ulp, 2^-9 relative)
    want = alpha * config.bf16_matmul_reference(a16, b16) + beta * c16
    e = (got.float() - want).abs()
    limit = abs(alpha) * _bf16_bound(a16, b16) + 2.0 ** -9 * want.abs()
    print(f"[10 linalg] mul bf16 8192^2 ({config.BF16_ROUTE}, one rounding): |got - plain| "
          f"{e.max().item():.3e}, worst share of its bound {(e / limit).max().item():.3f}")
    if not (e <= limit).all():
        raise RuntimeError("bf16 mul off the plain single-pass product past its bound")
    del want, e, limit
    v = st.strided(a)
    le.LAST_EXPR_DISPATCH = ""
    got = st.materialize(st.axpby(0.5, st.transpose(v), 0.5, v))
    if le.LAST_EXPR_DISPATCH != "pair-kernel":
        raise RuntimeError(f"axpby went to {le.LAST_EXPR_DISPATCH!r}, expected 'pair-kernel'")
    check("axpby(0.5, transpose(v), 0.5, v) 8192^2 [pair-kernel]", got,
          ks.pair_reference(a, alpha=0.5, beta=0.5, plain_first=False))
    got = st.materialize(st.strided(a) @ st.strided(b))
    check("v @ w f32 8192^2", got, ieee(torch.matmul)(a, b))
    m = 512
    ai, bi, ci = (torch.randint(-9, 9, (m, m), device=dev, dtype=torch.int32, generator=gen)
                  for _ in range(3))
    want = 3 * (ai.unsqueeze(1) * bi.T.unsqueeze(0)).sum(-1, dtype=torch.int32) + 2 * ci
    old_cfg = st.get_config()
    try:
        for k_red in (False, True):
            st.set_config(kernel_reductions=k_red)
            got = mul(st.strided(ai), st.strided(bi), ci, alpha=3, beta=2)
            route = "tile executor K4" if ec.LAST_PLAN else "plain path"
            check(f"generic mul int32 {m}^3, kernel_reductions {k_red} [{route}]", got, want)
    finally:
        st.set_config(kernel_reductions=old_cfg.kernel_reductions)
    torch.cuda.synchronize()
    print(f"[10 linalg] launches on the linalg path: pair_axpby {ks.LAUNCHES}, "
          f"tile_executor {ec.LAUNCHES}")
    if ks.LAUNCHES < 1:
        raise RuntimeError("axpby did not launch K2 on the linalg path")


def probe_phases(dev) -> None:
    """Phase 11: the transpose-pair probes and their four kernels (see the
    module docstring)."""
    from strided_tpu_torch.benchmarks import exp_pair_rect as er, exp_sym as es, same

    for counts in (es.LAUNCHES, er.LAUNCHES):
        for k in counts:
            counts[k] = 0
    # every variant of both scripts on the matrix their ``run`` draws (seed 0,
    # their default n), held to its plain result as ``run`` holds it
    x = torch.randn(8192, 8192, device=dev, generator=torch.Generator(dev).manual_seed(0))
    bad = [name for name, (fn, want) in es.variants().items() if not es.agrees(fn, want, x)]
    x = torch.randn(er.N, er.N, device=dev, generator=torch.Generator(dev).manual_seed(0))
    nans = torch.full_like(x, float("nan"))
    bad += [name for name, (fn, want, _bytes) in er.variants(er.N).items()
            if not same(fn(x, nans.clone()), want(x, nans))]
    torch.cuda.synchronize()
    launches = {**es.LAUNCHES, **er.LAUNCHES}
    print(f"[11 probes] every variant of exp_sym and exp_pair_rect equal to its plain result: "
          f"{not bad}; launches {launches}")
    if bad:
        raise RuntimeError(f"probe variants off their plain result: {bad}")
    for name, count in launches.items():
        if count < 1:
            raise RuntimeError(f"{name} was not launched by the probes")

    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(8192, 8192, device=dev, generator=gen)
    xr = torch.randn(er.N, er.N, device=dev, generator=gen)
    # each case: (kernel, shape, input, kernel(out), plain(out))
    cases = [("transpose_tiles", f"{th}x{tw}", x,
              lambda out, th=th, tw=tw: es.transpose_tiles(x, th, tw, out=out),
              lambda out: es.transpose_reference(x))
             for th, tw in ((32, 32), (64, 64), *es.RECT_TILES)]
    cases += [("sym_two_read", f"{t}", x, lambda out, t=t: es.sym_two_read(x, t, out=out),
               lambda out: es.sym_reference(x)) for t in es.SQUARE_TILES]
    for t in es.SQUARE_TILES:
        for label, kw, plain in (
                ("full", {}, lambda out: es.sym_reference(x)),
                ("copy", dict(do_transpose=False), lambda out: x.clone()),
                ("full skipdiag", dict(skip_diag=True), lambda out: es.sym_reference(x)),
                ("copy skipdiag", dict(do_transpose=False, skip_diag=True),
                 lambda out: x.clone())):
            cases.append(("pair_tiles", f"{t} {label}", x,
                          lambda out, t=t, kw=kw: es.pair_tiles(x, t, out=out, **kw), plain))
    for T in er.TILES:
        cases.append(("rect_pairs", f"{T}x{2 * T}", xr,
                      lambda out, T=T: er.rect_pairs(xr, out, T)[0],
                      lambda out, T=T: er.rect_pairs_reference(xr, out, T)[0]))
    for name, shape, src, kernel, plain in cases:
        # written into a NaN-filled tensor made just before the call: an
        # element the kernel skips stays NaN and fails the comparison
        got = kernel(torch.full_like(src, float("nan")))
        want = plain(torch.full_like(src, float("nan")))
        torch.cuda.synchronize()
        e = _max_err(got, want)
        print(f"[11 probes] {name} {shape}: |kernel - plain| {e:.3e} (limit 0, into NaNs)")
        if e != 0.0:
            raise RuntimeError(f"{name} {shape}: kernel off its plain version by {e:.3e}")
        del got, want


def _reversal_kernel(name: str) -> str:
    """The kernel a reversal probe variant runs, from its name."""
    if name.startswith("mxu"):
        return "rev4_mma"
    return "rev4_async" if name.startswith("dma4d") else "rev4_tiles"


def reduce_perm_phase(dev) -> None:
    """Phase 12: the streaming-reduction probe (P3) and the rank-4 reversal
    probes (P4-P6) with their four kernels (see the module docstring)."""
    from strided_tpu_torch.benchmarks import exp_perm2, exp_perm4, exp_perm_probe
    from strided_tpu_torch.benchmarks import exp_reduce as ere, exp_sym as es, perm_kernels as pk

    for counts in (ere.LAUNCHES, pk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    t2d_before = es.LAUNCHES["transpose_tiles"]
    # every variant of the four scripts on the tensor their ``run`` draws
    # (seed 0, their default size), held to its plain result as ``run`` holds
    # it; exp_perm2's and exp_perm_probe's ``run`` both add the engine's
    # reversal on the same tensor, checked once here
    bad = []
    a = torch.randn(8192, 8192, device=dev, generator=torch.Generator(dev).manual_seed(0))
    for name, (fn, want) in ere.variants().items():
        got = fn(a)
        if name.startswith("nocompute"):
            ok = torch.equal(got, want(a))
        else:
            e_plain, e64, tol = ere.sum_error(got, a)
            ok = e_plain <= tol and e64 <= tol
        if not ok:
            bad.append(f"exp_reduce.{name}")
    del a, got
    x = torch.randn((64,) * 4, device=dev, generator=torch.Generator(dev).manual_seed(0))
    for script in (exp_perm2, exp_perm4, exp_perm_probe):
        for name, (fn, want) in script.variants().items():
            if not torch.equal(fn(x, out=torch.full_like(x, float("nan"))), want(x)):
                bad.append(f"{script.__name__.rsplit('.', 1)[1]}.{name}")
    if not torch.equal(pk.engine_reversal(x)[0], pk.reversal_reference(x)):
        bad.append("the engine's reversal")
    torch.cuda.synchronize()
    launches = {**ere.LAUNCHES, **pk.LAUNCHES}
    t2d = es.LAUNCHES["transpose_tiles"] - t2d_before
    print(f"[12 reduce/perm] every variant of exp_reduce, exp_perm2, exp_perm4 and "
          f"exp_perm_probe equal to its plain result: {not bad}; launches {launches}, "
          f"transpose_tiles (P5 t2d) {t2d}")
    if bad:
        raise RuntimeError(f"probe variants off their plain result: {bad}")
    for name, count in {**launches, "transpose_tiles": t2d}.items():
        if count < 1:
            raise RuntimeError(f"{name} was not launched by the probes")

    gen = torch.Generator(device=dev).manual_seed(3)
    # P3: every slab, summing (K3's tolerance, against plain and f64) and not
    a = torch.randn(8192, 8192, device=dev, generator=gen)
    for R, C in ere.SLABS:
        got = ere.stream_sum_slabs(a, R, C)
        e_plain, e64, tol = ere.sum_error(got, a)
        print(f"[12 reduce/perm] stream_sum_slabs {R}x{C}: |kernel - plain| {e_plain:.3e}, "
              f"|kernel - f64| {e64:.3e} (limit {tol:.3e})")
        if not (e_plain <= tol and e64 <= tol):
            raise RuntimeError(f"stream_sum_slabs {R}x{C} off the sum by {max(e_plain, e64):.3e}")
        e = _max_err(ere.stream_sum_slabs(a, R, C, compute=False), a[0])
        print(f"[12 reduce/perm] stream_sum_slabs {R}x{C} nocompute: |kernel - a[0]| {e:.3e} "
              f"(limit 0)")
        if e != 0.0:
            raise RuntimeError(f"stream_sum_slabs {R}x{C} nocompute is not a[0]")
    del a

    # P4-P6: every reversal variant of the three scripts, exact
    x = torch.randn(64, 64, 64, 64, device=dev, generator=gen)
    for script in (exp_perm2, exp_perm4, exp_perm_probe):
        for name, (fn, plain) in script.variants().items():
            if name == "plain" or name.startswith("t2d"):
                continue  # the plain version itself; P1's transpose_tiles (phase 11)
            kernel = _reversal_kernel(name)
            # into a NaN-filled tensor made just before the call (as phase 11)
            e = _max_err(fn(x, out=torch.full_like(x, float("nan"))), plain(x))
            torch.cuda.synchronize()
            what = f"{kernel} {script.__name__.rsplit('.', 1)[1]}.{name}"
            print(f"[12 reduce/perm] {what}: |kernel - plain| {e:.3e} (limit 0, into NaNs)")
            if e != 0.0:
                raise RuntimeError(f"{what}: kernel off its plain version by {e:.3e}")


RICCATI_LIMIT = 1e-4  # max |dK|, f32 on the card against f64 on the CPU, N=50
ROLLOUT_LIMIT = 1e-4  # max |dx| over 100 steps of 0.01 s, 0.1 rad states
ILQR_LIMIT = 1e-3  # max |du|, cartpole T=40, 15 iterations, inputs up to ~86


def scenario_checks(mesh, dev) -> None:
    """``benchmarks/scenario_mpc.run``'s checks without its timers, over the
    ranks of ``mesh``: the chained step's first call equal to the eager
    chain bit for bit (``bench.matches_eager``), then ``WARMUP + REPS``
    chained steps captured and as many eagerly, the last state finite, and
    the consensus control finite. Every rank must call it together."""
    from strided_tpu_torch.bench import matches_eager
    from strided_tpu_torch.benchmarks import scenario_mpc as sm
    from strided_tpu_torch.capture import disable_capture
    from strided_tpu_torch.parallel import scenario_consensus_control, sharded_mpc_step

    model, ctrl = sm.controller(device=dev)
    x = sm.states(16384, dev)
    chain = sm.chained_step(sharded_mpc_step(ctrl, model, mesh, sm.DT), mesh)
    matches_eager(lambda: chain(x))
    state = x
    for _ in range(sm.WARMUP + sm.REPS):
        state = chain(state)
    with disable_capture():
        for _ in range(sm.WARMUP + sm.REPS):
            state = chain(state)
    u_cons, _ = scenario_consensus_control(ctrl, mesh)(x)
    if not (torch.isfinite(state).all() and torch.isfinite(u_cons).all()):
        raise RuntimeError("scenario_mpc: the chained steps or the consensus control are not "
                           "finite")


def slice_c_full(mesh, dev) -> dict:
    """Phase 14(b) at BASELINE config 5's size on each rank: the
    scenario-split step and the consensus at 16384 scenarios, N=50, ADMM-20,
    counted eagerly (inside ``disable_capture()``: K1 once a call), the
    rows within 1e-5 of the unsharded step's and within ``ATOL_KERNEL`` of
    K1's plain version (the ADMM loop) on the rank's rows, the consensus
    within 1e-5 of the oracle's mean. Over NCCL the step and the consensus
    are also called captured and held bit for bit against their eager calls
    (``bench.matches_eager``), and ``scenario_mpc``'s chained step is
    checked (:func:`scenario_checks`); over gloo every call runs eagerly (a
    gloo group cannot be captured). Then ``sharded_batched_pair`` on ``(2
    ranks, 4096, 4096)`` (K2 once a matrix, equal to ``pair_reference`` bit
    for bit) and ``sharded_stream_sum`` on ``(ranks 8192, 8192)`` (K3 once a
    rank on a 2^26-element block, within 1e-6 rows max|a| of the f64 column
    sum). Every rank must call it together. Raises on a failed check."""
    import torch.distributed as tdist

    from strided_tpu_torch import bench, config
    from strided_tpu_torch.benchmarks import scenario_mpc
    from strided_tpu_torch.capture import disable_capture
    from strided_tpu_torch.core import kernels_special as ks
    from strided_tpu_torch.core import stream_reduce as sr
    from strided_tpu_torch.mpc import fused_admm as fa
    from strided_tpu_torch.parallel import (axis_size, gather, scenario_consensus_control,
                                            shard, sharded_batched_pair, sharded_mpc_step,
                                            sharded_stream_sum)

    err = lambda a, b: (a.double() - b.double()).abs().max().item()  # noqa: E731
    n = axis_size(mesh)
    nccl = tdist.get_backend(mesh.get_group("data")) == "nccl"
    out = {"captured": nccl}
    model, ctrl = scenario_mpc.controller(device=dev)
    x = scenario_mpc.states(16384, dev)
    step = sharded_mpc_step(ctrl, model, mesh, scenario_mpc.DT)
    cons = scenario_consensus_control(ctrl, mesh)
    u_all, _ = ctrl.control(x)
    with disable_capture():  # eager calls: the launches a call
        fa.LAUNCHES = 0
        xn, u = step(x)
        out["k1_launches_step"] = fa.LAUNCHES
        fa.LAUNCHES = 0
        u_cons, _ = cons(x)
        out["k1_launches_consensus"] = fa.LAUNCHES
    if nccl:  # the captured calls, each held bit for bit against an eager one
        (xn_c, u_c), _, _ = bench.matches_eager(lambda: step(x))
        (uc_c, _), _, _ = bench.matches_eager(lambda: cons(x))
        out["captured_equals_eager"] = (torch.equal(xn_c, xn) and torch.equal(u_c, u)
                                        and torch.equal(uc_c, u_cons))
    out["step_u_err"] = err(gather(u, mesh), u_all)
    out["consensus_err"] = err(u_cons, u_all.mean(0))
    out["u0"] = u[0].tolist()
    config.set_config(fused_admm=False)  # the same rows through K1's plain version
    try:
        u_plain, _ = ctrl.control(shard(x, mesh))
    finally:
        config.set_config(fused_admm=True)
    out["k1_plain_err"] = err(u, u_plain)
    if not (out["k1_launches_step"] == out["k1_launches_consensus"] == 1
            and out["k1_plain_err"] <= ATOL_KERNEL and out["step_u_err"] <= 1e-5
            and out["consensus_err"] <= 1e-5 and out.get("captured_equals_eager", True)):
        raise RuntimeError(f"slice C at full size: a check failed: {out}")
    if nccl:
        scenario_checks(mesh, dev)

    gen = torch.Generator(device=dev).manual_seed(0)  # the same data on every rank
    xp = torch.randn((2 * n, 4096, 4096), generator=gen, device=dev)
    ks.LAUNCHES = 0
    sym = sharded_batched_pair(xp, mesh, scale_mode="mul", scale=0.5)
    out["k2_launches"] = ks.LAUNCHES
    out["k2_exact"] = all(torch.equal(s, ks.pair_reference(b, scale_mode="mul", scale=0.5))
                          for s, b in zip(sym, shard(xp, mesh)))
    if not (out["k2_launches"] == 2 and out["k2_exact"]):
        raise RuntimeError(f"K2: not 2 exact launches a rank: {out}")
    del xp, sym

    xs = torch.randn((n * 8192, 8192), generator=gen, device=dev)
    paths = dict(sr.PATHS)
    sr.LAUNCHES = 0
    ks.LAST_REDUCE_DISPATCH = ""
    total = sharded_stream_sum(xs, mesh)
    out["k3_launches"] = sr.LAUNCHES
    out["k3_routes"] = [k for k in sr.PATHS if sr.PATHS[k] != paths[k]]
    out["k3_err"] = err(total, xs.sum(0, dtype=torch.float64))
    out["k3_tol"] = 1e-6 * xs.shape[0] * xs.abs().max().item()
    if not (out["k3_launches"] == 1 and ks.LAST_REDUCE_DISPATCH == "stream-kernel"
            and all(r.startswith("identity/") for r in out["k3_routes"])
            and out["k3_err"] <= out["k3_tol"]):
        raise RuntimeError(f"K3 did not take the block, or is off the f64 sum: {out}")
    return out


def slice_c_rank(init_method, nproc, rank, backend, outdir) -> None:
    """One rank of phase 14(b), started by :func:`slice_c_ranks` as
    ``python3 chip_smoke.py --slice-c-rank <init_method> <nproc> <rank>
    <backend|auto> <outdir>``: the multi-process dry run
    (``parallel.multiproc.dryrun_checks``, which over gloo on the card also
    checks that a captured call is refused), then :func:`slice_c_full`;
    writes both to ``outdir/rank<rank>.npz``."""
    import torch.distributed as tdist

    from strided_tpu_torch.parallel import dist as pdist
    from strided_tpu_torch.parallel import make_mesh, multiproc

    torch.set_num_threads(1)
    if not pdist.init_distributed(init_method=init_method, world_size=int(nproc),
                                  rank=int(rank), device="cuda",
                                  backend=None if backend == "auto" else backend):
        raise RuntimeError("init_distributed took the single-process no-op path")
    dev = torch.device("cuda", torch.cuda.current_device())
    try:
        mesh = make_mesh(device="cuda")
        res = multiproc.dryrun_checks(mesh, dev)
        full = slice_c_full(mesh, dev)
    finally:
        tdist.destroy_process_group()
    np.savez(f"{outdir}/rank{rank}.npz", backend=np.array(pdist.BACKEND), device=str(dev),
             **res, **{"full_" + k: np.asarray(v) for k, v in full.items()})


def slice_c_ranks(nproc: int, backend) -> None:
    """Phase 14(b): ``nproc`` ranks of :func:`slice_c_rank` on the card
    (NCCL, one card a rank, unless ``backend="gloo"``); prints each rank's
    checks. Raises when a rank fails."""
    import os
    import tempfile

    from strided_tpu_torch._build import load_library
    from strided_tpu_torch.parallel import multiproc

    load_library()  # one nvcc build here, not one a rank
    with tempfile.TemporaryDirectory() as outdir:
        multiproc.spawn([os.path.abspath(__file__), "--slice-c-rank"], nproc,
                        (backend or "auto", outdir), timeout=300)
        ranks = [dict(np.load(f"{outdir}/rank{r}.npz")) for r in range(nproc)]
    for r, res in enumerate(ranks):  # every check already passed in the rank
        f = {k[len("full_"):]: v for k, v in res.items() if k.startswith("full_")}
        if bool(f["captured"]):
            mode = (f"captured: step and consensus == eager bit for bit "
                    f"{bool(f['captured_equals_eager'])}, graphs in the dry run "
                    f"{res['graph_captures']} captures / {res['graph_replays']} replays, "
                    f"scenario_mpc's chained step == eager and finite")
        else:
            mode = f"eager (gloo): a captured call refused ({str(res['err_gloo_graph'])[:60]}...)"
        print(f"[14 slice C] rank {r} of {nproc} ({res['backend']}, {res['device']}), {mode}; "
              f"dry run K1 {res['k1_step_f32']}+{res['k1_consensus_f32']}, K2 "
              f"{res['k2_launches']}, K3 {res['stream_launches']} launches; full size: u rows "
              f"vs unsharded {f['step_u_err']:.3e}, consensus {f['consensus_err']:.3e} (limit "
              f"1e-5), vs plain ADMM {f['k1_plain_err']:.3e} (limit {ATOL_KERNEL}), K1 "
              f"{f['k1_launches_step']}+{f['k1_launches_consensus']} eagerly, K2 "
              f"{f['k2_launches']} (== plain: {f['k2_exact']}), K3 {f['k3_launches']} "
              f"{[str(r) for r in f['k3_routes']]} err {f['k3_err']:.3e} (tol {f['k3_tol']:.3e}); "
              f"u[0] {[round(float(v), 6) for v in f['u0']]}")


def slice_c_phase(dev) -> None:
    """Phase 14: slice C, the multi-GPU layer, on one process (a 1-rank NCCL
    mesh: the step and the consensus counted eagerly, then captured and held
    bit for bit against eager, K1 in their profiled replays, the sharded
    rollout replaying the captured ``rollout``, ``scenario_mpc``'s chained
    step) and on two ranks (:func:`slice_c_ranks`). Raises on any failed
    check or failing rank."""
    import torch.distributed as tdist

    from strided_tpu_torch import bench
    from strided_tpu_torch import capture as cap
    from strided_tpu_torch.benchmarks import scenario_mpc
    from strided_tpu_torch.models import double_pendulum
    from strided_tpu_torch.mpc import fused_admm as fa
    from strided_tpu_torch.mpc import rollout
    from strided_tpu_torch.parallel import (axis_size, make_mesh, scenario_consensus_control,
                                            sharded_mpc_step, sharded_rollout)

    mesh = make_mesh(device="cuda")  # no process group yet: one NCCL rank
    try:
        backend = tdist.get_backend()
        model, ctrl = scenario_mpc.controller(device=dev)
        x = scenario_mpc.states(16384, dev)
        step = sharded_mpc_step(ctrl, model, mesh, scenario_mpc.DT)
        cons = scenario_consensus_control(ctrl, mesh)
        with cap.disable_capture():  # eager calls: the launches a call
            fa.LAUNCHES = 0
            xn, u = step(x)
            torch.cuda.synchronize()
            step_launches = fa.LAUNCHES
            fa.LAUNCHES = 0
            u_cons, _ = cons(x)
            torch.cuda.synchronize()
            cons_launches = fa.LAUNCHES
        u_loc, _ = ctrl.control(x)
        same = torch.equal(u, u_loc) and torch.equal(xn, model.step(x, u_loc, scenario_mpc.DT))
        same_cons = torch.equal(u_cons, u_loc.mean(0))
        graphs = cap.CAPTURES
        fa.LAUNCHES = 0  # each first captured call: the warm-up's and the capture's; then eager
        (xn_c, u_c), _, _ = bench.matches_eager(lambda: step(x))
        step_recorded = fa.LAUNCHES
        fa.LAUNCHES = 0
        (uc_c, _), _, _ = bench.matches_eager(lambda: cons(x))
        cons_recorded = fa.LAUNCHES
        captured = (torch.equal(xn_c, xn) and torch.equal(u_c, u)
                    and torch.equal(uc_c, u_cons))
        graphs = cap.CAPTURES - graphs
        print(f"[14 slice C] {axis_size(mesh)} rank ({backend}), 16384 scenarios, N=50, "
              f"ADMM-20: eager step "
              f"== ctrl.control + model.step bit for bit: {same}; consensus == their mean: "
              f"{same_cons}; K1 launches eagerly: step {step_launches}, consensus "
              f"{cons_launches}; captured (one graph each, {graphs} captures) == eager bit for "
              f"bit: {captured}; K1 launches of the warm-up, the capture and the eager call: "
              f"step {step_recorded}, consensus {cons_recorded}")
        if (backend != "nccl" or axis_size(mesh) != 1 or not (same and same_cons and captured)
                or graphs != 2
                or (step_launches, cons_launches) != (1, 1)
                or (step_recorded, cons_recorded) != (3, 3)):
            raise RuntimeError("slice C, one rank: a check failed (see the line above)")
        # K1 in the profiled replays. The count a replay is printed, not held
        # to 1: the profiler can drop a replay's records (0.8 a call has been
        # read); the launch counts of the warm-up and the capture are exact.
        for what, call in (("step", lambda: step(x)), ("consensus", lambda: cons(x))):
            replays = cap.REPLAYS
            profiled = bench.device_profile(call, calls=5)  # 3 warm-up calls, 5 profiled
            k1 = sum(c for _ms, c, name in profiled[2] if "fused_admm_kernel" in name)
            print(f"[14 slice C] one rank: the captured {what} profiled over 5 replays: "
                  f"fused_admm_kernel {k1:.1f} a call, {profiled[1]:.0f} device ops a call; "
                  f"replays {cap.REPLAYS - replays}")
            if not k1 > 0 or cap.REPLAYS - replays != 8:
                raise RuntimeError(f"the captured {what}: K1 {k1} a replay, "
                                   f"{cap.REPLAYS - replays} replays for 8 calls")

        pend = double_pendulum()  # the sharded rollout replays the captured rollout
        x0 = x[:1024, :4].contiguous() * 0.3
        us = torch.full((1024, 20, 2), 0.01, device=dev)
        roll = sharded_rollout(pend, mesh, 0.01)
        graphs, replays = cap.CAPTURES, cap.REPLAYS
        xs1, xs2 = roll(x0, us), roll(x0, us)
        with cap.disable_capture():
            xs_e = rollout(pend, x0, us, 0.01)
        rolled = (cap.CAPTURES - graphs, cap.REPLAYS - replays)
        print(f"[14 slice C] one rank: sharded_rollout 1024 x 20 twice: {rolled[0]} capture, "
              f"{rolled[1]} replays, == eager rollout bit for bit: "
              f"{torch.equal(xs1, xs_e) and torch.equal(xs2, xs_e)}")
        if rolled != (1, 2) or not (torch.equal(xs1, xs_e) and torch.equal(xs2, xs_e)):
            raise RuntimeError("sharded_rollout did not replay the captured rollout")

        scenario_checks(mesh, dev)  # over the same 1-rank group
        print("[14 slice C] one rank: scenario_mpc's chained step == eager bit for bit, its "
              "chained steps and consensus control finite")
    finally:
        tdist.destroy_process_group()
    del x, xn, u, u_loc, step, cons, ctrl, xn_c, u_c, uc_c
    torch.cuda.empty_cache()  # leave the card to the ranks

    slice_c_ranks(2, None if torch.cuda.device_count() >= 2 else "gloo")


def mpc_stack_phase(dev) -> None:
    """Phase 13: Riccati, rollouts and iLQR (slice B, plain PyTorch, no
    kernel of its own) on the card at the reference's sizes, each held to
    the port's own f64 run on the CPU, and their captured entry points to
    their eager calls. Raises on any failed check."""
    from strided_tpu_torch import bench
    from strided_tpu_torch.benchmarks import ilqr_bench
    from strided_tpu_torch.mpc import ilqr, rollout, rollout_final

    dK, k_scale = bench.riccati_accuracy(dev)
    print(f"[13 mpc stack] Riccati N=50: max |dK| f32 card vs f64 CPU {dK:.3e} "
          f"(limit {RICCATI_LIMIT}), max |K| {k_scale:.4f}")
    if not dK <= RICCATI_LIMIT:
        raise RuntimeError(f"Riccati gain off the f64 gain by {dK:.3e}")

    model, x0, us = bench.rollout_problem(dev)
    xs = rollout(model, x0, us, bench.ROLLOUT_DT)
    xT = rollout_final(model, x0, us, bench.ROLLOUT_DT)
    if tuple(xs.shape) != (4096, 101, 4) or not torch.isfinite(xs).all():
        raise RuntimeError(f"rollouts: shape {tuple(xs.shape)} or non-finite states")
    if not torch.equal(xT, xs[..., -1, :]):
        raise RuntimeError("rollout_final differs from the last state of rollout")
    cpu = lambda t: t[:64].double().cpu()
    e = (cpu(xs) - rollout(model, cpu(x0), cpu(us), bench.ROLLOUT_DT)).abs().max().item()
    print(f"[13 mpc stack] rollouts 4096 x 100: rollout_final == rollout[..., -1, :] bit for "
          f"bit; first 64 vs f64 CPU max |dx| {e:.3e} (limit {ROLLOUT_LIMIT})")
    if not e <= ROLLOUT_LIMIT:
        raise RuntimeError(f"rollouts off the f64 run by {e:.3e}")
    # BASELINE config 2's rollouts (``bench.rollout_times``' problem): the
    # captured call equal to the eager one, or this raises
    bench.matches_eager(lambda: rollout_final(model, x0, us, bench.ROLLOUT_DT))
    print("[13 mpc stack] rollout_final 4096 x 100 captured == eager bit for bit")

    du, u_scale, c32, c64 = bench.ilqr_accuracy(dev)
    print(f"[13 mpc stack] iLQR cartpole T=40 x 15: max |du| f32 card vs f64 CPU {du:.3e} "
          f"(limit {ILQR_LIMIT}), input scale {u_scale:.4f}, cost {c32:.6f} vs {c64:.6f}")
    if not du <= ILQR_LIMIT:
        raise RuntimeError(f"iLQR inputs off the f64 run by {du:.3e}")

    # ``benchmarks/ilqr_bench.py``'s solve (batch 256, horizon 50, 10
    # iterations): the first captured solve equal to the eager one (or this
    # raises), every cost finite
    model, cost, x0s, us0 = ilqr_bench.problem(device=dev)
    res, _, _ = bench.matches_eager(
        lambda: ilqr(model, cost, x0s, us0, bench.CARTPOLE_DT, iters=10))
    finite = bool(torch.isfinite(res.cost).all())
    print(f"[13 mpc stack] iLQR batch 256 x T=50 x 10: captured == eager bit for bit, costs "
          f"finite: {finite}")
    if not finite:
        raise RuntimeError("ilqr_bench's solve ended with a non-finite cost")

    # the receding-horizon iLQR step (the benchmark's quadrotor_ilqr cell):
    # its first captured period equal to the eager one (or this raises), then
    # one replay and no new capture a period, the plan staying on the card
    from strided_tpu_torch import capture as cap, entry

    model, ctrl = entry.make_ilqr_controller(50, bench.DT, dev)
    step = entry.make_ilqr_step(model, ctrl, bench.DT)
    x = torch.as_tensor(np.random.default_rng(0).uniform(-0.3, 0.3, (4096, 12)),
                        dtype=torch.float32, device=dev)
    plan = ctrl.initial_plan((4096,))
    (x, plan), _, _ = bench.matches_eager(lambda: step(x, plan))
    captures, replays = cap.CAPTURES, cap.REPLAYS
    for _ in range(10):
        x, plan = step(x, plan)
    counts = (cap.CAPTURES - captures, cap.REPLAYS - replays)
    finite = bool(torch.isfinite(x).all() and torch.isfinite(plan).all())
    print(f"[13 mpc stack] iLQR MPC step 4096 x N=50: captured == eager bit for bit; ten "
          f"chained periods: {counts[0]} captures, {counts[1]} replays, finite: {finite}, "
          f"plan on {plan.device}")
    if counts != (0, 10) or not finite or plan.device.type != "cuda":
        raise RuntimeError("the iLQR MPC step did not run as one replay a period, or left "
                           "the card, or gave non-finite states")


def gates_phase(dev) -> None:
    """Phase 15: the engine's four size gates, as set from the card's
    crossovers (``config.py``; ``benchmarks/exp_crossover.py``,
    ``exp_mapgate.py``). At each gate, one size at it and one just below,
    through the public engine: ``(v + v.T) / 2`` (K2), ``ssum(v, 0)`` (K3),
    ``scale_into(dst, 0.999, transpose(v))`` (K4's map gate, and with the map
    gate at 1 K4's floor ``min_kernel_elements``). At the gate the wrapper
    must count its launch and the dispatch record name the kernel; below it
    no launch and the plain path; both equal to the plain version bit for
    bit (the sums within 1e-6 * rows * max|a|). Then ``sweeps --quick``
    (every record with both arms' eager and device times, no rate above the
    card's peak, the rotation litmus: the script's own checks of its
    measurement) and ``exp_contract`` in a process of its own
    (``contract`` and ``mul`` on ``transpose(v)``: no kernel before the
    product, the allocator's peak one result more). The full ladders run
    standalone (``python -m strided_tpu_torch.benchmarks.exp_crossover``,
    ``...exp_mapgate``)."""
    import math
    import subprocess
    import sys

    import strided_tpu_torch as st
    from strided_tpu_torch.benchmarks import sweeps
    from strided_tpu_torch.core import kernels_special as ks

    cfg = st.get_config()
    gen = torch.Generator(device=dev).manual_seed(15)
    randn = lambda *shape: torch.randn(*shape, device=dev, generator=gen)  # noqa: E731

    def expect(what, at_gate, call, want, kernel, record, tol=0.0):
        got, route = sweeps.route_of(call)
        ran = route["route"]
        e = _max_err(got, want)
        records = [route["expr"], route["reduce"], "K4 plan" if route["plan"] else ""]
        print(f"[15 gates] {what}: route {ran!r} (records: {', '.join(filter(None, records))}), "
              f"|engine - plain| {e:.3e} (limit {tol:g})")
        ok = ran.startswith(kernel) and record(route) if at_gate else ran == "plain"
        if not ok:
            raise RuntimeError(f"{what}: route {route}, expected {kernel if at_gate else 'plain'}")
        if not e <= tol:
            raise RuntimeError(f"{what}: off the plain version by {e:.3e} > {tol:g}")

    g = cfg.pair_kernel_min_elements
    n = math.isqrt(g - 1) + 1  # the least square side at the gate
    for side, at in ((n, True), (n - 1, False)):
        a = randn(side, side)
        v = st.strided(a)
        expect(f"(v + v.T) / 2 at {side}^2 (K2's gate {g})", at,
               lambda: st.to_array((v + st.transpose(v)) / 2),
               ks.pair_reference(a, scale_mode="div", scale=2.0), "K2",
               lambda r: r["expr"] == "pair-kernel")
    g = cfg.min_stream_reduce_elements
    for rows, at in ((g // 8192, True), (g // 8192 - 1, False)):
        a = randn(rows, 8192)
        expect(f"ssum(v, 0) at {rows}x8192 (K3's gate {g})", at,
               lambda: st.materialize(st.ssum(st.strided(a), 0)), a.sum(0, keepdim=True), "K3",
               lambda r: r["reduce"] == "stream-kernel",
               tol=1e-6 * rows * a.abs().max().item())
    for field, g in (("map_min_elements", cfg.map_min_elements),
                     ("min_kernel_elements", cfg.min_kernel_elements)):
        if field == "min_kernel_elements":
            st.set_config(map_min_elements=1)
        try:
            for rows, at in ((g // 8192, True), (g // 8192 - 1, False)):
                a = randn(rows, 8192)
                dst = st.strided(torch.empty(8192, rows, device=dev))
                expect(f"scale_into(dst, 0.999, transpose(v)) at {rows}x8192 ({field} {g})",
                       at, lambda: st.to_array(st.scale_into(dst, 0.999,
                                                             st.transpose(st.strided(a)))),
                       torch.mul(a.T, 0.999).contiguous(), "K4", lambda r: r["plan"] is not None)
        finally:
            st.set_config(map_min_elements=cfg.map_min_elements)
    print(f"[15 gates] chosen: min_kernel_elements {cfg.min_kernel_elements}, map_min_elements "
          f"{cfg.map_min_elements}, pair_kernel_min_elements {cfg.pair_kernel_min_elements}, "
          f"min_stream_reduce_elements {cfg.min_stream_reduce_elements}")

    rows = sweeps.run(quick=True)
    litmus, records = rows[0], rows[1:]
    if not litmus["ok"]:
        raise RuntimeError(f"sweeps: the litmus failed (an L2-resident rerun?): {litmus}")
    for r in records:
        arms = [r[f"{arm}{kind}_ms"] for arm in ("engine", "torch") for kind in ("", "_device")]
        if None in arms or any("no-measurement" in note for note in r["notes"]):
            raise RuntimeError(f"sweeps {r['family']} {r['size']}: an arm is missing or no "
                               f"measurement: {r}")
    print(f"[15 gates] sweeps --quick: {len(records)} records, both arms eager and device, "
          f"the litmus passed")
    # a process of its own: after the profiles of the earlier phases this
    # process's profiler has been seen to record no kernel at all
    proc = subprocess.run([sys.executable, "-m", "strided_tpu_torch.benchmarks.exp_contract"],
                          capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if len(lines) != 2:
        raise RuntimeError(f"exp_contract exited {proc.returncode}: {proc.stderr[-2000:]}")
    check, _timing = map(json.loads, lines)
    for name in ("contract", "mul"):
        c = check[name]
        print(f"[15 gates] {name} on transpose(v) 1024^2: kernels {len(c['kernels'])}, before "
              f"the product {c['before_product']}, peak growth {c['peak_growth']} B (limit "
              f"{c['limit']}), |result - f64| {c['max_abs_err_vs_f64']:.3e}")
    if not check["ok"] or proc.returncode != 0:
        raise RuntimeError(f"exp_contract: a copy before the product, or the peak grew: {check}")


def _kernel_names(fn) -> list:
    """The device kernels one call of ``fn`` ran, in order, from a profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
            if e.device_type == DeviceType.CUDA]


def tracing_process() -> None:
    """Phase 17 in a process of its own (``python3 chip_smoke.py
    --tracing-phase``), its output printed here; raises when it fails."""
    import os
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tracing-phase"],
                          capture_output=True, text=True, timeout=600)
    print(proc.stdout, end="")
    if proc.returncode != 0:
        raise RuntimeError(f"phase 17 exited {proc.returncode}: {proc.stderr[-3000:]}")


def tracing_phase(dev) -> None:
    """Phase 17: the port's spans (``utils/profiling.py``). The captured MPC
    step at batch 16384 with tracing off (no marker in a profiled replay),
    then on (a capture of its own, ``qp.solve`` and ``model.step`` each
    between their two markers once a replay, equal to the unmarked step bit
    for bit); a graph the caller captures itself, with tracing on, holds no
    marker; the spans' counts and parents."""
    from strided_tpu_torch import capture as cap
    from strided_tpu_torch.entry import make_controller, make_step
    from strided_tpu_torch.mpc.qp import qp_solve
    from strided_tpu_torch.utils import profiling

    model, ctrl = make_controller(horizon=50, dt=0.02, device=dev)
    step = make_step(model, ctrl, 0.02)
    x = torch.as_tensor(np.random.default_rng(0).uniform(-0.3, 0.3, (16384, 12)),
                        dtype=torch.float32, device=dev)
    captures = cap.CAPTURES
    plain = step(x)
    names_off = _kernel_names(lambda: step(x))
    profiling.enable()
    try:
        marked = step(x)
        names_on = _kernel_names(lambda: step(x))
        ids = {v: k for k, v in profiling.sections().items()}
        caller = torch.cuda.CUDAGraph()
        xq = (x - ctrl.x_eq).contiguous()
        with cap.disable_capture():
            qp_solve(ctrl.qp, xq, ctrl.u_min, ctrl.u_max, ctrl.admm_iters)
            torch.cuda.synchronize()
            with torch.cuda.graph(caller, capture_error_mode="thread_local"):
                qp_solve(ctrl.qp, xq, ctrl.u_min, ctrl.u_max, ctrl.admm_iters)
        names_caller = _kernel_names(caller.replay)
        for _ in range(20):
            step(x)
        torch.cuda.synchronize()
        totals = profiling.totals()
    finally:
        profiling.disable()
    markers = [n for n in names_on if "strided_section_marker" in n]
    want = [f"strided_section_marker<{ids.get(s)}, {e}>" for s in ("qp.solve", "model.step")
            for e in (0, 1)]
    print(f"[17 tracing] captures {cap.CAPTURES - captures} (off, on); kernels a replay: off "
          f"{len(names_off)}, on {len(names_on)}; markers on: {markers}; sections "
          f"{profiling.sections()}; caller's graph kernels {len(names_caller)}, markers "
          f"{sum('strided_section_marker' in n for n in names_caller)}")
    if cap.CAPTURES != captures + 2:
        raise RuntimeError("turning tracing on did not capture anew")
    if any("strided_section_marker" in n for n in names_off + names_caller):
        raise RuntimeError("a marker in a graph captured with tracing off or by the caller")
    if len(markers) != 4 or not all(any(w in n for n in markers) for w in want):
        raise RuntimeError(f"expected {want} once each in a traced replay, got {markers}")
    if len(names_on) != len(names_off) + 4 or not torch.equal(plain, marked):
        raise RuntimeError("the traced step is not the untraced one plus four markers")
    for name in ("capture.replay", "capture.miss", "capture.signature", "capture.launch",
                 "capture.record", "qp.solve", "model.step"):
        t = totals.get(name)
        said = "none" if t is None else f"{t['count']} calls, parents {t['parents']}"
        print(f"[17 tracing] {name}: {said}")
    if totals["capture.replay"]["count"] < 20 or "capture.replay" not in \
            totals["capture.launch"]["parents"]:
        raise RuntimeError(f"the replay spans are not as documented: {totals}")
    profiling.reset()


def plant_process() -> None:
    """Phases 18 and 19 in a process of their own (``python3 chip_smoke.py
    --plant-phase``; their profiles need a profiler that still records
    kernels), its output printed here; raises when it fails."""
    import os
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--plant-phase"],
                          capture_output=True, text=True, timeout=600)
    print(proc.stdout, end="")
    if proc.returncode != 0:
        raise RuntimeError(f"phases 18-19 exited {proc.returncode}: {proc.stderr[-3000:]}")


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place of their dtype (f32 or f64): the
    distance between the two values' positions in the ordered line of that
    dtype (finite values)."""
    bits, sign = ((torch.int32, 0x7FFFFFFF) if a.dtype == torch.float32
                  else (torch.int64, 0x7FFFFFFFFFFFFFFF))

    def ordered(t):
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, -(i & sign), i)

    return (ordered(a) - ordered(b)).abs()


def plant_phase(dev) -> None:
    """Phase 18 (the module docstring): prints its checks; raises on a
    failed one."""
    import dataclasses

    from strided_tpu_torch import capture as cap
    from strided_tpu_torch.entry import make_controller, make_step
    from strided_tpu_torch.models import hover_input, hover_state, quadrotor, rk4_step
    from strided_tpu_torch.models import quadrotor_rk4 as qr

    dt = 0.02
    declines, launches = qr.DECLINES["autodiff"], qr.LAUNCHES
    model, ctrl = make_controller(horizon=50, dt=dt, device=dev)
    print(f"[18 plant] make_controller: DECLINES['autodiff'] +{qr.DECLINES['autodiff'] - declines}"
          f", LAUNCHES +{qr.LAUNCHES - launches} (the linearisation's jacfwd runs the eager step)")
    if qr.DECLINES["autodiff"] != declines + 1 or qr.LAUNCHES != launches:
        raise RuntimeError("the linearisation did not decline the kernel once")
    xe, ue = hover_state(device=dev), hover_input(device=dev)
    A, B = model.linearize(xe, ue, dt)
    A0, B0 = dataclasses.replace(model, fused_step=None).linearize(xe, ue, dt)
    same = torch.equal(A, A0) and torch.equal(B, B0)
    print(f"[18 plant] the hover linearisation's A and B equal to the eager plant's bit for bit: "
          f"{same}")
    if not same:
        raise RuntimeError("the linearisation changed with the fused step")

    other = quadrotor(m=1.7, g=9.7, Jx=0.013, Jy=0.011, Jz=0.023)
    f32, f64 = torch.float32, torch.float64
    for batch, body, h, dtype, how in (
            ((1,), model, dt, f32, ""), ((257,), model, dt, f32, ""),
            ((16384,), model, dt, f32, ""), ((4, 64), model, dt, f32, ""),
            ((4096,), other, 0.01, f32, ""), ((16384,), model, dt, f64, ""),
            ((4096,), other, 0.01, f64, ""), ((16384,), model, dt, f32, "strided"),
            ((16384,), model, dt, f64, "strided")):
        x, u, near = qr.stress_inputs(batch, dev, seed=18 + sum(batch), dtype=dtype)
        if how:  # x read through a row stride of 24, u through rollout's slice us[..., t, :]
            x = torch.cat([x, x], -1)[:, :12]
            u = torch.stack([u, u, u], -2)[..., 1, :]
        launches = qr.LAUNCHES
        got = body.step(x, u, h)
        want = rk4_step(body.dynamics, x, u, h)
        torch.cuda.synchronize()
        if qr.LAUNCHES != launches + 1 or got.shape != want.shape:
            raise RuntimeError(f"{batch}: the step did not launch the kernel once")
        agree = qr.within(got, want)
        rel = (got.double() - want.double()).abs() / (want.double().abs() + 1)
        fin = torch.isfinite(got) & torch.isfinite(want)
        ulps = _ulps(got, want).masked_fill(~fin, 0)
        at_clamp = ulps.reshape(-1, 12)[near].max().item()
        widest = rel.masked_fill(~fin, 0).max().item()
        what = (f"batch {batch} {str(dtype)[6:]}" + (f", m 1.7, dt {h}" if body is other else "")
                + (", strided x and u" if how else ""))
        print(f"[18 plant] {what}: |kernel - eager| / (|eager| + 1) widest {widest:.3e} "
              f"(limit {qr.TOLERANCE[dtype]:.0e}), widest gap {ulps.max().item()} ulps "
              f"({at_clamp} on the "
              f"{near.numel()} rows at the clamp), bit for bit "
              f"{(got == want).double().mean().item():.6f} of the elements, non-finite "
              f"{int((~torch.isfinite(got)).sum())}")
        if not bool(agree.all()):
            raise RuntimeError(f"{what}: {int((~agree).sum())} elements off the eager "
                               f"step by more than {qr.TOLERANCE[dtype]:.0e} (|eager| + 1)")

    xs = torch.as_tensor(np.random.default_rng(0).uniform(-0.3, 0.3, (16384, 12)),
                         dtype=torch.float32, device=dev)
    launches, replays = qr.LAUNCHES, cap.REPLAYS
    step = make_step(model, ctrl, dt)
    first = step(xs)
    at_capture = qr.LAUNCHES - launches
    for _ in range(10):
        step(xs)
    torch.cuda.synchronize()
    print(f"[18 plant] captured step: LAUNCHES +{at_capture} at its first call (warm-up and "
          f"capture), +{qr.LAUNCHES - launches - at_capture} over {cap.REPLAYS - replays - 1} "
          f"more replays")
    if at_capture != 2 or qr.LAUNCHES != launches + 2 or cap.REPLAYS != replays + 11:
        raise RuntimeError("the captured step did not launch the kernel at warm-up and "
                           "capture alone")
    with cap.disable_capture():
        eager_first = step(xs)
    eager_model = dataclasses.replace(model, fused_step=None)
    step_eager = make_step(eager_model, ctrl, dt)
    plain_first = step_eager(xs)
    gap = ((first - plain_first).abs() / (plain_first.abs() + 1)).max().item()
    print(f"[18 plant] captured step, kernel plant: equal to its eager call bit for bit "
          f"{torch.equal(first, eager_first)}; against the captured step with the eager plant "
          f"{gap:.3e} (limit 1e-6)")
    if not torch.equal(first, eager_first) or not gap <= 1e-6:
        raise RuntimeError("the captured step with the kernel is off its eager call or off "
                           "the eager plant")
    key, _ = cap.signature((xs,), {})
    graphs = {"kernel": step.cache.get(key)[0], "eager": step_eager.cache.get(key)[0]}
    ops = {name: _kernel_names(g.replay) for name, g in graphs.items()}
    plant_ops = {name: sum("quadrotor_rk4" in n for n in o) for name, o in ops.items()}
    print(f"[18 plant] captured step, device operations a replay: kernel plant "
          f"{len(ops['kernel'])} ({plant_ops['kernel']} of them the plant kernel), eager plant "
          f"{len(ops['eager'])} ({plant_ops['eager']})")
    if plant_ops != {"kernel": 1, "eager": 0}:
        raise RuntimeError(f"a replay of the captured step ran the plant kernel "
                           f"{plant_ops['kernel']} times with the kernel plant and "
                           f"{plant_ops['eager']} with the eager plant, not 1 and 0")


def _jac_gap(got, want) -> float:
    """Widest ``|got - want| / (|want| + 1)``: equal values and NaN in both
    count as no gap, a NaN in one alone as an infinite one."""
    gap = (got.double() - want.double()).abs() / (want.double().abs() + 1)
    same = (got == want) | (got.isnan() & want.isnan())
    return gap.masked_fill(same, 0).nan_to_num(float("inf")).max().item()


def jacobian_phase(dev) -> None:
    """Phase 19 (the module docstring): prints its checks; raises on a
    failed one."""
    import dataclasses

    from strided_tpu_torch import capture as cap
    from strided_tpu_torch.entry import make_controller, make_ilqr_controller, make_ilqr_step
    from strided_tpu_torch.models import hover_input, hover_state, linearize, quadrotor
    from strided_tpu_torch.models import quadrotor_jac as qj
    from strided_tpu_torch.models import quadrotor_rk4 as qr

    dt = 0.02
    declines, launches = dict(qj.DECLINES), qj.LAUNCHES
    model, _ = make_controller(horizon=50, dt=dt, device=dev)
    xe, ue = hover_state(device=dev), hover_input(device=dev)
    A, B = model.linearize(xe, ue, dt)
    plain = dataclasses.replace(model, fused_step=None, fused_linearize=None)
    A0, B0 = plain.linearize(xe, ue, dt)
    untouched = dict(qj.DECLINES) == declines and qj.LAUNCHES == launches
    same = torch.equal(A, A0) and torch.equal(B, B0)
    print(f"[19 plant jacobian] make_controller and Model.linearize at hover: the kernel "
          f"neither launched nor asked {untouched}; A and B equal to the eager plant's bit for "
          f"bit {same}")
    if not (untouched and same):
        raise RuntimeError("the one-point linearisation reached the Jacobian kernel or changed")

    def eager(body, xs, us, h):  # jacfwd refuses a dual of a broadcast tensor on the card
        return linearize(dataclasses.replace(body, fused_step=None, fused_linearize=None),
                         xs, us.contiguous(), h)

    other = quadrotor(m=1.7, g=9.7, Jx=0.013, Jy=0.011, Jz=0.023)
    for what, body, h, shape in (("4096 points", model, dt, (4096,)),
                                 ("trajectory slice 64 x 50", model, dt, (64, 51)),
                                 ("main path 4096 x 50", model, dt, (4096, 51)),
                                 ("u broadcast", model, dt, (4096,)),
                                 ("m 1.7, dt 0.01", other, 0.01, (4096,))):
        gaps = {}
        for dtype in (torch.float64, torch.float32):
            xs, us, near = qr.stress_inputs(shape, dev, seed=19 + len(what), dtype=dtype)
            at_clamp = torch.zeros(xs.shape[:-1].numel(), dtype=torch.bool, device=dev)
            at_clamp[near] = True
            at_clamp = at_clamp.reshape(xs.shape[:-1])
            if len(shape) == 2:  # the iteration's xs[:, :-1]; the main path's us is contiguous
                xs, at_clamp = xs[:, :-1], at_clamp[:, :-1]
                us = us[:, :-1].contiguous() if shape[0] == 4096 else us[:, 1:]
            if what == "u broadcast":
                us = us[3].expand(*xs.shape[:-1], 4)
            launches = qj.LAUNCHES
            got = linearize(body, xs, us, h)
            if qj.LAUNCHES != launches + 1:
                raise RuntimeError(f"{what}: base.linearize did not launch the kernel once")
            want64 = eager(body, xs.double(), us.double(), h)
            gaps[dtype] = [_jac_gap(g, w) for g, w in zip(got, want64)]
            if dtype == torch.float32:
                plain32 = eager(body, xs, us, h)
                gaps["off"] = [int((~qr.within(g, w)).sum()) for g, w in zip(got, plain32)]
                gaps["clamp"] = [_jac_gap(g[at_clamp], w[at_clamp]) for g, w in zip(got, want64)]
                gaps["jacfwd"] = [_jac_gap(g[at_clamp], w[at_clamp])
                                  for g, w in zip(plain32, want64)]
                gaps["bitwise"] = [((g == w) | (g.isnan() & w.isnan())).double().mean().item()
                                   for g, w in zip(got, plain32)]
        print(f"[19 plant jacobian] {what}: (A, B) f64 kernel widest |got - f64 jacfwd| / "
              f"(|f64| + 1) {gaps[torch.float64][0]:.3e}, {gaps[torch.float64][1]:.3e} (limit "
              f"1e-12); f32 kernel elements off f32 jacfwd by more than "
              f"{qr.TOLERANCE[torch.float32]:.0e} (|want| + 1) {gaps['off'][0]}, "
              f"{gaps['off'][1]} (limit 0), bit for bit {gaps['bitwise'][0]:.6f}, "
              f"{gaps['bitwise'][1]:.6f} of the elements; on the {int(at_clamp.sum())} rows at "
              f"the clamp, widest gap to f64 jacfwd: f32 kernel {gaps['clamp'][0]:.3e}, "
              f"{gaps['clamp'][1]:.3e}, f32 jacfwd {gaps['jacfwd'][0]:.3e}, "
              f"{gaps['jacfwd'][1]:.3e} (limit twice)")
        if not max(gaps[torch.float64]) <= 1e-12 or any(gaps["off"]) or not all(
                k <= 2 * j for k, j in zip(gaps["clamp"], gaps["jacfwd"])):
            raise RuntimeError(f"{what}: the Jacobian kernel is off jacfwd: {gaps}")

    model, ctrl = make_ilqr_controller(50, dt, dev)
    step = make_ilqr_step(model, ctrl, dt)
    x = torch.as_tensor(np.random.default_rng(0).uniform(-0.3, 0.3, (4096, 12)),
                        dtype=torch.float32, device=dev)
    plan = ctrl.initial_plan((4096,))
    launches, replays = qj.LAUNCHES, cap.REPLAYS
    first = step(x, plan)
    at_capture = qj.LAUNCHES - launches
    for _ in range(10):
        step(x, plan)
    torch.cuda.synchronize()
    print(f"[19 plant jacobian] captured iLQR step: LAUNCHES +{at_capture} at its first call "
          f"(warm-up and capture), +{qj.LAUNCHES - launches - at_capture} over "
          f"{cap.REPLAYS - replays - 1} more replays")
    if at_capture != 2 or qj.LAUNCHES != launches + 2 or cap.REPLAYS != replays + 11:
        raise RuntimeError("the captured iLQR step did not launch the Jacobian kernel at "
                           "warm-up and capture alone")
    with cap.disable_capture():
        eager_first = step(x, plan)
    same = all(torch.equal(a, b) for a, b in zip(first, eager_first))
    key, _ = cap.signature((x, plan), {})
    ops = _kernel_names(step.cache.get(key)[0].replay)
    jac_ops = sum("quadrotor_jac" in n for n in ops)
    print(f"[19 plant jacobian] captured iLQR step: equal to its eager call bit for bit {same}; "
          f"{len(ops)} device operations a replay, {jac_ops} of them the Jacobian kernel")
    if not same or jac_ops != 1:
        raise RuntimeError("the captured iLQR step is off its eager call or did not run the "
                           "Jacobian kernel once a replay")


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--slice-c-rank"]:
        slice_c_rank(*sys.argv[2:])
    elif sys.argv[1:2] == ["--tracing-phase"]:
        tracing_phase("cuda")
    elif sys.argv[1:2] == ["--plant-phase"]:
        plant_phase("cuda")
        jacobian_phase("cuda")
    else:
        main()
