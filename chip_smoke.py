"""Smoke test of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main path, one closed-loop step of the scenario-batched
12-state quadrotor MPC per control period, on the card at the headline size
(horizon 50, D = N*m = 200, ADMM-6 at rho=8, f32, batch 16384). Phases:

1. device: a CUDA device is required; prints its name and power limit;
2. build: compiles the CUDA sources (strided_tpu_torch/csrc) with nvcc, and
   prints ptxas's registers, stack frame and spills of every K1, K3, K4,
   transpose-pair probe, rank-4 reversal and plant kernel; K1's 64-row
   instance (the main path's), every instance of K3's program kernel, of
   K4's multi-axis map (``tile_box_v``) and
   every ``rev4_tiles`` and ``pair_tiles`` instance must not spill, and
   every ``rev4_tiles``, ``rev4_mma``, ``pair_tiles`` and ``tile_box_v``
   instance must be built; the plant kernel's f32 and f64 instances must be
   built and not spill;
3. kernel vs plain: the fused-ADMM kernel against its plain PyTorch version
   on the same inputs, and both against the same iterations in f64: the
   main-path QP (D=200) at B = 16384, at 64 * #SMs +- 1 (one row past or
   short of a whole wave of 64-row tiles), 63, 65, 33, 31 and 1; random QPs
   at D = 1, 12, 199, 201, 208 (the last width of the 64-row tiles), 209
   (the first of the wide instance's 16-row ones), 300 at B = 16 * #SMs +
   1, 400 and 512 (S streamed in panels), and 200 with z0 outside the
   bounds;
4. accuracy gate: first applied input within 1e-4 and horizon plan within
   0.15 of a converged f64 ADMM oracle, through the kernel path, the plan
   captured (one CUDA-graph replay, ``strided_tpu_torch.capture``);
5. main path: a 50-step closed loop at batch 16384 through
   ``strided_tpu_torch.entry.make_controller``, run captured (the whole loop
   one CUDA graph) and eagerly (``capture.disable_capture()``) on the same
   state: the two must agree bit for bit; the eager loop must launch K1
   and the plant kernel once per step each (a replay launches from the
   graph and counts nothing), and a profiled replay must run
   ``fused_admm_kernel`` and ``quadrotor_rk4_kernel`` once per step each
   (the plant's row of the JSON line gives that count a step); the loop must stay finite, shrink the state, and agree with the
   plain path, which must take an entry of its own (the config is in the
   key), after which the kernel's entry replays again, equal; a captured
   function that reads the host must raise, not run eagerly;
6. times (CUDA events after warm-up): the step captured (``entry.make_step``,
   one replay a step), eagerly, its first call (warm-up, capture,
   instantiation) and as device time alone (``bench.step_device_ms``: chained
   steps in one CUDA graph, after the captured step is held bit for bit
   against the eager step), with the kernel on and off;
   the kernel against its plain version and six cuBLAS products of the same
   shapes under IEEE FP32 (``product_ms``); then ``benchmarks/exp_admm.py``:
   K1, the tile designs it was chosen over and S streamed through its ring
   in panels of 32 and 64 rows, each checked as in phase 3 and timed at 6
   and 12 iterations;
7. wide QP: ``qp_solve`` at horizon 150 (D = N*m = 600, above the kernel's
   MAX_D = 512) with the kernel enabled must take the loop path and agree
   with it, finite;
8. the strided engine's main path at full size, through its entry points:
   the flagship ``(v + v.T) / 2`` at 4000^2 and 8192^2 f32 (and ``3v + 2v.T``,
   ``v - v.T``, bf16 at 4096^2, ragged 4001) through the tile-pair kernel;
   ``ssum(v, axis=0)``, ``smax(transpose(v), axis=1)`` and an int32 sum
   through the stream reduction; ``permutedims_into`` of an 8192^2
   transpose and a 64x128x64x128 permute, the scrambled map
   ``smap(x*3 + y, v.T, w)`` and (``kernel_reductions`` on) the int32
   ``out = 3*old + sum over axis 0`` through the tile executor, and
   ``smean(v, 0)`` through K3's program kernel. Each checks the dispatch
   record, and the result against the kernel's plain PyTorch version on the
   same inputs (bit-exact, except f32 sums: 1e-6 * rows * max|f(a)|, the
   summation order differs); the launch counts, and K3's and K4's by the
   kernel each launcher reports it ran (for K3 with its width), are read
   for this phase alone; then coverage off the main path: every program op
   through K4 (f32, bf16), bodies wider than ``ewise.CREG`` registers
   through K4's scalar interpreter, K4's per-element maps; K3 with every
   fold on f32, bf16 and int32 rows that are and are not whole 16-byte
   runs, and every program kernel: bodies of 1, 2, 3 and 5 registers on
   f32, bf16 and int32 leaves, float- and int-valued, every fold, on 8
   columns a thread and on one (ragged rows, an unaligned base); K4's
   multi-axis map (``multi_axis_checks``, limit 0): the README's
   four-permute sum at 96^4 (f32, bf16, int32), four inputs at 37x96x45x70,
   two- and three-input rank-3 maps, one with a broadcast row, and a rank-5
   map with four staging dims, which stays on ``tile_t2d_v``;
9. engine times: each kernel's wrapper against its plain version, in turns
   (kernel, plain, plain, kernel; with the one PyTorch call that computes
   the same function inside the turns where there is one), with GB/s; K2
   also at 1024^2 and 2048^2, the data for re-setting the TPU-valued size
   gates; the flagship through its entry point (``st.to_array((v + v.T) /
   2)``, host work included) against eager ``(a + a.T) / 2``; K3's f32, max,
   int32 and bf16 sums, ``st.smean(v, 0)`` (f32, bf16) against ``a.mean(0)``,
   programs of 3 and 5 registers, an int32 ``t*3 + 1``, an instruction
   ladder (0, 1, 2, 3, 9), four of those programs once more on one column
   a thread (an unaligned base), and K4's maps on the staged 8192^2 layout
   (the instruction ladder, bf16, int32 ``where``, the scalar interpreter),
   and the four-permute sum at 96^4 through the multi-axis map against its
   plain version, the PyTorch expression and ``tile_t2d_v``
   (``multi_axis_times``), each checked against its plain version first, and timed eagerly (every
   ``ms`` of the JSON line is an eager time) and as device time alone
   (``bench.graph_ms``, CUDA graphs; the ``device_*`` keys);
10. linalg at full size: ``mul`` f32 8192^2 through cuBLAS (equal to the
    plain ``alpha * a @ b + beta * c`` under IEEE FP32, and within 1e-2 of
    the f64 product: TF32 products would miss by ~4e-2), a transposed
    operand against its plain counterpart, a bf16 ``mul`` (bf16 operands
    run natively: the single-pass product, within its f32 summation-order
    bound of the plain one, then one rounding), ``axpby(0.5, transpose(v), 0.5, v)`` at 8192^2
    through K2 (record ``pair-kernel``, exact), the int32 generic ``mul`` at
    512^3 with ``kernel_reductions`` off and on (exact, route recorded) and
    ``v @ w``; K2's launches read for this phase alone; times of ``mul`` and
    ``axpby`` against plain;
11. the transpose-pair probes: ``exp_sym`` (every variant at 8192^2, each
    checked into a NaN-filled output) and ``exp_pair_rect`` (at 8064^2)
    through their ``main``, with the four probe kernels' launches read for
    that run alone; each kernel at every tile shape (``pair_tiles`` in all
    four modes: full, copy, and each skipping the diagonal's second write),
    written into a NaN-filled output made just before the call, exactly
    equal to its plain version (NaN pattern included for ``rect_pairs``)
    and timed against it in turns, with the one PyTorch call computing the
    same function inside the turns (``x.T.contiguous()``, ``torch.lerp(x,
    x.T, 0.5)``, ``x.clone()`` for the copy mode); both probe modules once
    more as ``python -m``;
12. the streaming-reduction and rank-4 reversal probes: ``exp_reduce`` (at
    8192^2), ``exp_perm2``, ``exp_perm4`` and ``exp_perm_probe`` (at 64^4)
    through their ``main``, with the four new kernels' launches (and
    ``transpose_tiles``' for ``exp_perm4``'s 2-D transposes) read for that run
    alone; ``stream_sum_slabs`` at every slab within K3's tolerance of the
    plain and the f64 sum, and equal to ``a[0]`` with compute off; every
    reversal variant (``rev4_tiles``, ``rev4_mma`` at both precisions,
    ``rev4_async``, the plane copy), written into a NaN-filled output made
    just before the call (here and in the scripts' own checks), exactly
    equal to its plain version; each timed against it in turns; the four
    modules once more as ``python -m``;
13. the rest of the MPC stack (Riccati, rollouts, iLQR; no kernel of its
    own) at the reference's sizes: the quadrotor's hover LQR gain at N=50 in
    f32 within 1e-4 of the f64 CPU gain; 4096 double-pendulum rollouts of
    100 steps, ``rollout_final`` equal to the last state of ``rollout`` bit
    for bit, the first 64 within 1e-4 of the same rollouts in f64 on the
    CPU, through the captured entry points: the first captured call equal to
    the eager one bit for bit, timed captured, eagerly and as device time,
    with the first call's time and its capture's, and profiled eagerly and
    captured (kernels a call, their device time, the device's busy share);
    cartpole iLQR (T=40, 15 iterations) in f32 within 1e-3 of f64 on the
    CPU; ``benchmarks/ilqr_bench.py`` (batch 256, horizon 50, 10
    iterations): the first captured solve equal to the eager one bit for
    bit, every cost finite, captured, eager and device time and solves/s,
    the first call and its capture, the memory the graph took, and a solve
    profiled captured (the eager solve's 90k host launches under the
    profiler would be most of the phase's time);
14. slice C, the multi-GPU layer (``strided_tpu_torch.parallel``), at
    BASELINE config 5's size (16384 scenarios, N=50, ADMM-20, f32), the
    step and the consensus captured on NCCL (one CUDA-graph replay a call a
    rank, K1 and the ``all_reduce`` inside it): (a) one process, a 1-rank
    NCCL mesh: counted eagerly (inside ``disable_capture()``), the step
    equal bit for bit to ``ctrl.control`` + ``model.step`` on the same state
    and the consensus to their mean, K1 launched once a call; then captured
    and held bit for bit against the eager calls (``bench.matches_eager``,
    two captures, K1 launched once by each warm-up and once by each
    capture), each profiled over replays with ``fused_admm_kernel`` found
    in them; ``sharded_rollout`` replaying the captured ``rollout``
    (one capture, two replays, equal to eager); ``benchmarks/scenario_mpc.py``'s
    row (the chained step captured, with its eager, device and first-call
    times) and its chained step profiled captured and eagerly; (b) two ranks
    (``slice_c_ranks``, this script's own rank entry through
    ``parallel.multiproc.spawn``: NCCL with two cards or more, else gloo
    asked for, whose calls run eagerly and whose captured calls must be
    refused, printed as "eager (gloo)"), each running the dry-run surface
    (``multiproc.dryrun_checks``) and then at full size (``slice_c_full``)
    the step (each rank's rows within 1e-5 of the unsharded step's and 2e-4
    of K1's plain version, the ADMM loop, K1 once a rank eagerly; over NCCL
    the captured step and consensus equal to the eager ones bit for bit),
    the consensus (within 1e-5 of the oracle's mean), ``sharded_batched_pair`` on (4,
    4096, 4096) (K2 twice a rank, equal to ``pair_reference``) and
    ``sharded_stream_sum`` on (16384, 8192) (K3 once a rank on its
    2^26-element block, identity route, within 1e-6 rows max|a| of the f64
    sum), with each rank's times (captured and eager) and, over NCCL, each
    rank's ``scenario_mpc`` row and the profile of its chained step.
    Two ranks on one card share it: their times are no scaling number.
15. the engine's four size gates (``config.py``, set from the card's
    crossovers): at each gate one size at it and one just below through the
    public engine (K2's ``(v + v.T) / 2``, K3's ``ssum(v, 0)``, K4's
    ``scale_into(dst, 0.999, transpose(v))`` at ``map_min_elements`` and,
    with the map gate at 1, at ``min_kernel_elements``): the kernel's
    launch counted and its dispatch record at the gate, the plain path
    below, both equal to the plain version (bit for bit; the sums within
    1e-6 * rows * max|a|); ``benchmarks/sweeps.py --quick`` (every record
    with both arms eagerly and as device time, no rate above the card's
    peak, the rotation litmus); ``benchmarks/exp_contract.py`` (as ``python
    -m``, a process of its own: its profiler must see the kernels): ``contract``
    and ``mul`` read a lazily transposed operand with no copy before the
    product; and one line of the chosen gates.
16. the reference's precision name "default" and what takes it: the
    single-pass bf16 product (``config.matmul``, the route it took printed)
    against its plain version (operands rounded to bf16, IEEE FP32) at
    16384x200 @ 200x200 and 4096^2, within the f32 summation-order bound
    2 k 2^-24 (|a| @ |b|) elementwise; ``qp_solve`` on the main path's QP
    with ``coarse_iters`` 0 of 20 (K1 once, equal bit for bit to K1 on the
    IEEE FP32 ``g`` and warm start) and 12 of 20 (no K1), and one coarse
    iteration against the plain product's within alpha times that bound;
    ``closed_loop`` at batch 16384 with ``admm_coarse_iters`` 12 of 20,
    captured and eager bit for bit, no K1 launch; ``mul`` at "default" at
    2048^2 against the plain product; ``symmetrize(x, 256)`` and
    ``symmetrize(x, tile=64)`` equal to ``(x + x.T) / 2`` at 4000^2 bit for
    bit; ``python -m strided_tpu_torch.bench`` in a process of its own
    (exit 0, its last line a JSON object with ``metric``, ``value``,
    ``unit``, ``vs_baseline``, printed here);
17. the port's spans (``utils/profiling.py``), in a process of its own
    (``python3 chip_smoke.py --tracing-phase``; this process's profiler
    stops recording kernels after phases 5-14's profiles): a span's host
    cost with tracing off and on, net of the empty loop; the captured step at batch 16384 with tracing off
    (no marker in a profiled replay) and on (a capture of its own; each of
    ``qp.solve``'s and ``model.step``'s two markers once a replay; equal
    to the unmarked step bit for bit); both graphs' device time in turns;
    no marker in a graph the caller captures itself; the spans' totals;
18. the quadrotor's RK4 plant kernel (``models/quadrotor_rk4.py``), in a
    process of its own (``python3 chip_smoke.py --plant-phase``):
    ``make_controller``'s linearisation declining the kernel once
    (``DECLINES``), the hover ``A`` and ``B`` equal to the eager plant's bit
    for bit; the kernel against the eager step (``rk4_step(model.dynamics,
    ...)``) in f32 at batch 1, 257, 16384 and (4, 64), at 4096 for another
    body (m = 1.7, dt = 0.01), in f64 at 16384 and for the other body, and
    at 16384 on strided operands (x through a row stride of 24, u as
    rollout's slice ``us[..., t, :]``) in both dtypes, on random states with
    large angles, every eighth pitch within 1e-7 of +-pi/2 (the clamp), each
    element within ``quadrotor_rk4.TOLERANCE`` (1e-6 (|eager| + 1) in f32,
    1e-13 in f64), with the widest gap in ulps and the share equal bit for
    bit; the plant alone, kernel and eager, as device time through CUDA
    graphs in turns; the captured step launching the kernel once at its
    warm-up and once at its capture and never at a replay (``LAUNCHES``),
    equal to its eager call bit for bit; the captured step's device
    operations a replay with the kernel and with the eager plant (exactly
    one plant kernel with the kernel plant, none with the eager one), and
    each graph's time in turns.

Any failure raises, so the exit code is non-zero. The last two lines are a
JSON object describing the thirteen kernels (each with its time, its plain
version's, its bound on an H100 SXM from NVIDIA's data sheet, and the time
of one PyTorch call computing the same function where there is one), then
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

ATOL_KERNEL = 2e-4  # f32 summation order differs from cuBLAS; |g| reaches ~1.4e3
ATOL_LOOP = 1e-3  # closed-loop states, kernel vs plain path, 50 steps (f32)
# NVIDIA H100 SXM data sheet: HBM3 rate, FP32 off the tensor cores (TF32
# fails K1's gate and mul's 1e-2 check, so it sets no bound), dense bf16 on
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12


def bound(nbytes: float, ops: float = 0.0, ops_per_s: float = FP32_OPS_PER_S) -> dict:
    """The least time the card could take for the work: the larger of the
    bytes it must move (each input read once, each output written once) over
    the HBM rate and its operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    if t_ops > t_bytes:
        return {"bound_ms": t_ops, "bound_by": "operations"}
    return {"bound_ms": t_bytes, "bound_by": "bytes"}


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
    plant_k = [spill for src, _name, _regs, spill in report if src == "quadrotor_rk4"]
    if len(plant_k) != 2 or any(plant_k):
        raise RuntimeError(f"ptxas: expected the plant kernel's f32 and f64 instances without "
                           f"spills, got spill stores {plant_k}")

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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (16384, 64 * sms - 1, 64 * sms + 1, 65, 63, 33, 31, 1):
        x = torch.as_tensor(rng.uniform(-0.3, 0.3, (B, 12)), dtype=torch.float32,
                            device=dev)
        max_err = max(max_err, check(*_admm_inputs(ctrl, x)))
    for B, D in ((65, 1), (33, 12), (65, 199), (65, 201), (65, 208), (65, 209),
                 (16 * sms + 1, 300), (33, 400), (65, 512)):
        check(*_random_inputs(rng, B, D, dev))
    check(*_random_inputs(rng, 65, 200, dev, z0_scale=2.0))

    launches, plant_launches = main_path_phase(dev, card)
    k1 = k1_times(dev, ctrl, rng, 16384, card, rho=rho, alpha=alpha, iters=iters)

    wide_qp_check(dev)
    engine = engine_phases(dev, card)
    linalg_phase(dev, card)
    probes = probe_phases(dev, card)
    last = reduce_perm_phase(dev, card)
    mpc_stack_phase(dev, card)
    slice_c_phase(dev, card)
    gates_phase(dev, card)
    precision_phase(dev, card)
    tracing_process()
    plant = {**plant_process(), "launches": plant_launches}

    print(json.dumps({"kernels": [{
        "name": "fused_admm",
        "route": "cuda",
        "source": "strided_tpu_torch/csrc/fused_admm.cu",
        "replaces": "strided_tpu/mpc/qp.py:157",
        "launches": launches,
        "max_abs_err": max_err,
        **k1,
        "library_ms": None,
    }, *engine, *probes, *last, plant]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def main_path_phase(dev, card) -> tuple:
    """Phases 4 and 5: the accuracy gate through the captured plan, then the
    captured 50-step closed loop at batch 16384 held against the eager one
    (see the module docstring). Returns the eager loop's K1 launches and the
    plant kernels a step of the profiled replay runs; raises on any failed
    check."""
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
    t = time.perf_counter()
    xs, us = loop()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    same = torch.equal(xs, xs_e) and torch.equal(us, us_e)
    _ms, _ops, rows = device_profile(loop, calls=1, warmup=1)  # one replay, profiled
    k1_replayed = sum(n for _t, n, name in rows if "fused_admm_kernel" in name)
    plant_replayed = sum(n for _t, n, name in rows if "quadrotor_rk4_kernel" in name)
    n0 = xs[:, 0].norm(dim=-1).mean().item()
    n1 = xs[:, -1].norm(dim=-1).mean().item()
    print(f"[5 main path] closed loop batch={batch} steps={steps}: captured == eager bit for "
          f"bit: {same}; {launches} K1 and {plant_launches} plant kernel launches eagerly, "
          f"{k1_replayed:.0f} fused_admm_kernel and {plant_replayed:.0f} quadrotor_rk4_kernel "
          f"in a profiled replay; first captured call {first_ms:.1f} ms "
          f"(capture and instantiation {cap.LAST_CAPTURE_MS:.1f}); mean |x| {n0:.4f} -> "
          f"{n1:.4f} [{card}]")
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

    return launches, plant_replayed / steps


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
    """Phase 2's check of K4's multi-axis map (``tile_box_v``): its two
    instances (three staging dims, and two) are built and neither spills;
    their registers and stack are in ptxas's lines."""
    built = {name: (regs, spill) for src, name, regs, spill in report
             if src == "tile_executor" and "tile_box_v" in name}
    want = [f"tile_box_vILi{nu}ELi{lx}EE" for nu, lx in ((3, 3), (2, 6))]
    for key in want:
        found = [v for name, v in built.items() if key in name]
        if len(found) != 1 or found[0][1]:
            raise RuntimeError(f"ptxas: {key} is missing or spills ({found})")
    print(f"[2 build] tile_executor: {len(want)} tile_box_v instances built, no spill "
          f"(registers {sorted(v[0] for name, v in built.items() if any(k in name for k in want))})")


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


PERMUTE_SUM_T2D_MS = 3.04  # tile_t2d_v<4> a call in card_scale's profile before this map (PERF.md)


def multi_axis_times(dev, gen, report) -> None:
    """Phase 9, the README's four-permute sum at 96^4 through K4's
    multi-axis map, called eagerly and as device time (CUDA graphs), in
    turns with its plain version and the PyTorch expression; then the same
    plan on tile_t2d_v (the staging cleared) against the multi-axis map.
    Bounds: the needed bytes (A read once, the output written once) and four
    reads of A and one write, the least a kernel reading each view once
    moves."""
    import dataclasses

    import strided_tpu_torch as st
    from strided_tpu_torch.core import executor_cuda as ec

    for dt in (torch.float32, torch.bfloat16):
        (v, *_), (a, *_) = _permuted_views((96,) * 4, [(0, 1, 2, 3)], dt, dev, gen)
        views = [v, st.permutedims(v, P2), st.permutedims(v, P3), st.permutedims(v, P4)]
        out = st.strided(torch.empty_like(a))
        plan = ec.make_plan(lambda p, q, r, s: p + q + r + s, None, None, a.shape, out, views)
        if plan is None or not plan.stage:
            raise RuntimeError("four-permute sum: not a multi-axis plan")
        old = dataclasses.replace(plan, stage=())
        pars = [a] * 4
        kernel = lambda: ec.tile_executor(plan, out.parent, pars)  # noqa: E731
        plain = lambda: ec.tile_executor_reference(plan, out.parent, pars)  # noqa: E731
        t2d = lambda: ec.tile_executor(old, out.parent, pars)  # noqa: E731
        lib = lambda: a + a.permute(P2) + a.permute(P3) + a.permute(P4)  # noqa: E731
        need, four = 2 * a.numel() * a.element_size(), 5 * a.numel() * a.element_size()
        what = (f"tile_executor four-permute sum 96^4 {dt} [multi_axis], bound "
                f"{bound(need)['bound_ms']:.4f} ms (needed bytes), {bound(four)['bound_ms']:.4f} ms "
                f"(four reads, one write); tile_t2d_v<4> in card_scale {PERMUTE_SUM_T2D_MS} ms")
        report(f"{what}, called eagerly", need, _turns(kernel, plain, reps=20, library=lib))
        report(f"{what}, device time (CUDA graph)", need,
               _turns(kernel, plain, reps=10, library=lib, graph=True))
        report(f"four-permute sum 96^4 {dt}: multi_axis (kernel) against tile_t2d_v (plain), "
               f"device time (CUDA graph)", need, _turns(kernel, t2d, reps=10, graph=True))


def k1_times(dev, ctrl, rng, batch, card, *, rho, alpha, iters) -> dict:
    """Phase 6: the step, captured and eagerly with its first call
    (``mpc_solves``) and as device time alone (``step_device_ms``), with K1
    on and off in turns; then K1 at the main
    path's shape against its plain version and six cuBLAS products of the
    same shapes under IEEE FP32 (how fast the library runs this product in
    FP32; no single call computes ADMM), in turns; then K1's designs
    (``benchmarks/exp_admm.py``). Returns K1's times and bound for the JSON
    line."""
    from strided_tpu_torch import config
    from strided_tpu_torch.bench import mpc_solves, step_device_ms
    from strided_tpu_torch.benchmarks import exp_admm
    from strided_tpu_torch.mpc import fused_admm as fa

    def step(fused: bool, timer) -> float:
        config.set_config(fused_admm=fused)
        try:
            return timer(fused)
        finally:
            config.set_config(fused_admm=True)

    # in turns (kernel, plain, plain, kernel) so drift hits both sides alike
    turns = (True, False, False, True)
    rows = [step(f, lambda fused: mpc_solves(dev, batch=batch)) for f in turns]
    device = [step(f, lambda fused: step_device_ms(dev, batch=batch)) for f in turns]
    for what, (k1_, p1, p2, k2) in (
            ("captured", [r["captured_ms"] for r in rows]),
            ("eagerly", [r["eager_ms"] for r in rows]),
            ("device time (chained steps in one CUDA graph)", device)):
        print(f"[6 times] step batch={batch} {what}: kernel path {k1_:.4f}/{k2:.4f} ms "
              f"({batch / (min(k1_, k2) * 1e-3):.0f} solves/s), plain ADMM loop "
              f"{p1:.4f}/{p2:.4f} ms ({batch / (min(p1, p2) * 1e-3):.0f} solves/s) [{card}]")
    k1_, p1, p2, k2 = (r["first_call_ms"] for r in rows)
    print(f"[6 times] step batch={batch} first call (warm-up, capture, instantiation, one "
          f"replay): kernel path {k1_:.1f}/{k2:.1f} ms, plain ADMM loop {p1:.1f}/{p2:.1f} ms "
          f"[{card}]")
    x = torch.as_tensor(rng.uniform(-0.3, 0.3, (batch, 12)), dtype=torch.float32, device=dev)
    args = _admm_inputs(ctrl, x)
    kw = dict(rho=rho, alpha=alpha, iters=iters)
    ieee = config.matmul_precision_scope
    rhs = torch.randn(args[0].shape, device=dev, generator=torch.Generator(dev).manual_seed(4))
    kernel = lambda: fa.fused_admm(*args, **kw)  # noqa: E731
    plain = ieee(lambda: fa.fused_admm_reference(*args, **kw))
    products = ieee(lambda: [torch.matmul(rhs, args[2]) for _ in range(iters)])
    times = _turns(kernel, plain, reps=100, library=products)
    B, D = args[0].shape
    # the products only: 2 * B * D^2 flops an iteration (the clip and the
    # updates add ~2%); g, z0 and the result, S, lo and hi in f32
    k1_bound = bound(4 * (3 * B * D + D * D + 2 * D), 2 * iters * B * D * D)
    _report(6, f"fused_admm B={B} D={D} iters={iters}, bound {k1_bound['bound_ms']:.4f} ms "
            f"({k1_bound['bound_by']}); one PyTorch call: {iters} torch.matmul "
            f"({B}, {D}) @ ({D}, {D}) IEEE FP32", "GFLOP/s", 2 * iters * B * D * D, times, card)
    rows = exp_admm.run()  # K1 and the tile designs it was chosen over
    for row in rows:
        print(f"[6 K1 designs] {json.dumps(row)} [{card}]")
    if not all(r["ok"] for r in rows):
        raise RuntimeError("a K1 tile design disagreed with the plain version")
    return {"ms": times[0], "plain_ms": times[1], **k1_bound, "product_ms": times[3]}


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


def precision_phase(dev, card) -> None:
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

    t0 = time.perf_counter()
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
    (xs, _us), first_ms, capture_ms = matches_eager(
        lambda: closed_loop(coarse, model, x, 10, 0.02))
    print(f"[16 precision] closed_loop batch 16384, 10 steps, admm_coarse_iters 12 of 20: "
          f"captured == eager bit for bit, {cap.CAPTURES - captures} capture, K1 "
          f"x{fa.LAUNCHES}, first call {first_ms:.1f} ms (capture {capture_ms:.1f}) [{card}]")
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
    print(f"[16 precision] python -m strided_tpu_torch.bench exit {proc.returncode}; its "
          f"stderr:")
    for line in proc.stderr.strip().splitlines()[-40:]:
        print(f"    {line}")
    print(f"[16 precision] its last line: {last}")
    head = json.loads(last) if last.startswith("{") else {}
    if proc.returncode != 0 or sorted(head) != ["metric", "unit", "value", "vs_baseline"]:
        raise RuntimeError("python -m strided_tpu_torch.bench failed or printed no headline")
    print(f"[16 precision] {time.perf_counter() - t0:.1f} s")


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


def engine_phases(dev, card):
    """Phases 8 and 9: the strided engine's main path and its three kernels.
    Returns the kernels' entries for the JSON line."""
    import strided_tpu_torch as st
    from strided_tpu_torch.core import ewise, executor_cuda as ec
    from strided_tpu_torch.core import kernels_special as ks, lazy_expr as le
    from strided_tpu_torch.core import stream_reduce as sr

    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, device=dev, generator=gen)  # noqa: E731
    randi = lambda *shape: torch.randint(-9, 9, shape, device=dev, dtype=torch.int32,  # noqa: E731
                                         generator=gen)
    err = {"pair_axpby": 0.0, "stream_reduce": 0.0, "tile_executor": 0.0}

    def check(kernel, what, got, want, atol=0.0):
        torch.cuda.synchronize()
        e = _max_err(got, want)
        print(f"[8 engine] {what}: |kernel - plain| {e:.3e} (limit {atol:g})")
        if not e <= atol:
            raise RuntimeError(f"{what}: kernel off its plain version by {e:.3e} > {atol:g}")
        err[kernel] = max(err[kernel], e)

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
        check("pair_axpby", f"{spelling} {n}^2 {dt}", got, ks.pair_reference(a, **plain_kw[spelling]))
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
        check("stream_reduce", what, got, want, atol)
        expect(f"{what}: K3's path", [q for q in sr.PATHS if sr.PATHS[q] != before[q]], [path])
    # K4, through permutedims_into, smap and (forced) mapreducedim_into
    out = st.strided(torch.empty(n, n, device=dev))
    ec.LAST_PLAN.clear()
    got = st.materialize(st.permutedims_into(out, v, (1, 0)))
    expect("permutedims_into 8192^2", bool(ec.LAST_PLAN), True)
    check("tile_executor", "permutedims_into(8192^2, (1, 0))", got, a.T)
    y = randn(64, 128, 64, 128)
    perm = (1, 3, 0, 2)
    out4 = st.strided(torch.empty(tuple(y.shape[p] for p in perm), device=dev))
    got = st.materialize(st.permutedims_into(out4, st.strided(y), perm))
    expect("rank-4 permute", bool(ec.LAST_PLAN), True)
    check("tile_executor", f"permutedims_into(64x128x64x128, {perm})", got, y.permute(perm))
    w = randn(n, n)
    got = st.materialize(st.smap(lambda p, q: p * 3 + q, st.transpose(v), st.strided(w)))
    expect("smap(x*3 + y, v.T, w)", bool(ec.LAST_PLAN), True)
    check("tile_executor", "smap(x*3 + y, v.T, w) 8192^2", got, a.T * 3 + w)
    old_cfg = st.get_config()
    st.set_config(kernel_reductions=True)
    try:
        xi, old = randi(8192, 4096), randi(1, 4096)
        ov = st.broadcast_to(st.strided(old), (8192, 4096))
        res = st.mapreducedim_into(lambda t: t, torch.add, lambda o: 3 * o, ov, st.strided(xi))
        expect("initop reduction", bool(ec.LAST_PLAN), True)
        check("tile_executor", "3*old + sum(int32 8192x4096, axis=0)", res.parent.reshape(1, 4096),
              3 * old + xi.sum(0, keepdim=True, dtype=torch.int32))
    finally:
        st.set_config(kernel_reductions=old_cfg.kernel_reductions)
    torch.cuda.synchronize()
    launches = {"pair_axpby": ks.LAUNCHES, "stream_reduce": sr.LAUNCHES,
                "tile_executor": ec.LAUNCHES}
    print(f"[8 engine] launches on the main path: {launches}; K3 by path {sr.PATHS}, "
          f"K4 maps by interpreter {ec.MAP_PATHS}")
    if (sr.PATHS["identity/vector"] < 1 or sr.PATHS["amortized/vector"] < 1
            or ec.MAP_PATHS["amortized"] < 1):
        raise RuntimeError("the main path did not run K3's identity and vector program kernels "
                           "or K4's amortized map")
    for name, count in launches.items():
        if count < 1:
            raise RuntimeError(f"{name} was not launched on the engine's main path")

    coverage_checks(dev, gen)
    multi_axis_checks(dev, gen)

    # phase 9: each wrapper against its plain version, in turns
    def report(what, nbytes, times):
        _report(9, what, "GB/s", nbytes, times, card)

    pair_times = {}
    for n in (1024, 2048, 4000, 8192):
        a = randn(n, n)
        kw = dict(scale_mode="div", scale=2.0)
        pair_times[n] = _turns(lambda: ks.pair_axpby(a, **kw), lambda: ks.pair_reference(a, **kw),
                               reps=50 if n >= 4000 else 200,
                               library=(lambda: torch.lerp(a, a.T, 0.5)) if n == 8192 else None)
        report(f"pair_axpby (a + a.T)/2 {n}^2 f32 (one call: torch.lerp(a, a.T, 0.5))",
               2 * 4 * n * n, pair_times[n])
    for n in (1024, 4000, 8192):  # through the entry point: host work included
        a = randn(n, n)
        v = st.strided(a)
        st.to_array((v + st.transpose(v)) / 2)
        report(f"end to end st.to_array((v + v.T) / 2) {n}^2 f32 "
               f"[{le.LAST_EXPR_DISPATCH}]", 2 * 4 * n * n,
               _turns(lambda: st.to_array((v + st.transpose(v)) / 2), lambda: (a + a.T) / 2,
                      reps=50))
    red_t, k3_cases = reduce_times(dev, gen, report)
    map_t, t_times = map_times(dev, gen, report, w)
    multi_axis_times(dev, gen, report)
    vy = st.strided(y)
    ins4 = [st.permutedims(vy, perm)]
    plan4 = ec.make_plan(lambda t: t, None, None, out4.shape, out4, ins4)
    report(f"tile_executor permute {perm} 64x128x64x128 f32", 2 * 4 * y.numel(),
           _turns(lambda: ec.tile_executor(plan4, out4.parent, [vy.parent]),
                  lambda: ec.tile_executor_reference(plan4, out4.parent, [vy.parent]), reps=50))
    st.set_config(kernel_reductions=True)
    try:
        ov = st.broadcast_to(st.strided(old), (8192, 4096))
        planr = ec.make_plan(lambda t: t, torch.add, lambda o: 3 * o, (8192, 4096), ov,
                             [st.strided(xi)])
    finally:
        st.set_config(kernel_reductions=old_cfg.kernel_reductions)
    kernel = lambda: ec.tile_executor(planr, ov.parent, [xi.reshape(-1)])  # noqa: E731
    plain = lambda: ec.tile_executor_reference(planr, ov.parent, [xi.reshape(-1)])  # noqa: E731
    report("tile_executor 3*old + sum axis 0, int32 8192x4096, called eagerly", 4 * xi.numel(),
           _turns(kernel, plain, reps=50))
    report("tile_executor 3*old + sum axis 0, int32 8192x4096, device time (CUDA graph)",
           4 * xi.numel(), _turns(kernel, plain, reps=20, graph=True))

    def entry(name, replaces, times, nbytes):
        eager, device = times
        return {"name": name, "route": "cuda", "source": f"strided_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches[name], "max_abs_err": err[name],
                "ms": eager[0], "plain_ms": eager[1], **bound(nbytes),
                "library_ms": eager[3] if len(eager) > 3 else None,
                **({} if device is None else {
                    "device_ms": device[0], "device_plain_ms": device[1],
                    "device_library_ms": device[3] if len(device) > 3 else None})}

    n2 = 8192 * 8192
    smap_bound = bound(3 * 4 * n2)
    map_e, map_d = map_t
    return [entry("pair_axpby", "strided_tpu/core/kernels_special.py:147", (pair_times[8192], None),
                  2 * 4 * n2),
            {**entry("stream_reduce", "strided_tpu/core/kernels_special.py:511", red_t,
                     4 * n2 + 4 * 8192), "cases": k3_cases},
            {**entry("tile_executor", "strided_tpu/core/executor_pallas.py:137", t_times,
                     2 * 4 * n2),
             "map_ms": map_e[0], "map_plain_ms": map_e[1], "map_bound_ms": smap_bound["bound_ms"],
             "map_library_ms": map_e[3], "map_device_ms": map_d[0],
             "map_device_plain_ms": map_d[1], "map_device_library_ms": map_d[3]}]


def reduce_times(dev, gen, report, n=8192):
    """Phase 9, K3: the f32 axis-0 sum (the JSON line's case), the axis-0
    max, the int32 and bf16 sums; then programs: ``smean(v, 0)`` in f32 and
    bf16 through the public entry point, the wrapper on ``t*0.5 + 1``, bodies
    of 3 and 5 registers (the scalar interpreter), an int32 ``t*3 + 1``, and
    an instruction ladder (bodies of 1, 2, 3 and 9 instructions; the
    identity sum is its 0); then ``t*0.5 + 1``, the 3-register body, the
    9-instruction rung and the 5-register body once more on the same values
    on a base one element past a 16-byte boundary, where the kernel takes
    one column a thread. Each is checked against its plain version, with
    the kernel and width the launcher reports it ran (8 columns a thread
    wherever ``stream_reduce.split`` gives them, and for ``t*0.5 + 1`` and
    ``st.smean`` in f32 always), then timed in turns
    against it and, where one call computes the same function, that call:
    called eagerly (as every kernel of the JSON line is timed) and as device
    time alone through CUDA graphs, with the host time a call beside them.
    Returns the f32 sum's eager and device times and every case's times."""
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
    cases = [  # (name, operand, program, fold, one call or None, entry-point call or None)
        (f"sum axis 0, {n}^2 f32", a, ident[f32], sr.RED_SUM, lambda: a.sum(0), None),
        (f"max axis 0, {n}^2 f32", a, ident[f32], sr.RED_MAX, lambda: a.amax(0), None),
        (f"sum axis 0, int32 {n}x{n // 2}", ai, ident[i32], sr.RED_SUM,
         lambda: ai.sum(0, dtype=torch.int32), None),
        (f"sum axis 0, {n}^2 bf16", a16, ident[bf16], sr.RED_SUM, lambda: a16.sum(0), None),
        (f"sum axis 0 of t*0.5 + 1, {n}^2 f32", a, prog(ladder[2][1]), sr.RED_SUM, None, None),
        (f"st.smean(v, 0), {n}^2 f32", a, mean[f32], sr.RED_SUM, lambda: a.mean(0),
         lambda: st.smean(va, 0)),
        (f"st.smean(v, 0), {n}^2 bf16", a16, mean[bf16], sr.RED_SUM, lambda: a16.mean(0),
         lambda: st.smean(va16, 0)),
        (f"sum axis 0 of (t+1)*(t+2) + t*3, {n}^2 f32", a,
         prog(lambda t: (t + 1) * (t + 2) + t * 3), sr.RED_SUM, None, None),
        (f"sum axis 0 of the wide body, {n}^2 f32", a, prog(lambda t: wide_body(t, t)),
         sr.RED_SUM, None, None),
        (f"sum axis 0 of t*3 + 1, int32 {n}x{n // 2}", ai, prog(lambda t: t * 3 + 1, i32),
         sr.RED_SUM, None, None),
    ] + [(f"sum axis 0 of {name}, {n}^2 f32 (ladder)", a, prog(f), sr.RED_SUM, None, None)
         for k, (name, f) in ladder.items() if k != 2]
    au = _unaligned(a)
    cases += [(f"sum axis 0 of {name}, {n}^2 f32, one column a thread (unaligned base)", au,
               prog(f), sr.RED_SUM, None, None)
              for name, f in (("t*0.5 + 1", ladder[2][1]),
                              ("(t+1)*(t+2) + t*3", lambda t: (t + 1) * (t + 2) + t * 3),
                              (ladder[9][0], ladder[9][1]),
                              ("the wide body", lambda t: wide_body(t, t)))]
    rungs = {cases[0][0], cases[4][0], *(c[0] for c in cases if "(ladder)" in c[0])}
    out, first, steps = {}, None, []
    for name, x, p, red, lib, call in cases:
        kernel = call or (lambda x=x, p=p, red=red: sr.stream_reduce(x, p, red))
        plain = lambda x=x, p=p, red=red: sr.stream_reduce_reference(x, p, red)  # noqa: E731
        before = dict(sr.PATHS)
        k = kernel()
        k = k if isinstance(k, torch.Tensor) else st.materialize(k).reshape(-1)
        want = plain()
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
        eager = _turns(kernel, plain, reps=100, library=lib)
        device = _turns(kernel, plain, reps=20, library=lib, graph=True)
        host = _host_ms(kernel)
        nbytes = x.element_size() * x.numel() + p.out_dtype.itemsize * x.shape[1]
        what = f"stream_reduce {name}, bound {bound(nbytes)['bound_ms']:.4f} ms"
        report(f"{what}, called eagerly (host time {host:.4f} ms a call)", nbytes, eager)
        report(f"{what}, device time (CUDA graph)", nbytes, device)
        out[name] = {"ms": eager[0], "device_ms": device[0], "host_ms": host,
                     "plain_ms": eager[1], "device_plain_ms": device[1],
                     "library_ms": eager[3] if lib else None,
                     "device_library_ms": device[3] if lib else None,
                     "bound_ms": bound(nbytes)["bound_ms"], "path": path}
        first = first or (eager, device)
        if name in rungs:
            steps.append((len(cp.instrs), cp.n_reg, device[0]))
    programs = [(c, t) for c, _r, t in steps if c > 0]
    slope, icpt = np.polyfit(*np.array(programs).T, 1)
    print(f"[9 stream_reduce] ladder (instructions, registers, device ms), f32 {n}^2 sums: "
          f"{sorted(steps)}; least squares over the programs {icpt:.4f} ms + {slope:.4f} ms "
          f"per instruction")
    return first, out


def map_times(dev, gen, report, w, n=8192):
    """Phase 9, K4's maps on the staged two-input 8192^2 layout (v.T, w):
    the instruction ladder (bodies of 0, 1, 3 and 9 instructions), a bf16
    and an int32 ``where`` map, the wide body (more than ewise.CREG
    registers: the scalar interpreter), each exact against its plain version
    and timed in turns, eagerly and as device time (CUDA graphs); then the
    transposed copy. Returns the smap's times (with ``torch.add(w, a.T,
    alpha=3)`` as its one call) and the copy's (with ``a.T.contiguous()``),
    each as (eager, device)."""
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
    smap, ladder = None, []
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
        lib = (lambda: torch.add(y, x.T, alpha=3)) if "smap" in name else None
        kernel = lambda: ec.tile_executor(plan, out.parent, parents)  # noqa: E731
        plain = lambda: ec.tile_executor_reference(plan, out.parent, parents)  # noqa: E731
        eager = _turns(kernel, plain, reps=10, library=lib)
        device = _turns(kernel, plain, reps=10, library=lib, graph=True)
        nbytes = 3 * x.element_size() * x.numel()
        what = f"tile_executor map {name} [{path}], bound {bound(nbytes)['bound_ms']:.4f} ms"
        report(f"{what}, called eagerly", nbytes, eager)
        report(f"{what}, device time (CUDA graph)", nbytes, device)
        if dt == torch.float32 and path == "amortized":
            ladder.append((len(body.instrs), device[0]))
        if "smap" in name:
            smap = (eager, device)
    if len(ladder) > 1:
        xs, ys = np.array([c for c, _ in ladder], float), np.array([t for _, t in ladder])
        slope, icpt = np.polyfit(xs, ys, 1)
        print(f"[9 tile_executor] ladder (instructions, device ms): {ladder}; least squares "
              f"{icpt:.4f} ms + {slope:.4f} ms per instruction")
    out = st.strided(torch.empty(n, n, device=dev))
    va = st.strided(a)
    plan = ec.make_plan(lambda t: t, None, None, out.shape, out, [st.transpose(va)])
    kernel = lambda: ec.tile_executor(plan, out.parent, [va.parent])  # noqa: E731
    plain = lambda: ec.tile_executor_reference(plan, out.parent, [va.parent])  # noqa: E731
    lib = lambda: a.T.contiguous()  # noqa: E731
    copy = (_turns(kernel, plain, reps=50, library=lib),
            _turns(kernel, plain, reps=20, library=lib, graph=True))
    report("tile_executor transpose copy 8192^2 f32 (one call: a.T.contiguous()), called eagerly",
           2 * 4 * a.numel(), copy[0])
    report("tile_executor transpose copy 8192^2 f32, device time (CUDA graph)",
           2 * 4 * a.numel(), copy[1])
    return smap, copy


def _turns(kernel, plain, reps, warmup=5, library=None, graph=False):
    """Kernel, plain, plain, kernel: ``(best kernel ms, best plain ms, all
    four)``. With ``library`` (one PyTorch call computing the same function,
    the JSON line's yardstick) the turns are kernel, plain, library,
    library, plain, kernel, and its best time is a fourth item. ``graph``:
    device time alone (``bench.graph_ms``), else host and device
    (``bench.cuda_ms``)."""
    from strided_tpu_torch.bench import cuda_ms, graph_ms

    def ms(f):
        return graph_ms(f, reps=reps) if graph else cuda_ms(f, reps=reps, warmup=warmup)

    if library is None:
        k1, p1, p2, k2 = (ms(f) for f in (kernel, plain, plain, kernel))
        return min(k1, k2), min(p1, p2), (k1, k2, p1, p2)
    k1, p1, l1, l2, p2, k2 = (ms(f) for f in (kernel, plain, library, library, plain, kernel))
    return min(k1, k2), min(p1, p2), (k1, k2, p1, p2), min(l1, l2)


def _host_ms(fn, reps=200) -> float:
    """Host milliseconds a call of ``fn()`` takes to enqueue its work (no
    synchronization inside the loop): where this is longer than the device
    time, an eager caller waits for the host."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def _library(what, call, reps=50) -> float:
    """The time of one PyTorch call that computes a kernel's function: the
    yardstick of the JSON line, used nowhere in the port."""
    from strided_tpu_torch.bench import cuda_ms

    ms = cuda_ms(call, reps=reps)
    print(f"[library] {what}: {ms:.4f} ms")
    return ms


def _report(phase, what, unit, amount, times, card):
    """One timing line; ``amount / ms / 1e6`` in ``unit`` (GB/s or GFLOP/s)."""
    k, p, (k1, k2, p1, p2) = times[:3]
    lib = f", one PyTorch call {times[3]:.4f} ms" if len(times) > 3 else ""
    print(f"[{phase} times] {what}: kernel {k1:.4f}/{k2:.4f} ms ({amount / k / 1e6:.0f} {unit}), "
          f"plain {p1:.4f}/{p2:.4f} ms ({amount / p / 1e6:.0f} {unit}){lib} [{card}]")


def ptxas_report(sources=("fused_admm", "stream_reduce", "tile_executor", "exp_sym",
                         "exp_perm", "quadrotor_rk4")) -> list:
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


def linalg_phase(dev, card) -> None:
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

    C = st.strided(c)
    _report(10, "mul f32 8192^2 alpha=1.5 beta=-0.5 (entry point vs plain)", "GFLOP/s",
            2 * n ** 3, _turns(lambda: st.mul(C, v, st.strided(b), alpha=alpha, beta=beta),
                               ieee(lambda: alpha * (a @ b) + beta * c), reps=10, warmup=2), card)
    _report(10, "axpby(0.5, transpose(v), 0.5, v) 8192^2 (entry point vs plain)", "GB/s",
            2 * 4 * n * n, _turns(lambda: st.axpby(0.5, st.transpose(v), 0.5, v),
                                  lambda: 0.5 * a.T + 0.5 * a, reps=50), card)


def probe_phases(dev, card):
    """Phase 11: the transpose-pair probes and their four kernels. Returns
    the kernels' entries for the JSON line."""
    import subprocess
    import sys

    from strided_tpu_torch.benchmarks import exp_pair_rect as er, exp_sym as es

    for counts in (es.LAUNCHES, er.LAUNCHES):
        for k in counts:
            counts[k] = 0
    rcs = (es.main([]), er.main([]))  # one JSON line a variant
    torch.cuda.synchronize()
    launches = {**es.LAUNCHES, **er.LAUNCHES}
    print(f"[11 probes] launches in the probes' run: {launches} [{card}]")
    if rcs != (0, 0):
        raise RuntimeError(f"a probe variant disagreed with its plain result (exit codes {rcs})")
    for name, count in launches.items():
        if count < 1:
            raise RuntimeError(f"{name} was not launched by the probes")

    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(8192, 8192, device=dev, generator=gen)
    xr = torch.randn(er.N, er.N, device=dev, generator=gen)
    nans = torch.full_like(xr, float("nan"))
    out_k, out_p = nans.clone(), nans.clone()  # NaN-filled once, outside the timed loops
    # the one PyTorch call of each function (the JSON line's library_ms),
    # timed inside the kernel's turns
    lerp = lambda: torch.lerp(x, x.T, 0.5)  # noqa: E731
    clone = lambda: x.clone()  # noqa: E731
    # each case: (kernel, shape, bytes, input, kernel(out), plain(out), the
    # one call or None); the timed calls take the default out (a new tensor;
    # rect_pairs': out_k and out_p)
    cases = [("transpose_tiles", f"{th}x{tw}", 2 * 4 * x.numel(), x,
              lambda out=None, th=th, tw=tw: es.transpose_tiles(x, th, tw, out=out),
              lambda out=None: es.transpose_reference(x), lambda: x.T.contiguous())
             for th, tw in ((32, 32), (64, 64), *es.RECT_TILES)]
    cases += [("sym_two_read", f"{t}", 3 * 4 * x.numel(), x,
               lambda out=None, t=t: es.sym_two_read(x, t, out=out),
               lambda out=None: es.sym_reference(x), lerp) for t in es.SQUARE_TILES]
    for t in es.SQUARE_TILES:
        for label, kw, plain, library in (
                ("full", {}, lambda out=None: es.sym_reference(x), lerp),
                ("copy", dict(do_transpose=False), lambda out=None: x.clone(), clone),
                ("full skipdiag", dict(skip_diag=True), lambda out=None: es.sym_reference(x), lerp),
                ("copy skipdiag", dict(do_transpose=False, skip_diag=True),
                 lambda out=None: x.clone(), clone)):
            cases.append(("pair_tiles", f"{t} {label}", 2 * 4 * x.numel(), x,
                          lambda out=None, t=t, kw=kw: es.pair_tiles(x, t, out=out, **kw), plain,
                          library))
    for T in er.TILES:
        nbytes = len(er.rect_worklist(er.N, T)) * 4 * T * 2 * T * 4
        cases.append(("rect_pairs", f"{T}x{2 * T}", nbytes, xr,
                      lambda out=out_k, T=T: er.rect_pairs(xr, out, T)[0],
                      lambda out=out_p, T=T: er.rect_pairs_reference(xr, out, T)[0], None))
    best, err = {}, {}
    for name, shape, nbytes, src, kernel, plain, library in cases:
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
        err[name] = max(err.get(name, 0.0), e)
        times = _turns(kernel, plain, reps=20, library=library)
        _report(11, f"{name} {shape}", "GB/s", nbytes, times, card)
        if name == "pair_tiles" and shape == "64 copy":
            copy = {"copy_ms": times[0], "copy_library_ms": times[3]}  # a.clone() in its turns
        if "copy" not in shape and (name not in best or times[0] < best[name][0][0]):
            best[name] = (times, nbytes)  # the JSON line: each kernel's fastest tile shape
    for module in ("exp_sym", "exp_pair_rect"):
        proc = subprocess.run([sys.executable, "-m", f"strided_tpu_torch.benchmarks.{module}"],
                              capture_output=True, text=True, timeout=300)
        rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        print(f"[11 probes] python -m strided_tpu_torch.benchmarks.{module}: exit {proc.returncode}, "
              f"{len(rows)} variants, all ok {all(r['ok'] for r in rows)}")
        if proc.returncode != 0 or not rows or not all(r["ok"] for r in rows):
            raise RuntimeError(f"{module} on its own failed:\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")

    # the bound counts each input element read once and each output written
    # once: sym_two_read's second read of A is not work the function needs
    need = {"transpose_tiles": 2 * 4 * x.numel(), "sym_two_read": 2 * 4 * x.numel(),
            "pair_tiles": 2 * 4 * x.numel(), "rect_pairs": best["rect_pairs"][1]}

    def entry(name, source, replaces, **extra):
        times = best[name][0]
        return {"name": name, "route": "cuda", "source": f"strided_tpu_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": launches[name], "max_abs_err": err[name],
                "ms": times[0], "plain_ms": times[1], **bound(need[name]),
                "library_ms": times[3] if len(times) > 3 else None, **extra}

    return [entry("transpose_tiles", "exp_sym", "benchmarks/exp_sym.py:43"),
            entry("sym_two_read", "exp_sym", "benchmarks/exp_sym.py:63"),
            entry("pair_tiles", "exp_sym", "benchmarks/exp_sym.py:222", **copy),
            entry("rect_pairs", "exp_pair_rect", "benchmarks/exp_pair_rect.py:110")]


REVERSAL_SOURCES = {  # kernel: TPU Pallas call it replaces (first of its family)
    "rev4_tiles": "benchmarks/exp_perm2.py:40",
    "rev4_mma": "benchmarks/exp_perm2.py:112",
    "rev4_async": "benchmarks/exp_perm4.py:153",
}


def _reversal_kernel(name: str) -> str:
    """The kernel a reversal probe variant runs, from its name."""
    if name.startswith("mxu"):
        return "rev4_mma"
    return "rev4_async" if name.startswith("dma4d") else "rev4_tiles"


def reduce_perm_phase(dev, card):
    """Phase 12: the streaming-reduction probe (P3) and the rank-4 reversal
    probes (P4-P6) with their four kernels. Returns the kernels' entries
    for the JSON line."""
    import subprocess
    import sys

    from strided_tpu_torch.benchmarks import exp_perm2, exp_perm4, exp_perm_probe
    from strided_tpu_torch.benchmarks import exp_reduce as ere, exp_sym as es, perm_kernels as pk

    scripts = (ere, exp_perm2, exp_perm4, exp_perm_probe)
    for counts in (ere.LAUNCHES, pk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    t2d_before = es.LAUNCHES["transpose_tiles"]
    rcs = tuple(m.main([]) for m in scripts)  # one JSON line a variant
    torch.cuda.synchronize()
    launches = {**ere.LAUNCHES, **pk.LAUNCHES}
    t2d = es.LAUNCHES["transpose_tiles"] - t2d_before
    print(f"[12 reduce/perm] launches in the probes' run: {launches}, transpose_tiles (P5 t2d) "
          f"{t2d} [{card}]")
    if rcs != (0,) * len(scripts):
        raise RuntimeError(f"a probe variant disagreed with its plain result (exit codes {rcs})")
    for name, count in {**launches, "transpose_tiles": t2d}.items():
        if count < 1:
            raise RuntimeError(f"{name} was not launched by the probes")

    gen = torch.Generator(device=dev).manual_seed(3)
    err, best = {}, {}

    def keep(name, e, times):
        err[name] = max(err.get(name, 0.0), e)
        if name not in best or times[0] < best[name][0]:
            best[name] = times  # the JSON line: each kernel's fastest form

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
        times = _turns(lambda R=R, C=C: ere.stream_sum_slabs(a, R, C), lambda: a.sum(0), reps=50)
        _report(12, f"stream_sum_slabs {R}x{C} 8192^2 f32", "GB/s", 4 * a.numel(), times, card)
        nc = _turns(lambda R=R, C=C: ere.stream_sum_slabs(a, R, C, compute=False),
                    lambda: a[0].clone(), reps=50)
        _report(12, f"stream_sum_slabs {R}x{C} nocompute (plain: a[0].clone())", "GB/s",
                4 * a.numel(), nc, card)
        keep("stream_sum_slabs", e_plain, times)
    lib_sum = _library("a.sum(0) 8192^2", lambda: a.sum(0))
    del a

    # P4-P6: every reversal variant of the three scripts, exact
    x = torch.randn(64, 64, 64, 64, device=dev, generator=gen)
    nbytes = 2 * 4 * x.numel()
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
            times = _turns(lambda fn=fn: fn(x), lambda plain=plain: plain(x), reps=20)
            _report(12, f"{what} 64^4 f32", "GB/s", nbytes, times, card)
            if not name.startswith(("nocompute", "mxu_default")):
                keep(kernel, e, times)
            else:
                err[kernel] = max(err.get(kernel, 0.0), e)
    lib_rev = _library("x.permute(3, 2, 1, 0).contiguous() 64^4",
                       lambda: x.permute(3, 2, 1, 0).contiguous())

    for script in scripts:
        module = script.__name__
        proc = subprocess.run([sys.executable, "-m", module], capture_output=True, text=True,
                              timeout=300)
        rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        print(f"[12 reduce/perm] python -m {module}: exit {proc.returncode}, {len(rows)} variants, "
              f"all ok {all(r['ok'] for r in rows)}")
        if proc.returncode != 0 or not rows or not all(r["ok"] for r in rows):
            raise RuntimeError(f"{module} on its own failed:\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")

    def entry(name, source, replaces, work, library):
        return {"name": name, "route": "cuda", "source": f"strided_tpu_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": launches[name], "max_abs_err": err[name],
                "ms": best[name][0], "plain_ms": best[name][1], **work, "library_ms": library}

    # the identity product: 2 * 16 flops an element (one k-tile of 16) in
    # each of three bf16 passes, on the tensor cores
    mma_work = bound(nbytes, 3 * 2 * 16 * x.numel(), BF16_TENSOR_OPS_PER_S)
    return [entry("stream_sum_slabs", "exp_reduce", "benchmarks/exp_reduce.py:49",
                  bound(4 * 8192 * 8192 + 4 * 8192), lib_sum),
            *(entry(k, "exp_perm", REVERSAL_SOURCES[k],
                    mma_work if k == "rev4_mma" else bound(nbytes), lib_rev)
              for k in ("rev4_tiles", "rev4_mma", "rev4_async"))]


RICCATI_LIMIT = 1e-4  # max |dK|, f32 on the card against f64 on the CPU, N=50
ROLLOUT_LIMIT = 1e-4  # max |dx| over 100 steps of 0.01 s, 0.1 rad states
ILQR_LIMIT = 1e-3  # max |du|, cartpole T=40, 15 iterations, inputs up to ~86


def _profile_lines(rows, top: int = 6) -> list:
    return [f"{ms:.4f} ms {n:.1f}x {name[:80]}" for ms, n, name in rows[:top]]


def slice_c_full(mesh, dev) -> dict:
    """Phase 14(b) at BASELINE config 5's size on each rank: the
    scenario-split step and the consensus at 16384 scenarios, N=50, ADMM-20,
    counted eagerly (inside ``disable_capture()``: K1 once a call), the
    rows within 1e-5 of the unsharded step's and within ``ATOL_KERNEL`` of
    K1's plain version (the ADMM loop) on the rank's rows, the consensus
    within 1e-5 of the oracle's mean. Over NCCL the step and the consensus
    are also called captured and held bit for bit against their eager calls
    (``bench.matches_eager``), and timed captured beside eagerly, and
    ``benchmarks/scenario_mpc.run``'s row is taken with a profile of the
    chained step captured and eagerly; over gloo every call runs eagerly (a
    gloo group cannot be captured). Then ``sharded_batched_pair`` on ``(2
    ranks, 4096, 4096)`` (K2 once a matrix, equal to ``pair_reference`` bit
    for bit) and ``sharded_stream_sum`` on ``(ranks 8192, 8192)`` (K3 once a
    rank on a 2^26-element block, within 1e-6 rows max|a| of the f64 column
    sum); with this rank's times. Every rank must call it together. Raises
    on a failed check."""
    import torch.distributed as tdist

    from strided_tpu_torch import bench, config
    from strided_tpu_torch.benchmarks import scenario_mpc
    from strided_tpu_torch.capture import disable_capture
    from strided_tpu_torch.core import kernels_special as ks
    from strided_tpu_torch.core import stream_reduce as sr
    from strided_tpu_torch.mpc import fused_admm as fa
    from strided_tpu_torch.parallel import (axis_size, collective, gather,
                                            scenario_consensus_control, shard,
                                            sharded_batched_pair, sharded_mpc_step,
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
        (xn_c, u_c), out["step_first_ms"], _ = bench.matches_eager(lambda: step(x))
        (uc_c, _), out["consensus_first_ms"], _ = bench.matches_eager(lambda: cons(x))
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
        out["step_ms"] = bench.cuda_ms(lambda: step(x), reps=20, warmup=3)
        out["consensus_ms"] = bench.cuda_ms(lambda: cons(x), reps=20, warmup=3)
    with disable_capture():
        out["step_eager_ms"] = bench.cuda_ms(lambda: step(x), reps=20, warmup=3)
        out["consensus_eager_ms"] = bench.cuda_ms(lambda: cons(x), reps=20, warmup=3)
    buf = torch.zeros(4, device=dev)  # the consensus's all_reduce alone, eagerly
    out["all_reduce_ms"] = bench.cuda_ms(lambda: collective("all_reduce", buf, mesh),
                                         reps=20, warmup=3)
    if nccl:  # the benchmark's row on these ranks, and its chained step profiled
        row = scenario_mpc.run(device=dev)
        for k in ("latency_ms", "eager_latency_ms", "device_ms", "first_call_ms"):
            out["scenario_" + k] = row[k]
        chain = scenario_mpc.chained_step(step, mesh)
        dev_ms, kernels, rows = bench.device_profile(lambda: chain(x), calls=5)
        out.update(profile_ms=dev_ms, profile_kernels=kernels, profile=_profile_lines(rows))
        with disable_capture():
            dev_ms, kernels, rows = bench.device_profile(lambda: chain(x), calls=5)
        out.update(profile_eager_ms=dev_ms, profile_eager_kernels=kernels,
                   profile_eager=_profile_lines(rows))

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


def slice_c_ranks(nproc: int, backend, card) -> None:
    """Phase 14(b): ``nproc`` ranks of :func:`slice_c_rank` on the card
    (NCCL, one card a rank, unless ``backend="gloo"``); prints each rank's
    numbers, and over NCCL each rank's ``scenario_mpc`` row and the profile
    of its chained step. Raises when a rank fails."""
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
        captured = bool(f["captured"])
        if captured:
            mode = (f"captured: step and consensus == eager bit for bit "
                    f"{bool(f['captured_equals_eager'])}, graphs in the dry run "
                    f"{res['graph_captures']} captures / {res['graph_replays']} replays")
            times = (f"step {f['step_ms']:.4f} ms captured, {f['step_eager_ms']:.4f} eager, "
                     f"first call {f['step_first_ms']:.1f}; consensus {f['consensus_ms']:.4f} "
                     f"captured, {f['consensus_eager_ms']:.4f} eager")
        else:
            mode = f"eager (gloo): a captured call refused ({str(res['err_gloo_graph'])[:60]}...)"
            times = (f"step {f['step_eager_ms']:.4f} ms eager, consensus "
                     f"{f['consensus_eager_ms']:.4f} eager")
        print(f"[14 slice C] rank {r} of {nproc} ({res['backend']}, {res['device']}), {mode}; "
              f"dry run K1 {res['k1_step_f32']}+{res['k1_consensus_f32']}, K2 "
              f"{res['k2_launches']}, K3 {res['stream_launches']} launches; full size: u rows "
              f"vs unsharded {f['step_u_err']:.3e}, consensus {f['consensus_err']:.3e} (limit "
              f"1e-5), vs plain ADMM {f['k1_plain_err']:.3e} (limit {ATOL_KERNEL}), K1 "
              f"{f['k1_launches_step']}+{f['k1_launches_consensus']} eagerly, K2 "
              f"{f['k2_launches']} (== plain: {f['k2_exact']}), K3 {f['k3_launches']} "
              f"{[str(r) for r in f['k3_routes']]} err {f['k3_err']:.3e} (tol {f['k3_tol']:.3e}); "
              f"{times}, all_reduce of 4 floats {f['all_reduce_ms']:.4f} ms eager; u[0] "
              f"{[round(float(v), 6) for v in f['u0']]} [{card}]")
        if captured:
            lat = float(f["scenario_latency_ms"])
            print(f"[14 slice C] rank {r} of {nproc}: scenario_mpc chained step captured "
                  f"{lat:.4f} ms, eager {float(f['scenario_eager_latency_ms']):.4f}, device "
                  f"{float(f['scenario_device_ms']):.4f}, first call "
                  f"{float(f['scenario_first_call_ms']):.1f}; profiled captured "
                  f"{float(f['profile_kernels']):.0f} device ops, "
                  f"{float(f['profile_ms']):.4f} device ms a step (busy share "
                  f"{float(f['profile_ms']) / lat:.3f}); eagerly "
                  f"{float(f['profile_eager_kernels']):.0f} ops, "
                  f"{float(f['profile_eager_ms']):.4f} device ms (busy share "
                  f"{float(f['profile_eager_ms']) / float(f['scenario_eager_latency_ms']):.3f}) "
                  f"[{card}]")
            for line in f["profile"]:
                print(f"  rank {r} captured: {line}")
            for line in f["profile_eager"][:3]:
                print(f"  rank {r} eager: {line}")


def slice_c_phase(dev, card) -> None:
    """Phase 14: slice C, the multi-GPU layer, on one process (a 1-rank NCCL
    mesh: the step and the consensus counted eagerly, then captured and held
    bit for bit against eager, K1 in their profiled replays, the sharded
    rollout replaying the captured ``rollout``, ``scenario_mpc``'s row) and
    on two ranks (:func:`slice_c_ranks`). Raises on any failed check or
    failing rank."""
    import torch.distributed as tdist

    from strided_tpu_torch import bench
    from strided_tpu_torch import capture as cap
    from strided_tpu_torch.benchmarks import scenario_mpc
    from strided_tpu_torch.models import double_pendulum
    from strided_tpu_torch.mpc import fused_admm as fa
    from strided_tpu_torch.mpc import rollout
    from strided_tpu_torch.parallel import (make_mesh, scenario_consensus_control,
                                            sharded_mpc_step, sharded_rollout)

    t0 = time.perf_counter()
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
        (xn_c, u_c), step_first, step_capture = bench.matches_eager(lambda: step(x))
        step_recorded = fa.LAUNCHES
        fa.LAUNCHES = 0
        (uc_c, _), cons_first, cons_capture = bench.matches_eager(lambda: cons(x))
        cons_recorded = fa.LAUNCHES
        captured = (torch.equal(xn_c, xn) and torch.equal(u_c, u)
                    and torch.equal(uc_c, u_cons))
        graphs = cap.CAPTURES - graphs
        print(f"[14 slice C] one rank ({backend}), 16384 scenarios, N=50, ADMM-20: eager step "
              f"== ctrl.control + model.step bit for bit: {same}; consensus == their mean: "
              f"{same_cons}; K1 launches eagerly: step {step_launches}, consensus "
              f"{cons_launches}; captured (one graph each, {graphs} captures) == eager bit for "
              f"bit: {captured}; K1 launches of the warm-up, the capture and the eager call: "
              f"step {step_recorded}, consensus {cons_recorded}; first call step "
              f"{step_first:.1f} ms (capture "
              f"{step_capture:.1f}), consensus {cons_first:.1f} ms (capture {cons_capture:.1f}) "
              f"[{card}]")
        if (backend != "nccl" or not (same and same_cons and captured) or graphs != 2
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
                  f"fused_admm_kernel {k1:.1f} a call, {profiled[1]:.0f} device ops, "
                  f"{profiled[0]:.4f} device ms a call; replays {cap.REPLAYS - replays} [{card}]")
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

        fa.LAUNCHES = 0
        row = scenario_mpc.run(device=dev)  # over the same 1-rank group
        torch.cuda.synchronize()
        print(f"[14 slice C] scenario_mpc {json.dumps(row)}")
        print(f"[14 slice C] one rank: chained step captured {row['latency_ms']:.4f} ms against "
              f"{row['device_ms']:.4f} device ({row['latency_ms'] / row['device_ms']:.3f}x), "
              f"eager {row['eager_latency_ms']:.4f}, first call {row['first_call_ms']:.1f} ms "
              f"[{card}]")
        if not row["captured"] or row["ranks"] != 1 or row["backend"] != "nccl":
            raise RuntimeError(f"scenario_mpc: not a captured 1-rank NCCL row: {row}")
        chain = scenario_mpc.chained_step(step, mesh)
        bench.print_profile("scenario chained step 16384 x N=50 x ADMM-20, one rank, captured",
                            "step", row["latency_ms"], bench.device_profile(lambda: chain(x),
                                                                            calls=5))
        with cap.disable_capture():
            bench.print_profile("scenario chained step, one rank, eager", "step",
                                row["eager_latency_ms"],
                                bench.device_profile(lambda: chain(x), calls=5))
    finally:
        tdist.destroy_process_group()
    del x, xn, u, u_loc, step, cons, ctrl, chain, xn_c, u_c, uc_c
    torch.cuda.empty_cache()  # leave the card to the ranks

    slice_c_ranks(2, None if torch.cuda.device_count() >= 2 else "gloo", card)
    print(f"[14 slice C] {time.perf_counter() - t0:.1f} s")


def mpc_stack_phase(dev, card) -> None:
    """Phase 13: Riccati, rollouts and iLQR (slice B, plain PyTorch, no
    kernel of its own) on the card at the reference's sizes, each held to
    the port's own f64 run on the CPU. Raises on any failed check."""
    from strided_tpu_torch import bench
    from strided_tpu_torch.benchmarks import ilqr_bench
    from strided_tpu_torch.capture import disable_capture
    from strided_tpu_torch.mpc import ilqr, rollout, rollout_final

    t0 = time.perf_counter()

    dK, k_scale = bench.riccati_accuracy(dev)
    print(f"[13 mpc stack] Riccati N=50: max |dK| f32 card vs f64 CPU {dK:.3e} "
          f"(limit {RICCATI_LIMIT}), max |K| {k_scale:.4f} [{card}]")
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
          f"bit; first 64 vs f64 CPU max |dx| {e:.3e} (limit {ROLLOUT_LIMIT}) [{card}]")
    if not e <= ROLLOUT_LIMIT:
        raise RuntimeError(f"rollouts off the f64 run by {e:.3e}")
    row = bench.rollout_times(dev)  # captured == eager, or it raises; prints its times
    call = lambda: rollout_final(model, x0, us, bench.ROLLOUT_DT)  # noqa: E731
    with disable_capture():
        bench.print_profile("rollouts 4096 x 100, eager", "call", row["eager_ms"],
                            bench.device_profile(call, warmup=0))
    bench.print_profile("rollouts 4096 x 100, captured", "call", row["captured_ms"],
                        bench.device_profile(call, warmup=1))

    du, u_scale, c32, c64 = bench.ilqr_accuracy(dev)
    print(f"[13 mpc stack] iLQR cartpole T=40 x 15: max |du| f32 card vs f64 CPU {du:.3e} "
          f"(limit {ILQR_LIMIT}), input scale {u_scale:.4f}, cost {c32:.6f} vs {c64:.6f} "
          f"[{card}]")
    if not du <= ILQR_LIMIT:
        raise RuntimeError(f"iLQR inputs off the f64 run by {du:.3e}")

    row = ilqr_bench.run(device=dev)  # captured == eager, costs finite, or it raises
    print(f"[13 mpc stack] iLQR batch 256 x T=50 x 10: captured == eager bit for bit, costs "
          f"finite; captured {row['captured_latency_ms']:.4f} ms "
          f"({row['captured_solves_per_s']:.6g} solves/s), eager {row['latency_ms']:.4f} ms "
          f"({row['solves_per_s']:.6g} solves/s), device {row['device_latency_ms']:.4f} ms "
          f"({row['device_solves_per_s']:.6g} solves/s); first call {row['first_call_ms']:.1f} "
          f"ms, its capture and instantiation {row['capture_ms']:.1f} ms [{card}]")
    print(f"[13 mpc stack] ilqr_bench {json.dumps(row)}")
    # The solve profiled captured only: under the profiler the eager solve's
    # 90k host launches were most of this phase's time.
    model, cost, x0s, us0 = ilqr_bench.problem(device=dev)
    solve = lambda: ilqr(model, cost, x0s, us0, bench.CARTPOLE_DT, iters=10)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    profiled = bench.device_profile(solve, warmup=1)  # the warm-up call captures
    print(f"[13 mpc stack] iLQR's graph: the card's reserved memory grew by "
          f"{(torch.cuda.memory_reserved() - reserved) / 2**20:.1f} MiB at its capture [{card}]")
    bench.print_profile("iLQR batch 256 x T=50 x 10, captured", "solve",
                        row["captured_latency_ms"], profiled)
    print(f"[13 mpc stack] {time.perf_counter() - t0:.1f} s")


def gates_phase(dev, card) -> None:
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
    card's peak, the litmus) and ``exp_contract`` in a process of its own
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

    t0 = time.perf_counter()
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
          f"min_stream_reduce_elements {cfg.min_stream_reduce_elements} [{card}]")

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
          f"litmus x + 1.0 {litmus['add1_device_gbs']:.0f} GB/s against x.clone() "
          f"{litmus['clone_device_gbs']:.0f} ({litmus['copies']} copies)")
    # a process of its own: after the profiles of phases 5-14 this process's
    # profiler has been seen to record no kernel at all
    proc = subprocess.run([sys.executable, "-m", "strided_tpu_torch.benchmarks.exp_contract"],
                          capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if len(lines) != 2:
        raise RuntimeError(f"exp_contract exited {proc.returncode}: {proc.stderr[-2000:]}")
    check, timing = map(json.loads, lines)
    for name in ("contract", "mul"):
        c = check[name]
        print(f"[15 gates] {name} on transpose(v) 1024^2: kernels {len(c['kernels'])}, before "
              f"the product {c['before_product']}, peak growth {c['peak_growth']} B (limit "
              f"{c['limit']}), |result - f64| {c['max_abs_err_vs_f64']:.3e}")
    if not check["ok"] or proc.returncode != 0:
        raise RuntimeError(f"exp_contract: a copy before the product, or the peak grew: {check}")
    print(f"[15 gates] contract on transpose(v) 2048^2 {timing['lazy_ms']:.4f} ms (device "
          f"{timing['lazy_device_ms']:.4f}) against einsum on the dense transpose "
          f"{timing['dense_ms']:.4f} ({timing['dense_device_ms']:.4f}) [{card}]")
    print(f"[15 gates] {time.perf_counter() - t0:.1f} s")


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


def _ns_per_span(annotate, n: int = 1_000_000) -> tuple:
    """(ns one span costs, net of the loop; ns an iteration of the loop
    that enters it; ns an iteration of the same loop without it)."""
    t = time.perf_counter_ns()
    for _ in range(n):
        with annotate("capture.replay"):
            pass
    with_span = (time.perf_counter_ns() - t) / n
    t = time.perf_counter_ns()
    for _ in range(n):
        pass
    loop = (time.perf_counter_ns() - t) / n
    return with_span - loop, with_span, loop


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


def tracing_phase(dev, card) -> None:
    """Phase 17: the port's spans (``utils/profiling.py``). A span's host
    cost with tracing off and on; the captured MPC step at batch 16384
    with tracing off (no marker in a profiled replay), then on (a capture
    of its own, ``qp.solve`` and ``model.step`` each between their two
    markers once a replay, equal to the unmarked step bit for bit); the
    markers' device time, both graphs in turns; a graph the caller
    captures itself, with tracing on, holds no marker; the totals."""
    from strided_tpu_torch import capture as cap
    from strided_tpu_torch.entry import make_controller, make_step
    from strided_tpu_torch.mpc.qp import qp_solve
    from strided_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    off = _ns_per_span(profiling.annotate)
    profiling.enable()
    on = _ns_per_span(profiling.annotate)
    profiling.disable()
    profiling.reset()
    print(f"[17 tracing] a span, host ns net of the loop (the loop with it, without it): off "
          f"{off[0]:.1f} ({off[1]:.1f}, {off[2]:.1f}), on {on[0]:.1f} ({on[1]:.1f}, "
          f"{on[2]:.1f}); torch {torch.__version__} [{card}]")

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
        said = "none" if t is None else (
            f"{t['count']} calls, {t['total_ns'] / t['count'] / 1e3:.2f} us a call, self "
            f"{t['self_ns'] / t['count'] / 1e3:.2f}, parents {t['parents']}")
        print(f"[17 tracing] {name}: {said}")
    if totals["capture.replay"]["count"] < 20 or "capture.replay" not in \
            totals["capture.launch"]["parents"]:
        raise RuntimeError(f"the replay spans are not as documented: {totals}")

    graphs = {}
    for traced in (False, True):
        if traced:
            profiling.enable()
        key, _ = cap.signature((x,), {})
        graphs[traced] = step.cache.get(key)[0]
        profiling.disable()
    ms = {False: [], True: []}
    for traced in (False, True, True, False):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        graphs[traced].replay()
        start.record()
        for _ in range(200):
            graphs[traced].replay()
        end.record()
        torch.cuda.synchronize()
        ms[traced].append(start.elapsed_time(end) / 200)
    print(f"[17 tracing] step device ms a replay, in turns: unmarked {ms[False]}, marked "
          f"{ms[True]} [{card}]")
    profiling.reset()
    print(f"[17 tracing] {time.perf_counter() - t0:.1f} s")


def plant_process() -> dict:
    """Phase 18 in a process of its own (``python3 chip_smoke.py
    --plant-phase``; its profiles need a profiler that still records
    kernels), its output printed here; returns the kernel's row of the JSON
    line; raises when it fails."""
    import os
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--plant-phase"],
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.splitlines()
    print("\n".join(ln for ln in lines if not ln.startswith("{")))
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    if proc.returncode != 0 or len(rows) != 1:
        raise RuntimeError(f"phase 18 exited {proc.returncode}: {proc.stderr[-3000:]}")
    return rows[0]


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


def plant_phase(dev, card) -> None:
    """Phase 18 (the module docstring): prints its checks and times, and
    the kernel's row of the JSON line last, as a JSON object of its own."""
    import dataclasses

    from strided_tpu_torch import capture as cap
    from strided_tpu_torch.bench import graph_ms
    from strided_tpu_torch.entry import make_controller, make_step
    from strided_tpu_torch.models import hover_input, hover_state, quadrotor, rk4_step
    from strided_tpu_torch.models import quadrotor_rk4 as qr

    t0 = time.perf_counter()
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

    worst = 0.0
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
        if dtype == f32:
            worst = max(worst, widest)
        what = (f"batch {batch} {str(dtype)[6:]}" + (f", m 1.7, dt {h}" if body is other else "")
                + (", strided x and u" if how else ""))
        print(f"[18 plant] {what}: |kernel - eager| / (|eager| + 1) widest {widest:.3e} "
              f"(limit {qr.TOLERANCE[dtype]:.0e}), widest gap {ulps.max().item()} ulps "
              f"({at_clamp} on the "
              f"{near.numel()} rows at the clamp), bit for bit "
              f"{(got == want).double().mean().item():.6f} of the elements, non-finite "
              f"{int((~torch.isfinite(got)).sum())} [{card}]")
        if not bool(agree.all()):
            raise RuntimeError(f"{what}: {int((~agree).sum())} elements off the eager "
                               f"step by more than {qr.TOLERANCE[dtype]:.0e} (|eager| + 1)")

    x, u, _ = qr.stress_inputs((16384,), dev, seed=1818)
    fused = lambda: model.step(x, u, dt)  # noqa: E731
    eager = lambda: rk4_step(model.dynamics, x, u, dt)  # noqa: E731
    k1, p1, p2, k2 = (graph_ms(f) for f in (fused, eager, eager, fused))
    plant_bound = bound(16384 * 28 * 4)
    print(f"[18 plant] the plant alone at 16384, device time through CUDA graphs in turns: "
          f"kernel {k1:.4f}/{k2:.4f} ms, eager {p1:.4f}/{p2:.4f} ms; bound "
          f"{plant_bound['bound_ms']:.4f} ms ({plant_bound['bound_by']}) [{card}]")

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
    ms = {"kernel": [], "eager": []}
    for name in ("kernel", "eager", "eager", "kernel"):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        graphs[name].replay()
        start.record()
        for _ in range(200):
            graphs[name].replay()
        end.record()
        torch.cuda.synchronize()
        ms[name].append(start.elapsed_time(end) / 200)
    print(f"[18 plant] captured step, ms a replay back to back, in turns: kernel plant "
          f"{ms['kernel']}, eager plant {ms['eager']} [{card}]")
    print(f"[18 plant] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({
        "name": "quadrotor_rk4", "route": "cuda",
        "source": "strided_tpu_torch/csrc/quadrotor_rk4.cu",
        "replaces": None,  # no TPU kernel: XLA fuses the reference's plant
        "launches": None,  # a step's count, from phase 5's profiled replay (main)
        "max_rel_err": worst, "ms": min(k1, k2), "plain_ms": min(p1, p2),
        **plant_bound, "library_ms": None}))


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--slice-c-rank"]:
        slice_c_rank(*sys.argv[2:])
    elif sys.argv[1:2] == ["--tracing-phase"]:
        from strided_tpu_torch.bench import card_label

        tracing_phase("cuda", card_label())
    elif sys.argv[1:2] == ["--plant-phase"]:
        from strided_tpu_torch.bench import card_label

        plant_phase("cuda", card_label())
    else:
        main()
