"""Multi-process runs of the multi-GPU layer, each rank checked against a
process-local oracle.

Counterpart of ``strided_tpu/parallel/multiproc.py``. :func:`spawn` starts
N worker processes that join one ``torch.distributed`` process group
through a file rendezvous in a new temporary directory (no port to pick, so
parallel runs cannot collide), and :func:`run_multiprocess_check` spawns
this module's worker. Each worker joins through
:func:`~.dist.init_distributed`, builds a ``('data',)`` mesh over the ranks
and runs :func:`dryrun_checks` on :func:`dryrun_inputs`: the reference
worker's checks (the k-split matmul; the consensus step against a
process-local oracle at 1e-5) and the rest of
``__graft_entry__.dryrun_multichip``'s surface (the sharded step and
rollout, the three matmul splits, ``sharded_smap``, partial and complete
``sharded_reduce``, ``sharded_batched_pair`` (K2 per rank),
``sharded_stream_sum`` (K3 per rank), the mesh's clamp and refusals, and
the ``('data', 'model')`` mesh with 4 ranks or more). Each worker prints a
``MULTIPROC_OK`` line and, given an output directory, writes what it
computed to ``rank<r>.npz`` there.

Worker entry: ``python -m strided_tpu_torch.parallel.multiproc <init_method>
<nproc> <rank> <device> <backend|auto> [<outdir>]``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Sequence

__all__ = ["spawn", "run_multiprocess_check", "worker_main", "dryrun_inputs", "dryrun_checks"]

# torchrun's variables: a worker takes its rank from its arguments only
_CLUSTER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE", "GROUP_RANK", "ROLE_RANK", "TORCHELASTIC_RUN_ID")


def spawn(argv: Sequence[str], nproc: int, args: Sequence[str] = (), timeout: float = 300) -> List[str]:
    """Run ``python *argv <init_method> <nproc> <rank> *args`` for each rank
    and return their outputs (stdout and stderr) in rank order.

    When a worker exits non-zero the others are killed and ``RuntimeError``
    carries its output; workers still running after ``timeout`` seconds are
    killed and ``RuntimeError`` carries every output."""
    env = {k: v for k, v in os.environ.items() if k not in _CLUSTER_ENV}
    root = str(Path(__file__).resolve().parents[2])  # workers import the package from here
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory(prefix="strided_tpu_torch_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(nproc)]
        procs, killed = [], []
        try:
            for r in range(nproc):
                procs.append(subprocess.Popen(
                    [sys.executable, *argv, init, str(nproc), str(r), *args],
                    stdout=logs[r], stderr=subprocess.STDOUT, env=env))
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                if None not in codes or any(codes):  # all done, or one failed
                    break
                time.sleep(0.05)
        finally:
            for r, p in enumerate(procs):
                if p.poll() is None:
                    p.kill()
                    killed.append(r)
                p.wait()
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
                f.close()
    for r, p in enumerate(procs):
        if r not in killed and p.returncode != 0:
            raise RuntimeError(f"worker {r} of {nproc} failed with exit code {p.returncode}"
                               f"{f' (ranks {killed} killed)' if killed else ''}:\n{outs[r]}")
    if killed:
        raise RuntimeError(f"workers {killed} of {nproc} still running after {timeout} s were "
                           f"killed:\n" + "\n".join(f"--- worker {r}:\n{o}" for r, o in enumerate(outs)))
    return outs


def run_multiprocess_check(nproc: int = 2, device="cuda", backend=None, timeout: float = 300,
                           outdir: Optional[str] = None) -> List[str]:
    """Spawn ``nproc`` ranks of this module's worker on ``device`` (the card
    by default; NCCL there unless ``backend="gloo"`` is given, which several
    ranks on one card need) and return their outputs, each with a
    ``MULTIPROC_OK`` line; raises ``RuntimeError`` with a worker's output
    when it fails or prints no such line. With ``outdir``, each rank writes
    what :func:`dryrun_checks` returned to ``outdir/rank<r>.npz``."""
    import torch

    if torch.device(device).type == "cuda":
        from .._build import load_library

        load_library()  # one nvcc build here, not one a worker
    args = (str(device), backend or "auto") + (() if outdir is None else (str(outdir),))
    outs = spawn(["-m", "strided_tpu_torch.parallel.multiproc"], nproc, args, timeout)
    for r, out in enumerate(outs):
        if "MULTIPROC_OK" not in out:
            raise RuntimeError(f"worker {r} printed no MULTIPROC_OK line:\n{out}")
    return outs


def dryrun_inputs() -> dict:
    """The dry run's operands, the same numpy arrays on every rank (one
    seed): sizes that divide by 1, 2, 4 and 8 ranks, except ``odd_a``'s 9
    rows."""
    import numpy as np

    rng = np.random.default_rng(0)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return {
        "x_step": rng.uniform(-0.2, 0.2, (16, 12)),
        "x_cons": rng.uniform(-0.2, 0.2, (32, 12)),
        "roll_x0": rng.standard_normal((64, 4)) * 0.1,
        "roll_us": rng.standard_normal((64, 20, 2)) * 0.01,
        "batch_x": np.arange(32.0).reshape(32, 1),
        "mm_A": f32(rng.standard_normal((48, 64))),
        "mm_B": f32(rng.standard_normal((64, 56))),
        "mm_Ai": rng.integers(-50, 50, (8, 16)).astype(np.int32),
        "mm_Bi": rng.integers(-50, 50, (16, 6)).astype(np.int32),
        "smap_a": rng.standard_normal((64, 32)),
        "smap_at": rng.standard_normal((32, 64)),
        "red_a": rng.standard_normal((64, 48)),
        "expr_a": rng.standard_normal((32, 32)),
        "odd_a": rng.standard_normal((9, 3)),
        "pair_x": f32(rng.standard_normal((8, 128, 128))),
        "sum_a": f32(rng.standard_normal((1024, 256))),
        "dm_X": f32(rng.standard_normal((16, 32))),
        "dm_W": f32(rng.standard_normal((32, 24))),
    }


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def _max_err(a, b) -> float:
    import torch

    return (torch.as_tensor(a).double().cpu() - torch.as_tensor(b).double().cpu()).abs().max().item()


def _controller(dtype, device):
    """``tests/test_sharding.py``'s controller: the quadrotor at horizon 8,
    dt 0.05, inputs within (-5, 10) and +-0.2."""
    import torch

    from ..models import hover_input, hover_state, quadrotor
    from ..mpc import make_hover_mpc

    as_t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    Q = torch.diag(as_t([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1]))
    model = quadrotor()
    ctrl = make_hover_mpc(
        model, hover_state(dtype, device), hover_input(dtype=dtype, device=device), Q,
        torch.eye(4, dtype=dtype, device=device) * 0.1, Q, horizon=8, dt=0.05,
        u_min=as_t([-5.0, -0.2, -0.2, -0.2]), u_max=as_t([10.0, 0.2, 0.2, 0.2]))
    return model, ctrl


def dryrun_checks(mesh, device) -> dict:
    """``__graft_entry__.dryrun_multichip``'s surface and the reference
    worker's checks on the ranks of ``mesh`` (a ``('data',)`` mesh), on
    :func:`dryrun_inputs`. Each result is checked against the port's
    unsharded result or numpy in this process; raises on a failed check.

    Returns numpy arrays: each result gathered over the ranks (key ``name``)
    beside the unsharded one (``name_local``), the rank's block shapes
    (``name_block``), the collectives each call issued (``coll_name``:
    all_reduce, all_gather, broadcast), the launches of K1 (``k1_step_f32``,
    ``k1_consensus_f32``), K2 (``k2_launches``) and K3 (``stream_launches``)
    on this rank, and the messages of the refusals (``err_name``).

    The step and the consensus are counted eagerly, inside
    ``disable_capture()``: a captured call's counts are its warm-up's and
    capture's, and a replay adds none. Then they are called as a user calls
    them and held bit for bit against the eager results: on the card over
    NCCL one capture and one replay each (``graph_captures``,
    ``graph_replays``), over gloo on the card a ``RuntimeError`` before any
    capture (``err_gloo_graph``), on the CPU the functions as they are."""
    import dataclasses
    import warnings

    import numpy as np
    import torch
    import torch.distributed as dist

    from .. import capture as cap
    from ..api import to_array
    from ..config import get_config, set_config
    from ..core import kernels_special as ks
    from ..core import stream_reduce as sr
    from ..core.mapreduce import ssum
    from ..core.view import strided, transpose
    from ..models import double_pendulum
    from ..mpc import fused_admm as fa
    from ..mpc.rollout import rollout
    from . import (COLLECTIVES, axis_size, gather, make_mesh, matmul_ksplit, matmul_msplit,
                   matmul_nsplit, scenario_consensus_control, shard, shard_batch,
                   sharded_batched_pair, sharded_mpc_step, sharded_reduce, sharded_rollout,
                   sharded_smap, sharded_stream_sum)
    from .tp import _dot

    n = axis_size(mesh)
    on_card = torch.device(device).type == "cuda"
    gloo_card = on_card and dist.get_backend(mesh.get_group("data")) != "nccl"
    inp = dryrun_inputs()
    t = lambda k: torch.as_tensor(inp[k], device=device)  # noqa: E731
    res = {}

    def counted(name, fn):
        """``fn()``, with the collectives it issued recorded as ``coll_name``."""
        before = dict(COLLECTIVES)
        out = fn()
        res[f"coll_{name}"] = np.array([COLLECTIVES[k] - before[k] for k in COLLECTIVES])
        return out

    def expect(name, collectives):
        _check(tuple(res[f"coll_{name}"]) == collectives,
               f"{name}: collectives {tuple(res[f'coll_{name}'])}, expected {collectives}")

    def refused(name, fn):
        """Record the ``ValueError`` that ``fn()`` raises as ``err_name``."""
        try:
            fn()
        except ValueError as e:
            res[f"err_{name}"] = np.array(str(e))
            return
        raise RuntimeError(f"{name}: no ValueError")

    # ---- the scenario-split step and the consensus, f64 then f32 (K1) ----
    graphs = (cap.CAPTURES, cap.REPLAYS)
    for dtype, sfx, tol in ((torch.float64, "", 1e-12), (torch.float32, "_f32", 1e-5)):
        model, ctrl = _controller(dtype, device)
        x, xc = t("x_step").to(dtype), t("x_cons").to(dtype)
        step = sharded_mpc_step(ctrl, model, mesh, 0.05)
        cons = scenario_consensus_control(ctrl, mesh)
        u_loc, _ = ctrl.control(x)
        with cap.disable_capture():  # eager calls: the counts a call
            k1 = fa.LAUNCHES
            xn, u = counted("step" + sfx, lambda: step(x))
            res["k1_step" + sfx] = fa.LAUNCHES - k1
            k1 = fa.LAUNCHES
            u_cons, plans = counted("consensus" + sfx, lambda: cons(xc))
            res["k1_consensus" + sfx] = fa.LAUNCHES - k1
        if gloo_card:
            for fn, arg in ((step, x), (cons, xc)):
                try:
                    fn(arg)
                except RuntimeError as e:
                    res["err_gloo_graph"] = np.array(str(e))
                else:
                    raise RuntimeError(f"{fn.__name__} over gloo on the card ran instead of "
                                       f"raising")
        else:
            same = [torch.equal(a, b) for a, b in zip((*step(x), *cons(xc)),
                                                      (xn, u, u_cons, plans))]
            _check(all(same), f"step{sfx}/consensus{sfx}: the decorated calls differ from "
                              f"the eager ones (x, u, u_cons, plans equal: {same})")
        res.update({"step_u" + sfx: gather(u, mesh), "step_x" + sfx: gather(xn, mesh),
                    "step_block" + sfx: np.array(u.shape), "step_u_local" + sfx: u_loc,
                    "step_x_local" + sfx: model.step(x, u_loc, 0.05)})
        u_loc, plans_loc = ctrl.control(xc)
        res.update({"cons_u" + sfx: u_cons, "cons_plans" + sfx: gather(plans, mesh),
                    "cons_u_local" + sfx: u_loc.mean(0), "cons_plans_local" + sfx: plans_loc})
        for key in ("step_u", "step_x", "cons_u", "cons_plans"):
            err = _max_err(res[key + sfx], res[key + "_local" + sfx])
            _check(err <= tol, f"{key}{sfx}: {err:.3e} off the unsharded result (limit {tol})")
        expect("step" + sfx, (0, 0, 0))
        expect("consensus" + sfx, (1, 0, 0))
    _check(res["k1_step_f32"] == res["k1_consensus_f32"] == int(on_card),
           "K1 did not launch once a call on the card")
    res["graph_captures"] = cap.CAPTURES - graphs[0]
    res["graph_replays"] = cap.REPLAYS - graphs[1]
    captures = 4 * int(on_card and not gloo_card)  # step and consensus, f64 and f32
    _check(res["graph_captures"] == res["graph_replays"] == captures,
           f"{res['graph_captures']} captures and {res['graph_replays']} replays, expected "
           f"{captures} of each")
    if n > 1:  # 4n - 1 rows over n ranks: no even split
        with cap.disable_capture():
            refused("batch", lambda: step(x[: n * 4 - 1]))

    # ---- a rollout and a generic batch function ----
    pend = double_pendulum()
    x0, us = t("roll_x0"), t("roll_us")
    res["rollout"] = gather(counted("rollout", lambda: sharded_rollout(pend, mesh, 0.01)(x0, us)),
                            mesh)
    res["rollout_local"] = rollout(pend, x0, us, 0.01)
    res["batch"] = gather(shard_batch(lambda z: torch.sin(z) * 2.0, mesh)(t("batch_x")), mesh)
    res["batch_local"] = torch.sin(t("batch_x")) * 2.0
    for key in ("rollout", "batch"):
        _check(_max_err(res[key], res[key + "_local"]) <= 1e-12, f"{key}: off the unsharded")

    # ---- the three matmul splits; the k-split's all_reduce crosses the ranks ----
    A, B = t("mm_A"), t("mm_B")
    res["mm_local"] = _dot(A, B)
    for name, fn, dim in (("n", matmul_nsplit, 1), ("m", matmul_msplit, 0),
                          ("k", matmul_ksplit, None)):
        C = counted(f"mm_{name}", lambda: fn(A, B, mesh))
        res[f"mm_{name}"] = C if dim is None else gather(C, mesh, dim)
        _check(np.allclose(res[f"mm_{name}"].cpu().numpy(), inp["mm_A"] @ inp["mm_B"],
                           atol=1e-3), f"{name}-split matmul mismatch")
    expect("mm_k", (1, 0, 0))
    res["mm_k_int"] = matmul_ksplit(t("mm_Ai"), t("mm_Bi"), mesh)
    _check(np.array_equal(res["mm_k_int"].cpu().numpy(), inp["mm_Ai"] @ inp["mm_Bi"]),
           "int k-split matmul not exact")

    # ---- the engine: maps, partial and complete reductions ----
    a, at, r, e = (strided(t(k)) for k in ("smap_a", "smap_at", "red_a", "expr_a"))
    m = counted("smap", lambda: sharded_smap(lambda p, q: p + 2 * q, mesh, a, a))
    res.update(smap=gather(m.materialize(), mesh, 0), smap_block=np.array(m.shape),
               smap_local=3 * t("smap_a"))
    m = counted("smap_t", lambda: sharded_smap(lambda p: p + 1.0, mesh, transpose(at)))
    res.update(smap_t=gather(m.materialize(), mesh, 1), smap_t_block=np.array(m.shape),
               smap_t_local=t("smap_at").T + 1.0)
    p = counted("partial", lambda: sharded_reduce(lambda z: z, torch.add, r, mesh, axes=1))
    res.update(partial=gather(p.materialize(), mesh), partial_block=np.array(p.shape),
               partial_local=t("red_a").sum(1))
    res["complete"] = counted("complete",
                              lambda: sharded_reduce(torch.abs, torch.maximum, r, mesh))
    res["complete_local"] = t("red_a").abs().max()
    res["complete_fold"] = counted(
        "complete_fold", lambda: sharded_reduce(lambda z: z, lambda p, q: p + q, r, mesh))
    res["complete_fold_local"] = t("red_a").sum()
    res["expr"] = counted("expr", lambda: sharded_reduce(
        lambda z: z, torch.add, (e + transpose(e)) / 2, mesh))
    res["expr_local"] = ssum((e + transpose(e)) / 2)
    for key in ("smap", "smap_t", "partial", "complete", "complete_fold", "expr"):
        err = _max_err(res[key], res[key + "_local"])
        _check(err <= 1e-12, f"{key}: {err:.3e} off the unsharded result")
    for key in ("smap", "smap_t", "partial"):
        expect(key, (0, 0, 0))
    expect("complete", (1, 0, 0))
    if inp["odd_a"].shape[0] % n:  # 9 rows over n ranks: no even split
        odd = strided(t("odd_a"))
        refused("smap", lambda: sharded_smap(lambda z: z * 2.0, mesh, odd))
        refused("reduce", lambda: sharded_reduce(lambda z: z, torch.add, odd, mesh))

    # ---- K2 and K3 per rank, combined over the mesh ----
    old = get_config()
    set_config(min_stream_reduce_elements=1024, pair_kernel_min_elements=1024)
    try:
        px = t("pair_x")
        k2 = ks.LAUNCHES
        sym = counted("pair", lambda: sharded_batched_pair(px, mesh, scale_mode="mul",
                                                            scale=0.5))
        res["k2_launches"] = ks.LAUNCHES - k2
        plain = [ks.pair_reference(b, scale_mode="mul", scale=0.5) for b in shard(px, mesh)]
        _check(all(torch.equal(s, q) for s, q in zip(sym, plain)), "K2 differs from plain")
        res.update(pair=gather(sym, mesh), pair_block=np.array(sym.shape),
                   pair_local=torch.stack([ks.pair_reference(q, scale_mode="mul", scale=0.5)
                                           for q in px]))
        sa = t("sum_a")
        tol = 1e-6 * sa.shape[0] * sa.abs().max().item()
        res["stream_local"] = to_array(ssum(strided(sa), axis=0)).reshape(-1)
        for key, gate in (("stream", 1024), ("stream_declined", 1 << 30)):
            set_config(min_stream_reduce_elements=gate)
            ks.LAST_REDUCE_DISPATCH = ""
            k3 = sr.LAUNCHES
            res[key] = counted(key, lambda: sharded_stream_sum(sa, mesh))
            res[key + "_launches"] = sr.LAUNCHES - k3
            res[key + "_dispatch"] = np.array(ks.LAST_REDUCE_DISPATCH)
            err = _max_err(res[key], sa.double().sum(0))
            _check(err <= tol, f"{key}: {err:.3e} off the f64 sum (tolerance {tol:.3e})")
        _check(str(res["stream_dispatch"]) == "stream-kernel", "K3 did not take the rank's block")
        _check(str(res["stream_declined_dispatch"]) == "xla", "K3's gate did not decline")
        _check(res["k2_launches"] == int(on_card) * px.shape[0] // n
               and res["stream_launches"] == int(on_card)
               and res["stream_declined_launches"] == 0,
               "K2/K3 did not launch once a matrix / a block on the card")
        expect("stream", (1, 0, 0))
    finally:
        set_config(**dataclasses.asdict(old))

    # ---- the mesh's own contract ----
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        clamped = make_mesh(axis_sizes=(n + 5,), device=torch.device(device).type)
    res.update(clamp_size=np.array(clamped.size()), clamp_warning=np.array(
        [str(x.message) for x in w if "clamping" in str(x.message)]))
    refused("2d", lambda: make_mesh((n, 2), ("data", "model"), device=torch.device(device).type))

    # ---- a ('data', 'model') mesh: a data-split batch times an n-split W ----
    if n >= 4 and n % 2 == 0:
        mesh2 = make_mesh((n // 2, 2), ("data", "model"), device=torch.device(device).type)
        X, W = t("dm_X"), t("dm_W")
        Y = counted("dm_n", lambda: torch.relu(
            matmul_nsplit(shard(X, mesh2, 0, "data"), W, mesh2, axis="model")))
        res["dm_n"] = gather(gather(Y, mesh2, 1, "model"), mesh2, 0, "data")
        res["dm_m"] = gather(counted("dm_m", lambda: matmul_msplit(A, B, mesh2, axis="data")),
                             mesh2, 0, "data")
        res["dm_k"] = counted("dm_k", lambda: matmul_ksplit(A, B, mesh2, axis="model"))
        res["dm_coords"] = np.array([mesh2.get_local_rank("data"),
                                     mesh2.get_local_rank("model")])
        _check(np.allclose(res["dm_n"].cpu().numpy(),
                           np.maximum(inp["dm_X"] @ inp["dm_W"], 0), atol=1e-4),
               "2-D mesh n-split matmul")
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in res.items()}


def worker_main(init_method: str, nproc: int, rank: int, device: str = "cuda",
                backend: str = "auto", outdir: Optional[str] = None) -> None:
    """One rank: join the group, build the mesh, run :func:`dryrun_checks`,
    print the ``MULTIPROC_OK`` line and, with ``outdir``, write the results
    to ``outdir/rank<rank>.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from . import dist as pdist
    from .mesh import make_mesh

    torch.set_num_threads(1)
    ok = pdist.init_distributed(init_method=init_method, world_size=nproc, rank=rank,
                                backend=None if backend == "auto" else backend, device=device)
    _check(ok, "init_distributed took the single-process no-op path")
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    try:
        res = dryrun_checks(make_mesh(device=dev.type), dev)
    finally:
        dist.destroy_process_group()
    _check("jax" not in sys.modules, "the port imported jax")
    if outdir is not None:
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), backend=np.array(pdist.BACKEND), **res)
    print(f"MULTIPROC_OK rank={rank} ranks={nproc} backend={pdist.BACKEND} "
          f"u={[round(float(v), 6) for v in res['cons_u_f32']]}", flush=True)


if __name__ == "__main__":
    worker_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:])
