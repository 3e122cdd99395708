"""The README's expressions through the port's public engine, eagerly,
round-robin, each call on another copy of its input.

Each expression's copies are drawn from the seed on the card in set-up
(``torch.randn`` with a seeded ``torch.Generator``), as many as put more
than 4x the card's L2 between two calls that read the same one, so no call
finds its input in L2. Each call writes a new output. The window is
eager: calls are made from Python as a user's code makes them, and one
``synchronize`` at the window's end is counted inside it. The rate is the
needed bytes of every call (each input byte read once, each output byte
written once: ``counts.elementwise_pass``) over the window's seconds.

Correctness: one call of each expression drawn from the seed among the
first ``sample_span`` rounds, and each expression's last call, are kept
and held after the window against the expression in f64
(``reference/strided_readme.py``), rounded to the input's dtype.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..common import Outcome, Profiler, Span, l2_bytes, per_second, rotation_count, steady
from ..counts import elementwise_pass
from ..reference import strided_readme as ref

def spellings() -> dict:
    """Each README expression through the port's public engine, spelled as
    ``strided_tpu_torch/benchmarks/sweeps.py``'s engine arms spell them;
    each returns a new tensor."""
    import strided_tpu_torch as st

    def symmetrize(x):
        v = st.strided(x)
        return st.to_array((v + st.transpose(v)) * 0.5)

    def scale_transpose(x):
        return st.to_array(3.0 * st.transpose(st.strided(x)))

    def broadcast(x):
        return st.to_array(st.sbroadcast(lambda t: t * torch.exp(-2 * t) + torch.sin(t * t),
                                         st.strided(x)))

    def permutedims(x):
        out = st.strided(torch.empty(tuple(reversed(x.shape)), dtype=x.dtype, device=x.device))
        return st.to_array(st.permutedims_into(out, st.strided(x), (3, 2, 1, 0)))

    def permute_sum(x):
        v = st.strided(x)
        return st.to_array(v + st.permutedims(v, ref.P2) + st.permutedims(v, ref.P3)
                           + st.permutedims(v, ref.P4))

    return {f.__name__: f for f in (symmetrize, scale_transpose, broadcast, permutedims,
                                    permute_sum)}


def route(call) -> str:
    """The kernels one call launched, from the port's own counters (K2's
    launches, K3's and K4's by the kernel their launchers report), or
    ``plain``."""
    from strided_tpu_torch.core import executor_cuda, kernels_special, stream_reduce

    k2, k3, k4 = kernels_special.LAUNCHES, dict(stream_reduce.PATHS), dict(executor_cuda.MAP_PATHS)
    k4_all = executor_cuda.LAUNCHES
    call()
    ran = [f"K2 x{kernels_special.LAUNCHES - k2}"] if kernels_special.LAUNCHES > k2 else []
    ran += [f"K3 {p} x{n - k3[p]}" for p, n in stream_reduce.PATHS.items() if n > k3[p]]
    ran += [f"K4 {p} x{n - k4[p]}" for p, n in executor_cuda.MAP_PATHS.items() if n > k4[p]]
    rest = executor_cuda.LAUNCHES - k4_all - sum(n - k4[p] for p, n in executor_cuda.MAP_PATHS.items())
    ran += [f"K4 reduction x{rest}"] if rest > 0 else []
    return ", ".join(ran) or "plain"


def operands(cell, seed: int, device, l2: int) -> dict:
    """``{expression: [input copies]}`` from ``seed``, on ``device``."""
    dtype = getattr(torch, cell.config["dtype"])
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for e in cell.config["expressions"]:
        shape = tuple(cell.traffic["shapes"][e])
        nbytes = int(np.prod(shape)) * torch.tensor([], dtype=dtype).element_size()
        copies = rotation_count(nbytes, l2)
        out[e] = [torch.randn(shape, generator=gen, device=device, dtype=dtype)
                  for _ in range(copies)]
    return out


def sample_rounds(cell, seed: int) -> dict:
    rng = np.random.default_rng([seed, 2])
    return {e: int(rng.integers(int(cell.traffic["sample_span"])))
            for e in cell.config["expressions"]}


def run(cell, seed: int, seconds: float, trace: bool, read_layers=None,
        device="cuda") -> Outcome:
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    exprs = cell.config["expressions"]
    fns = spellings()
    t_set = [time.perf_counter()]
    ops = operands(cell, seed, device, l2_bytes() if cuda else 0)
    sync()
    t_set.append(time.perf_counter())
    need = {e: elementwise_pass(ops[e][0].numel(), ops[e][0].element_size()) for e in exprs}
    routes = {e: route(lambda: fns[e](ops[e][0])) for e in exprs}
    for e in exprs:  # every shape and copy once: plans, kernels, caches
        for x in ops[e]:
            fns[e](x)
    sync()
    t_set.append(time.perf_counter())

    samples = sample_rounds(cell, seed)
    kept, last = {}, {}
    span = Span()

    def round_(r):
        """One call of each expression, in order; returns each call's host
        seconds (call to return: the enqueue)."""
        host = []
        for e in exprs:
            x = ops[e][r % len(ops[e])]
            t0 = time.perf_counter()
            with span(e):
                y = fns[e](x)
            host.append(time.perf_counter() - t0)
            if samples[e] == r:
                kept[e, "drawn"] = (r % len(ops[e]), y)
            last[e] = (r % len(ops[e]), y)
        return host

    steady()
    r, ends = 0, []
    window_open = time.time()
    t_start = time.perf_counter()
    while True:
        round_(r)
        ends.append(time.perf_counter())
        r += 1
        if time.perf_counter() - t_start >= seconds:
            break
    sync()
    window = time.perf_counter() - t_start
    per_round = sum(need.values())
    metrics = {"engine_gbs": per_round * r / window / 1e9}
    notes = [f"window {window:.3f} s, {r} rounds of {len(exprs)} calls, "
             f"{per_round * r / 1e9:.3f} GB needed",
             f"rounds enqueued a second: {per_second(ends, t_start, window)}",
             f"set-up: inputs {t_set[1] - t_set[0]:.3f} s, warm-up {t_set[2] - t_set[1]:.3f} s",
             "routes: " + "; ".join(f"{e} {r}" for e, r in routes.items())]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    out = Outcome(metrics, {}, r * len(exprs), 0, peak, window_open, notes=notes)
    if trace:  # after the window: host time a call from an empty queue, then a profile
        host = []
        for j in range(r, r + int(cell.traffic["probe_rounds"])):
            host += round_(j)
        sync()
        r += int(cell.traffic["probe_rounds"])
        n = int(cell.traffic["profile_rounds"])
        prof = Profiler()
        prof.start()
        span.on = True
        for j in range(r, r + n):
            round_(j)
        span.on = False
        out.trace = prof.stop(n * len(exprs), dict(bytes=per_round * n,
                                                   host_s_per_call=sum(host) / len(host)))
        out.layers = read_layers(out.trace) if read_layers else {}
    kept.update({(e, "last"): v for e, v in last.items()})
    out.checks, out.failed = check(ops, kept)
    return out


def check(ops: dict, kept: dict) -> tuple:
    """``({"<expression>_gap": widest gap}, outputs not finite)`` over the
    kept calls, each against the expression in f64 on its own input."""
    gaps, bad = {}, 0
    for (e, _which), (ci, out) in kept.items():
        g = ref.gap(e, ops[e][ci], out)
        if not np.isfinite(g):
            bad += 1
            g = float("inf")
        gaps[e + "_gap"] = max(gaps.get(e + "_gap", 0.0), g)
    return gaps, bad
