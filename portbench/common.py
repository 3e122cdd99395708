"""The benchmark's own yardstick: clocks, peaks, the profiler's reduction,
the card's label and the module check.

``graph_ms``, ``l2_bytes``, ``rotation_count`` and ``card_label`` are
frozen copies of ``strided_tpu_torch/bench.py``'s, and
the profiler reading follows its ``device_profile``; they live here so
that a change to the port cannot move the ruler it is measured with.
"""

from __future__ import annotations

import bisect
import gc
import subprocess
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit:
# FP32 outside the tensor cores, the HBM3 rate, and the L2 size used where
# the card does not report its own.
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
L2_BYTES_ASSUMED = 50 * 1024 * 1024

# top-level module names that no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "strided_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole: ``strided_tpu_torch`` is not ``strided_tpu``."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card_label() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds per call of ``fn()``: ``reps`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events. The
    port's captured entry points inside ``fn`` run as they are, recorded
    into this graph."""
    from strided_tpu_torch.capture import disable_capture

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with disable_capture():
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
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


def l2_bytes() -> int:
    """The current card's L2 size as it reports it, else the H100's 50 MiB."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return int(getattr(props, "L2_cache_size", 0) or 0) or L2_BYTES_ASSUMED


def rotation_count(copy_bytes: int, l2: int) -> int:
    """Copies of an input of ``copy_bytes`` whose sum exceeds 4x the L2, so
    that no call finds its input in L2 from an earlier call; at least 2."""
    return max(2, 4 * l2 // max(1, copy_bytes) + 1)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values`` (linear interpolation)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def smi_sample() -> str:
    """One ``nvidia-smi`` reading of every card's SM clock, power draw and
    limit and temperature; taken before and after a window, not during it
    (its queries go through the card's kernel module beside the run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {type(e).__name__}"
    return "; ".join(line.strip() for line in out.strip().splitlines())


def per_second(ends, t_start: float, window: float) -> str:
    """Items completed in each whole second of a window, from their end
    times on the host clock: how steady the window ran."""
    counts = np.bincount(((np.asarray(ends) - t_start) // 1.0).astype(int))
    return " ".join(str(int(c)) for c in counts[: int(window)])


def steady():
    """Before a window: collect once, then keep everything made in set-up
    out of the collector's later passes (``gc.freeze``)."""
    gc.collect()
    gc.freeze()


@dataclass
class Trace:
    """What one profiled span holds: device operations (kernels, copies,
    sets) and host events as ``(name, start_us, end_us)``, the span itself
    and the generator's count of periods or calls in it. ``extra``
    carries what a generator hands its per-layer readers."""

    device_ops: list
    host_events: list
    span_us: tuple
    units: int
    extra: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.span_us[1] - self.span_us[0]) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the span."""
        t0, t1 = self.span_us
        iv = sorted((max(s, t0), min(e, t1)) for _n, s, e in self.device_ops
                    if e > t0 and s < t1)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_seconds(self, match=None) -> float:
        """Summed device seconds of the operations whose name contains
        ``match`` (all of them when None)."""
        return sum(e - s for n, s, e in self.device_ops
                   if match is None or match in n.lower()) * 1e-6

    def top_device_ops(self, top: int = 10) -> list:
        by = {}
        for n, s, e in self.device_ops:
            by[n] = by.get(n, 0.0) + (e - s) * 1e-6
        return [[n[:120], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device seconds, summed by what the host was doing at each
        gap's middle: the shortest host event that covers it."""
        t0, t1 = self.span_us
        gaps, last = [], t0
        for s, e in self.busy_intervals():
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if t1 > last:
            gaps.append((last, t1))
        host = sorted(self.host_events, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by = {}
        active, i = [], 0
        for gs, ge in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (gs + ge)
            j = bisect.bisect_right(starts, mid)
            active.extend(host[i:j])
            i = max(i, j)
            active = [h for h in active if h[2] >= mid]
            name = (min(active, key=lambda h: h[2] - h[1])[0] if active
                    else "host outside any recorded event")
            by[name] = by.get(name, 0.0) + (ge - gs) * 1e-6
        return [[n[:120], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


SPAN_PREFIX = "portbench."


class Profiler:
    """``torch.profiler`` (CPU and CUDA activities) over a span that the
    caller starts and ends; the span is a host event of its own,
    ``SPAN``, which ends after the device has finished the span's work.
    :meth:`stop` returns the :class:`Trace`."""

    SPAN = SPAN_PREFIX + "profiled"

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.span = None

    def start(self):
        wait_device()
        self.prof.start()
        self.span = torch.profiler.record_function(self.SPAN)
        self.span.__enter__()

    def stop(self, units: int, extra=None) -> Trace:
        wait_device()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        from torch.autograd import DeviceType

        dev, host, span = [], [], None
        for e in self.prof.events():
            tr = e.time_range
            if tr.end <= tr.start:
                continue
            annotation = getattr(e, "is_user_annotation", False) or \
                e.name.startswith(SPAN_PREFIX)
            if e.device_type == DeviceType.CUDA:
                if not annotation:  # a host span's shadow on the device's timeline
                    dev.append((e.name, tr.start, tr.end))
            elif e.name == self.SPAN:
                span = (tr.start, tr.end)
            elif e.device_type == DeviceType.CPU:
                host.append((e.name, tr.start, tr.end))
        if span is None:
            raise RuntimeError("the profiler recorded no span event")
        return Trace(dev, host, span, units, dict(extra or {}))


class Span:
    """A named host span for the profiler's trace, recorded only while a
    profile is on (``torch.profiler.record_function``)."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return _NULL
        return torch.profiler.record_function(SPAN_PREFIX + name)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def wait_device():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads``, with its
    configuration's and its traffic's files read."""

    name: str
    config: dict
    traffic: dict
    chips: int


@dataclass
class Outcome:
    """What a generator's run gives back: the end-to-end values by name, the
    correctness readings by name (each held to the configuration's limit),
    requests attempted and failed, the device memory peak, the wall-clock
    time at which the window opened, the per-layer values of a traced run,
    its trace, and lines for standard error."""

    metrics: dict
    checks: dict
    attempted: int
    failed: int
    memory_peak: int
    window_open: float
    layers: dict = field(default_factory=dict)
    trace: Trace = None
    notes: list = field(default_factory=list)
    busy_s: float = None
    window_s: float = None
    breakdown: dict = None

    def summarise_trace(self):
        """Fill ``busy_s``, ``window_s`` and ``breakdown`` from the trace."""
        if self.trace is not None:
            self.busy_s = self.trace.busy_s()
            self.window_s = self.trace.window_s
            self.breakdown = {"device_ops": self.trace.top_device_ops(),
                              "idle_gaps": self.trace.idle_gaps()}
