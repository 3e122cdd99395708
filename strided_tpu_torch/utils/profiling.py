"""Profiling and tracing: the port's spans, their totals, and the device
markers of a captured call.

Counterpart of ``strided_tpu/utils/profiling.py``: :func:`trace` records
the enclosed block (the host's activity, and the card's when CUDA is
available) and writes a Chrome trace (viewable in ui.perfetto.dev) into its
directory; :func:`annotate` names a span; :class:`Timer` is a host-side
scope timer.

The port's layer boundaries are spans (``capture.replay``,
``capture.signature``, ``capture.launch``, ``capture.record``,
``capture.miss``, ``qp.solve``, ``model.step``, ``ilqr.linearize``,
``ilqr.backward``, ``ilqr.forward``, ``engine.plan``, ``engine.plain``,
``engine.launch``). What a span does depends on two switches:

- A ``torch.profiler`` is running: the span is a ``record_function``
  range, so it lands in the profiler's timeline beside the card's
  kernels. It stays out of :func:`totals`: the profiler slows the host.
- Tracing is on (:func:`enable`) and no profiler runs: the span adds its
  count, its host nanoseconds (``time.perf_counter_ns``) and its self
  nanoseconds (those no child span covers) to :func:`totals`, under its
  name, with the span open around it as its parent.
- Tracing is off (the default) and no profiler runs: :func:`annotate`
  returns one shared null context; the span reads no clock, runs no torch
  op and makes no call into torch (a running profiler is told by torch's
  own Python-level flag, ``torch.autograd.profiler._is_profiler_enabled``).

:func:`annotated` makes each call of a function such a span.

A CUDA-graph replay shows the card's kernels and no host span. So with
tracing on, a span entered while ``capture.py`` captures a call puts two
empty ``<<<1, 1>>>`` kernels into the graph, before and after its work:
``strided_section_marker<id, 0>`` and ``strided_section_marker<id, 1>``
(``csrc/section_marker.cu``), whose names alone say which span
(:func:`sections` maps the ids to names) and which end. A profiled replay
then shows each section's kernels between its markers. No marker goes
into a graph the caller captures itself, nor into the eager warm-up
before a capture; a graph captured with tracing off has none, and
turning tracing on captures anew (the switch is part of
``capture.signature``).

Use, on the card::

    from strided_tpu_torch.utils import profiling

    profiling.enable()                  # before the first call: it captures
    step = entry.make_step(model, ctrl, dt)
    for _ in range(100):
        step(x)
    profiling.totals()["capture.replay"]   # {"count", "total_ns", "self_ns", "parents"}
    with profiling.trace("traces") as d:   # d/trace.json: qp.solve and model.step
        step(x)                            # between their markers on the device
    profiling.sections()                   # {0: "qp.solve", 1: "model.step"}
    profiling.disable(); profiling.reset()
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import tempfile
import threading
import time
from typing import Iterator, Optional

import torch
from torch.autograd import profiler as _torch_profiler

__all__ = ["trace", "annotate", "annotated", "rename", "Timer", "enable", "disable", "enabled",
           "totals", "reset", "sections", "own_capture", "MAX_SECTIONS"]

MAX_SECTIONS = 32  # marker ids the kernel library is instantiated for (csrc/section_marker.cu)

_on = False
_totals: dict = {}  # span name -> [count, total ns, self ns, {parent name: count}]
_section_ids: dict = {}  # span name -> marker id
_local = threading.local()  # .stack: this thread's open timed spans; .own: > 0 while
# capture.py records a graph on this thread (captures are thread-local)
_lock = threading.Lock()  # guards _totals and _section_ids across threads


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[str]:
    """Record the enclosed block and write ``trace.json`` into ``logdir``
    (default: ``strided_tpu_torch_trace`` in the temporary directory).

    with profiling.trace("traces") as d:
        run_workload()
    # open d/trace.json in ui.perfetto.dev
    """
    logdir = logdir or os.path.join(tempfile.gettempdir(), "strided_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable() -> None:
    """Switch tracing on: spans record their totals, and a call captured
    from now on carries section markers."""
    global _on
    _on = True


def disable() -> None:
    """Switch tracing off; the totals are kept until :func:`reset`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def totals() -> dict:
    """``{span name: {"count", "total_ns", "self_ns", "parents"}}`` of the
    spans closed with tracing on and no profiler running; ``parents`` counts
    the span's calls by the name of the span open around each (None at the
    top)."""
    with _lock:
        return {name: {"count": c, "total_ns": t, "self_ns": s, "parents": dict(p)}
                for name, (c, t, s, p) in _totals.items()}


def reset() -> None:
    """Clear :func:`totals`."""
    with _lock:
        _totals.clear()


def sections() -> dict:
    """``{marker id: span name}`` of every span given markers so far."""
    return {i: name for name, i in _section_ids.items()}


@contextlib.contextmanager
def own_capture():
    """Held by ``capture.py`` around its own capture: spans entered inside,
    with tracing on, put their markers into the graph. It holds for this
    thread only, as a ``thread_local`` capture does."""
    _local.own = getattr(_local, "own", 0) + 1
    try:
        yield
    finally:
        _local.own -= 1


class _Null:
    """The span with tracing off. Its methods are a C function, so that
    ``with`` runs no Python frame: ``"".format`` takes any arguments and
    returns the falsy ``""``, so an exception passes on."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_NULL = _Null()


def annotate(name: str):
    """A span named ``name`` (the module docstring says what it records)."""
    if _on:
        return _Span(name, _torch_profiler._is_profiler_enabled)
    if _torch_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def annotated(name: str):
    """Decorator: each call of the function is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def rename(span, name: str) -> None:
    """Count the open span ``span`` (what ``with annotate(...) as span``
    gave) under ``name`` in :func:`totals`: for a call found, once inside,
    to be of another kind. Nothing for a null span or a profiler range."""
    if isinstance(span, _Span) and not span.profiled:
        span.name = name


class _Span:
    __slots__ = ("name", "profiled", "marker", "range", "t0", "parent", "child_ns")

    def __init__(self, name: str, profiled: bool):
        self.name, self.profiled = name, profiled

    def __enter__(self):
        self.marker = _marker_id(self.name) if _marking() else None
        if self.marker is not None:
            _mark(self.marker, 0)
        if self.profiled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
            return self
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.child_ns = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.profiled:
            self.range.__exit__(exc_type, exc, tb)
        else:
            ns = time.perf_counter_ns() - self.t0
            _stack().pop()
            parent = None
            if self.parent is not None:
                self.parent.child_ns += ns
                parent = self.parent.name
            with _lock:
                rec = _totals.setdefault(self.name, [0, 0, 0, {}])
                rec[0] += 1
                rec[1] += ns
                rec[2] += ns - self.child_ns
                rec[3][parent] = rec[3].get(parent, 0) + 1
        if self.marker is not None:
            _mark(self.marker, 1)
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _marking() -> bool:
    """Whether a span entered now gives markers: tracing is on and this is
    ``capture.py``'s own capture (never a caller's graph or a warm-up)."""
    return _on and getattr(_local, "own", 0) > 0 and torch.cuda.is_current_stream_capturing()


def _marker_id(name: str) -> Optional[int]:
    """The span's marker id, given at its first marker; None once all
    ``MAX_SECTIONS`` ids are taken."""
    with _lock:
        i = _section_ids.get(name)
        if i is None and len(_section_ids) < MAX_SECTIONS:
            i = _section_ids[name] = len(_section_ids)
        return i


@functools.cache
def _marker_fn():
    from .._build import load_library

    fn = load_library().strided_section_mark
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _mark(section: int, end: int) -> None:
    """Launch marker ``(section, end)`` on the current stream."""
    err = _marker_fn()(section, end, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"section marker: kernel launch failed, cudaError_t {err}")


class Timer:
    """Cheap wall-clock scope timer for host-side phases."""

    def __init__(self, name: str, sink=print):
        self.name, self.sink = name, sink

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sink(f"[{self.name}] {time.perf_counter() - self.t0:.4f}s")
        return False
