"""Profiling and tracing helpers over ``torch.profiler``.

Counterpart of ``strided_tpu/utils/profiling.py``: :func:`trace` records
the enclosed block (the host's activity, and the card's when CUDA is
available) and writes a Chrome trace (viewable in ui.perfetto.dev) into its
directory; :func:`annotate` names a range in it; :class:`Timer` is a
host-side scope timer.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch

__all__ = ["trace", "annotate", "Timer"]


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


def annotate(name: str):
    """Named range visible in profiler timelines."""
    return torch.profiler.record_function(name)


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
