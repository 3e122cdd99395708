"""What the per-layer readers take from the port's own spans
(``strided_tpu_torch/utils/profiling.py``): the switch that turns them on,
the host totals, and the device time between a span's section markers in
a profiled replay.

A reader calls :func:`switch_on` when it is loaded: ``run.py`` loads the
readers only for a traced run and before the generator, so the traced
run's capture carries the markers and its calls add to the totals, while
an untraced run never turns tracing on. On a port without the switch
(``profiling.enable``), nothing is turned on and the readers give None.
"""

from __future__ import annotations

import bisect
import re

# a marker's kernel name, as CUPTI gives it: strided_section_marker<id, end>
MARKER = re.compile(r"strided_section_marker\D*?(\d+)\D+?(\d+)")


def switch_on():
    """The port's profiling module with tracing on, or None where it has
    no tracing switch."""
    try:
        from strided_tpu_torch.utils import profiling
    except ImportError:
        return None
    enable = getattr(profiling, "enable", None)
    if enable is None:
        return None
    enable()
    return profiling


def host_us(totals: dict, name: str):
    """Mean host microseconds of span ``name`` over its calls, or None."""
    t = totals.get(name)
    if not t or t["count"] <= 0:
        return None
    return t["total_ns"] / t["count"] * 1e-3


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def section_ms(trace, name: str, sections: dict):
    """Device milliseconds a unit of ``trace`` inside span ``name``: the
    union of the device operations (markers aside) between each of its
    begin markers and the end marker that follows, summed over the trace
    and divided by ``trace.units``; None where the trace holds no such
    pair. ``sections`` maps marker ids to span names."""
    ids = {i for i, n in sections.items() if n == name}
    if not ids or trace.units <= 0:
        return None
    work, windows, opened = [], [], None
    for op, s, e in sorted(trace.device_ops, key=lambda o: o[1]):
        m = MARKER.search(op)
        if m is None:
            work.append((s, e))
        elif int(m.group(1)) in ids:
            if int(m.group(2)) == 0:
                opened = e
            elif opened is not None:
                windows.append((opened, s))
                opened = None
    if not windows:
        return None
    busy = _union(work)
    starts = [s for s, _e in busy]
    total = 0.0
    for w0, w1 in windows:
        for s, e in busy[max(0, bisect.bisect_right(starts, w0) - 1):]:
            if s >= w1:
                break
            total += max(0.0, min(e, w1) - max(s, w0))
    return total / trace.units * 1e-3
