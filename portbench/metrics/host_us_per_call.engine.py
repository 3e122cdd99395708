"""Host microseconds from an engine call's start to its return (the
enqueue), the mean over the probe rounds that run after the window and
before the profiler starts, each call from an empty queue. The benchmark's
own host clock around each call; the profiler is off."""


def read(trace):
    v = trace.extra.get("host_s_per_call")
    if v is None or trace.units <= 0:
        return None
    return v * 1e6
