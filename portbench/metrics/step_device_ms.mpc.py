"""Device busy milliseconds a control period: the union of the device
operations' intervals in the profiled span over the periods in it."""


def read(trace):
    if trace.units <= 0:
        return None
    return trace.busy_s() / trace.units * 1e3
