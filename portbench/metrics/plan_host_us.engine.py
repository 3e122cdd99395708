"""Host microseconds of K4's planner a call: the port's ``engine.plan``
span around ``core/executor_cuda.py::make_plan``, its mean over every call
made with no profiler running (the traced run's warm-up, window and probe
rounds)."""

from portbench import port_spans

PORT = port_spans.switch_on()


def read(trace):
    if PORT is None:
        return None
    return port_spans.host_us(PORT.totals(), "engine.plan")
