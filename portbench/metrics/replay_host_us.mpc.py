"""Host microseconds of the capture wrapper a replay: the port's
``capture.replay`` span (key, lookup, copies in, ``graph.replay()``, output
clones), its mean over the calls made with tracing on and no profiler
running: the traced run's warm-up and window."""

from portbench import port_spans

PORT = port_spans.switch_on()


def read(trace):
    if PORT is None:
        return None
    return port_spans.host_us(PORT.totals(), "capture.replay")
