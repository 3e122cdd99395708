"""Device milliseconds a control period inside the captured step's RK4
plant step: in the profiled tail, the union of the device operations
between each replay's ``model.step`` section markers, summed, over the
periods."""

from portbench import port_spans

PORT = port_spans.switch_on()


def read(trace):
    if PORT is None:
        return None
    return port_spans.section_ms(trace, "model.step", PORT.sections())
