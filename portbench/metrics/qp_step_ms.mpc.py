"""Device milliseconds a control period inside the captured step's QP
solve: in the profiled tail, the union of the device operations between
each replay's ``qp.solve`` section markers, summed, over the periods. The
markers are in the graph because tracing is on in a traced run
(``port_spans.switch_on``)."""

from portbench import port_spans

PORT = port_spans.switch_on()


def read(trace):
    if PORT is None:
        return None
    return port_spans.section_ms(trace, "qp.solve", PORT.sections())
