"""Device milliseconds a control period in the iLQR iteration's
linearization (the RK4 step's Jacobians along every trajectory,
``jacfwd`` vmapped over fleet and horizon): in the profiled tail, the
union of the device operations between each replay's
``ilqr.linearize`` section markers, summed, over the periods."""

from portbench import port_spans

PORT = port_spans.switch_on()


def read(trace):
    if PORT is None:
        return None
    return port_spans.section_ms(trace, "ilqr.linearize", PORT.sections())
