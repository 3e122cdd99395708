"""Device milliseconds a control period in the iLQR iteration's line
search (the affine policy rolled out at each of the four step sizes):
in the profiled tail, the union of the device operations between each
replay's ``ilqr.forward`` section markers, summed, over the periods."""

from portbench import port_spans

PORT = port_spans.switch_on()


def read(trace):
    if PORT is None:
        return None
    return port_spans.section_ms(trace, "ilqr.forward", PORT.sections())
