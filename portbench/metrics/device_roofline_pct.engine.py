"""The engine's share of the HBM roofline: the needed bytes of the
profiled calls (each input byte read once, each output byte written once)
over the card's HBM rate, against the device's busy time for those calls.
The same work reads the same whatever kernel or plain route runs."""

from portbench.common import HBM_BYTES_PER_S


def read(trace):
    nbytes, busy = trace.extra.get("bytes"), trace.busy_s()
    if not nbytes or busy <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / busy
