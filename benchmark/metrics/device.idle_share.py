"""device.idle_share: the share of the profiled shape's wall in which no
device event (kernel, copy, set) ran: one minus the union of their
intervals over the wall."""
from pdbench import trace


def read(run):
    if run.trace is None or not len(run.trace.dev):
        return None
    _, lo, hi = run.trace.shape()
    busy, _ = trace.busy_in(run.trace, lo, hi)
    return 100.0 * (1.0 - busy / ((hi - lo) * 1e-9))
