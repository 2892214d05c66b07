"""mfu: the least time the operations of the configuration's networks
could take at the card's peaks, over the wall time they took: the sum of
each network's `least_s` (benchmark/networks/<key>.py: its work that ran
within the profiled shape, of every client) over that shape's wall.
The DDNM network counts its UNet forwards, with operations per forward
from benchmark/reference/flops.py: the int8 sites at the int8 peak when
the configuration runs w8a8, every other operation at the bf16 peak.
With one client this is the least time of a shape's model work over its
seconds; with two, the same over the seconds a shape of the window takes
the card."""


def read(run):
    p = run.profiled
    if not p or p["wall_s"] <= 0:
        return None
    least = [s for s in (net.least_s(run)
                         for net in run.cell.networks.values())
             if s is not None]
    return 100.0 * sum(least) / p["wall_s"] if least else None
