"""roofline.int8_conv: K8's least time at the w8a8 UNet's site shapes
(benchmark/roofline/int8_conv.py) over its device time in the profiled
shape, for as many forwards as it launched."""
from pdbench import trace
from roofline import int8_conv

K8 = r"int8_conv"


def read(run):
    if run.trace is None:
        return None
    secs, launches = trace.kernel_time(run.trace, K8)
    sites = [c for c in run.counts.get("ddnm", {}).get("convs", ())
             if c[0]]
    if not launches or not sites:
        return None
    bound = int8_conv.bound_s(sites, run.peaks) * launches / len(sites)
    return 100.0 * bound / secs
