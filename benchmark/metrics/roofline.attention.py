"""roofline.attention: K2's least time at its call shapes
(benchmark/roofline/attention.py) over its device time in the profiled
shape, for as many forwards as it launched."""
from pdbench import trace
from roofline import attention

K2 = r"attn_mma|attn_fma"


def read(run):
    if run.trace is None:
        return None
    secs, launches = trace.kernel_time(run.trace, K2)
    calls = run.counts.get("ddnm", {}).get("attention")
    if not launches or not calls:
        return None
    bound = attention.bound_s(calls, run.peaks) * launches / len(calls)
    return 100.0 * bound / secs
