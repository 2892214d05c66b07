"""roofline.groupnorm: K5's least time at the UNet's GroupNorm sites
(benchmark/roofline/groupnorm.py) over its device time in the profiled
shape, for as many forwards as it launched."""
from pdbench import trace
from roofline import groupnorm

K5 = r"gn_fused"


def read(run):
    if run.trace is None:
        return None
    secs, launches = trace.kernel_time(run.trace, K5)
    if not launches:
        return None
    cfg = run.cell.config
    p = cfg["pipeline"]
    norms = groupnorm.sites(cfg["unet"], p.get("view_num", 8),
                            p.get("res", 256))
    bound = groupnorm.bound_s(norms, run.peaks) * launches / len(norms)
    return 100.0 * bound / secs
