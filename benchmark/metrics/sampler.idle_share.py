"""sampler.idle_share: the share of the profiled shape's sampler (its
first `inpaint.step` span's start to its last one's end, on the trace's
clock) in which no device event of any thread ran."""
from pdbench import spans


def read(run):
    steps = spans.named(spans.profiled(run), "inpaint.step")
    if not len(steps):
        return None
    return spans.idle_share(run.trace, int(steps[:, 0].min()),
                            int(steps[:, 1].max()))
