"""sampler.step_ms: device milliseconds of one DDNM sampler step: the
device events launched inside the `inpaint.step` spans (the port's
spans, on the trace's clock) of every client that lie within the
profiled shape, over those steps, reduced as `unet_forward_ms` reduces
forwards.  The trace gives every launching host thread one id, so with
two clients a step's launches are not told from the other client's: the
mean is over both clients' steps."""
from pdbench import spans, trace


def read(run):
    steps = spans.named(spans.within_shape(run), "inpaint.step")
    if not len(steps):
        return None
    s = trace.forward_device_s(run.trace, steps.tolist())
    return None if s is None else s * 1e3
