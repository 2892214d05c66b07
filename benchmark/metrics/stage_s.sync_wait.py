"""stage_s.sync_wait: mean seconds a shape spends in the device-wide
synchronise that ends each of its stages (the port's `<stage>.sync`
spans), over the window's shapes but the profiled one, unless it is the
only one.  With two shapes in flight a stage's synchronise also waits for
the other shape's queued work."""


def read(run):
    v = [[s for k, s in r.stages.items() if k.endswith(".sync")]
         for r in run.plain_shapes()]
    if not any(v):
        return None
    return sum(map(sum, v)) / len(v)
