"""stage_s.inpaint: mean seconds of the `inpaint` stage (DDNM, all views
at once) a shape, from the pipeline's device-synchronised StageTimer,
over the window's shapes but the profiled one (profiling slows the
host), unless it is the only one."""


def read(run):
    v = [r.stages["inpaint"] for r in run.plain_shapes()
         if "inpaint" in r.stages]
    return sum(v) / len(v) if v else None
