"""stage_s.other: mean seconds a shape of the synchronous stages other
than inpaint (geometry, project, unwrap, unproject, complete, optimize,
export), from the StageTimer; sub-stages ('a.b') and the unwrap thread's
own clock are parts of these and not added; the profiled shape is left
out where the window has others."""


def read(run):
    v = [sum(s for k, s in r.stages.items() if "." not in k
             and k != "inpaint") for r in run.plain_shapes()]
    return sum(v) / len(v) if v else None
