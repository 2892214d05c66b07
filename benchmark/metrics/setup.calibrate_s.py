"""setup.calibrate_s: seconds of the w8a8 static-scale calibration (the
port's `inpaint.calibrate` span: a dynamic 100-step pass, ended by a
device synchronise) in the warm-up shapes; it runs once a process."""


def read(run):
    v = [r.stages["inpaint.calibrate"] for r in run.window.warmup
         if "inpaint.calibrate" in r.stages]
    return sum(v) if v else None
