"""setup_s: process start to the window's opening (imports, clouds,
weights, kernel load, warm-up and, in w8a8, the static-scale
calibration of the first shape)."""


def read(run):
    return run.setup_s
