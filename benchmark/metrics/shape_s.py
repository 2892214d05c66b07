"""shape_s: the window's wall seconds over the shapes started in it; the
window closes when the last of them is done."""


def read(run):
    n = len(run.window.shapes)
    return run.window.seconds / n if n else None
