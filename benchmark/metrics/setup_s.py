"""Seconds from process start to the first timed operation: imports, scene,
kernel libraries (built on a checkout's first run), warm-up of the cell's
shapes."""


def read(run):
    return run.setup_s
