"""Milliseconds per unit of the traced slice (a render, a pass) in which the
device was idle: the slice's wall time less its device-busy time, over its
units. The frame driver's own cost and the host work it waits on."""


def read(run):
    t = run.trace
    units = run.job.slice_units() if run.job is not None else 0
    if t is None or not units:
        return None
    return (t["window_s"] - t["busy_s"]) * 1e3 / units
