"""Milliseconds per Adam step of the traced slice in which the device was
idle: the slice's wall time less its device-busy time, over its steps. The
training loop's and the autograd entry's host work (scene packing on CPU
tensors, Adam, the loss read)."""


def read(run):
    t = run.trace
    units = run.job.slice_units() if run.job is not None else 0
    if t is None or not units:
        return None
    return (t["window_s"] - t["busy_s"]) * 1e3 / units
