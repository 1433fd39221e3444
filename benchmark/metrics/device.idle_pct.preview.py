"""Share of the traced slice's wall time in which no operation ran on the
device: one minus the union of the device events' intervals over the
slice."""


def read(run):
    t = run.trace
    if t is None or not t["window_s"] > 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
