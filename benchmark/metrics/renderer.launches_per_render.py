"""K1 launches per converged render over the window, from the program's own
counter (``ops/cuda/megakernel.py::LAUNCH_COUNT``)."""


def read(run):
    launches = run.window.get("counters", {}).get("k1_launches")
    units = run.window.get("units")
    return launches / units if launches is not None and units else None
