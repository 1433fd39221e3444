"""95th percentile, over every pass of the window, of the milliseconds from
the camera key (if any) and the call to ``step()`` to the display image in
host memory."""
import numpy as np


def read(run):
    t = run.window.get("unit_seconds")
    return float(np.percentile(np.asarray(t) * 1e3, 95)) if t else None
