"""K2's share of its roofline in the traced slice: the least time the card
needs for the work of the slice's K2 launches (a replay of the forward
paths plus the reverse sweep, on the reference's tally; ``cptbench/
roofline.py``) over K2's device time in the trace."""
from cptbench import roofline, trace


def read(run):
    if run.trace is None:
        return None
    work = run.kernel_work(roofline.K2_SYMBOL)
    if work is None:
        return None
    return roofline.share_pct(*work, trace.kernel_seconds(run.trace, roofline.K2_SYMBOL))
