"""K1's share of its roofline in the traced slice: the least time the card
needs for the work of the slice's K1 launches (the reference's tally of
their paths, ``cptbench/roofline.py``) over K1's device time in the trace."""
from cptbench import roofline, trace


def read(run):
    if run.trace is None:
        return None
    work = run.kernel_work(roofline.K1_SYMBOL)
    if work is None:
        return None
    return roofline.share_pct(*work, trace.kernel_seconds(run.trace, roofline.K1_SYMBOL))
