"""Times per pass of the traced slice that the program's own code blocked on
the device (the program's counter ``host_waits``: its synchronisations and its
reads of device results into host memory)."""
from cptbench import spans


def read(run):
    return spans.counter_per_unit(run, "host_waits")
