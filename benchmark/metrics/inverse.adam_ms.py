"""Device-idle milliseconds per Adam step of the traced slice put down to the
optimizer (span ``inverse.adam``: ``zero_grad`` and ``step``)."""
from cptbench import spans


def read(run):
    return spans.idle_ms(run, lambda name: name == "inverse.adam")
