"""Device-idle milliseconds per Adam step of the traced slice put down to the
backward pass itself (span ``inverse.backward`` less its child spans:
autograd's hand-offs, outside K2's host entry ``k2.launch``)."""
from cptbench import spans


def read(run):
    return spans.idle_ms(run, lambda name: name == "inverse.backward")
