"""Device-idle milliseconds per render of the traced slice put down to K1's host
entry (span ``k1.launch``: argument checks, camera table, output buffer, the
ctypes call)."""
from cptbench import spans


def read(run):
    return spans.idle_ms(run, lambda name: name == "k1.launch")
