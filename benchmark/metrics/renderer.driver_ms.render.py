"""Device-idle milliseconds per render of the traced slice put down to the
frame driver's spans (``renderer.*``: set-up and packing, the render and its
passes, resets, synchronisations, the readback), the kernels' host entries
apart."""
from cptbench import spans


def read(run):
    return spans.idle_ms(run, lambda name: name.startswith("renderer."))
