"""Device-idle milliseconds per pass of the traced slice put down to the
frame driver's readback (span ``renderer.readback``: ``image_u8``'s tonemap and
its copy into host memory)."""
from cptbench import spans


def read(run):
    return spans.idle_ms(run, lambda name: name == "renderer.readback")
