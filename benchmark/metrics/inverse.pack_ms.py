"""Device-idle milliseconds per Adam step of the traced slice put down to the
scene packing of the loss (span ``inverse.pack``: the parameters merged into
the scene and ``pack_scene`` to the card)."""
from cptbench import spans


def read(run):
    return spans.idle_ms(run, lambda name: name == "inverse.pack")
