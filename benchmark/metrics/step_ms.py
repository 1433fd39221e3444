"""Milliseconds per Adam step: the window over every step completed in it."""


def read(run):
    steps = run.window.get("units")
    return run.window["seconds"] * 1e3 / steps if steps else None
