"""Million primary rays per second: width x height x every sample of every
render completed in the window, over the window's seconds."""


def read(run):
    rays = run.window.get("work", {}).get("primary_rays")
    return None if rays is None else rays / run.window["seconds"] / 1e6
