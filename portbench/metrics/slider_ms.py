"""slider_ms: the window's length over the slider steps completed in it,
the wait per step of a drag with every stall in it."""


def read(run):
    n = len(run.window_steps("slider"))
    return run.seconds * 1e3 / n if n else None
