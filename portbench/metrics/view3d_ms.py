"""view3d_ms: the window's length over the 3-D view updates completed in it,
the wait per redraw of the page's live view with every stall in it."""


def read(run):
    n = len(run.window_steps("view3d"))
    return run.seconds * 1e3 / n if n else None
