"""device_idle.view3d: the share of the traced window in which no operation
ran on the card, in %, in the 3-D view cell."""

from portbench import readers


def read(run):
    return readers.device_idle(run)
