"""device_idle.tilt: the share of the traced window in which no operation
ran on the card, in %, in the tilt cell."""

from portbench import readers


def read(run):
    return readers.device_idle(run)
