"""device_idle.apply512: the share of the traced window in which no
operation ran on the card, in %, in the 512² Apply cell."""

from portbench import readers


def read(run):
    return readers.device_idle(run)
