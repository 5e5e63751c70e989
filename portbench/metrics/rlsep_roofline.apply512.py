"""rlsep_roofline.apply512: the Apply's Richardson-Lucy bound over the RL
kernels' device time per traced Apply, in % of the card's roofline, in the
512² cell."""

from portbench import readers


def read(run):
    return readers.rl_roofline(run)
