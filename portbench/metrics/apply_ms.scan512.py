"""apply_ms.scan512: the summed time of every Apply completed in the window
over their number, the wait after pressing Apply, in the 512² cell."""

from portbench import readers


def read(run):
    return readers.mean_step_ms(run, "apply")
