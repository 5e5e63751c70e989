"""apply_ms.scan200: the summed time of every Apply completed in the window
over their number, the wait after pressing Apply, in the 200² cell."""

from portbench import readers


def read(run):
    return readers.mean_step_ms(run, "apply")
