"""apply_p95_ms.scan200: the 95th percentile of every Apply completed in the
window, in the 200² cell."""

from portbench import readers


def read(run):
    return readers.p95_step_ms(run, "apply")
