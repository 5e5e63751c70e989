"""slider_p95_ms: the 95th percentile of every slider step completed in the
window, from its first send to the worker's report."""

from portbench import readers


def read(run):
    return readers.p95_step_ms(run, "slider")
