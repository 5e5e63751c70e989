"""handoff_us.drag: the worker's hand-off, a slider command's put to the
worker's take (the program's ``worker.wait`` span), averaged over the
commands of the traced slider steps, in µs."""

from portbench import program_spans


def read(run):
    return program_spans.wait_us(run, "slider")
