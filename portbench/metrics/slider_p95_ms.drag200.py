"""slider_p95_ms.drag200: the 95th percentile of every slider step completed
in the window, in the 200² drag cell, where it is a per-layer reading: its
runs spread too widely between processes for a bound (PERF.md §2)."""

from portbench import readers


def read(run):
    return readers.p95_step_ms(run, "slider")
