"""apply_p95_ms.tail512: the 95th percentile of every Apply completed in the
window, in the 512² cell. A per-layer reading there: that cell's sets spread
too unevenly for one bound (PERF.md section 2); ``apply_ms.scan512`` carries
the bound."""

from portbench import readers


def read(run):
    return readers.p95_step_ms(run, "apply")
