"""chain_idle_ms.drag: device-idle ms inside the executor's stage loop (the
program's ``executor.run`` span) per traced slider step."""

from portbench import program_spans


def read(run):
    return program_spans.idle_ms(run, "slider", "executor.run")
