"""chain_enqueue_ms.drag: host ms of the executor's stage loop (the
program's ``executor.run`` span) per traced slider step."""

from portbench import program_spans


def read(run):
    return program_spans.host_ms(run, "slider", "executor.run")
