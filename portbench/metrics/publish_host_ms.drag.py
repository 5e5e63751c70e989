"""publish_host_ms.drag: host ms of ``Explorer.publish`` (the program's
``publish`` span) outside its ``publish.to_host`` copies, per traced slider
step."""

from portbench import program_spans


def read(run):
    return program_spans.publish_host_ms(run, "slider")
