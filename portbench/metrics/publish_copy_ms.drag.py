"""publish_copy_ms.drag: host ms in the publish's device-to-host copies (the
program's ``publish.to_host`` spans: the wait for the publish's device work
and the copies) per traced slider step."""

from portbench import program_spans


def read(run):
    return program_spans.host_ms(run, "slider", "publish.to_host")
