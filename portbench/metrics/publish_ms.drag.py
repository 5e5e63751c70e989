"""publish_ms.drag: host ms of ``Explorer.publish`` (a span around the
call, which ends in its device-to-host copies) per slider step."""

from portbench import readers


def read(run):
    return readers.publish_ms(run, "slider")
