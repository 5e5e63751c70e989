"""publish_ms.apply200: host ms of ``Explorer.publish`` per Apply, in the
200² cell."""

from portbench import readers


def read(run):
    return readers.publish_ms(run, "apply")
