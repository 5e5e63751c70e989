"""publish_ms.apply512: host ms of ``Explorer.publish`` per Apply, in the
512² cell."""

from portbench import readers


def read(run):
    return readers.publish_ms(run, "apply")
