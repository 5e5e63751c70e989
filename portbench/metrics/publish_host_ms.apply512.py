"""publish_host_ms.apply512: host ms of ``Explorer.publish`` outside its
``publish.to_host`` copies per traced Apply, in the 512² cell."""

from portbench import program_spans


def read(run):
    return program_spans.publish_host_ms(run, "apply")
