"""publish_copy_ms.apply512: host ms in the publish's device-to-host copies
(``publish.to_host`` spans) per traced Apply, in the 512² cell."""

from portbench import program_spans


def read(run):
    return program_spans.host_ms(run, "apply", "publish.to_host")
