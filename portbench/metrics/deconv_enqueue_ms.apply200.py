"""deconv_enqueue_ms.apply200: host ms of the deconvolution stage (the
program's ``stage.deconvolution`` span) per traced Apply, in the 200² cell."""

from portbench import program_spans


def read(run):
    return program_spans.host_ms(run, "apply", "stage.deconvolution")
