"""deconv_idle_ms.apply200: device-idle ms inside the deconvolution stage (the
program's ``stage.deconvolution`` span) per traced Apply, in the 200² cell."""

from portbench import program_spans


def read(run):
    return program_spans.idle_ms(run, "apply", "stage.deconvolution")
