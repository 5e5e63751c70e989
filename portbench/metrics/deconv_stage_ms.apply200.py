"""deconv_stage_ms.apply200: the deconvolution stage's device ms
(``Pipeline.timings_ms``) per Apply, in the 200² cell."""

from portbench import readers


def read(run):
    return readers.stage_ms(run, "apply", "deconvolution")
