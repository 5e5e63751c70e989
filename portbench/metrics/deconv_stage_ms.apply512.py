"""deconv_stage_ms.apply512: the deconvolution stage's device ms
(``Pipeline.timings_ms``) per Apply, in the 512² cell."""

from portbench import readers


def read(run):
    return readers.stage_ms(run, "apply", "deconvolution")
