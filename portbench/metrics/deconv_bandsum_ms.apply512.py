"""deconv_bandsum_ms.apply512: device ms (CUDA events) of the gains and the
band sum (GEMMs, complex product, iRFFT; the program's ``deconv.band_sum``
span) per traced Apply, in the 512² cell."""

from portbench import program_spans


def read(run):
    return program_spans.device_ms(run, "apply", "deconv.band_sum")
