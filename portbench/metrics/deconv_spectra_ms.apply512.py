"""deconv_spectra_ms.apply512: device ms (CUDA events) of the deconvolution's
phase a, the band data and the traces' rFFT, power and head/tail segments
(the program's ``deconv.spectra`` span), per traced Apply, in the 512² cell."""

from portbench import program_spans


def read(run):
    return program_spans.device_ms(run, "apply", "deconv.spectra")
