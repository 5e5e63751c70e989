"""deconv_energy_ms.apply512: device ms (CUDA events) of the band energy
images and their reflect pad (the program's ``deconv.energy`` span) per
traced Apply, in the 512² cell."""

from portbench import program_spans


def read(run):
    return program_spans.device_ms(run, "apply", "deconv.energy")
