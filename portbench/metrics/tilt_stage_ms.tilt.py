"""tilt_stage_ms.tilt: the tilt stage's device ms (``Pipeline.timings_ms
["tilt_compensation"]``, CUDA events) per slider step of the tilt cell."""

from portbench import readers


def read(run):
    return readers.stage_ms(run, "slider", "tilt_compensation")
