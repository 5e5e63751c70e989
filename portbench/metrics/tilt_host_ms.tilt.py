"""tilt_host_ms.tilt: host ms of the tilt stage (the program's
``stage.tilt_compensation`` span: its geometry, the window and the
insertion's enqueue) per traced slider step of the tilt cell."""

from portbench import program_spans


def read(run):
    return program_spans.host_ms(run, "slider", "stage.tilt_compensation")
