"""tilt_roofline.tilt: the tilt insertion's bound (bytes: the (W, H, T) cube
read once and the (W, H, T') extended cube written once, f32) over the
device time of the tilt kernel in each traced slider step, in % of the
card's roofline. T is the scan's length, T' the step's published length."""

from portbench import peaks

#: the device operation of ``csrc/tilt.cu``
PATTERN = r"tilt_insert"


def bound_bytes(n_pixels: int, n_time: int, n_out: int) -> int:
    """Bytes the insertion must move: every input sample read once, every
    output sample written once."""
    return (n_pixels * n_time + n_pixels * n_out) * 4


def read(run):
    if run.trace is None or run.device_name == "cpu":
        return None
    s_cfg = run.cfg["scan"]
    n, t = s_cfg["width"] * s_cfg["height"], s_cfg["n_time"]
    rate = peaks.peaks(run.device_name)[0]
    bound = spent = 0.0
    for step in run.traced_steps("slider"):
        ops = run.ops_in(step, PATTERN)
        if ops:
            bound += len(ops) * bound_bytes(n, t, step.n_time) / rate
            spent += sum(o[2] for o in ops)
    return 100.0 * bound / spent if spent > 0 else None
