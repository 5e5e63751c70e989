"""polar_roofline.slider: the FFT stage's amplitudes and unwrapped phases'
bound (bytes: the (N, F) complex64 spectrum read once and the two (N, F) f32
planes written once; N pixels, F = T // 2 + 1 bins of the step's trace
length T) over the device time of their kernel in each traced slider step,
in % of the card's roofline."""

from portbench import peaks

#: the device operation of ``csrc/polar.cu``
PATTERN = r"polar_unwrap"


def bound_bytes(n_pixels: int, n_bins: int) -> int:
    """Bytes the pass must move: every spectrum bin read once (8 bytes), its
    amplitude and phase written once (4 bytes each)."""
    return n_pixels * n_bins * 16


def read(run):
    if run.trace is None or run.device_name == "cpu":
        return None
    s_cfg = run.cfg["scan"]
    n = s_cfg["width"] * s_cfg["height"]
    rate = peaks.peaks(run.device_name)[0]
    bound = spent = 0.0
    for step in run.traced_steps("slider"):
        ops = run.ops_in(step, PATTERN)
        if ops:
            bound += len(ops) * bound_bytes(n, step.n_time // 2 + 1) / rate
            spent += sum(o[2] for o in ops)
    return 100.0 * bound / spent if spent > 0 else None
