"""envelope_roofline.view3d: the envelope's bound (bytes: the (N, T) f32
traces read once and the (N, T) f32 opacities written once) over the device
time of its kernel in each traced 3-D view update, in % of the card's
roofline."""

from portbench import peaks

#: the device operation of ``csrc/envelope.cu``
PATTERN = r"envelope_kernel"


def bound_bytes(n_traces: int, n_time: int) -> int:
    """Bytes the envelope must move: every sample read once and every
    opacity written once, 4 bytes each."""
    return n_traces * n_time * 8


def read(run):
    if run.trace is None or run.device_name == "cpu":
        return None
    s_cfg = run.cfg["scan"]
    n = s_cfg["width"] * s_cfg["height"]
    rate = peaks.peaks(run.device_name)[0]
    bound = spent = 0.0
    for step in run.traced_steps("view3d"):
        ops = run.ops_in(step, PATTERN)
        if ops:
            bound += len(ops) * bound_bytes(n, step.n_time) / rate
            spent += sum(o[2] for o in ops)
    return 100.0 * bound / spent if spent > 0 else None
