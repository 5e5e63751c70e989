"""specred_roofline.drag: the spectral reduction's bound (bytes: the (N, F)
spectrum and M masks read once, the sums written once; N pixels, F bins,
M = ROIs + the pixel mean) over the device time of its kernel in each traced
slider step, in % of the card's roofline."""

from portbench import peaks

PATTERN = r"specred"


def read(run):
    if run.trace is None or run.device_name == "cpu":
        return None
    s_cfg = run.cfg["scan"]
    n, m = s_cfg["width"] * s_cfg["height"], len(run.cfg["rois"]) + 1
    bound = spent = 0.0
    for step in run.traced_steps("slider"):
        ops = run.ops_in(step, PATTERN)
        if ops:
            bound += len(ops) * peaks.specred_bound_s(n, step.n_time // 2 + 1, m, run.device_name)
            spent += sum(o[2] for o in ops)
    return 100.0 * bound / spent if spent > 0 else None
