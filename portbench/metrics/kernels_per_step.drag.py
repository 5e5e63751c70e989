"""kernels_per_step.drag: device kernels (copies and sets left out) that
started during a slider step, per traced slider step."""

PATTERN = r"^(?!Memcpy|Memset)"


def read(run):
    steps = run.traced_steps("slider")
    if not steps:
        return None
    return sum(len(run.ops_in(s, PATTERN)) for s in steps) / len(steps)
