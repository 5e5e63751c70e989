"""topk_ms.view3d: the device ms of the kernels that ``torch.topk`` starts
(the radix select of the k-th value, the gather and the sort of the k
largest), matched by name, per traced 3-D view update."""

#: the device operations of ``torch.topk`` on the card
PATTERN = r"(?i)topk|radixFindKthValues|computeBlockwise|sort"


def read(run):
    if run.trace is None or run.device_name == "cpu":
        return None
    steps = run.traced_steps("view3d")
    if not steps:
        return None
    spent = sum(o[2] for s in steps for o in run.ops_in(s, PATTERN))
    return 1e3 * spent / len(steps) if spent > 0 else None
