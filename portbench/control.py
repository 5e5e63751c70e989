#!/usr/bin/env python3
"""The control of the comparison: the plain reference computed in TF32 put in
the program's place, at a cell's own size.

    python3 portbench/control.py --workload scan512.drag --seeds 11 12 13 [--states 4]

For each seed it makes the scan, walks the cell's traffic over one period of
its states (``session.TrafficPlan``, no program), takes ``--states`` of each
class's states drawn from the seed, computes their publishes with the
reference in float64 and in TF32 (``reference.numerics``), and judges the
TF32 publishes against the float64 ones by the cell's own verdict
(``check.verdict`` with the cell's limits). A step that names an output is
judged by its module (``portbench/outputs/<output>.py``): its ``control``
answers in the program's place, from the TF32 reference, and with
``--precision bf16`` computes the output's own part in bfloat16 instead. It
prints one JSON line a seed: ``correct`` (false where the comparison catches
the control), then each number beside its limit. It exits with 1 if any
seed's control came out correct. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def states_of(traffic: dict, seed: int, per_class: int) -> list[tuple[dict, object]]:
    """``per_class`` of each step class's distinct states over one period
    of the traffic, drawn from the seed, each with the output its step
    names (None: the publish)."""
    import numpy as np

    from portbench.session import TrafficPlan

    plan = TrafficPlan(traffic, seed)
    plan.setup_commands()
    by_class: dict[str, dict] = {}
    for _ in range(plan.period()):
        _kind, spec, _cmds, state = plan.next()
        by_class.setdefault(spec["class"], {})[repr(sorted(state.items()))] = (
            state, spec.get("output"))
    rng = np.random.default_rng([int(seed), 4])
    out = []
    for cls in sorted(by_class):
        states = list(by_class[cls].values())
        pick = rng.permutation(len(states))[:per_class]
        out += [states[i] for i in sorted(pick)]
    return out


def control_numbers(cfg: dict, traffic: dict, seed: int, device, per_class: int,
                    precision: str = "tf32", spec=None) -> dict:
    """The worst comparison numbers of the TF32 reference (for an output,
    its ``control`` in ``precision``) against the float64 one over the
    drawn states; the outputs' modules are ``spec``'s (by default this
    checkout's)."""
    from portbench import check
    from portbench.reference import Reference
    from portbench.spec import Spec

    spec = Spec(ROOT) if spec is None else spec

    ref = Reference(cfg, seed, device)
    ctl = Reference(cfg, seed, device, tf32=True)
    readings = []
    for state, output in states_of(traffic, seed, per_class):
        if output is None:
            readings.append(check.compare(ctl.published(state), ref.published(state),
                                          bool(state.get("deconvolved")), cfg["reference_roi"]))
        else:
            mod = spec.output(output)
            readings.append(mod.compare(mod.control(ctl, state, precision),
                                        mod.reference(ref, state)))
    ref.close()
    ctl.close()
    return check.worst(readings, spec.numbers(traffic))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--states", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--precision", choices=("tf32", "bf16"), default="tf32")
    args = ap.parse_args(argv)
    from portbench import check
    from portbench.spec import Spec

    spec = Spec(ROOT, parked=True)
    cell = spec.workload(args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    limits = spec.limits(args.workload)
    caught = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = control_numbers(cfg, traffic, seed, args.device, args.states,
                                  args.precision, spec)
        correct, checks = check.verdict(numbers, limits)
        caught &= not correct
        print(json.dumps({"workload": args.workload, "seed": seed, "precision": args.precision,
                          "correct": correct,
                          "checks": checks, "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
