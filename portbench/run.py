#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this process runs on.

    python3 portbench/run.py --workload scan200.apply --seed 7 --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or its
per-layer metrics with ``--trace 1``), ``device`` (and ``breakdown`` with
``--trace 1``), then ``checks``: each number of the comparison with its
limit, which also close standard error. Without CUDA, or with fewer cards
than the cell asks for, it prints no result and exits with 2; with JAX or
the JAX package loaded after the window, with 3.

The program's kernels are built (once) into ``build/torch_kernels/`` of this
checkout; any other compile cache of torch goes under ``build/portbench/``.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches():
    """Fixed cache directories inside the checkout."""
    base = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    import torch

    from portbench.cell import forbidden_modules, run_cell
    from portbench.spec import Spec

    spec = Spec(ROOT)
    chips = int(spec.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", _T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # imports start at the checkout's root, not at this script's directory
    sys.path[0] = str(ROOT)
    sys.exit(main())
