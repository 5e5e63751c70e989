"""Everything of a cell, found by name from ``BENCHMARK.json`` and files.

A cell (``workloads``) names a configuration and a traffic mix. The
configuration's file is the one ``configs`` gives; the traffic mix is
``portbench/traffic/<traffic>.json``; the cell's limits of the comparison are
``portbench/limits/<cell>.json``; each metric is read by
``portbench/metrics/<metric>.py``, whose ``read(run)`` returns the value, or
None where the run holds nothing to read; each output that a traffic step
names is compared by ``portbench/outputs/<output>.py``. A later cell,
traffic mix, metric or output is a new file and a new entry: no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


def add_parked(bench: dict, home) -> dict:
    """``bench`` with the entries of the cells parked in ``home/parked/``:
    cells left out of ``BENCHMARK.json`` with the metrics only they report."""
    for path in sorted(Path(home, "parked").glob("*.json")):
        for key, entries in json.loads(path.read_text()).items():
            if key != "why":
                bench[key].extend(entries)
    return bench


class Spec:
    """The benchmark rooted at ``root`` (the directory of ``BENCHMARK.json``);
    with ``parked``, its parked cells too (for a run by hand)."""

    def __init__(self, root, parked: bool = False):
        self.root = Path(root)
        self.home = self.root / "portbench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        if parked:
            add_parked(self.bench, self.home)
        self._modules: dict = {}

    @staticmethod
    def _named(entries, name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._named(self.bench["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.bench["configs"], name, "configuration")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.home / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.home / "limits" / f"{workload}.json").read_text())

    def metrics(self, workload: str, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics (``traced`` False) or its per-layer
        metrics (True): those that list the cell, or list no cells."""
        entries = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in entries if workload in m.get("workloads", [workload])]

    def _module(self, kind: str, name: str):
        """``portbench/<kind>/<name>.py``, loaded once."""
        mod = self._modules.get((kind, name))
        if mod is None:
            path = self.home / kind / f"{name}.py"
            mod_name = f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            if spec is None or not path.exists():
                raise KeyError(f"no {kind} module {path}")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[(kind, name)] = mod
        return mod

    def reader(self, name: str):
        """``read`` of ``portbench/metrics/<name>.py``."""
        return self._module("metrics", name).read

    def numbers(self, traffic: dict) -> tuple:
        """The comparison numbers of a cell with ``traffic``: the publish's
        (``check.NUMBERS``) and those of each output its steps name."""
        from portbench import check
        from portbench.session import outputs_of

        return check.NUMBERS + tuple(n for o in outputs_of(traffic)
                                     for n in self.output(o).NUMBERS)

    def output(self, name: str):
        """The module ``portbench/outputs/<name>.py`` that compares a step's
        returned output: ``NUMBERS``, ``capture(result)``, ``reference(ref,
        state)``, ``compare(got, want)`` and ``control(ctl, state,
        precision)``."""
        return self._module("outputs", name)
