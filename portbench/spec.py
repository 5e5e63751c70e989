"""Everything of a cell, found by name from ``BENCHMARK.json`` and files.

A cell (``workloads``) names a configuration and a traffic mix. The
configuration's file is the one ``configs`` gives; the traffic mix is
``portbench/traffic/<traffic>.json``; the cell's limits of the comparison are
``portbench/limits/<cell>.json``; each metric is read by
``portbench/metrics/<metric>.py``, whose ``read(run)`` returns the value, or
None where the run holds nothing to read. A later cell, traffic mix or
metric is a new file and a new entry: no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Spec:
    """The benchmark rooted at ``root`` (the directory of ``BENCHMARK.json``)."""

    def __init__(self, root):
        self.root = Path(root)
        self.home = self.root / "portbench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self._readers: dict = {}

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

    def reader(self, name: str):
        """``read`` of ``portbench/metrics/<name>.py``."""
        fn = self._readers.get(name)
        if fn is None:
            path = self.home / "metrics" / f"{name}.py"
            mod_name = "portbench_metric_" + name.replace(".", "_").replace("-", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            if spec is None or not path.exists():
                raise KeyError(f"no reader {path}")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            fn = self._readers[name] = mod.read
        return fn
