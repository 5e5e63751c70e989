"""Fixtures of the benchmark's CPU tests: a benchmark root at tiny sizes.

``tiny_root`` is a directory laid out as the checkout's root: its own
``BENCHMARK.json`` naming the real cells and the parked ones, with
configurations cut to a few dozen pixels and 256 or 128 samples (and a
deconvolution of 6 bands and 20 iterations, which such a scan can hold), and
a ``portbench`` directory whose traffic, limits, metric readers and output
modules are the real ones.

Tests that need the card carry the ``cuda`` marker and decide inside the
test whether there is one.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

HOME = Path(__file__).resolve().parents[1]
REPO = HOME.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: a seed larger than 32 signed bits hold, as a benchmark check's can be
SEED = 2**31 + 12345


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


def roi_polygons(w, h):
    return [[[w // 10, h // 10], [w // 3, h // 10], [w // 3, h // 3], [w // 10, h // 3]],
            [[w // 2, h // 2], [2 * w // 3, h // 2], [2 * w // 3, 2 * h // 3]],
            [[w // 6, 2 * h // 3], [w // 3, 2 * h // 3], [w // 4, 5 * h // 6]],
            [[3 * w // 5, h // 8], [4 * w // 5, h // 8], [4 * w // 5, h // 3],
             [3 * w // 5, h // 3]]]


def tiny_config(name: str) -> dict:
    """The configuration ``name`` cut to a size the CPU runs in seconds."""
    cfg = json.loads((HOME / "configs" / f"{name}.json").read_text())
    w, h, t = (40, 36, 256) if "200x200" in name else (32, 28, 128)
    cfg["scan"].update(width=w, height=h, n_time=t)
    cfg["rois"] = roi_polygons(w, h)
    cfg["deconvolution"].update(n_filters=6, n_iterations=20, start_freq=0.3)
    return cfg


def make_root(path: Path) -> Path:
    from portbench.spec import add_parked

    # the parked cells' entries as they stand: their traffic, limits, readers
    # and outputs are tested as a later PR would add them back
    bench = add_parked(json.loads((REPO / "BENCHMARK.json").read_text()), HOME)
    (path / "portbench").mkdir(parents=True)
    for sub in ("traffic", "limits", "metrics", "outputs"):
        shutil.copytree(HOME / sub, path / "portbench" / sub)
    for entry in bench["configs"]:
        entry["file"] = f"portbench/configs/{entry['name']}.json"
        (path / "portbench" / "configs").mkdir(exist_ok=True)
        (path / entry["file"]).write_text(json.dumps(tiny_config(entry["name"])))
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path / "root")
