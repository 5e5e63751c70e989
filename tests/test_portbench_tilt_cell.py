"""The benchmark's tilt cell (``scan512.tilt``) on the CPU at a tiny size.

The cell's configuration, traffic mix, limits and per-layer metrics are
found by name like every other cell's; a run of the program on the CPU is
``correct`` under the cell's limits, and so is every comparison number
against the CPU bounds the benchmark's own tests use; the cell's traced
metrics read a value (the roofline shares need a card's trace); the control
(the reference in TF32) fails the cell's limits. The configuration at its
real size is the 512x512 one with tilt compensation on.
"""

import importlib.util
import time
from pathlib import Path

import pytest

from portbench import cell as cellmod
from portbench import check, control
from portbench.reference import Reference
from portbench.session import Session
from portbench.spec import Spec

_CONFTEST = importlib.util.spec_from_file_location(
    "portbench_tests_conftest",
    Path(__file__).resolve().parents[1] / "portbench" / "tests"
    / "conftest.py")
bench_conftest = importlib.util.module_from_spec(_CONFTEST)
_CONFTEST.loader.exec_module(bench_conftest)

REPO, SEED = bench_conftest.REPO, bench_conftest.SEED
CELL = "scan512.tilt"
#: as ``portbench/tests/test_portbench_reference.py``'s CPU_BOUNDS: a sound
#: CPU run of the program at these sizes reads far below them
CPU_BOUNDS = dict(series_gap=1e-4, phase_gap=0.05, optical_gap=1e-2, apply_gap=1e-4)


@pytest.fixture
def tiny_root(tmp_path):
    return bench_conftest.make_root(tmp_path / "root")


def test_the_cell_is_declared_as_its_files_say():
    spec = Spec(REPO)
    cell = spec.workload(CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "tilt"
    cfg = spec.config(cell["config"])
    base = spec.config("scan-512x512x1024")
    assert cfg["filters"] == {"tilt_compensation": True, **base["filters"]}
    for key in ("scan", "pulse", "rois", "reference_roi", "psf", "deconvolution", "precision",
                "sample_thickness_m"):
        assert cfg[key] == base[key], key
    assert spec.limits(CELL) == {"series_gap": 8e-5, "phase_gap": 0.02, "optical_gap": 5e-4}
    e2e = {m["name"] for m in spec.metrics(CELL, traced=False)}
    assert e2e == {"slider_ms", "slider_p95_ms", "setup_s"}
    layer = {m["name"] for m in spec.metrics(CELL, traced=True)}
    assert layer == {"tilt_stage_ms.tilt", "tilt_host_ms.tilt", "tilt_roofline.tilt",
                     "device_idle.tilt", "polar_roofline.slider"}
    traffic = spec.traffic("tilt")
    assert traffic["sweep"] == [1.0, 1.1] and traffic["warmup_cycles"] == 4
    assert traffic["sample"] == {"slider": 6}


@pytest.mark.parametrize("traced", [False, True])
def test_a_run_on_the_cpu_is_correct(tiny_root, traced):
    result = cellmod.run_cell(Spec(tiny_root), CELL, SEED, 1.5, traced, "cpu",
                              time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    got = set(result["metrics"])
    if traced:
        # the roofline share reads the kernel in a card's trace
        assert got == {"tilt_stage_ms.tilt", "tilt_host_ms.tilt", "device_idle.tilt"}
        assert all(v["value"] >= 0 for v in result["metrics"].values())
    else:
        assert got == {"slider_ms", "slider_p95_ms", "setup_s"}


def test_published_series_match_the_reference_within_cpu_bounds():
    spec = Spec(REPO)
    cfg = bench_conftest.tiny_config(spec.workload(CELL)["config"])
    s = Session(cfg, spec.traffic("tilt"), SEED, "cpu")
    s.open()
    ref = Reference(cfg, SEED, "cpu")
    readings, lengths = [], set()
    for _ in range(4):
        step = s.next_step()
        assert step.ok and step.state["tilt"][1] == 1.0
        lengths.add(step.n_time)
        readings.append(check.compare(check.capture(s.explorer, s.roi_ids),
                                      ref.published(step.state), False, cfg["reference_roi"]))
    s.close()
    # the sweep alternates two trace lengths, both longer than the scan's
    assert len(lengths) == 2 and min(lengths) > cfg["scan"]["n_time"]
    for name, value in check.worst(readings).items():
        if value is not None:
            assert value <= CPU_BOUNDS[name], (name, value)


def test_control_fails_the_limits(tiny_root):
    spec = Spec(tiny_root)
    cell = spec.workload(CELL)
    numbers = control.control_numbers(spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                                      SEED, "cpu", 2)
    correct, checks = check.verdict(numbers, Spec(REPO).limits(CELL))
    assert not correct, checks


def test_the_roofline_reader_counts_each_byte_once():
    bound_bytes = Spec(REPO).reader("tilt_roofline.tilt").__globals__["bound_bytes"]
    assert bound_bytes(512 * 512, 1024, 1648) == 512 * 512 * (1024 + 1648) * 4
    # about 0.84 ms on the card's 3.35 TB/s
    assert abs(bound_bytes(512 * 512, 1024, 1648) / 3.35e12 - 0.836e-3) < 1e-5
