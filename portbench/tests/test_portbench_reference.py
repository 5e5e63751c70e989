"""The plain reference against the program, at tiny sizes on the CPU.

The program's published series, its deconvolved image and its tilted cube
agree with ``portbench.reference``; the reference's TF32 control does not
pass the cells' limits; the reference's integer geometry (ROI masks, tilt
shifts) is the program's; and the reference loads nothing of the program.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import REPO, SEED, tiny_config

from portbench import check, control
from portbench.reference import Reference, chain, geometry
from portbench.session import Session
from portbench.spec import Spec

#: the gaps a sound CPU run of the program reads at these sizes stay far
#: below these (1e-6 to 1e-5 of a series' peak; phases and optical
#: constants 1e-5 to 1e-2, a ROI of a few dozen pixels showing a turn of a
#: pixel's noise bins as 2 pi / N)
CPU_BOUNDS = dict(series_gap=1e-4, phase_gap=0.05, optical_gap=1e-2, apply_gap=1e-4)
CELLS = (("scan-200x200x1024", "apply"), ("scan-512x512x1024", "drag"))
#: the tilt slider dragged over one notch (tilt_x 1.0 <-> 1.1 degrees at
#: tilt_y 1.0), each step re-running the chain from the tilt stage
TILT = {"setup": [{"call": "set_filter_param", "args": ["tilt_compensation", "tilt_y", 1.0]},
                  {"call": "set_filter_param", "args": ["tilt_compensation", "tilt_x", 1.0]},
                  {"call": "set_filter_active", "args": ["tilt_compensation", True],
                   "state": {"tilt": [1.0, 1.0]}}],
        "steps": {"tilt": {"class": "slider", "reruns_from": "tilt_compensation",
                           "commands": [{"call": "set_filter_param",
                                         "args": ["tilt_compensation", "tilt_x", "$x"]},
                                        {"call": "update_filter", "args": ["tilt_compensation"]}],
                           "state": {"tilt": ["$x", 1.0], "deconvolved": False}}},
        "cycle": ["tilt"], "sweep": [1.0, 1.1], "warmup_cycles": 2, "sample": {"slider": 3}}


def _session(cfg, traffic, n_steps):
    """An opened session on the CPU after ``n_steps`` steps."""
    s = Session(cfg, traffic, SEED, "cpu")
    s.open()
    steps = [s.next_step() for _ in range(n_steps)]
    assert all(st.ok for st in steps)
    return s, steps


@pytest.mark.parametrize("config,traffic", CELLS, ids=[f"{c}-{t}" for c, t in CELLS])
def test_published_series_match_reference(config, traffic):
    cfg = tiny_config(config)
    s = Session(cfg, Spec(REPO).traffic(traffic), SEED, "cpu")
    s.open()
    ref = Reference(cfg, SEED, "cpu")
    readings = []
    for _ in range(4):
        step = s.next_step()
        assert step.ok
        readings.append(check.compare(check.capture(s.explorer, s.roi_ids),
                                      ref.published(step.state),
                                      bool(step.state.get("deconvolved")), cfg["reference_roi"]))
    s.close()
    numbers = check.worst(readings)
    for name, value in numbers.items():
        if value is not None:
            assert value <= CPU_BOUNDS[name], (name, value)
    assert (numbers["apply_gap"] is not None) == (traffic == "apply")


def test_deconvolved_image_matches_reference():
    cfg = tiny_config("scan-200x200x1024")
    tr = Spec(REPO).traffic("apply")
    s, steps = _session(cfg, tr, 2)
    assert steps[-1].cls == "apply" or steps[-2].cls == "apply"
    if steps[-1].cls != "apply":
        steps.append(s.next_step())
    image = np.asarray(s.explorer.image, np.float64)
    want = Reference(cfg, SEED, "cpu").published(steps[-1].state)["image"]
    s.close()
    before = Reference(cfg, SEED, "cpu").published(dict(steps[-1].state, deconvolved=False))
    # the Apply changed the image, and the program's change is the reference's
    assert np.abs(want - before["image"]).max() > 1e-3 * np.abs(want).max()
    assert np.abs(image - want).max() <= 1e-5 * np.abs(want).max()


def test_tilted_cube_matches_reference():
    cfg = tiny_config("scan-512x512x1024")
    s, steps = _session(cfg, TILT, 3)
    out = s.explorer.pipeline.output
    data, time = out.data.double().numpy(), out.time.numpy()
    s.close()
    ref = Reference(cfg, SEED, "cpu")
    slots = chain.chain(ref.raw, ref.time, cfg, steps[-1].state, ref.num)
    assert len(time) > cfg["scan"]["n_time"]
    np.testing.assert_array_equal(time, slots["time"])
    want = slots["final"].numpy()
    assert data.shape == want.shape
    assert np.abs(data - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("workload", ["scan200.apply", "scan512.drag", "scan512.apply"])
def test_control_fails_the_limits(tiny_root, workload):
    spec = Spec(tiny_root)
    cell = spec.workload(workload)
    numbers = control.control_numbers(spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                                      SEED, "cpu", 2)
    correct, checks = check.verdict(numbers, Spec(REPO).limits(workload))
    assert not correct, checks


@pytest.mark.parametrize("polygon", [
    [(2, 2), (20, 3), (18, 25), (4, 22)],
    [(10, 1), (30, 12), (5, 30)],
    [(3, 5), (3, 5), (25, 5), (25, 27)],
    [(-3, 4), (12, -2), (40, 20), (8, 33)],  # vertices off the grid wrap as u64
])
def test_roi_mask_is_the_programs(polygon):
    from thz_image_explorer_tpu_torch.ops.roi import polygon_mask_plain

    for shape in ((32, 28), (40, 36)):
        np.testing.assert_array_equal(geometry.polygon_mask(polygon, shape),
                                      polygon_mask_plain(polygon, shape))


@pytest.mark.parametrize("angles", [(1.0, 1.0), (1.1, 1.0), (2.0, -3.0), (-0.7, 0.4)])
def test_tilt_geometry_is_the_programs(angles):
    from thz_image_explorer_tpu_torch.ops import tilt

    for w, h in ((32, 28), (512, 512)):
        n = tilt.extension_steps(w, h, 0.5, 0.5, *angles)
        assert geometry.extension_steps(w, h, 0.5, 0.5, *angles) == n
        np.testing.assert_array_equal(geometry.pixel_shifts(w, h, 0.5, 0.5, *angles, n),
                                      tilt.pixel_shifts(w, h, (w, h), 0.5, 0.5, *angles, n))
        t = (np.arange(1024) * np.float32(0.05)).astype(np.float32)
        np.testing.assert_array_equal(geometry.extended_time(t, n), tilt.extended_time(t, n))


def test_tf32_rounding():
    from portbench.reference.numerics import tf32_round

    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0 - 2.0 ** -10])
    got = tf32_round(x)
    # 10 mantissa bits, ties away from zero
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -9]


def test_reference_loads_nothing_of_the_program():
    code = (
        "import sys, numpy as np\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from conftest import tiny_config\n"
        "from portbench.reference import Reference\n"
        "cfg = tiny_config('scan-200x200x1024')\n"
        "r = Reference(cfg, 3, 'cpu')\n"
        "r.published(dict(fft_window_low=1.1, tilt=None, deconvolved=True))\n"
        "r.published(dict(fft_window_low=1.1, tilt=[1.0, 1.0], deconvolved=False))\n"
        "bad = {m.split('.')[0] for m in sys.modules} & "
        "{'thz_image_explorer_tpu_torch', 'thz_image_explorer_tpu', 'jax', 'jaxlib', 'flax'}\n"
        "print(sorted(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(REPO / "portbench" / "tests"), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
