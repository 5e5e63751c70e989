"""The tilt insertion (``ops/tilt.py``: ``tilt_insert``) on the CPU.

``csrc/tilt.cu`` runs only on the card (``chip_smoke.py``'s ``tilt_kernel``
phase holds it against the plain route there; the ``cuda`` case below does
the same at a small size). Checked here: the plain route, which the CPU
takes, is the tilt compensation as it stood before the kernel bit for bit
(copied below), over angles, odd grids, a padded valid region and the blocks
of a mesh at their origins; the port's tilted cube against the benchmark's
plain reference (``portbench.reference.chain.tilt``); the wrapper refuses
what the kernel would not take, takes the plain route on a CPU tensor
without a launch, and raises on other devices; the stage calls it once a
tilt step and not at all in an FFT-window step; its spans; the source is
registered. Parity with the JAX package is in ``tests/test_torch_tilt.py``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.reference import chain as ref_chain
from portbench.reference.numerics import Numerics
from thz_image_explorer_tpu_torch import kernels
from thz_image_explorer_tpu_torch.data import make_cube
from thz_image_explorer_tpu_torch.io.dotthz import DotthzMetadata
from thz_image_explorer_tpu_torch.ops import tilt
from thz_image_explorer_tpu_torch.ops.windows import adapted_blackman_window
from thz_image_explorer_tpu_torch.parallel import mesh as pm
from thz_image_explorer_tpu_torch.pipeline import Explorer
from thz_image_explorer_tpu_torch.utils import spans

TILT = "tilt_compensation"
ANGLES = [(0.0, 0.0), (1.0, 1.0), (1.1, 1.0), (2.0, 2.0), (-15.0, 3.0), (7.5, -11.0),
          (15.0, 15.0), (-0.3, 0.1)]
#: the port's tilted cube against the float64 reference: the shifts are the
#: same integers (the reference copies the host geometry), the head and the
#: tail the same values, and inside, the port's f32 window (its cosines
#: within a few f32 ulps of the float64 taper's, ~3e-7) times a trace, one
#: f32 rounding (6e-8 relative): below ~5e-7 of the cube's largest value,
#: so the benchmark test's 1e-5 of it holds with 20x room
REFERENCE_REL = 1e-5


def _tilt_before(cube, tilt_x_deg, tilt_y_deg, valid_wh=None, host_time=None):
    """``ops/tilt.tilt_compensate`` as it stood before the kernel: the host
    shifts, an int64 index per output sample, a gather of the windowed
    cube, two selects."""
    num_steps = tilt.geometry(cube, tilt_x_deg, tilt_y_deg, valid_wh)
    if num_steps is None:
        return cube
    if host_time is None:
        host_time = cube.time.cpu().numpy()
    vwh = valid_wh if valid_wh is not None else cube.grid_wh
    dev = cube.device
    n_time = cube.n_time
    new_time = tilt.extended_time(host_time, num_steps)
    insert = torch.as_tensor(
        tilt.pixel_shifts(cube.width, cube.height, vwh, cube.dx, cube.dy,
                          tilt_x_deg, tilt_y_deg, num_steps, cube.origin),
        device=dev,
    )
    win = adapted_blackman_window(cube.time, 0.0, 7.0)
    k = torch.arange(new_time.shape[0], device=dev)
    idx = k[None, None, :] - insert[:, :, None]
    head, inside = idx < 0, idx < n_time
    gathered = torch.gather(cube.data * win, 2, idx.clamp_(0, n_time - 1))
    data = torch.where(head, cube.data[:, :, :1],
                       torch.where(inside, gathered, gathered.new_zeros(())))
    return cube.replace(data=data, time=torch.as_tensor(new_time, device=dev))


def _cube(w, h, n, seed, dx=0.5, dy=0.7):
    rng = np.random.default_rng(seed)
    t = (np.arange(n) * np.float32(0.05)).astype(np.float32)
    data = rng.normal(size=(w, h, n)).astype(np.float32)
    return t, make_cube(t, data, dx=dx, dy=dy, device="cpu")


@pytest.mark.parametrize("grid", [(24, 20), (19, 13), (31, 17), (1, 7)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("angles", ANGLES, ids=lambda a: f"{a[0]}_{a[1]}")
def test_plain_route_equals_the_tilt_before_bit_for_bit(grid, angles):
    t, cube = _cube(*grid, 96, seed=grid[0] * 31 + grid[1])
    want = _tilt_before(cube, *angles, host_time=t)
    got = tilt.tilt_compensate(cube, *angles, host_time=t)
    assert torch.equal(got.data, want.data) and torch.equal(got.time, want.time)
    assert got.data.shape[2] == got.time.shape[0]


@pytest.mark.parametrize("angles", [(2.0, 2.0), (12.0, -7.5)])
def test_plain_route_equals_the_tilt_before_in_a_padded_valid_region(angles):
    t, cube = _cube(26, 22, 80, seed=5)
    want = _tilt_before(cube, *angles, valid_wh=(20, 17), host_time=t)
    got = tilt.tilt_compensate(cube, *angles, valid_wh=(20, 17), host_time=t)
    assert torch.equal(got.data, want.data) and torch.equal(got.time, want.time)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 3)])
@pytest.mark.parametrize("grid,angles", [((30, 22), (2.0, 2.0)), ((31, 17), (12.0, -7.5))])
def test_plain_route_on_a_mesh_block_at_its_origin(shape, grid, angles):
    t, cube = _cube(*grid, 64, seed=11)
    mesh = pm.Mesh(shape)
    whole = _tilt_before(cube, *angles)
    for r in range(mesh.world):
        blk = pm.shard_cube(cube, mesh, r)
        assert blk.origin != (0, 0) or r == 0
        want = _tilt_before(blk, *angles)
        got = tilt.tilt_compensate(blk, *angles)
        x0, x1, y0, y1 = mesh.block(r, grid)
        assert torch.equal(got.data, want.data) and torch.equal(got.time, want.time)
        assert torch.equal(got.data, whole.data[x0:x1, y0:y1])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("angles", [(1.0, 1.0), (1.1, 1.0), (-3.0, 2.5), (12.0, -7.0)],
                         ids=lambda a: f"{a[0]}_{a[1]}")
def test_tilted_cube_matches_the_benchmark_reference(seed, angles):
    """A seeded random 24x20x256 cube at 0.5 mm: the port's tilted cube
    against ``portbench.reference.chain.tilt`` in float64 (REFERENCE_REL)."""
    t, cube = _cube(24, 20, 256, seed=seed, dx=0.5, dy=0.5)
    got = tilt.tilt_compensate(cube, *angles, host_time=t)
    cfg = {"scan": {"dx_mm": 0.5, "dy_mm": 0.5}}
    want, want_time = ref_chain.tilt(cube.data.double(), t, cfg, angles, Numerics("cpu"))
    np.testing.assert_array_equal(got.time.numpy(), want_time)
    assert got.data.shape == want.shape
    err = (got.data.double() - want).abs().max().item()
    assert err <= REFERENCE_REL * want.abs().max().item(), err


def test_shifts_output_is_pixel_shifts():
    t, cube = _cube(19, 13, 40, seed=3)
    n = tilt.extension_steps(19, 13, 0.5, 0.7, 3.0, -2.0)
    shifts = torch.full((19, 13), -1, dtype=torch.int64)
    tilt.tilt_insert(cube.data, cube.time, n, (19, 13), 0.5, 0.7, 3.0, -2.0, shifts=shifts)
    np.testing.assert_array_equal(shifts.numpy(),
                                  tilt.pixel_shifts(19, 13, (19, 13), 0.5, 0.7, 3.0, -2.0, n))


def test_head_is_the_raw_first_sample_and_tail_zero():
    t, cube = _cube(9, 6, 32, seed=4)
    win = adapted_blackman_window(cube.time, 0.0, 7.0)
    n = tilt.extension_steps(9, 6, 0.5, 0.7, 9.0, 4.0)
    shifts = torch.empty((9, 6), dtype=torch.int64)
    out = tilt.tilt_insert(cube.data, cube.time, n, (9, 6), 0.5, 0.7, 9.0, 4.0, shifts=shifts)
    assert out.shape == (9, 6, 32 + 2 * n) and n > 0
    for x in range(9):
        for y in range(6):
            s = int(shifts[x, y])
            row = out[x, y]
            assert torch.equal(row[:s], cube.data[x, y, :1].expand(s))
            assert torch.equal(row[s: s + 32], cube.data[x, y] * win)
            assert not row[s + 32:].any()


def _refusal_cases():
    t, cube = _cube(6, 5, 16, seed=6)
    args = dict(data=cube.data, time=cube.time, num_steps=3, valid_wh=(6, 5), dx=0.5, dy=0.7,
                tilt_x_deg=2.0, tilt_y_deg=1.0)
    return args, {
        "data float64": dict(data=cube.data.double()),
        "data of two dims": dict(data=cube.data[0]),
        "data not contiguous": dict(data=cube.data.transpose(0, 1)),
        "data of no samples": dict(data=cube.data[:, :, :0], time=cube.time[:0]),
        "time float64": dict(time=cube.time.double()),
        "time of another length": dict(time=cube.time[:-1]),
        "time not contiguous": dict(time=torch.stack([cube.time, cube.time], 1)[:, 0]),
        "time on another device": dict(time=cube.time.to("meta")),
        "negative num_steps": dict(num_steps=-1),
        "negative origin": dict(origin=(-1, 0)),
    }


@pytest.mark.parametrize("bad", sorted(_refusal_cases()[1]))
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    args, cases = _refusal_cases()
    args.update(cases[bad])
    with pytest.raises(ValueError):
        tilt.tilt_insert(**args)
    with pytest.raises(ValueError):
        tilt.tilt_insert_plain(**args)


@pytest.mark.parametrize("shifts", [torch.zeros((6, 5), dtype=torch.int32),
                                    torch.zeros((5, 6), dtype=torch.int64),
                                    torch.zeros((5, 6), dtype=torch.int64).T],
                         ids=["int32", "other shape", "not contiguous"])
def test_wrapper_refuses_a_shifts_output_it_cannot_fill(shifts):
    args, _ = _refusal_cases()
    with pytest.raises(ValueError):
        tilt.tilt_insert(**args, shifts=shifts)


def test_cpu_takes_the_plain_route_without_a_launch():
    args, _ = _refusal_cases()
    want = tilt.tilt_insert_plain(**args)
    before = tilt.tilt_insert.launches
    got = tilt.tilt_insert(**args)
    assert tilt.tilt_insert.launches == before
    assert torch.equal(got, want)


def test_other_devices_raise():
    args, _ = _refusal_cases()
    args.update(data=args["data"].to("meta"), time=args["time"].to("meta"))
    with pytest.raises(ValueError, match="no tilt kernel"):
        tilt.tilt_insert(**args)


def test_source_is_registered():
    assert "tilt" in kernels.SOURCES
    assert (kernels.CSRC / "tilt.cu").exists()


def _tilted_explorer():
    t, cube = _cube(20, 18, 64, seed=8)
    ex = Explorer(device="cpu")
    ex.open_arrays(t, cube.data.numpy(), DotthzMetadata(md={"dx [mm]": "0.5", "dy [mm]": "0.5"}))
    ex.set_filter_param(TILT, "tilt_y", 1.0)
    ex.set_filter_param(TILT, "tilt_x", 1.0)
    ex.set_filter_active(TILT, True)
    return ex


def test_one_insertion_a_tilt_step_none_in_a_window_step(monkeypatch):
    ex = _tilted_explorer()
    calls = []
    real = tilt.tilt_insert

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tilt, "tilt_insert", counted)
    for x in (1.1, 1.0, 1.1):
        ex.set_filter_param(TILT, "tilt_x", x)
        ex.update_filter(TILT)
    assert len(calls) == 3
    ex.set_fft_window_low(1.2)
    assert len(calls) == 3


def test_tilt_step_records_its_spans_under_the_stage():
    ex = _tilted_explorer()
    ex.set_filter_param(TILT, "tilt_x", 1.1)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        ex.update_filter(TILT)
    got = spans.spans()
    (stage,) = [s for s in got if s.name == "stage." + TILT]
    (geo,) = [s for s in got if s.name == "tilt.geometry"]
    (ins,) = [s for s in got if s.name == "tilt.insert"]
    assert geo.parent == stage.id and ins.parent == stage.id
    assert stage.t0 <= geo.t0 <= geo.t1 <= ins.t0 <= ins.t1 <= stage.t1
    assert ins.device_ms is not None and geo.device_ms is None
    spans.clear()
    ex.update_filter(TILT)  # no profiler: nothing recorded
    assert not [s for s in spans.spans() if s.name.startswith("tilt.")]


@pytest.mark.cuda
def test_kernel_equals_the_plain_route_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: csrc/tilt.cu runs only there")
    for grid, angles, origin in (((24, 20), (1.1, 1.0), (0, 0)), ((31, 17), (-15.0, 7.5), (0, 0)),
                                 ((15, 17), (12.0, -7.5), (16, 0))):
        t, cube = _cube(*grid, 256, seed=grid[0])
        data, time = cube.data.cuda(), cube.time.cuda()
        vwh = (origin[0] + grid[0], grid[1])
        n = tilt.extension_steps(*vwh, 0.5, 0.7, *angles)
        shifts = torch.empty(grid, dtype=torch.int64, device="cuda")
        before = tilt.tilt_insert.launches
        got = tilt.tilt_insert(data, time, n, vwh, 0.5, 0.7, *angles, origin, shifts=shifts)
        want = tilt.tilt_insert_plain(data, time, n, vwh, 0.5, 0.7, *angles, origin)
        assert tilt.tilt_insert.launches == before + 1
        assert torch.equal(got, want)
        np.testing.assert_array_equal(shifts.cpu().numpy(),
                                      tilt.pixel_shifts(*grid, vwh, 0.5, 0.7, *angles, n, origin))
