"""The deconvolution Apply path as a whole: both ``Explorer``s driven through
one command sequence on a 20x18x64 scan (dx = dy = 1 mm) with the
synthetic asymmetric PSF, every published series and the image compared
after each step. Also the executor's rerun-suppression rule on its own.
"""

import dataclasses

import numpy as np
import pytest

from make_sample import synthetic_scan, write_scan_thz
from test_torch_deconv import psf_pair
from thz_image_explorer_tpu.pipeline import Explorer as JaxExplorer
from thz_image_explorer_tpu_torch import convert
from thz_image_explorer_tpu_torch.ops import deconvolution as tdec
from thz_image_explorer_tpu_torch.pipeline import Explorer, PlotData

DEC = "deconvolution"
# the main-path tolerance (tests/test_torch_pipeline.py), and the
# deconvolved steps' (relative to each series' largest value: the gains
# are square roots of ratios of Richardson-Lucy estimates, computed in
# another summation order)
ATOL, RTOL = 5e-5, 1e-4
DECONV_REL = 1e-4

#: (name, command, whether the published state is deconvolved after it)
STEPS = [
    ("open", lambda ex, a: ex.open_file(a["path"]), False),
    ("roi", lambda ex, a: (ex.add_roi("u1", "r1", [(1, 1), (9, 1), (9, 8)]),
                           ex.set_reference("r1"), ex.set_sample("Selected Pixel")), False),
    ("psf", lambda ex, a: ex.apply_psf(a["psf"]), False),
    ("int_params_as_floats", lambda ex, a: [
        ex.set_filter_param(DEC, k, v) for k, v in
        (("n_filters", 5.0), ("n_iterations", 8.0), ("start_freq", 0.25), ("end_freq", 4.0))],
     False),
    ("switch_on", lambda ex, a: ex.set_filter_active(DEC, True), False),
    ("apply", lambda ex, a: ex.update_filter(DEC, force=True), True),
    ("click", lambda ex, a: ex.set_selected_pixel(12, 9), True),
    ("slider", lambda ex, a: ex.set_fft_window_low(1.1), False),
    ("apply_again", lambda ex, a: ex.update_filter(DEC, force=True), True),
    ("calculate_all", lambda ex, a: ex.update_filters(), True),
    ("switch_off", lambda ex, a: ex.set_filter_active(DEC, False), False),
]

_SERIES = [f.name for f in dataclasses.fields(PlotData)]


def _snapshot(ex):
    plot = {}
    for name in _SERIES:
        v = getattr(ex.plot, name)
        if isinstance(v, dict):
            v = {u: (n, np.array(a)) for u, (n, a) in v.items()}
        elif isinstance(v, np.ndarray):
            v = np.array(v)
        plot[name] = v
    return plot, np.array(ex.image), getattr(ex.pipeline, "run_epoch", None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("apply")
    t, raw = synthetic_scan(width=20, height=18, n_time=64)
    path = write_scan_thz(str(tmp / "s.thzimg"), t, raw, dx=1.0, dy=1.0)
    jpsf, tpsf = psf_pair(tmp)
    out = {}
    for key, ex, psf in (("jax", JaxExplorer(), jpsf), ("port", Explorer(device="cpu"), tpsf)):
        args = {"path": path, "psf": psf}
        out[key] = [(step(ex, args), _snapshot(ex))[1] for _name, step, _d in STEPS]
    return out


def _close(got, ref, deconvolved, msg):
    if deconvolved:
        atol, rtol = DECONV_REL * float(np.nanmax(np.abs(ref), initial=0.0)), 0.0
    else:
        atol, rtol = ATOL, RTOL
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol, err_msg=msg)


@pytest.mark.parametrize("step", range(len(STEPS)), ids=[s[0] for s in STEPS])
def test_apply_path_matches_jax_explorer(runs, step):
    deconvolved = STEPS[step][2]
    (jplot, jimg, _), (tplot, timg, _) = runs["jax"][step], runs["port"][step]
    _close(timg, jimg, deconvolved, "image")
    for name in _SERIES:
        j, t = jplot[name], tplot[name]
        if isinstance(j, dict):
            assert list(t) == list(j), name
            for uuid in j:
                assert t[uuid][0] == j[uuid][0]
                _close(t[uuid][1], j[uuid][1], deconvolved, f"{name}[{uuid}]")
        elif isinstance(j, np.ndarray):
            assert t.shape == j.shape, name
            _close(t, j, deconvolved, name)
        else:
            assert t == j, name


def test_sequence_is_not_vacuous(runs):
    """The Apply changes the image, the switch-on ran nothing, the slider
    dropped the deconvolved result, and switching off restores the chain."""
    snaps = {name: snap for (name, _s, _d), snap in zip(STEPS, runs["port"])}
    before, applied = snaps["switch_on"][1], snaps["apply"][1]
    assert np.isfinite(applied).all()
    assert np.abs(applied - before).max() > 1e-2 * np.abs(before).max()
    assert snaps["switch_on"][2] == snaps["int_params_as_floats"][2]  # no rerun
    assert snaps["click"][2] == snaps["apply"][2]  # a click runs no chain
    np.testing.assert_array_equal(snaps["apply_again"][1], snaps["calculate_all"][1])
    assert not np.allclose(snaps["slider"][1], snaps["apply_again"][1])
    np.testing.assert_array_equal(snaps["switch_off"][1], snaps["slider"][1])


# ------------------------------------------------------------ port rules
@pytest.fixture
def applied(tmp_path):
    """A port Explorer after an Apply, and the deconvolution's chain index."""
    t, raw = synthetic_scan(width=20, height=18, n_time=64)
    path = write_scan_thz(str(tmp_path / "s.thzimg"), t, raw, dx=1.0, dy=1.0)
    ex = Explorer(device="cpu")
    ex.open_file(path)
    ex.apply_psf(psf_pair(tmp_path)[1])
    ex.pipeline.filters[DEC].params = tdec.DeconvolutionParams(
        n_iterations=4, n_filters=3, start_freq=0.25, end_freq=4.0)
    ex.set_filter_active(DEC, True)
    ex.update_filter(DEC, force=True)
    return ex, ex.pipeline.index_of(DEC)


def test_suppression_is_keyed_on_the_requested_start(applied):
    ex, k = applied
    p = ex.pipeline
    assert p.slots[k] is not p.slots[k - 1]
    ms = p.timings_ms[DEC]
    # an inactive filter before the deconvolution still suppresses it
    assert not p.filters["time_band_pass_after_fft"].active
    ex.update_filter("time_band_pass_after_fft")
    assert p.slots[k] is p.slots[k - 1] and p.timings_ms[DEC] == ms
    # an update requested from the deconvolution itself runs it
    ex.update_filter(DEC)
    assert p.slots[k] is not p.slots[k - 1]
    ex.set_fft_window_low(1.2)  # a slider: suppressed
    assert p.slots[k] is p.slots[k - 1]
    ex.set_downscaling(1)  # from the scaling stage, not forced: suppressed
    assert p.slots[k] is p.slots[k - 1]
    ex.update_filters()  # Calculate All: forced
    assert p.slots[k] is not p.slots[k - 1]
    assert p.progress[DEC] is None


def test_switching_deconvolution_on_waits_for_apply(applied):
    ex, k = applied
    p = ex.pipeline
    ex.set_filter_active(DEC, False)
    assert p.slots[k] is p.slots[k - 1]
    epoch = p.run_epoch
    ex.set_filter_active(DEC, True)
    assert p.run_epoch == epoch and p.slots[k] is p.slots[k - 1]


def test_set_filter_param_reaches_params_and_keeps_ints():
    ex = Explorer(device="cpu")
    ex.set_filter_param(DEC, "n_filters", 7.0)
    ex.set_filter_param(DEC, "start_freq", 1)
    ex.set_filter_param(DEC, "bogus", 1.0)  # ignored, like the JAX facade
    params = ex.pipeline.filters[DEC].params
    assert params.n_filters == 7 and type(params.n_filters) is int
    assert params.start_freq == 1.0 and type(params.start_freq) is float
    assert not hasattr(params, "bogus")


def test_filter_params_from_numpy_fills_params():
    filters = convert.filter_params_from_numpy(
        {DEC: {"n_iterations": np.int32(12), "active": np.bool_(True),
               "win_width": np.float32(0.25)}})
    stage = filters[DEC]
    assert stage.active is True and stage.params.n_iterations == 12
    assert type(stage.params.n_iterations) is int and stage.params.win_width == 0.25
    with pytest.raises(AttributeError, match="no parameter"):
        convert.filter_params_from_numpy({DEC: {"n_iteration": 3}})


def test_open_psf_reads_the_npz(tmp_path):
    from thz_image_explorer_tpu_torch.io.psf_npz import save_psf

    psf = psf_pair(tmp_path)[1]
    save_psf(str(tmp_path / "psf.npz"), psf)
    ex = Explorer(device="cpu")
    ex.open_psf(str(tmp_path / "psf.npz"))
    assert ex.pipeline.psf.fingerprint() == psf.fingerprint()
