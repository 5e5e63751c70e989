"""Each ported op of ``thz_image_explorer_tpu_torch.ops`` (and the data
model) against its JAX counterpart in ``thz_image_explorer_tpu``, on the
same seeded numpy inputs. JAX runs on the CPU (tests/conftest.py).

Tolerances: f32 elementwise math with the same formula agrees to a few
ulps (1e-6 relative); FFTs and cumsums differ in summation order between
the two libraries' CPU kernels (1e-5 relative, 1e-5..1e-4 absolute on
unit-scale data); the wrap rule and the rasterizer are exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thz_image_explorer_tpu import data as jdata
from thz_image_explorer_tpu.ops import bandpass as jbp
from thz_image_explorer_tpu.ops import fourier as jfourier
from thz_image_explorer_tpu.ops import intensity as jint
from thz_image_explorer_tpu.ops import optical as jopt
from thz_image_explorer_tpu.ops import roi as jroi
from thz_image_explorer_tpu.ops import scaling as jscaling
from thz_image_explorer_tpu.ops import windows as jwin
from thz_image_explorer_tpu_torch import convert
from thz_image_explorer_tpu_torch import data as tdata
from thz_image_explorer_tpu_torch.ops import bandpass as tbp
from thz_image_explorer_tpu_torch.ops import fourier as tfourier
from thz_image_explorer_tpu_torch.ops import intensity as tint
from thz_image_explorer_tpu_torch.ops import optical as topt
from thz_image_explorer_tpu_torch.ops import roi as troi
from thz_image_explorer_tpu_torch.ops import scaling as tscaling
from thz_image_explorer_tpu_torch.ops import windows as twin
from thz_image_explorer_tpu_torch.pipeline.stage import instantiate_filters

TIME = (np.arange(64) * 0.1).astype(np.float32)  # 0 .. 6.3 ps
FREQ = (np.arange(33) / np.float32(TIME[-1] - TIME[0])).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _leaves(cube) -> dict:
    """A JAX ScanCube's array leaves as numpy."""
    return {
        f.name: np.asarray(getattr(cube, f.name))
        for f in dataclasses.fields(cube)
        if not f.metadata.get("static") and getattr(cube, f.name) is not None
    }


def _port_cube(jcube):
    return convert.cube_from_numpy(
        _leaves(jcube), dx=jcube.dx, dy=jcube.dy, x_min=jcube.x_min,
        y_min=jcube.y_min, scaling=jcube.scaling, device="cpu",
    )


def _jax_cube(shape=(6, 5, 64), seed=0):
    rng = np.random.default_rng(seed)
    data = np.float32(rng.standard_normal(shape))
    return jdata.make_cube(TIME[: shape[2]], data, dx=0.5, dy=0.25)


# ------------------------------------------------------------- data model
def test_frequency_axis_and_load_preprocess():
    rng = np.random.default_rng(1)
    raw = np.float32(rng.standard_normal((4, 3, 64)) + 0.5)
    np.testing.assert_array_equal(
        tdata.frequency_axis(_t(TIME)).numpy(), np.asarray(jdata.frequency_axis(TIME))
    )
    jd, jimg = jdata.load_preprocess(raw)
    td, timg = tdata.load_preprocess(_t(raw))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=1e-5)
    x = np.float32(rng.standard_normal((4, 3, 7)))
    np.testing.assert_allclose(
        tdata.masked_pixel_mean(_t(x), (4, 3)).numpy(),
        np.asarray(jdata.masked_pixel_mean(jnp.asarray(x), jnp.asarray([4, 3]))),
        rtol=1e-6, atol=1e-7,
    )


def test_cube_from_numpy_keeps_every_leaf():
    jcube = jfourier.forward_fft(_jax_cube(), jwin.WindowType.HANNING, 0.0, 0.0)
    cube = _port_cube(jcube)
    assert cube.fft.dtype == torch.complex64 and cube.data.dtype == torch.float32
    for name, value in _leaves(jcube).items():
        if name != "valid_wh":
            np.testing.assert_array_equal(getattr(cube, name).numpy(), value, err_msg=name)
    assert cube.valid_wh == (6, 5) and (cube.dx, cube.dy) == (0.5, 0.25)


# ---------------------------------------------------------------- windows
@pytest.mark.parametrize(
    "kind,low,high",
    [
        ("ADAPTED_BLACKMAN", 1.0, 2.0),
        ("ADAPTED_BLACKMAN", 0.0, 0.0),  # [0, 0] disables the taper
        ("ADAPTED_BLACKMAN", 4.0, 3.0),  # overlapping head and tail
        ("BLACKMAN", 0.0, 0.0),
        ("HANNING", 0.0, 0.0),
        ("HAMMING", 0.0, 0.0),
        ("FLAT_TOP", 0.0, 0.0),
    ],
)
def test_window_array(kind, low, high):
    got = twin.window_array(_t(TIME), twin.WindowType[kind], low, high).numpy()
    ref = np.asarray(jwin.window_array(jnp.asarray(TIME), jwin.WindowType[kind], low, high))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------- bandpass
@pytest.mark.parametrize(
    "low,high,width",
    [(1.0, 5.0, 0.5), (-3.0, 99.0, 2.0), (2.05, 2.1, 0.3), (5.0, 1.0, 0.1)],
)
def test_td_bandpass_weights(low, high, width):
    got = tbp.td_bandpass_weights(_t(TIME), low, high, width).numpy()
    ref = np.asarray(jbp.td_bandpass_weights(jnp.asarray(TIME), low, high, width))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize(
    "low,high,width",
    [(0.2, 5.0, 0.1), (-1.0, 100.0, 0.5), (1.0, 1.2, 0.3), (4.0, 0.5, 0.1)],
)
def test_fd_bandpass_weights(low, high, width):
    got = tbp.fd_bandpass_weights(_t(FREQ), low, high, width).numpy()
    ref = np.asarray(jbp.fd_bandpass_weights(jnp.asarray(FREQ), low, high, width))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("width,depth", [(0.02, 1.0), (0.3, 0.5), (0.2, 1.7)])
def test_water_notch_weights(width, depth):
    from thz_image_explorer_tpu_torch.assets.water_lines import WATER_LINES_THZ
    from thz_image_explorer_tpu.assets.water_lines import WATER_LINES_THZ as JLINES

    assert WATER_LINES_THZ == JLINES
    lines = np.asarray(WATER_LINES_THZ, np.float32)
    got = tbp.water_notch_weights(_t(FREQ), _t(lines), width, depth).numpy()
    ref = np.asarray(jbp.water_notch_weights(jnp.asarray(FREQ), jnp.asarray(lines), width, depth))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_band_filters_apply_to_cube():
    rng = np.random.default_rng(2)
    data = np.float32(rng.standard_normal((3, 4, 64)))
    spec = (rng.standard_normal((3, 4, 33)) + 1j * rng.standard_normal((3, 4, 33))).astype(np.complex64)
    amps = np.abs(spec).astype(np.float32)
    np.testing.assert_allclose(
        tbp.td_bandpass(_t(data), _t(TIME), 1.0, 4.0, 0.5).numpy(),
        np.asarray(jbp.td_bandpass(data, TIME, 1.0, 4.0, 0.5)), rtol=1e-6, atol=1e-7,
    )
    lines = np.asarray([0.5, 1.1, 2.0], np.float32)
    for got, ref in (
        (tbp.fd_bandpass(_t(spec), _t(amps), _t(FREQ), 0.3, 3.0, 0.2),
         jbp.fd_bandpass(spec, amps, FREQ, 0.3, 3.0, 0.2)),
        (tbp.water_notch(_t(spec), _t(amps), _t(FREQ), _t(lines), 0.2, 0.8),
         jbp.water_notch(spec, amps, FREQ, lines, 0.2, 0.8)),
    ):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)


def test_fd_weight_vector_contract():
    """Every FD stage's apply equals multiplying the spectrum and the
    amplitudes by its fd_weight_vector: the factorization the publish's
    one-pass reduction relies on."""
    rng = np.random.default_rng(1)
    cube = tdata.make_cube(TIME, np.float32(rng.standard_normal((6, 5, 64))), device="cpu")
    spec = torch.complex(torch.randn(6, 5, 33), torch.randn(6, 5, 33))
    cube = cube.replace(fft=spec, amplitudes=spec.abs())
    fd = [f for f in instantiate_filters().values() if hasattr(f, "fd_weight_vector")]
    assert len(fd) == 2
    for stage in fd:
        stage.active = True
        out = stage.apply(cube, None)
        w = stage.fd_weight_vector(cube.freq)
        assert bool((w >= 0).all()) and bool((w <= 1.0 + 1e-6).all())
        torch.testing.assert_close(out.fft, cube.fft * w, rtol=0, atol=1e-6)
        torch.testing.assert_close(out.amplitudes, cube.amplitudes * w, rtol=0, atol=1e-6)
        assert out.phases is cube.phases


# ---------------------------------------------------------------- fourier
def test_wrap_adjust_is_exact_at_pi():
    pi = np.float32(np.pi)
    d = np.asarray(
        [pi, -pi, np.nextafter(pi, np.float32(4)), np.nextafter(-pi, np.float32(-4)),
         np.nextafter(pi, np.float32(0)), 0.0, 3.5, -3.5, 6.0, -6.0, np.float32(np.pi + 1e-7)],
        np.float32,
    )
    got = tfourier.wrap_adjust(_t(d)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfourier.wrap_adjust(jnp.asarray(d))))
    assert got[0] == pi and got[1] == -pi  # a jump of exactly pi is kept


def test_phase_increments_and_unwrap():
    rng = np.random.default_rng(3)
    phase = np.float32(rng.uniform(-np.pi, np.pi, (5, 7, 40)))
    phase[0, 0, 5] = np.float32(np.pi)
    phase[0, 0, 6] = np.float32(0.0)  # a jump of exactly -pi
    np.testing.assert_array_equal(
        tfourier.phase_increments(_t(phase)).numpy(),
        np.asarray(jfourier.phase_increments(jnp.asarray(phase))),
    )
    np.testing.assert_allclose(
        tfourier.unwrap(_t(phase)).numpy(),
        np.asarray(jfourier.unwrap(jnp.asarray(phase))), rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        tfourier.unwrap(_t(phase), dim=1).numpy(),
        np.asarray(jfourier.unwrap(jnp.asarray(phase), axis=1)), rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("kind", ["ADAPTED_BLACKMAN", "HANNING"])
def test_forward_fft(kind):
    jin = _jax_cube()
    ref = jfourier.forward_fft(jin, jwin.WindowType[kind], 1.0, 2.0)
    got = tfourier.forward_fft(_port_cube(jin), twin.WindowType[kind], 1.0, 2.0)
    for name in ("data", "fft", "amplitudes"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got.phases.numpy(), np.asarray(ref.phases),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("avg_in_fourier_space", [False, True])
def test_inverse_fft(avg_in_fourier_space):
    """Fed the JAX forward_fft's output through convert.cube_from_numpy."""
    spectral = jfourier.forward_fft(_jax_cube(seed=4), jwin.WindowType.ADAPTED_BLACKMAN, 1.0, 2.0)
    ref = jfourier.inverse_fft(spectral, avg_in_fourier_space)
    got = tfourier.inverse_fft(_port_cube(spectral), avg_in_fourier_space)
    for name in ("data", "avg_data", "avg_fft", "avg_signal_fft", "avg_phase_fft"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_polar_irfft():
    rng = np.random.default_rng(6)
    amp = np.float32(rng.uniform(0, 2, (3, 33)))
    ph = np.float32(rng.uniform(-9, 9, (3, 33)))
    np.testing.assert_allclose(
        tfourier.polar_irfft(_t(amp), _t(ph), 64).numpy(),
        np.asarray(jfourier.polar_irfft(jnp.asarray(amp), jnp.asarray(ph), 64)),
        rtol=1e-5, atol=1e-5,
    )


# ------------------------------------------------ scaling and intensity
@pytest.mark.parametrize("scale", [2, 3])
def test_scale_cube(scale):
    spectral = jfourier.forward_fft(_jax_cube((7, 5, 64), seed=5),
                                    jwin.WindowType.HANNING, 0.0, 0.0)
    ref = jscaling.scale_cube(spectral, scale, valid_wh=(7, 5))
    got = tscaling.scale_cube(_port_cube(spectral), scale, valid_wh=(7, 5))
    for name in ("data", "fft", "amplitudes", "phases"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert got.valid_wh == tuple(int(v) for v in np.asarray(ref.valid_wh))
    assert (got.dx, got.dy, got.scaling) == (ref.dx, ref.dy, ref.scaling)


def test_scale_cube_no_op_cases():
    cube = _port_cube(_jax_cube((3, 2, 64)))
    assert tscaling.scale_cube(cube, 1) is cube
    assert tscaling.scale_cube(cube, 4) is cube  # 2 // 4 == 0
    assert tscaling.scale_cube(cube, 2, valid_wh=(1, 2)) is cube


@pytest.mark.parametrize("scale", [1, 3])
def test_intensity_images(scale):
    rng = np.random.default_rng(7)
    data = np.float32(rng.standard_normal((4, 3, 16)))
    if scale == 1:
        got, ref = tint.intensity_image(_t(data)), jint.intensity_image(data)
    else:
        got = tint.upscaled_intensity_image(_t(data), scale)
        ref = jint.upscaled_intensity_image(data, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- ROIs
@pytest.mark.parametrize(
    "polygon,shape,scaling",
    [
        ([(1, 1), (8, 1), (8, 8)], (18, 14), 1),
        ([(2, 3), (15, 2), (12, 11), (4, 9)], (18, 14), 2),
        ([(-3, 2), (30, 4), (10, 40)], (12, 10), 1),  # vertices past the edges (u64 wrap)
        ([(0, 0), (5, 0), (5, 5), (0, 5)], (6, 6), 1),
        ([(3, 3)], (6, 6), 1),  # degenerate
        ([(1, 1), (4, 1), (4, 4)], (6, 6), 0),  # scaling 0: empty mask
    ],
)
def test_polygon_mask(polygon, shape, scaling):
    got = troi.polygon_mask(polygon, shape, scaling)
    ref = jroi.polygon_mask(polygon, shape, scaling)
    assert got.dtype == bool and got.shape == tuple(shape)
    np.testing.assert_array_equal(got, ref)


def test_masked_mean_stack():
    rng = np.random.default_rng(8)
    arr = np.float32(rng.standard_normal((6, 5, 9)))
    masks = np.float32(rng.uniform(0, 1, (3, 6, 5)) > 0.5)
    masks[2] = 0  # an empty mask gives zeros
    got = troi.masked_mean_stack(_t(arr), _t(masks)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jroi.masked_mean_stack(jnp.asarray(arr), jnp.asarray(masks))),
        rtol=1e-5, atol=1e-6,
    )
    assert not got[2].any()
    assert troi.masked_mean_stack(_t(arr), torch.zeros(0, 6, 5)).shape == (0, 9)


# --------------------------------------------------------------- optical
def test_optical_properties():
    rng = np.random.default_rng(9)
    f = np.float32(np.linspace(0.1, 3.0, 33))
    sa, ra = np.float32(rng.uniform(0.1, 1, 33)), np.float32(rng.uniform(0.1, 1, 33))
    sp, rp = np.float32(rng.uniform(-20, 0, 33)), np.float32(rng.uniform(-20, 0, 33))
    got = topt.calculate_optical_properties(_t(sa), _t(sp), _t(ra), _t(rp), _t(f), 1e-3)
    ref = jopt.calculate_optical_properties(sa, sp, ra, rp, f, np.float32(1e-3))
    for name, g, r in zip(("n", "alpha", "kappa"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5, err_msg=name)
