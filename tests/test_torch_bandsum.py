"""The deconvolution's band sum (ops/bandsum.py) on the CPU.

``csrc/bandsum.cu`` runs only on the card (``chip_smoke.py`` holds it against
the plain version there). Checked here: the plain version, which the CPU
takes, is the deconvolution's band sum before the kernel bit for bit (the
gains, the two f32 matmuls, the products, the inverse transform and the
centre window, copied below as they stood); the wrapper refuses what the
kernel would not take, takes the plain route on a CPU tensor without a
launch, and raises on other devices; the kernel's plan and its
shared-memory mirror; the source is registered. The deconvolution's parity
with the JAX package is in ``tests/test_torch_deconv.py``.
"""

import numpy as np
import pytest
import torch

from thz_image_explorer_tpu_torch import kernels
from thz_image_explorer_tpu_torch.ops import bandsum as bs
from thz_image_explorer_tpu_torch.ops import deconvolution as dec


def _band_sum_before(spec, u, energy, taps_spec, bd, shape, origin):
    """The deconvolution's phase c as it stood before the kernel: the crop,
    the gains and ``_spectral_band_sum`` with the taps as two f32 arrays.
    Returns (the weighted spectrum, the band-summed cube)."""
    x, y, n_time = shape
    imgs = energy.T.reshape(-1, x, y)
    pr, pc = bd["pad_r_max"] + origin[0], bd["pad_c_max"] + origin[1]
    u = u[:, pr: pr + x, pc: pc + y]
    gains = torch.sqrt(torch.clamp(u, min=0.0) / imgs)
    g = gains.reshape(gains.shape[0], -1)
    wr = g.T @ torch.as_tensor(taps_spec.real.astype(np.float32))
    wi = g.T @ torch.as_tensor(taps_spec.imag.astype(np.float32))
    sr = spec.real * wr - spec.imag * wi
    si = spec.real * wi + spec.imag * wr
    weighted = torch.complex(sr, si)
    out = torch.fft.irfft(weighted, n=bd["fft_len"])
    return weighted, out[:, bd["shift"]: bd["shift"] + n_time].reshape(x, y, n_time)


def _case(n_time, bands, grid, block, origin, seed):
    """Phase c's inputs for a block of ``block`` pixels at ``origin`` of a
    ``grid``: spectra at the deconvolution's transform length, estimates on
    the grid's padded canvas with negative values, band energies, and one
    pixel whose energy and estimate are both 0 in band 0 (0/0)."""
    rng = np.random.default_rng(seed)
    fft_len = dec._conv_len(n_time + 200)
    m = fft_len // 2 + 1
    pad_r, pad_c = 3, 4
    n = block[0] * block[1]
    spec = torch.as_tensor((rng.standard_normal((n, m))
                            + 1j * rng.standard_normal((n, m))).astype(np.complex64))
    u = torch.as_tensor(rng.standard_normal(
        (bands, grid[0] + 2 * pad_r, grid[1] + 2 * pad_c)).astype(np.float32))
    energy = torch.as_tensor(rng.uniform(0.0, 2.0, (n, bands)).astype(np.float32))
    energy[1, 0] = 0.0
    u[0, pad_r + origin[0], pad_c + origin[1] + 1] = 0.0
    taps_spec = np.fft.rfft(rng.standard_normal((bands, 201)), n=fft_len, axis=-1)
    bd = dict(fft_len=fft_len, shift=100, pad_r_max=pad_r, pad_c_max=pad_c,
              taps=torch.as_tensor(taps_spec.astype(np.complex64)))
    return spec, u, energy, taps_spec, bd, (*block, n_time)


@pytest.mark.parametrize("n_time,bands,grid,block,origin", [
    (1024, 25, (12, 10), (12, 10), (0, 0)),   # m = 769, the reference Apply's bands
    (1024, 7, (12, 10), (12, 10), (0, 0)),
    (1024, 1, (9, 7), (9, 7), (0, 0)),
    (1536, 25, (12, 10), (12, 10), (0, 0)),   # m = 1025 (a tilted T)
    (1536, 7, (16, 14), (8, 7), (8, 7)),      # a mesh rank's block at its origin
    (1023, 25, (16, 14), (8, 14), (8, 0)),    # an odd T, a block of whole rows
])
def test_plain_band_sum_equals_the_deconvolution_before_bit_for_bit(n_time, bands, grid, block,
                                                                     origin):
    spec, u, energy, taps_spec, bd, shape = _case(n_time, bands, grid, block, origin,
                                                  seed=n_time + bands)
    want_weighted, want = _band_sum_before(spec.clone(), u, energy, taps_spec, bd, shape,
                                           origin)
    offset = (bd["pad_r_max"] + origin[0], bd["pad_c_max"] + origin[1])
    got_weighted = bs.weighted_spectrum(spec.clone(), u, energy, bd["taps"], offset, shape[1])
    got = dec._band_sum(spec.clone(), u, energy, bd, shape, origin)
    assert np.isnan(want_weighted.numpy()).any() and np.isnan(want.numpy()).any()
    np.testing.assert_array_equal(got_weighted.numpy(), want_weighted.numpy())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_nan_in_u_stays_nan():
    spec, u, energy, taps_spec, bd, shape = _case(1024, 7, (9, 7), (9, 7), (0, 0), seed=3)
    u[2, bd["pad_r_max"] + 4, bd["pad_c_max"] + 5] = float("nan")
    out = bs.weighted_spectrum(spec, u, energy, bd["taps"], (bd["pad_r_max"], bd["pad_c_max"]),
                               shape[1])
    assert torch.isnan(out[4 * 7 + 5]).all()


def test_weighted_spectrum_writes_over_spec():
    spec, u, energy, _taps, bd, shape = _case(1024, 7, (9, 7), (9, 7), (0, 0), seed=4)
    before = spec.clone()
    out = bs.weighted_spectrum(spec, u, energy, bd["taps"], (bd["pad_r_max"], bd["pad_c_max"]),
                               shape[1])
    assert out is spec and not torch.equal(torch.nan_to_num(spec), torch.nan_to_num(before))


def _refusal_cases():
    spec, u, energy, _taps, bd, shape = _case(1024, 7, (9, 7), (9, 7), (0, 0), seed=5)
    args = dict(spec=spec, u=u, energy=energy, taps=bd["taps"], offset=(3, 4), cols=7)
    n, m = spec.shape
    return args, {
        "spec float32": dict(spec=spec.real.contiguous()),
        "spec complex128": dict(spec=spec.to(torch.complex128)),
        "spec of even m": dict(spec=spec[:, :-1].contiguous(), taps=bd["taps"][:, :-1].contiguous()),
        "spec not contiguous": dict(spec=torch.zeros(m, n, dtype=torch.complex64).T),
        "u float64": dict(u=u.double()),
        "u of two dims": dict(u=u[0]),
        "u not contiguous": dict(u=u[:, 1:, :]),
        "energy float64": dict(energy=energy.double()),
        "energy of other bands": dict(energy=energy[:, :-1].contiguous()),
        "energy band-major": dict(energy=energy.T.contiguous().T),
        "taps complex128": dict(taps=bd["taps"].to(torch.complex128)),
        "taps of other bins": dict(taps=bd["taps"][:, :-2].contiguous()),
        "taps not contiguous": dict(taps=torch.zeros(m, 7, dtype=torch.complex64).T),
        "pixels not whole rows": dict(cols=8),
        "block off the canvas": dict(offset=(7, 4)),
        "negative offset": dict(offset=(-1, 4)),
        "u on another device": dict(u=u.to("meta")),
    }


@pytest.mark.parametrize("bad", sorted(_refusal_cases()[1]))
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    args, cases = _refusal_cases()
    args.update(cases[bad])
    with pytest.raises(ValueError):
        bs.weighted_spectrum(**args)
    with pytest.raises(ValueError):
        bs.weighted_spectrum_plain(**args)


def test_cpu_takes_the_plain_route_without_a_launch():
    spec, u, energy, _taps, bd, shape = _case(1024, 25, (12, 10), (12, 10), (0, 0), seed=6)
    offset = (bd["pad_r_max"], bd["pad_c_max"])
    want = bs.weighted_spectrum_plain(spec.clone(), u, energy, bd["taps"], offset, shape[1])
    before = bs.weighted_spectrum.launches
    got = bs.weighted_spectrum(spec.clone(), u, energy, bd["taps"], offset, shape[1])
    assert bs.weighted_spectrum.launches == before
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_other_devices_raise():
    spec, u, energy, _taps, bd, shape = _case(1024, 7, (9, 7), (9, 7), (0, 0), seed=7)
    meta = [t.to("meta") for t in (spec, u, energy, bd["taps"])]
    with pytest.raises(ValueError, match="no band-sum kernel"):
        bs.weighted_spectrum(*meta, (3, 4), 7)


def test_source_is_registered():
    assert "bandsum" in kernels.SOURCES
    assert (kernels.CSRC / "bandsum.cu").exists()


@pytest.mark.parametrize("n,m,bands", [
    (40_000, 769, 25), (262_144, 769, 25), (40_000, 1025, 25), (40_000, 1153, 25),
    (20_000, 769, 7), (117, 9, 3), (64, 1, 2), (40_000, 769, 1), (40_000, 769, 64),
    (40_000, 769, 65), (40_000, 1153, 400), (1, 769, 25),
])
def test_plan_fits_two_blocks_an_sm(n, m, bands):
    p = bs.plan(n, m, bands)
    assert p["smem"] == bs.layout_bytes(p["ci"], p["bc"]) <= bs.SMEM_BUDGET
    assert p["ci"] % 32 == 0 and p["ci"] >= 32 and 1 <= p["bc"] <= bands
    assert p["blocks"] == -(-n // bs.BLOCK_ROWS)
    if p["bc"] < bands:  # bands in chunks: one step of taps a chunk
        assert p["ci"] == 32 and bands > 64
    else:  # the fewest chunks of taps that fit
        h = (m - 1) // 2
        assert p["ci"] >= min(h, 32) and (p["ci"] >= 32 * -(-h // 32) or
                                           bs.layout_bytes(p["ci"] + 32, bands) > bs.SMEM_BUDGET)


def test_reference_apply_plan():
    """The 200x200 and 512x512 Applies' plan: four chunks of 96 vector
    indices (h = 384), all 25 bands at once, blocks of 64 pixels."""
    assert bs.plan(40_000, 769, 25) == dict(ci=96, bc=25, blocks=625, smem=110_736)
    assert bs.plan(262_144, 769, 25)["blocks"] == 4096


@pytest.mark.parametrize("n,m,bands", [(0, 769, 25), (100, 768, 25), (100, 769, 0)])
def test_plan_refuses_shapes_the_kernel_does_not_take(n, m, bands):
    with pytest.raises(ValueError):
        bs.plan(n, m, bands)
