"""The port's PSF model and FIR helpers against the JAX package, on the CPU.

``models/psf.create_psf_2d`` (the dense 2-D PSF from two axis profiles) and
``ops/firdesign.frequency_response`` are host numpy in both packages, the
same arithmetic: held bit for bit. ``ops/firapply.fir_block_matrix`` is host
numpy too (bit for bit); ``window_input`` pads and slides in torch against
JAX's ``jnp`` (bit for bit: it copies values, computes none), and the
banded product of the two gives the port's spectral correlation within
1e-5 of the traces' scale (float32 products against float64 spectra).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thz_image_explorer_tpu.models import psf as jpsf
from thz_image_explorer_tpu.ops import firapply as jfir
from thz_image_explorer_tpu.ops import firdesign as jfd
from thz_image_explorer_tpu_torch.models import psf as tpsf
from thz_image_explorer_tpu_torch.ops import firapply as tfir
from thz_image_explorer_tpu_torch.ops import firdesign as tfd


def _profiles(seed, n_x, n_y, dx):
    """Gaussian axis profiles with seeded centres, widths and noise on
    symmetric axes of ``dx`` mm steps."""
    rng = np.random.default_rng(seed)
    x = (np.arange(n_x, dtype=np.float32) - n_x // 2) * np.float32(dx)
    y = (np.arange(n_y, dtype=np.float32) - n_y // 2) * np.float32(dx)
    x0, y0 = rng.uniform(-0.5, 0.5, 2)
    wx, wy = rng.uniform(0.6, 2.5, 2)
    px = tpsf.gaussian(x, x0, wx) + rng.uniform(0, 1e-3, n_x).astype(np.float32)
    py = tpsf.gaussian(y, y0, wy) + rng.uniform(0, 1e-3, n_y).astype(np.float32)
    return px, py, x, y


@pytest.mark.parametrize("seed,n_x,n_y,dx", [(0, 19, 25, 0.5), (1, 31, 21, 0.25),
                                             (2, 41, 41, 1.0), (3, 9, 13, 0.75)])
def test_create_psf_2d_equals_jax(seed, n_x, n_y, dx):
    """Bit for bit, and the outer product of the axis profiles."""
    px, py, x, y = _profiles(seed, n_x, n_y, dx)
    got = tpsf.create_psf_2d(px, py, x, y, dx, dx)
    want = jpsf.create_psf_2d(px, py, x, y, dx, dx)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    ax, ay = tpsf.create_psf_axes(px, py, x, y, dx, dx)
    np.testing.assert_array_equal(got, np.outer(ax, ay).astype(np.float32))
    assert got.max() == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("n_filters,ntaps", [(5, 99), (20, 499)])
def test_frequency_response_equals_jax(n_filters, ntaps):
    """Every band of a filter bank's magnitude response, bit for bit."""
    t = np.arange(1001) * 0.05
    bank, _ = tfd.create_filter_bank(n_filters, 0.25, 4.0, 0.1, t, ntaps=ntaps)
    for taps in bank:
        got = tfd.frequency_response(taps, 257, 20.0)
        want = jfd.frequency_response(taps, 257, 20.0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ntaps,block,n_time", [(31, 256, 700), (8, 64, 64), (499, 256, 1001)])
def test_fir_block_form_equals_jax(ntaps, block, n_time):
    """The block matrix and the input windows bit for bit; their product
    is the correlation of ``fir_correlate_bands`` within 1e-5 of the
    traces' scale."""
    rng = np.random.default_rng(ntaps)
    taps = rng.standard_normal(ntaps)
    traces = rng.standard_normal((3, n_time)).astype(np.float32)
    shift = ntaps - 1 - ntaps // 2
    g = tfir.fir_block_matrix(taps[::-1].copy(), block)
    np.testing.assert_array_equal(g, jfir.fir_block_matrix(taps[::-1].copy(), block))
    xw = tfir.window_input(torch.as_tensor(traces), ntaps, shift, block)
    np.testing.assert_array_equal(
        xw.numpy(), np.asarray(jfir.window_input(jnp.asarray(traces), ntaps, shift, block)))
    out = (xw.double() @ torch.as_tensor(g).double()).reshape(3, -1)[:, :n_time].numpy()
    want = tfir.fir_correlate_bands(traces.astype(np.float64), taps[None], "cpu")[0]
    np.testing.assert_allclose(out, want, atol=1e-5 * np.abs(want).max())
