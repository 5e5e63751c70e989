"""The port's last two Richardson-Lucy kernels against the JAX package's, on
the CPU: the general 2-D one (``ops/rl2d.py``, port of
``pallas_rl.py:richardson_lucy_pallas``) and the grouped separable one
(``ops/rlsep.py:rl_bands_separable_grouped``, port of
``pallas_rl.py:rl_bands_separable_grouped``). The JAX kernels run in
interpret mode, as the JAX package's own tests run them.

Every PSF below is asymmetric, so a correlation taken in the wrong direction
(a convolution) shows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thz_image_explorer_tpu.ops import deconvolution as jdec
from thz_image_explorer_tpu.ops import pallas_rl as jrl
from thz_image_explorer_tpu_torch import kernels
from thz_image_explorer_tpu_torch.ops import rl2d, rlsep

#: tests/test_pallas_rl.py's tolerance for the 2-D kernel (f32 throughout;
#: the sums run in another order)
RTOL, ATOL = 2e-4, 1e-5


def _gauss2d(kr, kc, r0, c0, sr, sc):
    a = np.arange(kr, dtype=np.float64)[:, None] - kr // 2
    b = np.arange(kc, dtype=np.float64)[None, :] - kc // 2
    k = np.exp(-((a - r0) ** 2) / (2 * sr * sr) - ((b - c0) ** 2) / (2 * sc * sc))
    return (k / k.sum()).astype(np.float32)


def _case(name):
    """(padded, psf, n_iter): tests/test_pallas_rl.py's 40x36 image with a
    random 7x5 PSF, an off-centre 9x9 Gaussian, and an even 6x4 PSF."""
    if name == "pallas_rl_test":
        rng = np.random.default_rng(0)
        return (rng.uniform(0.1, 1.0, (40, 36)).astype(np.float32),
                rng.uniform(0.0, 1.0, (7, 5)).astype(np.float32), 4)
    rng = np.random.default_rng(5)
    if name == "asymmetric_9x9":
        return (rng.uniform(0.2, 1.5, (33, 47)).astype(np.float32),
                _gauss2d(9, 9, 1.3, -0.8, 1.5, 2.2), 6)
    return (rng.uniform(0.2, 1.5, (21, 26)).astype(np.float32),
            _gauss2d(6, 4, 0.4, -0.3, 1.2, 1.0), 5)


def _jax_pallas(padded, psf, n_iter):
    return np.asarray(jrl.richardson_lucy_pallas(
        jnp.asarray(padded), jnp.asarray(psf), jnp.asarray(psf[::-1, ::-1]),
        jnp.asarray(n_iter, jnp.int32), h2=padded.shape[0], w2=padded.shape[1],
        kr=psf.shape[0], kc=psf.shape[1], interpret=True))


@pytest.mark.parametrize("case", ["pallas_rl_test", "asymmetric_9x9", "even_6x4"])
def test_rl2d_plain_matches_jax_pallas(case):
    padded, psf, n_iter = _case(case)
    got = rl2d.richardson_lucy_direct(torch.from_numpy(padded), torch.from_numpy(psf), n_iter)
    plain = rl2d.richardson_lucy_direct_plain(torch.from_numpy(padded),
                                              torch.from_numpy(psf), n_iter)
    assert torch.equal(got, plain)  # the CPU wrapper is the plain version
    np.testing.assert_allclose(got.numpy(), _jax_pallas(padded, psf, n_iter),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["pallas_rl_test", "asymmetric_9x9"])
def test_rl2d_matches_jax_same_correlation(case):
    """For odd PSF dims the Pallas padding is XLA's "SAME" correlation."""
    padded, psf, n_iter = _case(case)
    k, kf = jnp.asarray(psf), jnp.asarray(psf[::-1, ::-1].copy())
    ref = np.asarray(jdec._richardson_lucy(
        jnp.asarray(padded), jnp.asarray(n_iter, jnp.int32),
        lambda a: jdec._correlate_same(a, k), lambda a: jdec._correlate_same(a, kf)))
    got = rl2d.richardson_lucy_direct(torch.from_numpy(padded), torch.from_numpy(psf), n_iter)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_rl2d_even_psf_is_not_same():
    """For an even PSF the window sits one sample below "SAME": the result
    differs from XLA's, as the Pallas kernel's does."""
    padded, psf, n_iter = _case("even_6x4")
    k, kf = jnp.asarray(psf), jnp.asarray(psf[::-1, ::-1].copy())
    same = np.asarray(jdec._richardson_lucy(
        jnp.asarray(padded), jnp.asarray(n_iter, jnp.int32),
        lambda a: jdec._correlate_same(a, k), lambda a: jdec._correlate_same(a, kf)))
    got = rl2d.richardson_lucy_direct(torch.from_numpy(padded), torch.from_numpy(psf), n_iter)
    assert np.abs(got.numpy() - same).max() > 1e-3


def test_rl2d_zero_iterations_is_identity():
    padded, psf, _ = _case("pallas_rl_test")
    got = rl2d.richardson_lucy_direct(torch.from_numpy(padded), torch.from_numpy(psf), 0)
    np.testing.assert_array_equal(got.numpy(), padded)
    np.testing.assert_array_equal(_jax_pallas(padded, psf, 0), padded)


def test_rl2d_outer_product_equals_the_separable_band():
    """A separable PSF px (x) py through the 2-D recurrence equals the
    separable recurrence of tests/test_torch_deconv.py's asymmetric case
    (a zero margin around each band's region; band 1 pre-flipped)."""
    rng = np.random.default_rng(13)
    padded = np.zeros((2, 31, 45), np.float32)
    padded[0, 2:29, 3:42] = rng.uniform(0.2, 1.5, (27, 39))
    padded[1, 4:27, 1:44] = rng.uniform(0.2, 1.5, (23, 43))
    x = np.arange(-4, 5, dtype=np.float32)
    px = np.stack([np.exp(-(x - 1.3) ** 2 / 3), np.exp(-(x + 0.7) ** 2 / 5)]).astype(np.float32)
    y = np.arange(-6, 7, dtype=np.float32)
    py = np.stack([np.exp(-(y - 0.9) ** 2 / 2), np.exp(-(y + 2.1) ** 2 / 8)[::-1]]).astype(
        np.float32)
    n_iter = np.array([5, 9])
    sep = rlsep.rl_bands_separable_plain(*(torch.from_numpy(a) for a in (padded, px, py)),
                                         n_iter)
    for b in range(2):
        psf = torch.from_numpy(np.outer(px[b], py[b]).astype(np.float32))
        got = rl2d.richardson_lucy_direct(torch.from_numpy(padded[b]), psf, int(n_iter[b]))
        # the same function, sums in another order: 1e-5 of the image's max
        np.testing.assert_allclose(got.numpy(), sep[b].numpy(), rtol=0,
                                   atol=1e-5 * float(sep[b].abs().max()))


def test_rl2d_refuses_bad_input():
    padded, psf, n_iter = (torch.from_numpy(np.asarray(a)) if i < 2 else a
                           for i, a in enumerate(_case("pallas_rl_test")))
    with pytest.raises(ValueError, match="padded"):
        rl2d.richardson_lucy_direct(padded.double(), psf, n_iter)
    with pytest.raises(ValueError, match="psf"):
        rl2d.richardson_lucy_direct(padded, psf[0], n_iter)
    with pytest.raises(ValueError, match="n_iter"):
        rl2d.richardson_lucy_direct(padded, psf, -1)
    with pytest.raises(ValueError, match="contiguous"):
        rl2d.richardson_lucy_direct(padded.T, psf, n_iter)


# ------------------------------------------------------ grouped separable RL
def _grouped_case(b, seed):
    """B bands with their own asymmetric profiles (3 and 5 taps) and ragged
    trip counts, 0 included."""
    rng = np.random.default_rng(seed)
    padded = rng.uniform(0.5, 2.0, (b, 16, 40)).astype(np.float32)
    px = rng.uniform(0.1, 0.4, (b, 3)).astype(np.float32)
    py = rng.uniform(0.1, 0.4, (b, 5)).astype(np.float32)
    n_iter = rng.integers(0, 7, b).astype(np.int32)
    n_iter[b // 2] = 0
    return padded, px, py, n_iter


@pytest.mark.parametrize("b,group", [(4, 2), (6, 2), (6, 3), (4, 1)])
def test_grouped_matches_jax_grouped(b, group):
    padded, px, py, n_iter = _grouped_case(b, seed=7 + b + group)
    rs = np.stack([jdec._banded_matrix(v, padded.shape[1]) for v in px])
    cs = np.stack([jdec._banded_matrix(v, padded.shape[2]) for v in py])
    ref = np.asarray(jrl.rl_bands_separable_grouped(
        jnp.asarray(padded), jnp.asarray(rs), jnp.asarray(cs), jnp.asarray(n_iter),
        group=group, interpret=True))
    t = [torch.from_numpy(a) for a in (padded, px, py)]
    got = rlsep.rl_bands_separable_grouped(*t, n_iter, group=group)
    assert torch.equal(got, rlsep.rl_bands_separable(*t, n_iter))  # the same function
    # the JAX kernel's operands are split into bf16 pairs (the tolerance of
    # tests/test_pallas_rl.py's separable test)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=1e-4)
    np.testing.assert_array_equal(got[n_iter == 0].numpy(), padded[n_iter == 0])


def test_grouped_refuses_a_ragged_group():
    padded, px, py, n_iter = _grouped_case(6, seed=1)
    t = [torch.from_numpy(a) for a in (padded, px, py)]
    for group in (4, 0):
        with pytest.raises(ValueError, match="multiple of group"):
            rlsep.rl_bands_separable_grouped(*t, n_iter, group=group)


# ------------------------------------------------------------ the CUDA path
def test_cuda_path_raises_without_a_card_or_toolchain(monkeypatch, tmp_path):
    """The wrappers never fall back to the plain version: a tensor on any
    device but the CPU goes to a kernel or raises, and a kernel that cannot
    be built raises."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_loaded", {})
    for name in ("rl2d", "rlsep", "envelope"):
        assert name in kernels.SOURCES
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernels.load(name)
    padded, psf, _ = _case("pallas_rl_test")
    with pytest.raises(ValueError, match="no Richardson-Lucy kernel"):
        rl2d.richardson_lucy_direct(torch.from_numpy(padded).to("meta"),
                                    torch.from_numpy(psf).to("meta"), 2)
    p, px, py, n_iter = (torch.from_numpy(a).to("meta") if i < 3 else a
                         for i, a in enumerate(_grouped_case(4, seed=2)))
    with pytest.raises(ValueError, match="no Richardson-Lucy kernel"):
        rlsep.rl_bands_separable_grouped(p, px, py, n_iter, group=2)
