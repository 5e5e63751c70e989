"""The port's spectral reduction (ops/specred.py) against the JAX package's
``ops/pallas_specred.py``.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode, with ``THZ_SPECRED_MXU=0`` (exact f32 adds). The port runs
its plain PyTorch version, which is what its wrapper takes for a CPU
tensor; the CUDA kernel itself is held against that plain version on the
card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thz_image_explorer_tpu.ops import fourier as jfourier
from thz_image_explorer_tpu.ops import pallas_specred as jsr
from thz_image_explorer_tpu_torch.ops import fourier as tfourier
from thz_image_explorer_tpu_torch.ops import specred as tsr

# the JAX test's tolerance (tests/test_specred.py): sums of up to 1000
# f32 terms taken in another order
ATOL, RTOL = 5e-4, 1e-5


def _inputs(n, f, m, seed):
    rng = np.random.default_rng(seed)
    c = np.float32(rng.standard_normal((n, f)))
    s = np.float32(rng.standard_normal((n, f)))
    masks = np.float32(rng.uniform(0, 1, (m, n)) > 0.4)
    return c, s, masks


def _jax_sums(c, s, masks, monkeypatch, with_complex=True):
    monkeypatch.setenv("THZ_SPECRED_MXU", "0")
    out = jsr.spectral_reduction_sums(
        jnp.asarray(c), jnp.asarray(s), jnp.asarray(masks), with_complex=with_complex
    )
    return [None if o is None else np.asarray(o) for o in out]


def _port_sums(c, s, masks, with_complex=True):
    spec = torch.complex(torch.from_numpy(c), torch.from_numpy(s))
    out = tsr.spectral_reduction_sums(spec, torch.from_numpy(masks), with_complex)
    return [None if o is None else o.numpy() for o in out]


@pytest.mark.parametrize(
    "n,f,m", [(64, 33, 1), (256, 513, 5), (80, 129, 3), (1000, 513, 3)]
)
def test_sums_match_jax_kernel(n, f, m, monkeypatch):
    c, s, masks = _inputs(n, f, m, n + f)
    ref = _jax_sums(c, s, masks, monkeypatch)
    got = _port_sums(c, s, masks)
    for name, g, r in zip(("amp", "inc", "re", "im"), got, ref):
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL, err_msg=name)


def test_without_complex_leaves_them_out(monkeypatch):
    c, s, masks = _inputs(64, 33, 2, 3)
    got = _port_sums(c, s, masks, with_complex=False)
    ref = _jax_sums(c, s, masks, monkeypatch, with_complex=False)
    assert got[2] is None and got[3] is None and ref[2] is None
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("with_complex", [False, True])
def test_more_than_16_masks_go_in_groups(with_complex, monkeypatch):
    """The wrapper's grouping (one kernel launch per 16 masks), driven on
    the CPU with the plain version standing in for the launch: 20 masks
    become groups of 16 and 4, and the joined sums equal the JAX kernel's
    (which takes at most 16 masks) run on the same two groups."""
    c, s, masks = _inputs(200, 65, 20, 7)
    spec = torch.complex(torch.from_numpy(c), torch.from_numpy(s))
    sizes = []

    def fake_launch(spec_, masks_, wc):
        sizes.append(masks_.shape[0])
        outs = tsr.spectral_reduction_sums_plain(spec_, masks_, wc)
        return torch.stack([o for o in outs if o is not None])

    got = tsr._in_groups(fake_launch, spec, torch.from_numpy(masks), with_complex)
    assert sizes == [16, 4]
    parts = [_jax_sums(c, s, masks[:16], monkeypatch, with_complex),
             _jax_sums(c, s, masks[16:], monkeypatch, with_complex)]
    for k in range(4 if with_complex else 2):
        ref = np.concatenate([parts[0][k], parts[1][k]])
        np.testing.assert_allclose(got[k].numpy(), ref, atol=ATOL, rtol=RTOL)
    if not with_complex:
        assert got[2] is None and got[3] is None


def test_inc_means_finish_to_unwrap_means():
    """Row sums of the increments, divided and cumsummed, equal the mean
    of per-row unwrapped phases (the publish's contract), and both agree
    with the JAX unwrap."""
    rng = np.random.default_rng(0)
    n, f = 64, 65
    c = np.float32(rng.standard_normal((n, f)))
    s = np.float32(rng.standard_normal((n, f)))
    _, inc_sums, _, _ = _port_sums(c, s, np.ones((1, n), np.float32))
    got = tfourier.finish_unwrap(torch.from_numpy(inc_sums[0] / n)).numpy()
    port_mean = tfourier.unwrap(torch.from_numpy(np.arctan2(s, c))).numpy().mean(axis=0)
    jax_mean = np.asarray(jfourier.unwrap(jnp.asarray(np.arctan2(s, c)))).mean(axis=0)
    np.testing.assert_allclose(got, port_mean, atol=1e-4)
    np.testing.assert_allclose(got, jax_mean, atol=1e-4)


@pytest.mark.parametrize("with_complex", [False, True])
def test_lean_spectral_outputs_match_jax(with_complex, monkeypatch):
    """The publish's means: FD weights factored out, empty ROI -> zeros."""
    monkeypatch.setenv("THZ_SPECRED_MXU", "0")
    rng = np.random.default_rng(5)
    x, y, nf = 10, 8, 33
    spec = (rng.standard_normal((x, y, nf)) + 1j * rng.standard_normal((x, y, nf))).astype(np.complex64)
    wvec = np.float32(rng.uniform(0, 1, nf))
    masks = np.zeros((3, x, y), np.float32)
    masks[0, 2:6, 2:6] = 1
    masks[1, 1:9, 1:7] = 1  # mask 2 stays empty
    ref = jsr.lean_spectral_outputs(
        jnp.asarray(spec), jnp.asarray(wvec), jnp.asarray(masks),
        jnp.asarray([x, y], jnp.int32), with_complex=with_complex,
    )
    got = tsr.lean_spectral_outputs(
        torch.from_numpy(spec), torch.from_numpy(wvec), torch.from_numpy(masks),
        (x, y), with_complex=with_complex,
    )
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=5e-5, rtol=1e-4, err_msg=key)
    assert not got["roi_amp"][2].any() and not got["roi_ph"][2].any()


def test_wrapper_refuses_bad_input():
    spec = torch.zeros((8, 5), dtype=torch.complex64)
    with pytest.raises(ValueError, match="complex64"):
        tsr.spectral_reduction_sums(spec.real.contiguous(), torch.ones(1, 8))
    with pytest.raises(ValueError, match="do not fit"):
        tsr.spectral_reduction_sums(spec, torch.ones(1, 9))
    with pytest.raises(ValueError, match="do not fit"):
        tsr.spectral_reduction_sums(spec, torch.ones(0, 8))
    with pytest.raises(ValueError, match="float32"):
        tsr.spectral_reduction_sums(spec, torch.ones(1, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tsr.spectral_reduction_sums(spec, torch.ones(8, 2).t())


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(monkeypatch):
    """On a CPU tensor the wrapper runs the plain version: the kernel's
    launch counter stays put and no library is built or loaded."""
    def no_build(*a, **k):
        raise AssertionError("the CPU path must not touch the CUDA library")

    monkeypatch.setattr(tsr.kernels, "load", no_build)
    before = tsr.spectral_reduction_sums.launches
    c, s, masks = _inputs(32, 17, 2, 1)
    got = _port_sums(c, s, masks)
    plain = tsr.spectral_reduction_sums_plain(
        torch.complex(torch.from_numpy(c), torch.from_numpy(s)), torch.from_numpy(masks)
    )
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())
    assert tsr.spectral_reduction_sums.launches == before
