"""The FFT stage's amplitudes and unwrapped phases (``ops/polar.py``) on the CPU.

``csrc/polar.cu`` runs only on the card (``chip_smoke.py``'s ``polar_kernel``
phase holds it against the plain route there at the benchmark's shapes; the
``cuda`` cases below do the same at small sizes). Checked here: the plain
route, which the CPU takes, is the FFT stage's code as it stood before the
kernel bit for bit (copied below), over row lengths, a single row, no rows
and a NaN bin; ``forward_fft`` returns the same cube as before; the wrapper
refuses what the kernel would not take, takes the plain route on a CPU
tensor without a launch, and raises on other devices; the FFT stage calls it
once a run and a click not at all; the kernel's summation order (emulated in
numpy) stays within the bound the module states of the plain cumsum, and
PyTorch's own scan on the card takes that order at every slider step's
shape; the source is registered; the benchmark's roofline share
(``portbench/metrics/polar_roofline.slider.py``) counts each byte once and
reads the kernel alone.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import torch_cuda_scan_chunk
from thz_image_explorer_tpu_torch import kernels
from thz_image_explorer_tpu_torch.data import make_cube
from thz_image_explorer_tpu_torch.io.dotthz import DotthzMetadata
from thz_image_explorer_tpu_torch.ops import fourier, polar
from thz_image_explorer_tpu_torch.ops.windows import WindowType, window_array
from thz_image_explorer_tpu_torch.pipeline import Explorer

PI_F32 = float(np.float32(np.pi))
TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def _abs_angle_before(spec):
    """``ops/fourier._abs_angle`` as it stood before the kernel."""
    if spec.device.type != "cpu":
        return torch.abs(spec), torch.angle(spec)
    real, imag = spec.real, spec.imag
    return torch.hypot(real, imag), torch.atan2(imag, real)


def _increments_before(phase):
    """``ops/fourier.phase_increments`` along the last axis as it stood
    before the kernel."""
    d = phase[..., 1:] - phase[..., :-1]
    d_adj = d - TWO_PI_F32 * (d > PI_F32).to(d.dtype) + TWO_PI_F32 * (d < -PI_F32).to(d.dtype)
    return torch.cat([phase[..., :1], d_adj], dim=-1)


def _stage_before(spec):
    """The FFT stage's amplitudes and phases before the kernel: the absolute
    value and angle, the wrapped steps and ``torch.cumsum``."""
    amplitudes, angles = _abs_angle_before(spec)
    return amplitudes, torch.cumsum(_increments_before(angles), dim=-1)


def _spectrum(shape, seed, nan=False):
    """A complex64 spectrum with the angle's edge cases in its first row:
    zeros of both signs, the negative real axis from both sides (angles of
    +pi and -pi: steps of exactly 2 pi) and, with ``nan``, a NaN bin."""
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    flat = z.reshape(-1, shape[-1]) if z.size else z.reshape(0, shape[-1])
    if flat.shape[0] and shape[-1] >= 8:
        flat[0, 1:8] = np.array([0, complex(-0.0, -0.0), complex(-1.0, 0.0), complex(-1.0, -0.0),
                                 complex(-1.0, 0.0), complex(0.0, -0.0), complex(-2.0, -0.0)],
                                dtype=np.complex64)
        if nan:
            flat[-1, shape[-1] // 2] = complex(np.nan, 1.0)
    return torch.from_numpy(flat.reshape(shape).copy())


def _same_bits(a, b):
    """Equal shapes, NaN at the same places, every other element equal bit
    for bit (the sign of a zero included)."""
    assert a.shape == b.shape and a.dtype == b.dtype
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


SHAPES = {
    "F513": ((3, 4, 513), False),
    "F811": ((2, 3, 811), False),
    "F825": ((5, 825), False),
    "odd F": ((7, 37), False),
    "one row": ((1, 513), False),
    "no rows": ((0, 513), False),
    "NaN bin": ((3, 129), True),
}


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plain_route_equals_the_stage_before_bit_for_bit(case):
    shape, nan = SHAPES[case]
    spec = _spectrum(shape, seed=len(case), nan=nan)
    want_amp, want_ph = _stage_before(spec)
    inc = torch.empty(shape, dtype=torch.float32)
    amp, ph = polar.amplitude_phase_plain(spec, increments=inc)
    _same_bits(amp, want_amp)
    _same_bits(ph, want_ph)
    _same_bits(inc, _increments_before(_abs_angle_before(spec)[1]))
    before = polar.amplitude_phase.launches
    amp2, ph2 = polar.amplitude_phase(spec)
    assert polar.amplitude_phase.launches == before
    _same_bits(amp2, want_amp)
    _same_bits(ph2, want_ph)


def _forward_fft_before(cube, window_type, low, high):
    """``ops/fourier.forward_fft`` as it stood before the kernel."""
    w = window_array(cube.time, window_type, low, high)
    data = cube.data * w
    spec = fourier.batch_fft(torch.fft.rfft, data, cube)
    amplitudes, phases = _stage_before(spec)
    return cube.replace(data=data, fft=spec, amplitudes=amplitudes, phases=phases)


@pytest.mark.parametrize("n_time", [64, 63, 1024])
@pytest.mark.parametrize("window", [WindowType.ADAPTED_BLACKMAN, WindowType.HANNING])
def test_forward_fft_returns_the_cube_it_did(n_time, window):
    rng = np.random.default_rng(n_time)
    t = (np.arange(n_time) * np.float32(0.05)).astype(np.float32)
    cube = make_cube(t, rng.normal(size=(6, 5, n_time)).astype(np.float32), device="cpu")
    want = _forward_fft_before(cube, window, 1.0, 2.0)
    got = fourier.forward_fft(cube, window, 1.0, 2.0)
    for name in ("data", "fft", "amplitudes", "phases"):
        a, b = getattr(got, name), getattr(want, name)
        assert torch.equal(a, b), name


def _refusal_cases():
    spec = _spectrum((4, 3, 33), seed=5)
    return spec, {
        "spec complex128": dict(spec=spec.to(torch.complex128)),
        "spec real": dict(spec=spec.real.contiguous()),
        "spec not contiguous": dict(spec=spec.transpose(0, 1)),
        "spec of no dimension": dict(spec=spec[0, 0, 0]),
        "increments float64": dict(increments=torch.zeros((4, 3, 33), dtype=torch.float64)),
        "increments of another shape": dict(increments=torch.zeros((4, 33))),
        "increments not contiguous": dict(increments=torch.zeros((3, 4, 33)).transpose(0, 1)),
        "increments on another device": dict(increments=torch.zeros((4, 3, 33), device="meta")),
    }


@pytest.mark.parametrize("bad", sorted(_refusal_cases()[1]))
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    spec, cases = _refusal_cases()
    args = dict(spec=spec, increments=None)
    args.update(cases[bad])
    before = polar.amplitude_phase.launches
    with pytest.raises(ValueError):
        polar.amplitude_phase(**args)
    with pytest.raises(ValueError):
        polar.amplitude_phase_plain(**args)
    assert polar.amplitude_phase.launches == before


def test_other_devices_raise():
    spec, _ = _refusal_cases()
    with pytest.raises(ValueError, match="no polar kernel"):
        polar.amplitude_phase(spec.to("meta"))


def test_source_is_registered():
    assert "polar" in kernels.SOURCES
    assert (kernels.CSRC / "polar.cu").exists()


def _explorer(device):
    rng = np.random.default_rng(3)
    t = (np.arange(128) * np.float32(0.05)).astype(np.float32)
    ex = Explorer(device=device)
    ex.open_arrays(t, rng.normal(size=(12, 10, 128)).astype(np.float32),
                   DotthzMetadata(md={"dx [mm]": "0.5", "dy [mm]": "0.5"}))
    return ex


def test_one_call_an_fft_stage_run_none_a_click(monkeypatch):
    ex = _explorer("cpu")
    calls = []
    real = polar.amplitude_phase

    def counted(spec, increments=None):
        calls.append(tuple(spec.shape))
        return real(spec, increments)

    monkeypatch.setattr(fourier, "amplitude_phase", counted)
    for low in (1.0, 1.1, 1.2):
        ex.set_fft_window_low(low)
    assert calls == [(12, 10, 65)] * 3
    ex.set_selected_pixel(3, 4)
    ex.set_selected_pixel(7, 2)
    assert len(calls) == 3


def _chunked_cumsum(inc, chunk):
    """An inclusive sum along the last axis in chunks of ``chunk`` bins, each
    scanned by the Sklansky tree after the previous chunks' total is added
    to its first bin, all in f32: ``csrc/polar.cu``'s order at 32, and
    PyTorch's CUDA ``cumsum`` of rows (``tensor_kernel_scan_innermost_dim``)
    at its chunk (``chip_smoke.torch_cuda_scan_chunk``)."""
    rows, f = inc.shape
    out = np.empty_like(inc)
    carry = np.zeros(rows, np.float32)
    lanes = np.arange(chunk)
    for c0 in range(0, f, chunk):
        n = min(chunk, f - c0)
        v = np.zeros((rows, chunk), np.float32)
        v[:, :n] = inc[:, c0: c0 + n]
        v[:, 0] = v[:, 0] + carry
        s = 1
        while s < chunk:
            hit = (lanes & s) != 0
            v[:, hit] = v[:, hit] + v[:, ((lanes & ~(2 * s - 1)) + s - 1)[hit]]
            s *= 2
        out[:, c0: c0 + n] = v[:, :n]
        carry = v[:, -1]
    return out


def _bound(inc):
    """2 k 2^-24 sum_{j <= k} |inc_j| at each bin k."""
    k = np.arange(inc.shape[-1])
    return 2.0 * k * 2.0**-24 * np.cumsum(np.abs(inc.astype(np.float64)), axis=-1)


@pytest.mark.parametrize("f", [513, 825, 6501])
def test_kernel_order_stays_within_the_stated_bound(f):
    spec = _spectrum((24, f), seed=f)
    inc = _increments_before(_abs_angle_before(spec)[1]).numpy()
    plain = torch.cumsum(torch.from_numpy(inc), dim=-1).numpy()
    kernel = _chunked_cumsum(inc, 32)
    assert (np.abs(kernel.astype(np.float64) - plain) <= _bound(inc)).all()
    # against PyTorch's card order at a chunk of 1024 (few rows): the first
    # chunk of 32 bins is the same tree, bit for bit
    other = _chunked_cumsum(inc, 1024)
    np.testing.assert_array_equal(kernel[:, :32], other[:, :32])
    assert (np.abs(kernel.astype(np.float64) - other) <= _bound(inc)).all()


@pytest.mark.parametrize("rows, f", [(512 * 512, 513), (512 * 512, 811), (512 * 512, 825),
                                     (200 * 200, 513), (200 * 200, 745), (200 * 200, 804),
                                     (100 * 200, 513), (100 * 100, 513), (256 * 512, 513),
                                     (128 * 512, 825), (200 * 200, 512)])
def test_pytorch_scans_every_slider_steps_shape_in_the_kernels_chunks(rows, f):
    assert torch_cuda_scan_chunk(rows, f) == 32


def test_the_chunk_rule_elsewhere():
    assert torch_cuda_scan_chunk(1, 513) == 0
    assert torch_cuda_scan_chunk(2, 513) == 1024
    assert torch_cuda_scan_chunk(192, 6501) == 256
    assert torch_cuda_scan_chunk(512, 513) == 64  # R's power of two below F's
    assert torch_cuda_scan_chunk(513, 513) == 32
    assert torch_cuda_scan_chunk(2**19, 513) == 32
    # more than 512 times F's power of two: the uint32 wrap of ATen's rule
    assert torch_cuda_scan_chunk(2**20, 513) == 1024
    assert torch_cuda_scan_chunk(512 * 512, 16) == 1024


# ------------------------------------------------------------------ the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: csrc/polar.cu runs only there")


CARD_SHAPES = [((64, 48, 513), False), ((40, 40, 825), False), ((3, 6501), False),
               ((1, 513), False), ((200, 37), False), ((16, 129), True), ((70, 70, 811), False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, nan", CARD_SHAPES, ids=lambda v: str(v))
def test_kernel_against_the_plain_route_on_the_card(shape, nan):
    _card()
    spec = _spectrum(shape, seed=shape[-1], nan=nan).cuda()
    inc = torch.empty(shape, dtype=torch.float32, device="cuda")
    want_inc = torch.empty_like(inc)
    before = polar.amplitude_phase.launches
    amp, ph = polar.amplitude_phase(spec, increments=inc)
    assert polar.amplitude_phase.launches == before + 1
    want_amp, want_ph = polar.amplitude_phase_plain(spec, increments=want_inc)
    _same_bits(amp.cpu(), want_amp.cpu())
    _same_bits(inc.cpu(), want_inc.cpu())
    f = shape[-1]
    rows = spec.numel() // f
    inc_np = inc.cpu().numpy().reshape(rows, f)
    # the kernel's sum is its stated order over its own steps, bit for bit
    _same_bits(ph.cpu().reshape(rows, f), torch.from_numpy(_chunked_cumsum(inc_np, 32)))
    if torch_cuda_scan_chunk(rows, f) == 32:
        _same_bits(ph.cpu(), want_ph.cpu())
    ok = ~np.isnan(inc_np).cumsum(axis=-1).astype(bool)
    gap = np.abs(ph.cpu().numpy().reshape(rows, f).astype(np.float64)
                 - want_ph.cpu().numpy().reshape(rows, f))
    assert (gap[ok] <= _bound(inc_np)[ok]).all()
    again = polar.amplitude_phase(spec)
    _same_bits(again[0].cpu(), amp.cpu())
    _same_bits(again[1].cpu(), ph.cpu())


@pytest.mark.cuda
def test_a_blocks_rows_equal_the_whole_cubes_on_the_card():
    _card()
    spec = _spectrum((96, 50, 513), seed=9).cuda()
    amp, ph = polar.amplitude_phase(spec)
    for x0, x1 in ((0, 48), (48, 96), (24, 72), (95, 96)):
        b_amp, b_ph = polar.amplitude_phase(spec[x0:x1].contiguous())
        _same_bits(b_amp.cpu(), amp[x0:x1].cpu())
        _same_bits(b_ph.cpu(), ph[x0:x1].cpu())


@pytest.mark.cuda
def test_one_launch_an_fft_stage_run_none_a_click_on_the_card():
    _card()
    ex = _explorer("cuda")
    before = polar.amplitude_phase.launches
    for low in (1.0, 1.1, 1.2):
        ex.set_fft_window_low(low)
    torch.cuda.synchronize()
    assert polar.amplitude_phase.launches == before + 3
    ex.set_selected_pixel(3, 4)
    ex.set_selected_pixel(7, 2)
    torch.cuda.synchronize()
    assert polar.amplitude_phase.launches == before + 3


# ------------------------------------------------------------ the benchmark
def _reader():
    from portbench.spec import Spec

    return Spec(Path(__file__).resolve().parents[1]).reader("polar_roofline.slider")


def test_the_roofline_reader_counts_each_byte_once():
    bound_bytes = _reader().__globals__["bound_bytes"]
    assert bound_bytes(512 * 512, 513) == 512 * 512 * 513 * (8 + 4 + 4)
    # about 0.64 ms on the card's 3.35 TB/s
    assert abs(bound_bytes(512 * 512, 513) / 3.35e12 - 0.642e-3) < 1e-5


def test_the_roofline_reader_reads_the_kernel_alone():
    read = _reader()
    pattern = read.__globals__["PATTERN"]
    assert re.search(pattern, "void (anonymous namespace)::polar_unwrap_kernel<false>("
                              "(anonymous namespace)::Args)")
    # torch.polar's own kernel, and the scan the kernel replaces, are not it
    assert not re.search(pattern, "void at::native::vectorized_elementwise_kernel<4, "
                                  "at::native::polar_kernel_cuda(at::TensorIterator&)")
    assert not re.search(pattern, "void at_cuda_detail::tensor_kernel_scan_innermost_dim")
    steps = [SimpleNamespace(n_time=1024), SimpleNamespace(n_time=1648)]
    ops = {id(steps[0]): [("polar_unwrap_kernel", 0.0, 1.0e-3)],
           id(steps[1]): [("polar_unwrap_kernel", 0.0, 2.0e-3)]}
    run = SimpleNamespace(trace=object(), device_name="NVIDIA H100 80GB HBM3",
                          cfg={"scan": {"width": 512, "height": 512}},
                          traced_steps=lambda cls: steps if cls == "slider" else [],
                          ops_in=lambda step, pat: ops[id(step)] if pat == pattern else [])
    want = 100.0 * 512 * 512 * 16 * (513 + 825) / 3.35e12 / 3.0e-3
    assert abs(read(run) - want) < 1e-9
    # a CPU run, or a trace without the kernel (the parent commit), reads nothing
    assert read(SimpleNamespace(trace=None, device_name="cpu")) is None
    run.ops_in = lambda step, pat: []
    assert read(run) is None
