"""The port's command worker: the coalescing queue against the JAX
package's on random command sequences, the abort epochs, the two-phase open (the JAX tests of the progressive open,
ported against the port's Explorer), and the settings round trip.

Every worker is closed in a ``finally`` or fixture, and every wait has a
timeout.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from make_sample import synthetic_scan, write_scan_thz
from thz_image_explorer_tpu.pipeline import worker as jworker
from thz_image_explorer_tpu_torch.io import dotthz as tdotthz
from thz_image_explorer_tpu_torch.pipeline import Explorer
from thz_image_explorer_tpu_torch.pipeline import worker as tworker
from thz_image_explorer_tpu_torch.pipeline.worker import CommandQueue, ExplorerWorker

WAIT = 60.0


def _write_scan(tmp_path, w=20, h=18, nt=64, name="scan.thzimg"):
    p = os.path.join(str(tmp_path), name)
    t, cube = synthetic_scan(width=w, height=h, n_time=nt)
    write_scan_thz(p, t, cube, dx=0.5, dy=0.5)
    return p


@pytest.fixture
def cpu_worker():
    w = ExplorerWorker(device="cpu")
    yield w
    w.close()


# ------------------------------------------------- coalescing parity
_METHODS = (
    sorted(tworker.COALESCE_BY_METHOD)[:6]
    + sorted(tworker.COALESCE_BY_METHOD_AND_ARG)
    + sorted(tworker.COALESCE_BY_METHOD_AND_TWO_ARGS)
    + ["add_roi", "delete_roi", "open_file", "update_filters", "save_file"]
)

_put = st.tuples(
    st.just("put"),
    st.sampled_from(_METHODS),
    st.lists(st.integers(0, 2), max_size=3).map(tuple),
    st.sampled_from([{}, {}, {}, {"force": True}]),
)
_ops = st.lists(st.one_of(_put, st.just(("take",)), st.just(("drain",))), max_size=40)


def test_coalescing_sets_and_keys_equal_jax():
    assert tworker.COALESCE_BY_METHOD == jworker.COALESCE_BY_METHOD
    assert tworker.COALESCE_BY_METHOD_AND_ARG == jworker.COALESCE_BY_METHOD_AND_ARG
    assert tworker.COALESCE_BY_METHOD_AND_TWO_ARGS == jworker.COALESCE_BY_METHOD_AND_TWO_ARGS


@settings(max_examples=60, deadline=None)
@given(ops=_ops)
def test_coalescing_matches_jax_queue(ops):
    """The same random sequence of puts (coalescing and one-shot, with and
    without kwargs), takes and drains through the JAX queue and the
    port's: the same keys, the same take order and payloads, the same
    abort epochs."""
    jq, tq = jworker.CommandQueue(), CommandQueue()
    got = {"jax": [], "port": []}
    try:
        for op in ops + [("take",)] * 45:
            for name, q, mod in (("jax", jq, jworker), ("port", tq, tworker)):
                if op[0] == "put":
                    _, method, args, kwargs = op
                    key = mod.coalesce_key(method, args, kwargs)
                    got[name].append(("key", key))
                    q.put((method, args, kwargs), key=key)
                elif op[0] == "take":
                    got[name].append(("take", q.take(timeout=0)))
                else:
                    got[name].append(("drain", q.drain(), q.abort_epoch))
            assert jq.empty() == tq.empty()
        assert got["port"] == got["jax"]
        assert tq.empty()
    finally:
        jq.close()
        jq.release()
        tq.close()


@pytest.mark.parametrize("method,args", [
    ("set_fft_window_low", ()),  # coalesces per method
    ("update_filter", ("frequency_band_pass",)),  # per method and first arg
    ("set_filter_param", ("frequency_band_pass", "low")),  # per first two args
])
def test_slider_drag_coalesces_in_place(method, args):
    """A drag of one slider keeps one pending command at its first
    position; one-shots around it all stay, in order."""
    q = CommandQueue()
    try:
        def put(m, *a):
            q.put((m, a, {}), key=tworker.coalesce_key(m, a))

        put("add_roi", "u1")
        for v in (1.0, 1.1, 1.2):
            put(method, *args, v)
        put("add_roi", "u2")
        put(method, *args, 1.3)
        got = [q.take(timeout=1) for _ in range(3)]
        assert got == [("add_roi", ("u1",), {}), (method, args + (1.3,), {}),
                       ("add_roi", ("u2",), {})]
        assert q.take(timeout=0.05) is None and q.empty()
    finally:
        q.close()


def test_take_times_out_and_close_wakes_a_blocked_take():
    q = CommandQueue()
    t0 = time.monotonic()
    assert q.take(timeout=0.05) is None
    assert time.monotonic() - t0 >= 0.04
    got = []
    taker = threading.Thread(target=lambda: got.append(q.take(timeout=30)))
    taker.start()
    time.sleep(0.05)
    q.close()
    taker.join(timeout=5)
    assert not taker.is_alive() and got == [None]


# ------------------------------------------------------ abort epochs
def test_command_queue_abort_epochs():
    q = CommandQueue()
    try:
        q.put(("a", (), {}))
        assert q.take(timeout=1) is not None
        assert q.pop_epoch == q.abort_epoch == 0
        q.drain()
        assert q.abort_epoch == 1
        q.put(("b", (), {}))
        assert q.take(timeout=1) is not None
        assert q.pop_epoch == q.abort_epoch == 1
    finally:
        q.close()


def test_abort_cancels_inflight_command(cpu_worker):
    w = cpu_worker
    started = threading.Event()
    outcome = {}

    def long_cmd(ex):
        started.set()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if ex.pipeline.cancelled():
                outcome["cancelled"] = True
                return
            time.sleep(0.005)
        outcome["cancelled"] = False

    w.queue.put((long_cmd, (), {}))
    assert started.wait(5.0)
    w.abort()
    assert w.join_idle(10.0)
    assert outcome.get("cancelled") is True
    # a stale abort does not cancel the next command
    assert w.call(lambda ex: ex.pipeline.cancelled(), timeout=10.0) is False


def test_abort_cancels_command_that_escaped_the_drain(cpu_worker):
    """A command popped just before an abort's drain escapes the drain;
    its pop epoch is below the abort epoch, so it runs cancelled."""
    w = cpu_worker
    real_take = w.queue.take
    popped = threading.Event()
    gate = threading.Event()

    def slow_take(timeout=None):
        cmd = real_take(timeout=timeout)
        if cmd is not None:
            popped.set()
            gate.wait(5.0)
        return cmd

    w.queue.take = slow_take
    time.sleep(0.3)  # let a take() entered before the patch time out
    outcome = {}
    done = threading.Event()

    def cmd(ex):
        outcome["cancelled"] = ex.pipeline.cancelled()
        done.set()

    try:
        w.queue.put((cmd, (), {}))
        assert popped.wait(5.0)
        w.abort()
        gate.set()
        assert done.wait(10.0)
        assert outcome.get("cancelled") is True
    finally:
        gate.set()
        w.queue.take = real_take


def test_worker_runs_on_the_card_unless_asked():
    """No hidden fallback: a worker without a device asks for the card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExplorerWorker()


def test_failed_command_is_logged_and_recorded(cpu_worker):
    cpu_worker.send("set_filter_active", "no_such_filter", True)
    assert cpu_worker.join_idle(WAIT)
    assert [m for m, _tb in cpu_worker.failures] == ["set_filter_active"]
    assert "KeyError" in cpu_worker.failures[0][1]


def test_close_stops_the_worker():
    w = ExplorerWorker(device="cpu")
    w.close()
    assert not w._thread.is_alive()
    w.send("publish")  # after the close: queued, never run, no crash
    assert w.queue.take(timeout=0) is not None


# ------------------------------------------------- the two-phase open
def test_open_file_direct_call_stays_synchronous(tmp_path):
    p = _write_scan(tmp_path)
    ex = Explorer(device="cpu")
    ex.open_file(p)
    assert not ex.preview_pending
    assert ex.pipeline.input is not None
    assert ex.plot.signal_fft.size
    assert ex.image is not None and ex.image.shape == (20, 18)


def test_direct_open_builds_no_preview_image(tmp_path, monkeypatch):
    """Without a worker the device phase publishes at once, so the host
    preview image (two einsums over the cube) is not computed."""
    p = _write_scan(tmp_path)
    ex = Explorer(device="cpu")

    def no_preview(self):
        raise AssertionError("a direct open computed the preview image")

    monkeypatch.setattr(tdotthz.HostScan, "preview_image", no_preview)
    ex.open_file(p)
    assert ex.image is not None and ex.image.shape == (20, 18)


def test_open_arrays_goes_through_both_phases():
    """``open_arrays`` defers its device phase like ``open_file``; its
    preview equals the device phase's raw intensity and raw trace within
    f32 rounding."""
    t, cube = synthetic_scan(width=20, height=18, n_time=64)
    ex = Explorer(device="cpu")
    deferred = []
    ex.defer = lambda m, *a: deferred.append((m, a))
    ex.open_arrays(t, cube)
    assert ex.preview_pending and ex.pipeline.input is None
    preview_img, preview_sig = ex.image, ex.plot.signal
    assert deferred == [("_finalize_open", (1,))]
    ex._finalize_open(1)
    assert not ex.preview_pending
    raw = ex.pipeline.input.data
    np.testing.assert_allclose(preview_img, (raw * raw).sum(-1).numpy(), rtol=1e-5)
    np.testing.assert_allclose(preview_sig, ex.plot.signal, atol=1e-6)


def test_preview_matches_jax_host_scan(tmp_path):
    """``HostScan.preview_image`` / ``preview_trace`` equal the JAX ones on
    the same file (host numpy, the same expression)."""
    from thz_image_explorer_tpu.io import dotthz as jdotthz

    p = _write_scan(tmp_path, w=21, h=17, nt=96)
    jh, th = jdotthz.open_scan_host(p), tdotthz.open_scan_host(p)
    np.testing.assert_array_equal(th.preview_image(), jh.preview_image())
    for px, py in ((0, 0), (20, 16), (7, 3)):
        np.testing.assert_array_equal(th.preview_trace(px, py), jh.preview_trace(px, py))


def test_preview_served_while_device_phase_blocked(tmp_path, monkeypatch):
    from thz_image_explorer_tpu_torch.web import WebApp

    p = _write_scan(tmp_path)
    gate = threading.Event()
    entered = threading.Event()
    real = tdotthz.finalize_scan

    def slow_finalize(host, device):
        entered.set()
        assert gate.wait(timeout=30), "test gate never released"
        return real(host, device)

    monkeypatch.setattr(tdotthz, "finalize_scan", slow_finalize)
    app = WebApp(device="cpu")
    try:
        app.worker.send("open_file", p)
        assert entered.wait(timeout=30)
        deadline = time.monotonic() + 10
        snap = None
        while time.monotonic() < deadline:
            snap = app.state()
            if snap.get("preview") and snap.get("image"):
                break
            time.sleep(0.1)
        assert snap is not None and snap["preview"]
        assert snap["image"]
        assert snap["image_shape"] == [20, 18]
        assert snap["file"] == p
        assert len(snap["plots"]["signal"]) > 0
        gate.set()
        assert app.worker.join_idle(timeout=WAIT)
        final = app.state()
        assert not final["preview"]
        assert len(final["plots"]["filtered_signal_fft"]) > 0
    finally:
        gate.set()
        app.worker.close()


def test_drained_finalize_self_heals(tmp_path):
    p = _write_scan(tmp_path)
    ex = Explorer(device="cpu")
    ex.defer = lambda *a: None  # the deferred finalize is lost
    ex.open_file(p)
    assert ex.preview_pending
    assert ex.pipeline.input is None
    assert ex.plot.signal.size and not ex.plot.signal_fft.size
    ex.set_fft_window_low(1.0)
    assert not ex.preview_pending
    assert ex.pipeline.input is not None
    assert ex.plot.signal_fft.size


def test_rapid_sibling_opens_finalize_only_latest(tmp_path, monkeypatch, cpu_worker):
    """Arrow-key skipping through the worker: the second ``open_sibling``
    supersedes the first's pending open instead of finalizing it, so only
    the last scan pays the device phase (the JAX worker finalizes the
    first: its exclusion names only ``open_file``)."""
    p1 = _write_scan(tmp_path, w=20, h=18, name="scan_a.thzimg")
    _write_scan(tmp_path, w=24, h=22, name="scan_b.thzimg")
    w = cpu_worker
    w.send("open_file", p1)
    assert w.join_idle(WAIT)
    n_final = [0]
    real = tdotthz.finalize_scan

    def counting(host, device):
        n_final[0] += 1
        return real(host, device)

    monkeypatch.setattr(tdotthz, "finalize_scan", counting)
    gate = threading.Event()
    w.queue.put((lambda ex: gate.wait(30), (), {}))
    w.send("open_sibling", 1)  # -> scan_b
    w.send("open_sibling", 1)  # -> scan_a again (wrap-around)
    gate.set()
    assert w.join_idle(WAIT)
    assert n_final[0] == 1
    assert w.call(lambda ex: (ex.file_path, ex.image.shape, ex.preview_pending),
                  timeout=WAIT) == (p1, (20, 18), False)
    assert not w.failures


def test_rapid_opens_direct_replay_finalize_only_latest(tmp_path, monkeypatch):
    p1 = _write_scan(tmp_path, w=20, h=18)
    p2 = _write_scan(tmp_path, w=24, h=22, name="scan2.thzimg")
    ex = Explorer(device="cpu")
    deferred = []
    ex.defer = lambda m, *a: deferred.append((m, a))
    ex.open_file(p1)
    ex.open_file(p2)
    assert len(deferred) == 2
    n_final = [0]
    real = tdotthz.finalize_scan

    def counting(host, device):
        n_final[0] += 1
        return real(host, device)

    monkeypatch.setattr(tdotthz, "finalize_scan", counting)
    for m, a in deferred:
        getattr(ex, m)(*a)
    assert n_final[0] == 1
    assert ex.image.shape == (24, 22)
    assert not ex.preview_pending


def test_failed_device_phase_rolls_facade_back(tmp_path, monkeypatch):
    p1 = _write_scan(tmp_path, w=20, h=18)
    p2 = _write_scan(tmp_path, w=24, h=22, name="scan2.thzimg")
    ex = Explorer(device="cpu")
    ex.open_file(p1)
    img1, meta1, hk1 = ex.image, ex.metadata, ex.housekeeping

    def boom(host, device):
        raise RuntimeError("synthetic h2d failure")

    monkeypatch.setattr(tdotthz, "finalize_scan", boom)
    with pytest.raises(RuntimeError, match="synthetic h2d"):
        ex.open_file(p2)
    monkeypatch.undo()
    assert ex.file_path == p1
    assert ex.image is img1
    assert ex.metadata is meta1
    assert ex.housekeeping is hk1
    assert not ex.preview_pending
    ex.set_fft_window_low(1.0)
    assert ex.plot.signal_fft.size
    assert ex.image.shape == (20, 18)


def test_finalize_publish_runs_with_preview_marker(tmp_path, monkeypatch):
    p = _write_scan(tmp_path)
    ex = Explorer(device="cpu")
    deferred = []
    ex.defer = lambda m, *a: deferred.append((m, a))
    ex.open_file(p)
    assert deferred and ex.preview_pending
    n_final = [0]
    real = tdotthz.finalize_scan

    def counting(host, device):
        n_final[0] += 1
        return real(host, device)

    seen = []
    real_publish = ex.publish

    def spying_publish():
        seen.append(ex.preview_pending)
        real_publish()

    ex.publish = spying_publish
    monkeypatch.setattr(tdotthz, "finalize_scan", counting)
    ex._finalize_open(deferred[0][1][0])
    assert n_final[0] == 1
    assert seen == [True]
    assert not ex.preview_pending


def test_queued_mutation_survives_deferred_finalize(tmp_path, cpu_worker):
    p = _write_scan(tmp_path)
    w = cpu_worker
    gate = threading.Event()
    w.queue.put((lambda ex: gate.wait(30), (), {}))
    w.send("open_file", p)
    w.send("set_filter_param", "time_band_pass_before_fft", "low", 1.25)
    gate.set()
    assert w.join_idle(timeout=WAIT)
    f = w.explorer.pipeline.filters["time_band_pass_before_fft"]
    assert f.low == 1.25, "queued param write reverted by finalize"
    assert not w.explorer.preview_pending
    assert w.explorer.pipeline.input is not None


def test_failed_deferred_finalize_is_recorded(tmp_path, monkeypatch, cpu_worker):
    """A command queued behind an open runs the deferred device phase
    itself; when that phase fails, the worker records the failure (not only
    logs it), the facade rolls back, and the command runs on the previous
    scan."""
    p1 = _write_scan(tmp_path, w=20, h=18)
    p2 = _write_scan(tmp_path, w=24, h=22, name="scan2.thzimg")
    w = cpu_worker
    w.send("open_file", p1)
    assert w.join_idle(WAIT) and not w.failures

    def boom(host, device):
        raise RuntimeError("synthetic h2d failure")

    monkeypatch.setattr(tdotthz, "finalize_scan", boom)
    gate = threading.Event()
    w.queue.put((lambda ex: gate.wait(30), (), {}))
    w.send("open_file", p2)
    w.send("set_fft_window_low", 1.0)  # queued ahead of the deferred finalize
    gate.set()
    assert w.join_idle(WAIT)
    assert [m for m, _tb in w.failures] == ["_finalize_open"]
    assert "synthetic h2d failure" in w.failures[0][1]
    assert w.call(lambda ex: (ex.file_path, ex.image.shape, ex.preview_pending,
                              ex.pipeline.config.fft_window[0]),
                  timeout=WAIT) == (p1, (20, 18), False, 1.0)


# ------------------------------------------------------------ settings
def _synthetic_psf_path(tmp_path):
    from test_torch_deconv import synthetic_psf_arrays

    path = tmp_path / "psf.npz"
    np.savez(path, **synthetic_psf_arrays(correction=np.random.default_rng(4)))
    return str(path)


def test_settings_roundtrip_through_explorer(tmp_path):
    """apply_settings -> collect_settings -> save -> load keeps every
    preference and the PSF's coefficients; the saved JSON equals the JAX
    package's for the same preferences and PSF."""
    from thz_image_explorer_tpu.io.psf_npz import load_psf as jload_psf
    from thz_image_explorer_tpu.utils.settings import Settings as JSettings
    from thz_image_explorer_tpu_torch.io.psf_npz import load_psf
    from thz_image_explorer_tpu_torch.utils.settings import Settings

    psf_path = _synthetic_psf_path(tmp_path)
    prefs = dict(fft_log_plot=True, avg_in_fourier_space=True, downscaling=2,
                 sample_thickness=2.5, opacity_threshold=0.03, contrast_3d=1.5,
                 kernel_sigma=2.0, kernel_radius=7)
    ex = Explorer(device="cpu")
    ex.apply_settings(Settings(psf=load_psf(psf_path), **prefs))
    assert ex.pipeline.config.scale_factor == 2 and ex.view3d["kernel_radius"] == 7
    got = ex.collect_settings()
    for k, v in prefs.items():
        assert getattr(got, k) == v, k
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got.save(str(tmp_path / "port"))
    JSettings(psf=jload_psf(psf_path), **prefs).save(str(tmp_path / "jax"))
    port_json = json.loads((tmp_path / "port" / "settings.json").read_text())
    jax_json = json.loads((tmp_path / "jax" / "settings.json").read_text())
    assert port_json == jax_json
    back = Settings.load(str(tmp_path / "port"))
    assert back.psf is not None and back.psf.is_loaded
    assert back.psf.fingerprint() == got.psf.fingerprint()
    ex2 = Explorer(device="cpu")
    ex2.apply_settings(back)
    assert ex2.pipeline.psf.fingerprint() == got.psf.fingerprint()
    assert ex2.collect_settings().sample_thickness == 2.5


def test_settings_through_worker(cpu_worker, tmp_path):
    from thz_image_explorer_tpu_torch.utils.settings import Settings

    s = Settings(downscaling=3, kernel_sigma=1.5)
    cpu_worker.send("apply_settings", s)
    assert cpu_worker.join_idle(WAIT)
    got = cpu_worker.call(lambda ex: ex.collect_settings(), timeout=WAIT)
    assert got.downscaling == 3 and got.kernel_sigma == 1.5 and got.psf is None
