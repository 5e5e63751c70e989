"""The port's web shell against the JAX package's, on the CPU.

The JAX ``WebApp`` (without its shape buckets, ``THZ_SHAPE_BUCKET=1``) and
the port's (``device="cpu"``) take the same command list through
``command()`` and are read through ``state()`` after each step: the same
keys at every level of the state, the plot series at atol 5e-5 / rtol
1e-4 (the main path's tolerance), the image behind the PNG at the same
tolerance, and the PNG's pixels within one 8-bit step. Then the 3-D view
endpoint, the PSF page's endpoints on fitted knife edges, the drop
routing, the midpoint clamp, the busy fallback, a slider drag through the
port's ``dragbench``, and one true-socket server with its loopback checks.

Every worker and server is closed in a fixture or ``finally``; every wait
has a timeout.
"""

import base64
import copy
import http.client
import json
import math
import struct
import threading
import time
import zlib
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

import chip_smoke
from make_sample import synthetic_scan, write_scan_thz
from thz_image_explorer_tpu import web as jweb
from thz_image_explorer_tpu.psf_tool import app as japp
from thz_image_explorer_tpu.psf_tool import data_loader as jdl
from thz_image_explorer_tpu_torch import convert
from thz_image_explorer_tpu_torch import web as tweb
from thz_image_explorer_tpu_torch.psf_tool import app as tapp
from thz_image_explorer_tpu_torch.utils import dragbench

ATOL, RTOL = 5e-5, 1e-4
WAIT = 120.0
#: data-valued maps whose keys differ by design between the packages:
#: stage timings (JAX also times its fused programs) and the log tail
_DATA_KEYED = {"timings_ms", "log", "last_warning"}

#: (name, commands) through ``WebApp.command``; the state is compared after each
STEPS = [
    ("fd_filters", [("set_filter_active", ["frequency_band_pass", True]),
                    ("set_filter_active", ["water_vapor_notch", True])]),
    ("rois", [("add_roi", ["u1", "r1", [[1, 1], [12, 1], [12, 10]]]),
              ("add_roi", ["u2", "r2", [[10, 2], [18, 2], [18, 9], [10, 9]]])]),
    ("pixel", [("set_selected_pixel", [3, 4])]),
    ("window", [("set_fft_window_low", [1.1]), ("set_fft_window_high", [6.5])]),
    ("td_filter", [("set_filter_param", ["time_band_pass_before_fft", "low", 0.4]),
                   ("set_filter_active", ["time_band_pass_before_fft", True])]),
    ("optical", [("set_reference", ["r1"]), ("set_sample", ["Selected Pixel"]),
                 ("set_material_thickness", [0.5])]),
    ("log_plot", [("set_fft_log_plot", [True]), ("set_view", ["midpoint", 30])]),
    ("window_type", [("set_fft_window_type", ["hanning"])]),
    ("click", [("set_selected_pixel", [15, 11])]),
]


def _scan(tmp_path, name="scan.thzimg", w=20, h=18, nt=64, seed=0):
    t, cube = synthetic_scan(width=w, height=h, n_time=nt, seed=seed)
    return write_scan_thz(str(tmp_path / name), t, cube, dx=0.5, dy=0.5)


def _png_rgba(b64):
    """Decode this shell's PNGs (one IDAT, filter 0 on every row)."""
    raw = base64.b64decode(b64)
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", raw[16:24])
    i, idat = 8, b""
    while i < len(raw):
        n = struct.unpack(">I", raw[i:i + 4])[0]
        if raw[i + 4:i + 8] == b"IDAT":
            idat += raw[i + 8:i + 8 + n]
        i += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both apps through STEPS: (state, image) after the open and each step."""
    d = tmp_path_factory.mktemp("web")
    path = _scan(d)
    _scan(d, "scan2.thzimg", seed=1)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("THZ_SHAPE_BUCKET", "1")
        mp.setenv("XDG_CONFIG_HOME", str(d / "xdg"))
        for key, app in (("jax", jweb.WebApp()), ("port", tweb.WebApp(device="cpu"))):
            try:
                snaps = []
                app.command("open_file", [path], {})
                assert app.worker.join_idle(WAIT)
                snaps.append((app.state(), np.array(app.worker.explorer.image)))
                for _name, cmds in STEPS:
                    for method, args in cmds:
                        app.command(method, args, {})
                    assert app.worker.join_idle(WAIT)
                    snaps.append((app.state(), np.array(app.worker.explorer.image)))
                out[key] = snaps
            finally:
                app.worker.close()
    return out


def _same_keys(j, t, where="state"):
    if isinstance(j, dict):
        assert isinstance(t, dict), where
        assert set(t) == set(j), (where, sorted(set(t) ^ set(j)))
        for k in j:
            if k not in _DATA_KEYED:
                _same_keys(j[k], t[k], f"{where}.{k}")


def _close(j, t, where):
    """Numbers within the main path's tolerance, None where the other has
    None (non-finite), everything else equal."""
    if isinstance(j, dict):
        for k in j:
            if k not in _DATA_KEYED and k not in ("image", "colorbar"):
                _close(j[k], t[k], f"{where}.{k}")
    elif isinstance(j, list):
        assert isinstance(t, list) and len(t) == len(j), (where, len(j), len(t))
        if j and all(isinstance(v, (int, float)) or v is None for v in j + t) and \
                not all(isinstance(v, bool) for v in j):
            jj = np.array([np.nan if v is None else v for v in j], np.float64)
            tt = np.array([np.nan if v is None else v for v in t], np.float64)
            np.testing.assert_allclose(tt, jj, atol=ATOL, rtol=RTOL, err_msg=where)
        else:
            for i, (a, b) in enumerate(zip(j, t)):
                _close(a, b, f"{where}[{i}]")
    elif isinstance(j, float) and not isinstance(j, bool) and isinstance(t, (int, float)):
        if math.isfinite(j):
            assert t == pytest.approx(j, rel=RTOL, abs=ATOL), where
        else:
            assert not math.isfinite(t), where
    else:
        assert t == j, (where, j, t)


@pytest.mark.parametrize("step", range(len(STEPS) + 1),
                         ids=["open"] + [s[0] for s in STEPS])
def test_state_matches_jax_webapp(runs, step):
    (js, jimg), (ts, timg) = runs["jax"][step], runs["port"][step]
    js, ts = copy.deepcopy(js), copy.deepcopy(ts)
    _same_keys(js, ts)
    for s in (js, ts):  # host clocks, not results
        for f in s["filters"].values():
            f.pop("time_ms")
        s["readouts"].pop("dr_db")
        s.pop("busy")
    _close(js, ts, "state")
    np.testing.assert_allclose(timg, jimg, atol=ATOL, rtol=RTOL, err_msg="image")
    jpx, tpx = _png_rgba(js["image"]), _png_rgba(ts["image"])
    assert jpx.shape == tpx.shape
    assert np.abs(jpx.astype(int) - tpx.astype(int)).max() <= 1
    assert ts["colorbar"] == js["colorbar"]
    assert ts["preview"] is False and ts["phase"] is None


def test_dr_readout_matches_jax(runs):
    """DR is rounded to 0.1 dB, so it is compared at that step."""
    for (js, _), (ts, _) in zip(runs["jax"], runs["port"]):
        assert abs(ts["readouts"]["dr_db"] - js["readouts"]["dr_db"]) <= 0.1 + 1e-9


def test_state_steps_are_not_vacuous(runs):
    snaps = [s for s, _img in runs["port"]]
    assert len(snaps[0]["plots"]["filtered_signal_fft"]) == 33
    assert snaps[2]["plots"]["roi_ffts"].keys() == {"u1", "u2"}
    assert snaps[6]["plots"]["refractive_index"] and snaps[7]["config"]["fft_log_plot"]
    assert snaps[7]["view"]["midpoint"] == 30.0
    assert snaps[8]["config"]["fft_window_type"] == "hanning"
    assert snaps[8]["plots"]["signal"] != snaps[9]["plots"]["signal"]
    assert snaps[0]["siblings"] == ["scan.thzimg", "scan2.thzimg"]


# ------------------------------------------------------------ 3-D view
@pytest.fixture(scope="module")
def voxel_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("vox")
    path = _scan(d, w=16, h=14, nt=128, seed=2)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("THZ_SHAPE_BUCKET", "1")
        mp.setenv("XDG_CONFIG_HOME", str(d / "xdg"))
        for key, app in (("jax", jweb.WebApp()), ("port", tweb.WebApp(device="cpu"))):
            try:
                app.command("open_file", [path], {})
                assert app.worker.join_idle(WAIT)
                out[key] = (app.voxels(contrast=0.5, sigma=2.0, radius=4, threshold=0.2),
                            app.worker.call(lambda ex: dict(ex.view3d), timeout=WAIT))
            finally:
                app.worker.close()
    return out


def _decode_voxels(r):
    pos = np.frombuffer(base64.b64decode(r["positions"]), np.float32).reshape(-1, 3)
    rgba = np.frombuffer(base64.b64decode(r["rgba"]), np.uint8).reshape(-1, 4)
    return {tuple(np.round(p, 5)): c.astype(int) for p, c in zip(pos, rgba)}


def test_voxels_endpoint_matches_jax(voxel_pair):
    (jr, jv3), (tr, tv3) = voxel_pair["jax"], voxel_pair["port"]
    assert set(tr) == set(jr)
    assert 0 < tr["n"] == jr["n"]
    assert tr["threshold"] == pytest.approx(jr["threshold"], abs=2e-5)
    assert tr["extent"] == pytest.approx(jr["extent"], abs=1e-6)
    g, r = _decode_voxels(tr), _decode_voxels(jr)
    assert set(g) == set(r)
    # colours: 8-bit truncations of the same opacities and jet colours
    assert max(int(np.abs(g[k] - r[k]).max()) for k in g) <= 1
    assert tv3 == jv3 == {"contrast": 0.5, "kernel_sigma": 2.0, "kernel_radius": 4,
                          "opacity_threshold": 0.2}


# ------------------------------------------------------------ PSF page
def _port_result(jres):
    """The JAX tool's result as the port's: the same fits and filtered
    cubes (converted), the port's own curve fits of those widths (equal to
    JAX's to 1e-12, ``tests/test_torch_psf_tool.py``). So both pages read
    the same numbers and only the shell is compared."""
    def fits(b):
        return convert.beam_width_fits_from_numpy(
            b.popt_xs, b.popt_ys, b.filtered_traces_x, b.filtered_traces_y,
            b.x_positions, b.y_positions, device="cpu")

    axes = {}
    for name in ("x", "y"):
        a = getattr(jres, name)
        m = a.mean_fit
        axes[name] = tapp.AxisResult(
            measurement=convert.knife_edge_from_numpy(
                a.measurement.positions, a.measurement.time_traces, a.measurement.times),
            mean_fit=convert.mean_beam_fit_from_numpy(m.x0, m.y0, m.popt_x, m.popt_y),
            beam_fits=fits(a.beam_fits), beam_fits_left=fits(a.beam_fits_left),
            beam_fits_right=fits(a.beam_fits_right))
    curve = tapp.compute_curve_fits(np.asarray(jres.center_frequencies),
                                    axes["x"].beam_fits, axes["y"].beam_fits)
    return tapp.PsfComputeResult(filters=np.array(jres.filters),
                                 center_frequencies=np.array(jres.center_frequencies),
                                 x=axes["x"], y=axes["y"], curve_fits=curve,
                                 warnings=list(jres.warnings))


@pytest.fixture(scope="module")
def psf_pages(tmp_path_factory):
    """Both apps' PSF tools holding the fits of the same knife edges."""
    d = tmp_path_factory.mktemp("psfpage")
    mx = chip_smoke.knife_edge_traces(60, 512, seed=0)
    my = chip_smoke.knife_edge_traces(60, 512, seed=1, width_scale=1.2)
    jres = japp.compute_psf(jdl.KnifeEdgeMeasurement(*mx), jdl.KnifeEdgeMeasurement(*my),
                            japp.FilterParams(n_filters=4, start_freq=0.5, end_freq=2.0))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XDG_CONFIG_HOME", str(d / "xdg"))
        for key, app, res in (("jax", jweb.WebApp(), jres),
                              ("port", tweb.WebApp(device="cpu"), _port_result(jres))):
            try:
                tool = app.psf_tool
                tool.result = res
                tool._update_diagnostics(res)
                out[key] = (app.psf_state(), app.psf_band("x", 2), app.psf_band("y", 9),
                            app.psf_image_png(1.0), app.psf_band("z", 0))
            finally:
                app.psf_tool._shutdown()
                app.worker.close()
    return out


def test_psf_page_matches_jax(psf_pages):
    j, t = psf_pages["jax"], psf_pages["port"]
    assert t[1]["n_bands"] == j[1]["n_bands"] == 4 and t[2]["band"] == j[2]["band"] == 3
    assert t[4] == j[4] == {"n_bands": 0}
    assert t[0]["result"] and t[0]["diagnostics"] and t[0]["diag_series"]
    _same_keys(j[0], t[0], "psf_state")
    for jv, tv, name in ((j[0], t[0], "psf_state"), (j[1], t[1], "band_x"),
                         (j[2], t[2], "band_y")):
        _close(jv, tv, name)
    assert t[3]["extent"] == pytest.approx(j[3]["extent"], abs=1e-3)
    np.testing.assert_array_equal(_png_rgba(t[3]["image"]), _png_rgba(j[3]["image"]))


# ------------------------------------------------------------ the port alone
@pytest.fixture
def app(tmp_path):
    a = tweb.WebApp(device="cpu")
    a.command("open_file", [_scan(tmp_path)], {})
    assert a.worker.join_idle(WAIT)
    yield a
    a.worker.close()


def test_drop_routes_by_extension(app, tmp_path):
    from test_torch_deconv import synthetic_psf_arrays

    psf = tmp_path / "beam.npz"
    np.savez(psf, **synthetic_psf_arrays())
    r = app.drop("beam.npz", psf.read_bytes())
    assert app.worker.join_idle(WAIT)
    assert r["saved"].endswith("beam.npz")
    assert app.worker.call(lambda ex: ex.pipeline.psf.is_loaded, timeout=WAIT)
    scan = _scan(tmp_path, "other.thzimg", w=12, h=10)
    with open(scan, "rb") as f:
        r = app.drop("../../evil/other.thzimg", f.read())
    assert app.worker.join_idle(WAIT)
    assert r["saved"].endswith("/other.thzimg") and "evil" not in r["saved"]
    s = app.state()
    assert s["file"] == r["saved"] and s["image_shape"] == [12, 10]
    assert not app.worker.failures


@pytest.mark.parametrize("key,value,want", [
    ("midpoint", 0, 1.0), ("midpoint", 100, 99.0), ("midpoint", 42.5, 42.5),
    ("cut_low", -5, 0.0), ("cut_high", 250, 100.0), ("bw", 1, True),
])
def test_set_view_clamped(app, key, value, want):
    app.command("set_view", [key, value], {})
    assert app.view[key] == want
    s = app.state()
    assert s["view"][key] == want
    assert not np.isnan(_png_rgba(s["image"]).astype(float)).any()
    json.dumps(s, allow_nan=False)


def test_state_falls_back_to_snapshot_when_busy(app):
    """A worker busy past the poll's wait serves the last snapshot marked
    busy and stale, with the phase and preview readable meanwhile."""
    s0 = app.state()
    gate = threading.Event()
    app.worker.queue.put((lambda ex: gate.wait(30), (), {}))
    try:
        t0 = time.monotonic()
        s = app.state()
        assert time.monotonic() - t0 < 10
        assert s["busy"] is True and s["stale"] is True
        assert s["file"] == s0["file"] and s["image"] == s0["image"]
        assert s["phase"] is None and s["preview"] is False
    finally:
        gate.set()
    assert app.worker.join_idle(WAIT)
    assert "stale" not in app.state()


def test_phase_reads_building_while_kernels_build(app, monkeypatch):
    """A kernel build queued on the worker (``serve --precompile``) shows
    as the phase "building" in the fallback state while it runs."""
    from pathlib import Path

    from thz_image_explorer_tpu_torch import kernels

    gate, entered = threading.Event(), threading.Event()

    def blocked_compile(names):
        entered.set()
        assert gate.wait(30)
        return {}

    monkeypatch.setattr(kernels, "library_path", lambda name: Path("/nonexistent") / name)
    monkeypatch.setattr(kernels, "_compile", blocked_compile)
    app.worker.send(lambda _ex: kernels.build(("specred",)))
    try:
        assert entered.wait(30)
        s = app.state()
        assert s["busy"] and s["stale"] and s["phase"] == "building"
    finally:
        gate.set()
    assert app.worker.join_idle(WAIT)
    assert app.state()["phase"] is None and not app.worker.failures


def test_state_build_error_serves_snapshot(app, monkeypatch):
    s0 = app.state()

    def boom(ex):
        raise RuntimeError("synthetic state failure")

    monkeypatch.setattr(app, "_build_state", boom)
    s = app.state()
    assert s["busy"] is True and s["file"] == s0["file"]


def test_unknown_command_refused(app):
    with pytest.raises(ValueError, match="unknown command"):
        app.command("__init__", [], {})
    with pytest.raises(ValueError, match="unknown command"):
        app.command("_finalize_open", [1], {})


def test_update_filter_force_as_keyword(app, tmp_path):
    """The page's Apply: ``update_filter`` with ``{"force": true}`` as a
    kwarg reaches the Explorer (a one-shot, never coalesced)."""
    from test_torch_deconv import synthetic_psf_arrays

    psf = tmp_path / "p.npz"
    np.savez(psf, **synthetic_psf_arrays())
    app.command("open_psf", [str(psf)], {})
    for k, v in (("n_filters", 3), ("n_iterations", 4), ("start_freq", 0.3)):
        app.command("set_filter_param", ["deconvolution", k, v], {})
    app.command("set_filter_active", ["deconvolution", True], {})
    app.command("update_filter", ["deconvolution"], {"force": True})
    assert app.worker.join_idle(WAIT)
    s = app.state()
    assert s["filters"]["deconvolution"]["active"] is True
    assert s["filters"]["deconvolution"]["time_ms"] > 0
    assert not app.worker.failures


def test_abort_command_drains(app):
    gate = threading.Event()
    app.worker.queue.put((lambda ex: gate.wait(30), (), {}))
    app.command("set_fft_window_low", [1.4], {})
    app.command("abort", [], {})
    gate.set()
    assert app.worker.join_idle(WAIT)
    assert app.state()["config"]["fft_window"][0] == 1.0


def test_png_encode_cached_across_polls(app, monkeypatch):
    calls = {"n": 0}
    orig = tweb.encode_png

    def counting(rgba):
        calls["n"] += 1
        return orig(rgba)

    monkeypatch.setattr(tweb, "encode_png", counting)
    app._png_cache = app._cbar_cache = None
    s1, s2 = app.state(), app.state()
    assert calls["n"] == 2 and s1["image"] == s2["image"]
    app.command("set_view", ["midpoint", 60], {})
    app.state()
    assert calls["n"] == 4
    app.command("set_fft_window_low", [1.2], {})  # a new image
    assert app.worker.join_idle(WAIT)
    app.state()
    assert calls["n"] == 5


def test_drag_replay_coalesces_and_settles(app):
    server = ThreadingHTTPServer(("127.0.0.1", 0), tweb.make_handler(app))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        r = dragbench.replay_drag(server.server_address[1], n_events=30, interval_s=0.002,
                                  settle_timeout_s=60, app=app)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert r["drag_unsatisfied_events"] == 0
    assert 1 <= r["drag_chain_updates"] <= 30
    assert r["drag_p50_ms"] is not None and r["drag_p99_ms"] >= r["drag_p50_ms"]
    assert app.state()["config"]["fft_window"][0] == pytest.approx(1.5)


def test_live_http_server_end_to_end(tmp_path):
    """A true socket: command POSTs, the GET surface, and the loopback
    Host/Origin checks."""
    path = _scan(tmp_path, w=24, h=20, nt=128)
    app = tweb.WebApp(device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), tweb.make_handler(app))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def req(method, url, body=None, origin=None, host=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        headers = {"Host": host or f"localhost:{port}"}
        if body is not None:
            body = json.dumps(body)
            headers["Content-Type"] = "application/json"
            headers["Origin"] = origin or f"http://localhost:{port}"
        try:
            conn.request(method, url, body=body, headers=headers)
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    def cmd(method, args, kwargs=None):
        status, raw = req("POST", "/api/command",
                          {"method": method, "args": args, "kwargs": kwargs or {}})
        assert status == 200 and json.loads(raw)["ok"] is True, (method, status, raw)

    try:
        cmd("open_file", [path])
        cmd("set_filter_active", ["frequency_band_pass", True])
        cmd("add_roi", ["u1", "r1", [[2, 2], [20, 2], [20, 18]]])
        cmd("set_fft_window_low", [1.2])
        cmd("add_roi", ["u2", "r2", [[3, 10], [18, 10], [18, 16]]])
        assert app.worker.join_idle(WAIT)
        status, raw = req("GET", "/api/state")
        assert status == 200
        s = json.loads(raw)
        assert {k: v["name"] for k, v in s["rois"].items()} == {"u1": "r1", "u2": "r2"}
        assert set(s["plots"]["roi_ffts"]) == {"u1", "u2"}
        assert s["config"]["fft_window"][0] == 1.2
        for url in ("/", "/psf", "/diagnostics", "/fits", "/visualizer", "/api/voxels",
                    "/api/logs?level=warning", f"/api/browse?path={tmp_path}",
                    "/api/psf_state", "/api/psf_band?axis=x&band=0"):
            status, body = req("GET", url)
            assert status == 200, url
        status, body = req("GET", "/")
        assert b"THz Image Explorer \xe2\x80\x94 CUDA" in body
        status, raw = req("POST", "/api/command", {"method": "no_such", "args": []})
        assert status == 400 and json.loads(raw)["ok"] is False
        # cross-site POST and a non-loopback Host are refused before running
        status, _ = req("POST", "/api/command",
                        {"method": "set_fft_window_low", "args": [9.9]},
                        origin="https://evil.example")
        assert status == 403
        status, _ = req("GET", "/api/state", host="evil.example")
        assert status == 403
        status, _ = req("GET", "/api/nothing")
        assert status == 404
        assert app.worker.join_idle(WAIT)
        assert app.worker.explorer.pipeline.config.fft_window[0] == 1.2
        assert not app.worker.failures
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        app.worker.close()


@pytest.mark.parametrize("page", ["PAGE", "PSF_PAGE"])
def test_embedded_js_ids_exist(page):
    import re

    html = getattr(tweb, page)
    ids = set(re.findall(r"el\('([\w]+)'\)", html)) | set(
        re.findall(r"getElementById\('([\w]+)'\)", html))
    present = set(re.findall(r'id="([\w]+)"', html))
    assert ids and not sorted(i for i in ids if i not in present)
