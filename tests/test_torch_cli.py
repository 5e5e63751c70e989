"""The port's command-line shell, every subcommand with ``--device cpu``,
against the JAX package's CLI where both compute the same thing: ``info``
prints the same lines, ``process --save`` and ``deconvolve --save`` (a
synthetic PSF, few bands and iterations) write cubes within the Apply
tolerance (1e-3 of max), ``psf-fit`` exports the same PSF within the PSF
tool's knife-edge tolerance and ``psf-diagnostics`` prints the same
summary. ``serve`` runs in a subprocess and is stopped; ``update`` is
pointed at local addresses only.
"""

import http.client
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("h5py")

import chip_smoke  # noqa: E402
from make_sample import synthetic_scan, write_scan_thz  # noqa: E402
from test_torch_deconv import synthetic_psf_arrays  # noqa: E402
from test_torch_psf_tool import _write_knife_edge  # noqa: E402
from thz_image_explorer_tpu import cli as jcli  # noqa: E402
from thz_image_explorer_tpu_torch import cli as tcli  # noqa: E402
from thz_image_explorer_tpu_torch.utils import update as tupdate  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DECONV_REL = 1e-3
OFFLINE_URL = "http://127.0.0.1:9/releases/latest"


@pytest.fixture
def scan_path(tmp_path):
    t, cube = synthetic_scan(width=18, height=16, n_time=128)
    return write_scan_thz(str(tmp_path / "scan.thzimg"), t, cube, dx=1.0, dy=1.0)


@pytest.fixture
def psf_path(tmp_path):
    path = tmp_path / "psf.npz"
    np.savez(path, **synthetic_psf_arrays())
    return str(path)


@pytest.fixture
def no_buckets(monkeypatch):
    """The JAX CLI without its shape buckets, as the parity tests run it."""
    monkeypatch.setenv("THZ_SHAPE_BUCKET", "1")


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr()


def _cube(path):
    from thz_image_explorer_tpu_torch.io import dotthz

    host = dotthz.open_scan_host(path)
    return host.data, host.metadata


def test_cli_info_matches_jax(scan_path, capsys, no_buckets):
    rc, out = _run(tcli.main, ["info", scan_path, "--device", "cpu"], capsys)
    jrc, jout = _run(jcli.main, ["info", scan_path], capsys)
    assert rc == jrc == 0
    assert "18 x 16 pixels x 128 samples" in out.out
    assert out.out == jout.out


def test_cli_info_single_pulse(tmp_path, capsys):
    import h5py

    p = str(tmp_path / "pulse.thz")
    t = np.linspace(0.0, 10.0, 64, dtype=np.float32)
    with h5py.File(p, "w") as f:
        g = f.create_group("G")
        g.create_dataset("ds1", data=np.stack([t, np.sin(t)], axis=1))
    rc, out = _run(tcli.main, ["info", p, "--device", "cpu"], capsys)
    assert rc == 0 and "1 x 1 pixels" in out.out


@pytest.mark.parametrize("extra", [
    ["--fd-bandpass", "0.2", "5.0", "--water-notch"],
    ["--td-bandpass", "0.5", "5.5", "--window", "hanning", "--window-low", "1.2"],
    ["--downscale", "2", "--avg-in-fourier"],
])
def test_cli_process_save_matches_jax(scan_path, tmp_path, capsys, no_buckets, extra):
    tout, jout = str(tmp_path / "t.thz"), str(tmp_path / "j.thz")
    rc, out = _run(tcli.main, ["process", scan_path, *extra, "--save", tout,
                               "--device", "cpu"], capsys)
    assert rc == 0 and "stage timings" in out.out and " fft " in out.out
    assert _run(jcli.main, ["process", scan_path, *extra, "--save", jout], capsys)[0] == 0
    (tdata, tmd), (jdata, jmd) = _cube(tout), _cube(jout)
    assert tdata.shape == jdata.shape
    np.testing.assert_allclose(tdata, jdata, atol=DECONV_REL * np.abs(jdata).max(), rtol=0)
    for key in ("width", "height", "dx [mm]", "dy [mm]"):
        assert float(tmd.md[key]) == float(jmd.md[key]), key
    raw, _ = _cube(scan_path)
    assert not np.allclose(tdata.shape == raw.shape and tdata, raw - raw[..., :1], atol=1e-7)


def test_cli_process_vtu_and_png(scan_path, tmp_path, capsys):
    vtu, png = str(tmp_path / "v.vtu"), str(tmp_path / "png")
    rc, out = _run(tcli.main, ["process", scan_path, "--vtu", vtu, "--png", png,
                               "--device", "cpu"], capsys)
    assert rc == 0
    assert Path(vtu).read_text().startswith("<?xml")
    assert {"intensity.png", "pulse.png"} <= set(os.listdir(png))


def test_cli_deconvolve_save_matches_jax(scan_path, psf_path, tmp_path, capsys, no_buckets):
    tout, jout = str(tmp_path / "t.thz"), str(tmp_path / "j.thz")
    args = ["--psf", psf_path, "--n-filters", "4", "--iterations", "8", "--start-freq", "0.3",
            "--end-freq", "3.0"]
    rc, out = _run(tcli.main, ["deconvolve", scan_path, *args, "--save", tout,
                               "--device", "cpu"], capsys)
    assert rc == 0 and "deconvolution:" in out.out
    assert _run(jcli.main, ["deconvolve", scan_path, *args, "--save", jout], capsys)[0] == 0
    (tdata, _), (jdata, _) = _cube(tout), _cube(jout)
    np.testing.assert_allclose(tdata, jdata, atol=DECONV_REL * np.abs(jdata).max(), rtol=0)
    raw, _ = _cube(scan_path)
    assert not np.allclose(tdata, raw - raw[..., :1], atol=1e-3 * np.abs(raw).max())


def test_cli_deconvolve_skip_is_a_clean_error(tmp_path, psf_path, capsys):
    import h5py

    t, cube = synthetic_scan(width=16, height=16, n_time=128)
    p = write_scan_thz(str(tmp_path / "nodx.thzimg"), t, cube, dx=1.0, dy=1.0)
    with h5py.File(p, "r+") as f:
        g = f["Image"]
        for i, name in enumerate(g.attrs["mdDescription"].split(",")):
            if name.strip() in ("dx [mm]", "dy [mm]"):
                g.attrs[f"md{i + 1}"] = "not-a-number"
    rc, out = _run(tcli.main, ["deconvolve", p, "--psf", psf_path, "--n-filters", "3",
                               "--iterations", "4", "--device", "cpu"], capsys)
    assert rc == 1 and "did not run" in out.out


def test_cli_psf_fit_and_diagnostics_match_jax(tmp_path, capsys):
    paths = []
    for axis, scale in (("x", 1.0), ("y", 1.2)):
        pos, traces, t = chip_smoke.knife_edge_traces(60, 512, seed=len(paths),
                                                      width_scale=scale)
        paths.append(_write_knife_edge(str(tmp_path / f"{axis}.thz"), pos, traces, t))
    args = ["--x", paths[0], "--y", paths[1], "--n-filters", "4", "--start-freq", "0.5",
            "--end-freq", "2.0"]
    tout, jout = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    rc, out = _run(tcli.main, ["psf-fit", *args, "--out", tout, "--device", "cpu"], capsys)
    assert rc == 0 and "exported PSF" in out.out
    assert _run(jcli.main, ["psf-fit", *args, "--out", jout], capsys)[0] == 0
    from thz_image_explorer_tpu.io.psf_npz import load_psf as jload
    from thz_image_explorer_tpu_torch.io.psf_npz import load_psf

    tpsf, jpsf = load_psf(tout), jload(jout)
    f = np.linspace(0.1, 10.0, 50, dtype=np.float32)
    # the knife-edge fits' tolerance of tests/test_torch_psf_tool.py
    for fit in ("wx_fit", "wy_fit"):
        np.testing.assert_allclose(getattr(tpsf, fit).eval(f), getattr(jpsf, fit).eval(f),
                                   atol=1e-4, err_msg=fit)
    for spl in ("x0_spline", "y0_spline"):
        np.testing.assert_allclose(getattr(tpsf, spl).eval_const_extrap(f),
                                   getattr(jpsf, spl).eval_const_extrap(f), atol=1e-4)
    # diagnostics of one PSF file: the same text
    rc, out = _run(tcli.main, ["psf-diagnostics", jout], capsys)
    jrc, jdiag = _run(jcli.main, ["psf-diagnostics", jout], capsys)
    assert rc == jrc == 0 and "PSF Diagnostics" in out.out
    assert out.out == jdiag.out


def test_cli_psf_diagnostics_synthetic(psf_path, capsys):
    rc, out = _run(tcli.main, ["psf-diagnostics", psf_path], capsys)
    jrc, jout = _run(jcli.main, ["psf-diagnostics", psf_path], capsys)
    assert rc == jrc == 0 and out.out == jout.out


def test_cli_psf_fit_requires_a_measurement(tmp_path, capsys):
    rc, out = _run(tcli.main, ["psf-fit", "--out", str(tmp_path / "p.npz"), "--device", "cpu"],
                   capsys)
    assert rc == 2 and "--x / --y" in out.err


def test_cli_update_offline_reports_unknown(monkeypatch, capsys):
    monkeypatch.setattr(tupdate, "RELEASES_URL", OFFLINE_URL)
    rc, out = _run(tcli.main, ["update"], capsys)
    assert rc == 0
    assert "latest release: unknown" in out.out


@pytest.mark.parametrize("tag,expect", [("v9.0.0", "update available: v9.0.0"),
                                        ("v0.1.0", "up to date"),
                                        ("nightly", "is not a version")])
def test_cli_update_reads_a_local_release(tmp_path, monkeypatch, capsys, tag, expect):
    rel = tmp_path / "latest.json"
    rel.write_text(json.dumps({"tag_name": tag}))
    monkeypatch.setattr(tupdate, "RELEASES_URL", rel.as_uri())
    rc, out = _run(tcli.main, ["update"], capsys)
    assert rc == 0 and expect in out.out


def test_cli_device_defaults_to_the_card(scan_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["info", scan_path])


def test_cli_serve_on_the_cpu(scan_path, tmp_path):
    """``python -m thz_image_explorer_tpu_torch serve --device cpu --port 0
    scan`` binds a free port, prints it, opens the scan, answers the state
    poll and saves the settings when interrupted."""
    env = dict(os.environ, XDG_CONFIG_HOME=str(tmp_path / "xdg"),
               THZ_UPDATE_RELEASES_URL=OFFLINE_URL,
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    with open(tmp_path / "serve.err", "w") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "thz_image_explorer_tpu_torch", "serve", scan_path,
             "--device", "cpu", "--port", "0"],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=err_file, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 90
        port = None
        while port is None:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        state = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
                conn.request("GET", "/api/state", headers={"Host": f"localhost:{port}"})
                state = json.loads(conn.getresponse().read())
                conn.close()
                if state.get("file") == scan_path and not state.get("preview") \
                        and state["plots"]["filtered_signal_fft"]:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert state is not None and state["file"] == scan_path, state
        assert state["image_shape"] == [18, 16]
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
        reader.join(timeout=10)
        assert proc.returncode == 0, (tmp_path / "serve.err").read_text()[-2000:]
        saved = tmp_path / "xdg" / "thz_image_explorer_tpu_torch" / "settings.json"
        assert json.loads(saved.read_text())["downscaling"] == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_module_entry_point_runs_psf_diagnostics(psf_path):
    r = subprocess.run([sys.executable, "-m", "thz_image_explorer_tpu_torch",
                        "psf-diagnostics", psf_path], cwd=str(REPO), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "PSF Diagnostics" in r.stdout
