"""The port's host helpers of the shell against the JAX package's: the same
inputs through each function of ``viz/colormap``, ``viz/plots``,
``viz/jslogic``, ``utils/logbuffer``, ``utils/settings`` and
``utils/update`` must give identical outputs (host numpy and plain
Python: bit for bit). The cases follow ``tests/test_viz_utils.py`` and
``tests/test_jslogic.py``; the PSF is synthetic.

Also the import guard: the port's shell loads neither ``jax`` nor the JAX
package.
"""

import json
import logging
import math
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest

from thz_image_explorer_tpu import web as jweb
from thz_image_explorer_tpu.utils import logbuffer as jlogbuffer
from thz_image_explorer_tpu.utils import settings as jsettings
from thz_image_explorer_tpu.utils import update as jupdate
from thz_image_explorer_tpu.viz import colormap as jcolormap
from thz_image_explorer_tpu.viz import jslogic as jjs
from thz_image_explorer_tpu.viz import plots as jplots
from thz_image_explorer_tpu_torch import web as tweb
from thz_image_explorer_tpu_torch.utils import logbuffer as tlogbuffer
from thz_image_explorer_tpu_torch.utils import settings as tsettings
from thz_image_explorer_tpu_torch.utils import update as tupdate
from thz_image_explorer_tpu_torch.viz import colormap as tcolormap
from thz_image_explorer_tpu_torch.viz import jslogic as tjs
from thz_image_explorer_tpu_torch.viz import plots as tplots

REPO = Path(__file__).resolve().parents[1]
#: a local address nothing listens on: the update check's offline case
OFFLINE_URL = "http://127.0.0.1:9/releases/latest"


def _same(a, b):
    """Identical values: arrays equal element for element with the same
    dtype and shape, NaN where the other has NaN; scalars and containers
    equal (NaN equals NaN)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert a == b and type(a) is type(b)


# ------------------------------------------------------------ colormap
_RNG = np.random.default_rng(11)
_IMG = _RNG.random((13, 9)).astype(np.float32) * 5.0

COLOR_CASES = [
    # the reference's own tests (math_tools.rs:711-754) and edges
    (np.array([0.0, 50.0, 100.0]), 100.0, (0.0, 100.0), 50.0, True),
    (np.array([0.0]), 100.0, (0.0, 100.0), 50.0, False),
    (np.array([100.0]), 100.0, (0.0, 100.0), 50.0, False),
    (np.linspace(0, 1, 101), 1.0, (10.0, 90.0), 30.0, False),
    (np.linspace(0, 1, 101), 1.0, (10.0, 90.0), 70.0, True),
    (_IMG, float(_IMG.max()), (5.0, 95.0), 50.0, False),
    (np.array([-1.0, 2.0]), 1.0, (0.0, 100.0), 1.0, False),
]


@pytest.mark.parametrize("case", range(len(COLOR_CASES)))
def test_color_from_intensity_identical(case):
    args = COLOR_CASES[case]
    _same(tcolormap.color_from_intensity(*args), jcolormap.color_from_intensity(*args))


@pytest.mark.parametrize("kw", [
    {}, {"cut_off": (5.0, 80.0)}, {"midpoint": 20.0}, {"bw": True},
    {"cut_off": (0.0, 50.0), "midpoint": 99.0, "bw": True},
])
@pytest.mark.parametrize("img", ["random", "zeros", "ramp"])
def test_intensity_image_rgba_identical(img, kw):
    arr = {"random": _IMG, "zeros": np.zeros((4, 6), np.float32),
           "ramp": np.arange(12, dtype=np.float32).reshape(3, 4)}[img]
    _same(tcolormap.intensity_image_rgba(arr, **kw), jcolormap.intensity_image_rgba(arr, **kw))


@pytest.mark.parametrize("args", [(100, 50.0, False), (100, 25.0, True), (37, 80.0, False),
                                  (100, 1.0, False), (100, 99.0, True)])
def test_colorbar_rgba_identical(args):
    _same(tcolormap.colorbar_rgba(*args), jcolormap.colorbar_rgba(*args))


# --------------------------------------------------------------- plots
_SPEC = np.abs(_RNG.standard_normal(300)) + 1e-3


@pytest.mark.parametrize("args", [
    (_SPEC,), (_SPEC, None, False), (_SPEC, _SPEC * 2.0, True),
    (np.array([0.0, 1.0, 2.0]),), (np.array([0.0, 0.0]),), (np.zeros(0),),
])
def test_fft_plot_series_identical(args):
    _same(tplots.fft_plot_series(*args), jplots.fft_plot_series(*args))


@pytest.mark.parametrize("args", [(_SPEC, True), (_SPEC, False), (_SPEC[:50], True),
                                  (np.zeros(0), True), (np.zeros(3), True)])
def test_dynamic_range_db_identical(args):
    with np.errstate(divide="ignore"):
        _same(tplots.dynamic_range_db(*args), jplots.dynamic_range_db(*args))


@pytest.mark.parametrize("sig", [_SPEC - 0.5, np.zeros(0), np.array([3.0])])
def test_peak_to_peak_identical(sig):
    _same(tplots.peak_to_peak(sig), jplots.peak_to_peak(sig))


@pytest.mark.parametrize("signals", [
    {"a": np.array([-1.0, 2.0]), "b": np.array([-3.0, 0.5])},
    {"a": np.zeros(0), "b": np.array([1.0, 2.0])},
    {},
])
def test_stacked_pulse_series_identical(signals):
    _same(tplots.stacked_pulse_series(signals), jplots.stacked_pulse_series(signals))


# -------------------------------------------------------------- jslogic
def test_jslogic_constants_identical():
    for name in ("ROI_CLOSE_FRACTION", "GAUGE_A0", "GAUGE_A1", "ORBIT_RAD_PER_PX",
                 "VIEW_FILL", "SERIES_MARGINS", "XY_MARGINS"):
        _same(getattr(tjs, name), getattr(jjs, name))


_POLY = [(2, 2), (20, 2), (20, 20), (5, 14)]
JS_CASES = [
    ("roi_click_closes", ((0, 0), (0.9, 0), (20, 40), 3)),
    ("roi_click_closes", ((0, 0), (1.0, 0), (20, 40), 3)),
    ("roi_click_closes", ((0, 0), (0.1, 0), (20, 40), 1)),
    ("roi_click_closes", ((5, 5), (5, 6.9), (40, 200), 2)),
    ("display_to_plot", (0.0, 0.0, 2.0, 20)),
    ("display_to_plot", (39.9, 39.9, 2.0, 20)),
    ("display_to_plot", (13.7, 5.2, 1.5, 31)),
    ("display_to_pixel", (0.0, 0.0, 2.0, 20)),
    ("display_to_pixel", (13.7, 5.2, 1.5, 31)),
    ("gauge_fraction", (950.0, 800.0, 1100.0, False)),
    ("gauge_fraction", (1e-3, 1e-6, 1e3, True)),
    ("gauge_fraction", (0.0, 0.0, 1.0, True)),
    ("gauge_fraction", (1.0, 1.0, 1.0, False)),
    ("gauge_value_deg", (50.0, 0.0, 100.0, False)),
    ("gauge_value_deg", (500.0, 0.0, 100.0, False)),
    ("gauge_value_deg", (1e-2, 1e-6, 1e3, True)),
    ("gauge_angle_rad", (-45.0,)),
    ("gauge_angle_rad", (150.0,)),
    ("project_voxel", (1.0, 2.0, 3.0, 0.0, 0.0)),
    ("project_voxel", (1.0, -2.0, 0.5, 0.7, -1.3)),
    ("voxel_screen_xy", (0.3, -0.2, 100.0, 640.0, 480.0)),
    ("voxel_view_scale", (0.5, 640.0, 480.0)),
    ("voxel_view_scale", (12.0, 300.0, 700.0)),
    ("orbit_drag", (0.1, 0.2, 15.0, -30.0)),
    ("point_in_poly", (10.0, 10.0, _POLY)),
    ("point_in_poly", (1.0, 1.0, _POLY)),
    ("point_in_poly", (20.0, 10.0, _POLY)),
    ("series_bounds", ([{"y": [1.0, None, 3.0]}, {"y": [0.5], "x": [9.0]}], [0.0, 1.0, 2.0])),
    ("series_bounds", ([{"y": [2.0, 2.0]}], [0.0, 1.0])),
    ("series_bounds", ([{"y": [None]}, {}], [0.0])),
    ("series_bounds", ([{"y": [1.0, 2.0, 3.0]}], [5.0])),
    ("series_px", (1.5, 0.0, 3.0, 400.0)),
    ("series_px", (1.5, 0.0, 3.0, 400.0, (20.0, 10.0, 15.0, 15.0))),
    ("series_py", (0.25, -1.0, 1.0, 200.0)),
    ("series_py", (0.25, -1.0, 1.0, 200.0, (20.0, 10.0, 15.0, 15.0))),
    ("cbar_click_mid", (0.0, 200.0)),
    ("cbar_click_mid", (150.0, 200.0)),
    ("cbar_click_mid", (400.0, 200.0)),
    ("cbar_drag_mid", (50.0, 30.0, 200.0)),
    ("cbar_drag_mid", (98.0, 30.0, 200.0)),
    ("cbar_marker_y", (37.0, 200.0)),
]


@pytest.mark.parametrize("case", range(len(JS_CASES)),
                         ids=[f"{n}-{i}" for i, (n, _a) in enumerate(JS_CASES)])
def test_jslogic_identical(case):
    name, args = JS_CASES[case]
    _same(getattr(tjs, name)(*args), getattr(jjs, name)(*args))


def test_point_in_poly_grid_identical():
    got = [tjs.point_in_poly(x + 0.5, y + 0.5, _POLY) for x in range(24) for y in range(24)]
    ref = [jjs.point_in_poly(x + 0.5, y + 0.5, _POLY) for x in range(24) for y in range(24)]
    assert got == ref and any(got)


@pytest.mark.parametrize("page", ["PAGE", "PSF_PAGE"])
def test_pages_are_the_jax_pages_with_the_product_name(page):
    """The page strings are copied: the JS the jslogic mirrors pin
    (``tests/test_jslogic.py``) is the same text, only the product name
    in the title differs."""
    port, ref = getattr(tweb, page), getattr(jweb, page)
    assert "TPU" in ref and "TPU" not in port and "CUDA" in port
    assert port.replace("CUDA", "TPU") == ref


# ------------------------------------------------------------ logbuffer
def _drive(buf, name):
    logger = logging.getLogger(name)
    logger.addHandler(buf)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    try:
        out = []
        for i in range(10):
            logger.info("msg %d", i)
        out.append(len(buf.records))
        out.append(buf.last_warning)
        logger.warning("trouble %s!", "here")
        out.append(buf.last_warning)
        logger.error("worse")
        out.append([line.split(" ", 2)[2] for line in buf.tail(3)])
        out.append([line.split(" ", 2)[2] for line in buf.tail(10, min_level=logging.WARNING)])
        buf.clear_warning()
        out.append(buf.last_warning)
        return out
    finally:
        logger.removeHandler(buf)


@pytest.mark.parametrize("capacity", [5, 100])
def test_log_ring_buffer_identical(capacity):
    got = _drive(tlogbuffer.LogRingBuffer(capacity=capacity), "thz_ring_test.port")
    ref = _drive(jlogbuffer.LogRingBuffer(capacity=capacity), "thz_ring_test.port")
    assert got == ref


def test_install_log_buffer_on_the_port_logger():
    buf = tlogbuffer.install_log_buffer()
    assert tlogbuffer.install_log_buffer() is buf
    logging.getLogger("thz_image_explorer_tpu_torch.some.module").warning("seen %d", 7)
    assert buf.last_warning == "seen 7"
    buf.clear_warning()


# ------------------------------------------------------------- settings
def _psf_pair(tmp_path, seed):
    from test_torch_deconv import synthetic_psf_arrays
    from thz_image_explorer_tpu.io.psf_npz import load_psf as jload_psf
    from thz_image_explorer_tpu_torch.io.psf_npz import load_psf

    path = tmp_path / f"psf{seed}.npz"
    np.savez(path, **synthetic_psf_arrays(correction=np.random.default_rng(seed)))
    return jload_psf(str(path)), load_psf(str(path))


@pytest.mark.parametrize("with_psf", [False, True])
def test_settings_json_identical(tmp_path, with_psf):
    jpsf, tpsf = _psf_pair(tmp_path, 5) if with_psf else (None, None)
    kw = dict(dark_mode=False, downscaling=3, sample_thickness=2.5, kernel_radius=4)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jsettings.Settings(psf=jpsf, **kw).save(str(tmp_path / "j"))
    tsettings.Settings(psf=tpsf, **kw).save(str(tmp_path / "t"))
    j = json.loads((tmp_path / "j" / "settings.json").read_text())
    t = json.loads((tmp_path / "t" / "settings.json").read_text())
    assert t == j
    back = tsettings.Settings.load(str(tmp_path / "t"))
    assert back.dark_mode is False and back.downscaling == 3 and back.kernel_radius == 4
    if with_psf:
        assert back.psf.fingerprint() == tpsf.fingerprint()
        assert tsettings.psf_to_json(back.psf) == jsettings.psf_to_json(jpsf)
    else:
        assert back.psf is None


@pytest.mark.parametrize("content", ["", "[1, 2]", "{not json", '{"downscaling": 2}'])
def test_settings_load_identical(tmp_path, content):
    if content:
        (tmp_path / "settings.json").write_text(content)
    t = tsettings.Settings.load(str(tmp_path))
    j = jsettings.Settings.load(str(tmp_path))
    for f in ("dark_mode", "downscaling", "opacity_threshold", "kernel_radius", "psf"):
        assert getattr(t, f) == getattr(j, f)


def test_psf_tool_state_roundtrip_identical(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jsettings.PsfToolState(knife_edge_x_path="/a/b.thz", n_filters=33).save(str(tmp_path / "j"))
    tsettings.PsfToolState(knife_edge_x_path="/a/b.thz", n_filters=33).save(str(tmp_path / "t"))
    assert (json.loads((tmp_path / "t" / "psf_tool_state.json").read_text())
            == json.loads((tmp_path / "j" / "psf_tool_state.json").read_text()))
    st = tsettings.PsfToolState.load(str(tmp_path / "t"))
    assert st.knife_edge_x_path == "/a/b.thz" and st.n_filters == 33


def test_config_dir_is_the_ports_own():
    assert tsettings.config_dir().endswith("thz_image_explorer_tpu_torch")
    assert Path(tsettings.config_dir()).parent == Path(jsettings.config_dir()).parent


# --------------------------------------------------------------- update
@pytest.mark.parametrize("v", ["v1.3.0", "1.4.0", "0.0.1-rc1", "nope", "1.2", ""])
def test_parse_version_identical(v):
    def run(mod):
        try:
            return mod.parse_version(v)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(tupdate) == run(jupdate)


@pytest.mark.parametrize("pair", [("1.4.0", "1.3.9"), ("1.3.0", "1.3.0"), ("v2.0.0", "1.9.9"),
                                  ("0.1.0", "0.1.1")])
def test_is_newer_identical(pair):
    assert tupdate.is_newer(*pair) == jupdate.is_newer(*pair)


def test_update_check_offline_identical(monkeypatch):
    monkeypatch.setattr(tupdate, "RELEASES_URL", OFFLINE_URL)
    monkeypatch.setattr(jupdate, "RELEASES_URL", OFFLINE_URL)
    assert tupdate.check_for_updates(timeout=2) is None
    assert tupdate.check_for_updates(timeout=2) == jupdate.check_for_updates(timeout=2)
    assert tupdate.latest_release(timeout=2) is None
    assert tupdate.fetch_release_tarball_url(timeout=2) is None
    assert jupdate.fetch_release_tarball_url(timeout=2) is None


def test_update_check_reads_a_local_release(tmp_path, monkeypatch):
    rel = tmp_path / "latest.json"
    rel.write_text(json.dumps({"tag_name": "v9.0.0", "tarball_url": "file:///x.tgz"}))
    for mod in (tupdate, jupdate):
        monkeypatch.setattr(mod, "RELEASES_URL", rel.as_uri())
    assert tupdate.latest_release() == "v9.0.0"
    assert tupdate.check_for_updates() == jupdate.check_for_updates() == "v9.0.0"
    assert tupdate.fetch_release_tarball_url() == jupdate.fetch_release_tarball_url()


def _package_tree(tmp_path, name, version):
    pkg = tmp_path / "site" / name
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text(f"__version__ = '{version}'\n")
    return pkg


def _release_tarball(tmp_path, name):
    src = tmp_path / "repo-abc123" / name
    src.mkdir(parents=True)
    (src / "__init__.py").write_text("__version__ = '9.9.9'\n")
    tar = tmp_path / "rel.tar.gz"
    with tarfile.open(tar, "w:gz") as tf:
        tf.add(tmp_path / "repo-abc123", arcname="repo-abc123")
    return tar


def test_install_update_replaces_the_ports_package(tmp_path):
    name = "thz_image_explorer_tpu_torch"
    pkg = _package_tree(tmp_path, name, "0.1.0")
    tar = _release_tarball(tmp_path, name)
    assert tupdate.install_update(tar.as_uri(), package_dir=str(pkg)) == str(pkg)
    assert "9.9.9" in (pkg / "__init__.py").read_text()
    assert "0.1.0" in (pkg.parent / f"{name}.bak" / "__init__.py").read_text()


@pytest.mark.parametrize("archive", ["bad", "packageless"])
def test_install_update_rolls_back(tmp_path, archive):
    pkg = _package_tree(tmp_path, "thz_image_explorer_tpu_torch", "0.1.0")
    if archive == "bad":
        tar = tmp_path / "bad.tar.gz"
        tar.write_bytes(b"not a tarball")
        err = Exception
    else:
        # a release of the JAX package only: no port tree in it
        tar = _release_tarball(tmp_path, "thz_image_explorer_tpu")
        err = ValueError
    with pytest.raises(err):
        tupdate.install_update(tar.as_uri(), package_dir=str(pkg))
    assert "0.1.0" in (pkg / "__init__.py").read_text()


# --------------------------------------------------------- import guard
def test_shell_imports_nothing_of_jax():
    """The port's web, cli, worker and utils load neither ``jax`` nor any
    module of ``thz_image_explorer_tpu``."""
    code = (
        "import sys\n"
        "import thz_image_explorer_tpu_torch.web, thz_image_explorer_tpu_torch.cli\n"
        "import thz_image_explorer_tpu_torch.pipeline.worker\n"
        "import thz_image_explorer_tpu_torch.utils, thz_image_explorer_tpu_torch.utils.update\n"
        "import thz_image_explorer_tpu_torch.utils.dragbench, thz_image_explorer_tpu_torch.viz\n"
        "import thz_image_explorer_tpu_torch.__main__\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'\n"
        "       or m == 'thz_image_explorer_tpu' or m.startswith('thz_image_explorer_tpu.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == "[]"
