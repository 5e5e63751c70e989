"""Settings persistence.

The port's own copy of ``thz_image_explorer_tpu/utils/settings.py``, on
the port's ``models/psf.py``: the reference's persistence stores:
``GuiSettingsContainer`` saved via the ``preferences`` crate — including
the full serialized PSF — loaded at start and autosaved on exit
(``main.rs:144-161``, ``gui/application.rs:134-217``), and the PSF tool's
JSON state at ``<config>/thz_image_explorer/psf_tool_state.json``
(``psf_tool/app.rs:33-69``). Stored as JSON under
``<XDG_CONFIG_HOME or ~/.config>/thz_image_explorer_tpu_torch/``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Optional

import numpy as np

from thz_image_explorer_tpu_torch.models.psf import PSF, CubicSplineCoeffs, HybridFit


def _atomic_json_dump(obj, path: str):
    """Write-temp + rename: concurrent savers (e.g. two HTTP threads
    persisting PSF-tool state) can interleave plain ``open('w')`` writes
    into truncated JSON; ``os.replace`` makes the last writer win with a
    whole file either way."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def config_dir() -> str:
    base = os.environ.get(
        "XDG_CONFIG_HOME", os.path.join(os.path.expanduser("~"), ".config")
    )
    path = os.path.join(base, "thz_image_explorer_tpu_torch")
    os.makedirs(path, exist_ok=True)
    return path


# ---------------------------------------------------------------- PSF JSON
def _spline_to_json(s: CubicSplineCoeffs) -> dict:
    return {
        "knots": s.knots.tolist(),
        "values": s.values.tolist(),
        "coeff_a": s.coeff_a.tolist(),
        "coeff_b": s.coeff_b.tolist(),
        "coeff_c": s.coeff_c.tolist(),
        "coeff_d": s.coeff_d.tolist(),
    }


def _spline_from_json(d: dict) -> CubicSplineCoeffs:
    return CubicSplineCoeffs(
        **{k: np.asarray(v, np.float32) for k, v in d.items()}
    )


def psf_to_json(psf: PSF) -> dict:
    return {
        "wx_fit": {
            "base_a": psf.wx_fit.base_a,
            "base_b": psf.wx_fit.base_b,
            "correction": _spline_to_json(psf.wx_fit.correction),
        },
        "wy_fit": {
            "base_a": psf.wy_fit.base_a,
            "base_b": psf.wy_fit.base_b,
            "correction": _spline_to_json(psf.wy_fit.correction),
        },
        "x0_spline": _spline_to_json(psf.x0_spline),
        "y0_spline": _spline_to_json(psf.y0_spline),
    }


def psf_from_json(d: dict) -> PSF:
    def hybrid(h):
        return HybridFit(
            base_a=float(h["base_a"]),
            base_b=float(h["base_b"]),
            correction=_spline_from_json(h["correction"]),
        )

    return PSF(
        wx_fit=hybrid(d["wx_fit"]),
        wy_fit=hybrid(d["wy_fit"]),
        x0_spline=_spline_from_json(d["x0_spline"]),
        y0_spline=_spline_from_json(d["y0_spline"]),
    )


@dataclasses.dataclass
class Settings:
    """User preferences (``GuiSettingsContainer`` defaults,
    ``gui/application.rs:180-217``)."""

    dark_mode: bool = True
    fft_log_plot: bool = False
    phases_visible: bool = False
    water_lines_visible: bool = True
    avg_in_fourier_space: bool = False
    downscaling: int = 1
    opacity_threshold: float = 0.1
    contrast_3d: float = 2.0
    kernel_sigma: float = 3.0
    kernel_radius: int = 9
    sample_thickness: float = 1.0
    psf: Optional[PSF] = None

    FILE = "settings.json"

    def save(self, directory: Optional[str] = None):
        # NOT dataclasses.asdict: that would deep-copy the whole PSF
        # spline tree only to overwrite the entry one line later
        d = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name != "psf"
        }
        d["psf"] = psf_to_json(self.psf) if self.psf is not None else None
        path = os.path.join(directory or config_dir(), self.FILE)
        _atomic_json_dump(d, path)

    @classmethod
    def load(cls, directory: Optional[str] = None) -> "Settings":
        path = os.path.join(directory or config_dir(), cls.FILE)
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError):
            return cls()
        if not isinstance(d, dict):  # corrupted file (e.g. JSON list)
            return cls()
        psf = d.pop("psf", None)
        known = {f.name for f in dataclasses.fields(cls)}
        out = cls(**{k: v for k, v in d.items() if k in known and k != "psf"})
        if psf is not None:
            try:
                out.psf = psf_from_json(psf)
            except (KeyError, TypeError, ValueError):
                out.psf = None
        return out


@dataclasses.dataclass
class PsfToolState:
    """The PSF tool's persisted parameters (``psf_tool/app.rs:33-69``), a
    JSON file in the directory the caller gives (``psf_tool/app.py``'s
    ``PsfToolApp(persist_dir=)``)."""

    knife_edge_x_path: str = ""
    knife_edge_y_path: str = ""
    n_filters: int = 20
    low_cut: float = 0.1
    high_cut: float = 10.0
    start_freq: float = 0.15
    end_freq: float = 5.0
    win_width: float = 0.5
    frequency_spacing: str = "log"
    w_max: float = 30.0
    use_monotonicity_constraint: bool = True

    FILE = "psf_tool_state.json"

    def save(self, directory: str):
        _atomic_json_dump(dataclasses.asdict(self), os.path.join(directory, self.FILE))

    @classmethod
    def load(cls, directory: str) -> "PsfToolState":
        try:
            with open(os.path.join(directory, cls.FILE)) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError):
            return cls()
        if not isinstance(d, dict):
            return cls()
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
