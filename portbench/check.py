"""The comparison that decides ``correct``.

A run keeps a sample, drawn from the seed, of the publishes its window
produced: each with the session state it was made in. Once the window has
closed and the program is freed, the plain reference (``portbench.reference``)
works out the same publishes from the seed, and each number below is the
widest gap over the sample:

``series_gap``
    every published series but the phases and the optical constants (the
    axes, the pixel's traces and spectra, the pixel-mean and ROI means, the
    intensity image): ``max |program - reference| / max |reference|``, each
    series (each ROI's row) on its own scale. The traces an Apply changes
    count here only in publishes without an Apply.
``phase_gap``
    the pixel's and the means' unwrapped phases, in rad: ``max |wrap(program
    - reference)|``. The wrap leaves a whole turn that the unwrap of a
    single noise bin can take on rounding (a step within rounding of pi)
    out of the pixel's series; a mean over N pixels still shows such a turn
    as 2 pi / N.
``optical_gap``
    n - 1, alpha and kappa (the pixel against ROI 0), each on its own scale,
    over the bins above DC where both spectra hold at least 1 % of their
    peak: elsewhere a ratio of noise to noise.
``apply_gap``
    in publishes after an Apply, the traces it changes: the pixel's final
    trace, the pixel-mean and ROI traces and the intensity image.

A step that returns an output (a ``call`` step naming ``output``) is judged
by ``portbench/outputs/<output>.py`` instead, whose ``NUMBERS`` join these in
:func:`worst` and :func:`verdict`.
"""

from __future__ import annotations

import math

import numpy as np

#: series compared by ``series_gap`` (the deconvolved ones only without an Apply)
SERIES = ("time", "signal", "frequencies", "signal_fft", "filtered_time",
          "filtered_frequencies", "filtered_signal_fft", "avg_signal_fft", "roi_amp")
DECONVOLVED = ("filtered_signal", "avg_signal", "roi_trace", "image")
PHASES = ("phase_fft", "filtered_phase_fft", "avg_phase_fft", "roi_ph")
OPTICAL = ("refractive_index", "absorption_coefficient", "extinction_coefficient")
NUMBERS = ("series_gap", "phase_gap", "optical_gap", "apply_gap")
_PLOT_KEYS = ("time", "signal", "frequencies", "signal_fft", "phase_fft", "filtered_time",
              "filtered_signal", "filtered_frequencies", "filtered_signal_fft",
              "filtered_phase_fft", "avg_signal", "avg_signal_fft", "avg_phase_fft") + OPTICAL
#: share of a spectrum's peak below which the optical constants are not compared
OPTICAL_FLOOR = 1e-2


def capture(explorer, roi_ids) -> dict:
    """The Explorer's published series as they stand (host arrays, kept by
    reference: each publish makes new ones)."""
    p = explorer.plot
    out = {k: getattr(p, k) for k in _PLOT_KEYS}
    out["roi_trace"] = np.stack([p.roi_signal[u][1] for u in roi_ids])
    out["roi_amp"] = np.stack([p.roi_signal_fft[u][1] for u in roi_ids])
    out["roi_ph"] = np.stack([p.roi_phase[u][1] for u in roi_ids])
    out["image"] = explorer.image
    return out


#: series that are stacks of one row a ROI, each row on its own scale
_ROWS = ("roi_trace", "roi_amp")


def _rel_gap(got, want, rows: bool = False) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return math.inf
    if rows:
        return max((_rel_gap(g, w) for g, w in zip(got, want)), default=0.0)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    diff = np.abs(got - want)
    if not np.all(np.isfinite(diff)):
        return math.inf
    return float(diff.max() / scale) if scale > 0 else float(diff.max(initial=0.0))


def _phase_gap(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return math.inf
    d = got - want
    if not np.all(np.isfinite(d)):
        return math.inf
    return float(np.abs(np.remainder(d + np.pi, 2 * np.pi) - np.pi).max(initial=0.0))


def _optical_gap(got, want, ref_roi: int) -> float:
    samp = np.asarray(want["filtered_signal_fft"])
    refa = np.asarray(want["roi_amp"][ref_roi])
    bins = np.zeros(len(samp), bool)
    bins[1:] = True
    bins &= samp >= OPTICAL_FLOOR * samp.max()
    bins &= refa >= OPTICAL_FLOOR * refa.max()
    if not bins.any():
        return 0.0
    gaps = []
    for key in OPTICAL:
        g = np.asarray(got[key], np.float64)
        w = np.asarray(want[key], np.float64)
        if g.shape != w.shape:
            return math.inf
        if key == "refractive_index":
            g, w = g - 1.0, w - 1.0
        gaps.append(_rel_gap(g[bins], w[bins]))
    return max(gaps)


def compare(got: dict, want: dict, deconvolved: bool, ref_roi: int) -> dict:
    """The numbers of one publish (``apply_gap`` None without an Apply)."""
    series = max(_rel_gap(got[k], want[k], k in _ROWS) for k in SERIES)
    changed = max(_rel_gap(got[k], want[k], k in _ROWS) for k in DECONVOLVED)
    return dict(
        series_gap=series if deconvolved else max(series, changed),
        phase_gap=max(_phase_gap(got[k], want[k]) for k in PHASES),
        optical_gap=_optical_gap(got, want, ref_roi),
        apply_gap=changed if deconvolved else None,
    )


def worst(readings: list[dict], names=NUMBERS) -> dict:
    """Each number of ``names`` (the publish's, and those of the outputs a
    cell's steps name), its widest gap over the readings (None where none
    read it)."""
    out = {}
    for name in names:
        vals = [r[name] for r in readings if r.get(name) is not None]
        out[name] = max(vals) if vals else None
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` for the numbers that have a
    limit; a number that was read and has none is a fault of the files."""
    checks, ok = {}, True
    for name, value in numbers.items():
        if value is None:
            continue
        if name not in limits:
            raise KeyError(f"no limit for {name!r}")
        checks[name] = {"value": value, "limit": limits[name]}
        ok &= bool(value <= limits[name])
    return ok and bool(checks), checks
