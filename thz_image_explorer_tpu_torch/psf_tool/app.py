"""PSF tool orchestration.

Port of ``thz_image_explorer_tpu/psf_tool/app.py`` (the compute side of the
reference's ``psf_tool/app.rs``): the parameter-hash-triggered recompute,
the compute thread with progress, cancellation and stale-result guards, the
double-knife-edge left/right averaging, the curve fits, the diagnostics and
the Apply handshake (``runtime_psf`` feeds ``Explorer.apply_psf``).

The device is explicit: ``compute_psf`` and ``PsfToolApp`` take one
(``"cuda"`` when None, which raises without CUDA) and the compute thread
receives it as an argument.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import numpy as np

from thz_image_explorer_tpu_torch.data import resolve_device
from thz_image_explorer_tpu_torch.models.psf import PSF
from thz_image_explorer_tpu_torch.ops.firapply import average_pair
from thz_image_explorer_tpu_torch.ops.firdesign import create_filter_bank
from thz_image_explorer_tpu_torch.psf_tool.curve_fitting import CurveFits
from thz_image_explorer_tpu_torch.psf_tool.data_loader import (
    KnifeEdgeMeasurement,
    split_and_flip,
)
from thz_image_explorer_tpu_torch.psf_tool.diagnostics import DiagnosticResults
from thz_image_explorer_tpu_torch.psf_tool.fitting import (
    BeamFitParams,
    BeamWidthFits,
    MeanBeamFit,
    fit_beam_widths,
    fit_mean_beam,
)
from thz_image_explorer_tpu_torch.utils.settings import PsfToolState


@dataclasses.dataclass
class FilterParams:
    """(``psf_tool/filters.rs:15-38``)"""

    n_filters: int = 20
    low_cut: float = 0.1
    high_cut: float = 10.0
    start_freq: float = 0.15
    end_freq: float = 5.0
    win_width: float = 0.5
    frequency_spacing: str = "log"


def check_transition_width(start_freq: float, end_freq: float,
                           win_width: float) -> Optional[str]:
    """Warn when the transition band exceeds half the frequency range
    (``warnings.rs:27-43``)."""
    frequency_range = end_freq - start_freq
    if win_width > frequency_range * 0.5:
        return (
            f"Band transition too wide ({win_width:.2f} THz) compared to "
            f"frequency range ({frequency_range:.2f} THz). "
            "Suggestion: reduce transition width."
        )
    return None


@dataclasses.dataclass
class AxisResult:
    measurement: KnifeEdgeMeasurement
    mean_fit: MeanBeamFit
    beam_fits: BeamWidthFits
    #: left/right detail for the individual-fits view
    beam_fits_left: Optional[BeamWidthFits] = None
    beam_fits_right: Optional[BeamWidthFits] = None


@dataclasses.dataclass
class PsfComputeResult:
    filters: np.ndarray  # (B, ntaps)
    center_frequencies: np.ndarray
    x: Optional[AxisResult]
    y: Optional[AxisResult]
    curve_fits: Optional[CurveFits]
    warnings: list


def _fit_axis(meas: KnifeEdgeMeasurement, taps: np.ndarray, fit_params: BeamFitParams,
              progress: Callable[[int, int], bool], device) -> Optional[AxisResult]:
    """Fit one axis: split and flip, fit both halves, average left and
    right and re-centre (``app.rs:543-713``)."""
    results = []
    for half in split_and_flip(meas):
        mean_fit = fit_mean_beam(half.positions, half.positions,
                                 half.time_traces, half.time_traces)
        fits = fit_beam_widths(mean_fit, half.positions, half.positions, half.time_traces,
                               half.time_traces, taps, fit_params, progress, device)
        if fits is None:
            return None
        results.append((mean_fit, fits))
    (mean_l, fits_l), (mean_r, fits_r) = results

    # left centres negated, widths averaged, then re-centred
    popt_avg = fits_l.popt_xs.copy()
    popt_avg[:, 0] = (-fits_l.popt_xs[:, 0] + fits_r.popt_xs[:, 0]) / 2.0
    popt_avg[:, 1] = (fits_l.popt_xs[:, 1] + fits_r.popt_xs[:, 1]) / 2.0
    mean_pos = popt_avg[:, 0].mean()
    popt_avg[:, 0] -= mean_pos

    filtered_x_avg = average_pair(fits_l.filtered_traces_x, fits_r.filtered_traces_x)
    if (fits_l.filtered_traces_y is fits_l.filtered_traces_x
            and fits_r.filtered_traces_y is fits_r.filtered_traces_x):
        # fit_beam_widths shares one cube for identical x/y traces: share
        # the average too
        filtered_y_avg = filtered_x_avg
    else:
        filtered_y_avg = average_pair(fits_l.filtered_traces_y, fits_r.filtered_traces_y)

    beam_fits = BeamWidthFits(
        popt_xs=popt_avg.copy(),
        popt_ys=popt_avg.copy(),
        filtered_traces_x=filtered_x_avg,
        filtered_traces_y=filtered_y_avg,
        x_positions=fits_l.x_positions,
        y_positions=fits_l.y_positions,
    )
    mean_fit = MeanBeamFit(
        x0=((-mean_l.x0) + mean_r.x0) / 2.0 - mean_pos,
        y0=0.0,
        popt_x=mean_r.popt_x,
        popt_y=mean_r.popt_y,
    )
    return AxisResult(measurement=meas, mean_fit=mean_fit, beam_fits=beam_fits,
                      beam_fits_left=fits_l, beam_fits_right=fits_r)


def compute_curve_fits(center_frequencies: np.ndarray, fits_x: Optional[BeamWidthFits],
                       fits_y: Optional[BeamWidthFits]) -> Optional[CurveFits]:
    """(``app.rs:912-962``) A single-axis measurement serves both axes."""
    if fits_x is not None and fits_y is not None:
        wx = np.abs(fits_x.popt_xs[:, 1])
        wy = np.abs(fits_y.popt_ys[:, 1])
        x0 = fits_x.popt_xs[:, 0]
        y0 = fits_y.popt_ys[:, 0]
    elif fits_x is not None:
        wx = wy = np.abs(fits_x.popt_xs[:, 1])
        x0 = y0 = fits_x.popt_xs[:, 0]
    elif fits_y is not None:
        wx = wy = np.abs(fits_y.popt_ys[:, 1])
        x0 = y0 = fits_y.popt_ys[:, 0]
    else:
        return None
    try:
        return CurveFits.fit_from_data(center_frequencies, wx, wy, x0, y0)
    except ValueError:
        return None


def compute_psf(
    x_meas: Optional[KnifeEdgeMeasurement],
    y_meas: Optional[KnifeEdgeMeasurement],
    filter_params: FilterParams,
    fit_params: Optional[BeamFitParams] = None,
    progress: Callable[[str, int, int], bool] = lambda _a, _c, _t: True,
    device=None,
) -> Optional[PsfComputeResult]:
    """The full PSF computation (``app.rs:415-757``) with its band filtering
    on ``device``. ``progress(axis, cur, total)`` returning False cancels;
    returns None when cancelled."""
    device = resolve_device(device)
    fit_params = fit_params or BeamFitParams()
    meas = x_meas if x_meas is not None else y_meas
    if meas is None:
        raise ValueError("no measurements given")

    taps, centers = create_filter_bank(
        filter_params.n_filters,
        filter_params.start_freq,
        filter_params.end_freq,
        filter_params.win_width,
        meas.times,
        low_cut=filter_params.low_cut,
        high_cut=filter_params.high_cut,
        spacing=filter_params.frequency_spacing,
    )

    results: list[Optional[AxisResult]] = []
    for axis_name, m in (("x", x_meas), ("y", y_meas)):
        if m is None:
            results.append(None)
            continue
        # both halves report into one 2 * n_filters progress bar
        counter = {"n": 0}

        def axis_progress(_cur, total, _axis=axis_name, _counter=counter):
            _counter["n"] += 1
            return progress(_axis, _counter["n"], total * 2)

        res = _fit_axis(m, taps, fit_params, axis_progress, device)
        if res is None:
            return None
        results.append(res)

    x_res, y_res = results
    curve_fits = compute_curve_fits(centers, x_res.beam_fits if x_res else None,
                                    y_res.beam_fits if y_res else None)
    warnings = []
    w = check_transition_width(filter_params.start_freq, filter_params.end_freq,
                               filter_params.win_width)
    if w:
        warnings.append(w)
    return PsfComputeResult(filters=taps, center_frequencies=centers, x=x_res, y=y_res,
                            curve_fits=curve_fits, warnings=warnings)


class PsfToolApp:
    """Threaded orchestration with the parameter-hash recompute,
    cancellation and stale-result guards (``app.rs:155-413,759-840``).
    Parameters persist only when ``persist_dir`` is given."""

    def __init__(self, persist_dir: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.filter_params = FilterParams()
        self.fit_params = BeamFitParams()
        self.x_path: Optional[str] = None
        self.y_path: Optional[str] = None
        self._persist_dir = persist_dir
        if persist_dir is not None:
            st = PsfToolState.load(persist_dir)
            self.x_path = st.knife_edge_x_path or None
            self.y_path = st.knife_edge_y_path or None
            self.filter_params = FilterParams(
                n_filters=st.n_filters, low_cut=st.low_cut, high_cut=st.high_cut,
                start_freq=st.start_freq, end_freq=st.end_freq, win_width=st.win_width,
                frequency_spacing=st.frequency_spacing)
            self.fit_params = BeamFitParams(
                w_max=st.w_max, use_monotonicity_constraint=st.use_monotonicity_constraint)
        self.result: Optional[PsfComputeResult] = None
        self.diagnostics: Optional[DiagnosticResults] = None
        self.error: Optional[str] = None
        self.progress: dict[str, tuple[int, int]] = {}
        self._run_id = 0
        self._cancel = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._threads: list[threading.Thread] = []  # every live run
        self._start_lock = threading.Lock()
        self._atexit_registered = False
        self._lock = threading.Lock()
        self._last_params_hash: Optional[int] = None
        self.on_complete: list[Callable[[PsfComputeResult], None]] = []

    # ------------------------------------------------------------------
    def _params_hash(self) -> int:
        return hash((self.x_path, self.y_path, dataclasses.astuple(self.filter_params),
                     dataclasses.astuple(self.fit_params)))

    def should_compute(self) -> bool:
        """(``app.rs:358-366``) a path is set and no run is in flight."""
        running = self._thread is not None and self._thread.is_alive()
        return bool(self.x_path or self.y_path) and not running

    def maybe_recompute(self) -> bool:
        """Start a recompute if the parameters changed since the last run
        (the reference's per-frame parameter-hash trigger,
        ``app.rs:1043-1049``); while a run is in flight it waits."""
        if self._params_hash() == self._last_params_hash or not self.should_compute():
            return False
        self.start_computation()
        return True

    def save_state(self):
        """Persist the parameters (``app.rs:33-69``) when asked to."""
        if self._persist_dir is None:
            return
        f, b = self.filter_params, self.fit_params
        try:
            PsfToolState(
                knife_edge_x_path=self.x_path or "", knife_edge_y_path=self.y_path or "",
                n_filters=f.n_filters, low_cut=f.low_cut, high_cut=f.high_cut,
                start_freq=f.start_freq, end_freq=f.end_freq, win_width=f.win_width,
                frequency_spacing=f.frequency_spacing, w_max=b.w_max,
                use_monotonicity_constraint=b.use_monotonicity_constraint,
            ).save(self._persist_dir)
        except OSError:  # the directory is not writable: keep running
            pass

    def start_computation(self):
        """Cancel any run in flight and start a new one from a snapshot of
        the parameters (``app.rs:367-413``), under a lock so concurrent
        callers cannot interleave the cancel, the run id and the thread."""
        with self._start_lock:
            self.save_state()
            self.cancel()
            self._cancel = threading.Event()
            self._run_id += 1
            run_id = self._run_id
            cancel = self._cancel
            self._last_params_hash = self._params_hash()
            snapshot = (self.x_path, self.y_path, dataclasses.replace(self.filter_params),
                        dataclasses.replace(self.fit_params))
            self.progress = {}
            if not self._atexit_registered:
                # a compute thread inside a device call at interpreter exit
                # must be cancelled and joined before teardown
                import atexit

                atexit.register(self._shutdown)
                self._atexit_registered = True
            self._threads = [t for t in self._threads if t.is_alive()]
            self._thread = threading.Thread(
                target=self._compute, args=(run_id, cancel, self.device, *snapshot),
                daemon=True)
            self._threads.append(self._thread)
            self._thread.start()

    def _shutdown(self):
        """Cancel and join every live compute thread, a superseded one too.
        The cancel happens under the start lock, so no new uncancelled run
        can start between it and the joins."""
        with self._start_lock:
            self.cancel()
            threads = list(self._threads)
        for t in threads:
            if t.is_alive():
                t.join(timeout=5.0)

    def cancel(self):
        self._cancel.set()

    def clamp_filter_params(self):
        """Constrain the band start/end frequencies by the filter cuts
        (``app.rs:1201-1226``)."""
        f = self.filter_params
        min_f = max(f.low_cut + 0.01, 0.01)
        f.start_freq = float(min(max(f.start_freq, min_f), f.high_cut))
        f.end_freq = float(min(max(f.end_freq, min_f), min(f.high_cut - 0.01, 20.0)))

    def reset_parameters(self):
        """Every parameter and cached result back to the defaults, the
        measurement paths kept (``app.rs:316-340``); a run in flight is
        cancelled and the recompute trigger re-armed."""
        with self._start_lock:
            self.cancel()
            self.filter_params = FilterParams()
            self.fit_params = BeamFitParams()
            with self._lock:
                self.result = None
                self.diagnostics = None
                self.error = None
            self.progress = {}
            self._last_params_hash = None
            self.save_state()

    def wait(self, timeout: Optional[float] = None):
        t = self._thread
        if t is not None:
            t.join(timeout)

    def _compute(self, run_id: int, cancel: threading.Event, device,
                 x_path: Optional[str], y_path: Optional[str],
                 filter_params: FilterParams, fit_params: BeamFitParams):
        try:
            x_meas = KnifeEdgeMeasurement.from_thz_file(x_path) if x_path else None
            y_meas = KnifeEdgeMeasurement.from_thz_file(y_path) if y_path else None
            if x_meas is None and y_meas is None:
                raise ValueError("No files selected")

            def progress(axis, cur, total):
                # a superseded run must not overwrite the new run's bars
                if run_id == self._run_id:
                    self.progress[axis] = (cur, total)
                return not cancel.is_set()

            result = compute_psf(x_meas, y_meas, filter_params, fit_params, progress, device)
        except Exception as e:  # noqa: BLE001 - reported as the tool's error
            with self._lock:
                if run_id == self._run_id and not cancel.is_set():
                    self.error = str(e)
            return
        with self._lock:
            if run_id != self._run_id or cancel.is_set():
                return  # a stale Complete from a cancelled run is dropped
            self.result = result
            self.error = None
            if result is not None and result.curve_fits is not None:
                self._update_diagnostics(result)
            else:
                self.diagnostics = None
            for cb in self.on_complete:
                cb(result)

    def _update_diagnostics(self, result: PsfComputeResult):
        """(``app.rs:964-978``): diagnostics over 200 points 0.1-10 THz of
        the fitted width curves."""
        freqs = 0.1 + np.arange(200) / 199.0 * 9.9
        w0x = result.curve_fits.wx_fit.evaluate(freqs)
        w0y = result.curve_fits.wy_fit.evaluate(freqs)
        try:
            self.diagnostics = DiagnosticResults.compute(freqs, w0x, w0y)
        except ValueError:
            self.diagnostics = None

    # ------------------------------------------------------------------
    def runtime_psf(self) -> Optional[PSF]:
        """The ApplyPSF payload (``app.rs:214-217``) for
        ``Explorer.apply_psf``."""
        if self.result is None or self.result.curve_fits is None:
            return None
        return self.result.curve_fits.to_runtime_psf()

    def export_npz(self, path: str) -> bool:
        """Export the fitted curves in the 28-key schema
        (``psf_tool/export.rs``) through ``io/psf_npz.save_psf``."""
        from thz_image_explorer_tpu_torch.io.psf_npz import save_psf

        psf = self.runtime_psf()
        if psf is None:
            return False
        save_psf(path, psf)
        return True
