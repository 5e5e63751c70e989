"""Incremental per-stage pipeline executor.

Port of the exact per-stage mode of
``thz_image_explorer_tpu/pipeline/executor.py`` (reference ``main_thread``,
``data_thread.rs:1080-1228``): an ordered stage chain over one cached
output cube per stage (a "slot"), re-executed from the first dirty stage
onward. Every slot stays materialized on the device; an inactive stage
passes its input cube object through, so pass-through slots share their
tensors instead of copying them.

Contracts kept:

* stages upstream of the dirty index keep their cached outputs;
* inactive stages are identity (``data_thread.rs:1185-1188``);
* a stage that changes the time-axis length (tilt compensation) gets a
  recomputed frequency axis and zero spectra of the new length
  (``data_thread.rs:1194-1227``); the host axis comes from the stage's
  ``host_time_out``, never from the device;
* per-stage compute times (``filter_computation_time_lock``), here from
  CUDA events read after one synchronize;
* the deconvolution-rerun suppression (``data_thread.rs:1139-1150``): a
  run requested from index ``k`` re-runs the deconvolution only when no
  other filter stage, active or not, lies at or after ``k``, unless the
  run is forced (Apply, Calculate All). A suppressed deconvolution passes
  its input through and keeps its last ms.

On a mesh (``Pipeline(mesh=)``, ``parallel.mesh``) the pipeline holds one
rank's block of a pixel-sharded cube (``parallel.shard_cube``,
``open_scan_sharded`` or ``open_arrays_sharded``) and every stage runs on
it: the per-pixel stages as they are, the downscale and the iFFT's pixel
means with their collectives, tilt at the block's origin, the
deconvolution as ``deconvolve_cube``'s sharded form. Every slot is the
mesh's block of its grid. Each rank runs the same commands in the same
order, so every rank enters the same collectives; a mesh of one rank gives
the single-device values bit for bit. ``current_image`` is the whole image
on every rank; ``raw_fd_view``, ``spectral_source`` and ``timings_ms`` are
the rank's own. The JAX package reaches the same through XLA's SPMD
partitioner on a cube placed by its ``parallel.mesh.shard_cube``.

The JAX package's fused/lean/click programs, compile cache and async
probes were TPU workarounds and are not ported.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch import kernels
from thz_image_explorer_tpu_torch.data import ScanCube, frequency_axis, resolve_device
from thz_image_explorer_tpu_torch.ops.fourier import forward_fft, inverse_fft
from thz_image_explorer_tpu_torch.ops.intensity import intensity_image, upscale_image
from thz_image_explorer_tpu_torch.ops.scaling import scale_cube
from thz_image_explorer_tpu_torch.ops.windows import WindowType
from thz_image_explorer_tpu_torch.parallel.mesh import Mesh, check_rank_block, grid_gather
from thz_image_explorer_tpu_torch.pipeline.stage import (
    FilterStage,
    StageContext,
    build_chain,
    instantiate_filters,
)
from thz_image_explorer_tpu_torch.utils import spans

log = logging.getLogger(__name__)


class PipelineConfig:
    """Processing configuration (``ConfigContainer``, ``config.rs:171-213``)."""

    def __init__(self):
        self.fft_window = [1.0, 7.0]
        self.fft_window_type = WindowType.ADAPTED_BLACKMAN
        self.scale_factor = 1
        self.avg_in_fourier_space = False
        #: plot settings the reference stores with the processing config
        #: (``config.rs:171-213``); the chain does not read them
        self.fft_log_plot = False
        self.fft_df = 1.0


class Pipeline:
    """Ordered stage chain with dirty-index incremental recompute on one
    device, over a whole cube or (with ``mesh``) one rank's block of a
    pixel-sharded cube. ``run_epoch`` changes with every chain run, so
    consumers can cache what they derive from the slots."""

    def __init__(self, device="cuda",
                 filters: Optional[dict[str, FilterStage]] = None,
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.filters: dict[str, FilterStage] = (
            filters if filters is not None else instantiate_filters()
        )
        self.chain, self.scaling_index, self.fft_index, self.ifft_index = (
            build_chain(self.filters)
        )
        self.slots: list[Optional[ScanCube]] = [None] * len(self.chain)
        self.config = PipelineConfig()
        self.run_epoch = 0
        #: host copy of each slot's time axis (parameter clamping reads it
        #: without a device->host copy per update)
        self._host_time: dict[int, np.ndarray] = {}
        #: chain index -> the FD weight vector that stage applied in its
        #: last run (None: an active FD stage without ``fd_weight_vector``)
        self._fd_weights: dict[int, Optional[torch.Tensor]] = {}
        self._timings_ms: dict[str, float] = {}
        #: (stage, timer) of the last run's stages, read by ``timings_ms``
        self._pending_timers: list = []
        #: valid (width, height) of slot 0
        self.valid_wh0: Optional[tuple[int, int]] = None
        #: the PSF model the deconvolution uses (``models.psf.PSF``), set
        #: by ``Explorer.open_psf`` / ``apply_psf``
        self.psf = None
        #: polled by long stages (the deconvolution) between groups of work
        self.cancelled: Callable[[], bool] = lambda: False
        #: uuid -> progress of the stage's running apply (None when idle)
        self.progress: dict[str, Optional[float]] = {uuid: None for uuid in self.filters}

    @property
    def phase(self) -> Optional[str]:
        """"building" while ``kernels.build`` compiles a source (at a
        kernel's first use, or the shell's ``--precompile``), else None:
        the counterpart of the JAX package's "compiling" phase."""
        return "building" if kernels.building() else None

    # ------------------------------------------------------------------
    def index_of(self, uuid: str) -> int:
        return self.chain.index(uuid)

    @property
    def input(self) -> Optional[ScanCube]:
        return self.slots[0]

    @property
    def output(self) -> Optional[ScanCube]:
        return self.slots[-1]

    def raw_fd_view(self) -> Optional[ScanCube]:
        """The slot the reference publishes its "raw" spectrum from: the
        output of stage ``fft_index + 1`` (``data_thread.rs:1365-1380``)."""
        return self.slots[min(self.fft_index + 1, len(self.slots) - 1)]

    def valid_for(self, cube: ScanCube) -> Optional[tuple[int, int]]:
        """Valid (width, height) of a pipeline cube: slot 0's valid region
        divided by the cube's downscale factor."""
        if self.valid_wh0 is None:
            return None
        s = cube.scaling
        return (max(self.valid_wh0[0] // s, 1), max(self.valid_wh0[1] // s, 1))

    # ------------------------------------------------------------------
    def set_input(self, cube: ScanCube, *, reset_filters: bool = True):
        """Load a new scan: fill slot 0, reset filters, run the chain
        (``data_thread.rs:717-720`` + ``reset_filters`` at ``:1027-1060``).
        On a mesh ``cube`` is this rank's block; a block that is not this
        rank's, and a whole cube on a mesh of several ranks, raise
        ``ValueError``."""
        if cube.device != self.device:
            raise ValueError(f"cube on {cube.device}, pipeline on {self.device}")
        if self.mesh is not None:
            check_rank_block(cube, self.mesh)
        self.slots = [cube] + [None] * (len(self.chain) - 1)
        time = cube.time.cpu().numpy()
        self._host_time = {0: time}
        self._fd_weights = {}
        self.valid_wh0 = tuple(cube.valid_wh)
        if reset_filters:
            shape = (*cube.grid_wh, cube.n_time)
            for f in self.filters.values():
                f.reset(time, shape)
        self.run_from(1)

    def run_from(self, start_idx: int, force_all: bool = False):
        """Re-execute ``chain[start_idx:]`` from the cached slot before it.
        ``force_all`` lifts the deconvolution-rerun suppression (Apply,
        Calculate All). The rule is keyed on the requested start: any
        other filter stage in the range, active or not, suppresses the
        deconvolution (``data_thread.rs:1139-1149``)."""
        self.run_epoch += 1
        self._pending_timers = []
        run_deconvolution = True
        with spans.span("executor.run"):
            for i in range(max(start_idx, 1), len(self.chain)):
                name = self.chain[i]
                inp = self.slots[i - 1]
                if inp is None or inp.time.shape[0] == 0:
                    log.warning("input for stage %s is empty; skipping", name)
                    continue
                stage = self.filters.get(name)
                if stage is not None and not stage.is_deconvolution:
                    run_deconvolution = False
                # the stage's span reads the same timer as timings_ms
                timer = spans.Timer(self.device)
                with spans.span("stage." + name, timer=timer) as stage_span:
                    out = self._run_stage(i, name, inp, run_deconvolution or force_all)
                    if out is inp:
                        stage_span.discard()  # a pass-through: the stage did not run
                    else:
                        self._stop_timer(name, timer)
                if out.n_time != inp.n_time:
                    time = stage.host_time_out(self._host_time[i - 1], inp, self.valid_for(inp))
                    if time.shape[0] != out.n_time:
                        raise ValueError(f"stage {name!r} gave {out.n_time} samples, its "
                                         f"host_time_out {time.shape[0]}")
                    out = self._replan(out)
                    self._host_time[i] = time
                else:
                    self._host_time[i] = self._host_time[i - 1]
                self.slots[i] = out

    def _run_stage(self, i: int, name: str, inp: ScanCube,
                   run_deconvolution: bool) -> ScanCube:
        cfg = self.config
        if name == "scaling":
            return scale_cube(inp, cfg.scale_factor, valid_wh=self.valid_for(inp), mesh=self.mesh)
        if name == "fft":
            return forward_fft(inp, cfg.fft_window_type, cfg.fft_window[0],
                               cfg.fft_window[1])
        if name == "ifft":
            return inverse_fft(inp, cfg.avg_in_fourier_space, self.mesh)
        stage = self.filters[name]
        in_fd = self.fft_index < i < self.ifft_index
        if not stage.active or (stage.is_deconvolution and not run_deconvolution):
            self._fd_weights.pop(i, None)
            return inp  # identity pass-through: the slot shares the tensors
        stage.clamp_params(inp, self._host_time[i - 1])
        out = stage.apply(inp, StageContext(
            progress=self._progress_setter(name), cancelled=self.cancelled,
            psf=self.psf, valid_wh=self.valid_for(inp), time=self._host_time[i - 1],
            mesh=self.mesh,
        ))
        if in_fd:
            weight = getattr(stage, "fd_weight_vector", None)
            self._fd_weights[i] = None if weight is None else weight(inp.freq)
        return out

    def _progress_setter(self, uuid: str) -> Callable[[Optional[float]], None]:
        def setter(value: Optional[float]):
            self.progress[uuid] = value

        return setter

    @staticmethod
    def _replan(cube: ScanCube) -> ScanCube:
        """Frequency-axis recompute + zero spectra of the new length after a
        time-length change (``data_thread.rs:1194-1227``). Nothing reads
        these spectra: the next FFT stage replaces them, and the publish
        reads only slots at and after it. So they are zero scalars expanded
        to the cube's shape, which allocate nothing (three zeroed cubes
        would be ≈ 477 MB at 200x200 and F = 745, on every tilt step)."""
        freq = frequency_axis(cube.time)
        shape = (cube.width, cube.height, freq.shape[0])
        dev = cube.device

        def zeros(dtype, *size):
            return torch.zeros((), dtype=dtype, device=dev).expand(*size)

        return cube.replace(
            freq=freq,
            fft=zeros(torch.complex64, *shape),
            amplitudes=zeros(torch.float32, *shape),
            phases=zeros(torch.float32, *shape),
            avg_data=zeros(torch.float32, cube.n_time),
            avg_fft=zeros(torch.complex64, freq.shape[0]),
            avg_signal_fft=zeros(torch.float32, freq.shape[0]),
            avg_phase_fft=zeros(torch.float32, freq.shape[0]),
        )

    # ------------------------------------------------------------ timings
    def _stop_timer(self, name: str, timer: spans.Timer):
        timer.stop()
        if self.device.type == "cuda":
            self._pending_timers.append((name, timer))
        else:
            self._timings_ms[name] = timer.ms()

    @property
    def timings_ms(self) -> dict[str, float]:
        """Per-stage compute time of each stage's last real run, in ms
        (pass-throughs keep their last value). On CUDA the events of the
        last run are read here, after one synchronize."""
        if self._pending_timers:
            for name, timer in self._pending_timers:
                self._timings_ms[name] = timer.ms()
            self._pending_timers = []
        return dict(self._timings_ms)

    # ------------------------------------------------------------------
    def spectral_source(self) -> tuple[ScanCube, torch.Tensor]:
        """What the publish's one-pass reduction reads: the FFT stage's
        slot (raw spectrum: post-window, before the FD stages) and the
        product of the weight vectors the active FD stages applied.

        FD stages weight amplitudes but leave phases alone, so the
        published phases must come from the raw spectrum; that only holds
        when every active FD stage is a per-frequency multiply. A stage
        without ``fd_weight_vector`` breaks the contract and is refused."""
        spec = self.slots[self.fft_index]
        w = torch.ones(spec.n_freq, dtype=torch.float32, device=spec.device)
        for i in range(self.fft_index + 1, self.ifft_index):
            if i not in self._fd_weights:
                continue
            wi = self._fd_weights[i]
            if wi is None:
                raise NotImplementedError(
                    f"active frequency-domain stage {self.chain[i]!r} has no "
                    "fd_weight_vector: the publish reduces the raw spectrum "
                    "and factors every FD stage out as a per-frequency weight"
                )
            w = w * wi
        return spec, w

    # ------------------------------------------------------------------
    def update_filter(self, uuid: str, force: bool = False):
        """Incremental recompute from one filter's position
        (``UpdateFilter``, ``data_thread.rs:907-921``); ``force`` is the
        Apply button's path."""
        self.run_from(self.index_of(uuid), force_all=force)

    def update_all(self):
        """Calculate All: the whole chain, the deconvolution included."""
        self.run_from(1, force_all=True)

    def materialize_output(self) -> Optional[ScanCube]:
        """The final slot with its time-domain data and its spectra
        (``fft``, ``amplitudes``, ``phases``), for inspection (the
        ``show_data`` hook, export). Every slot of this executor holds them
        (each stage materializes its output; there is no lean program that
        drops the final spectra, as the JAX package's has), so this returns
        the slot itself: nothing is recomputed or launched, no stage's ms
        changes, and the deconvolution is not run again."""
        return self.output

    def current_image(self) -> Optional[np.ndarray]:
        """Intensity image of the final stage, block-upscaled to the
        original grid when downscaled (``data_thread.rs:1242-1308``) and
        cropped to slot 0's valid region. On a mesh, the whole image on
        every rank: the blocks' images joined by one ``grid_gather``."""
        out = self.output
        if out is None:
            return None
        img = intensity_image(out.data)
        if self.mesh is not None:
            img = grid_gather(img, self.mesh, out.grid_wh, out.origin)
        if out.scaling > 1:
            img = upscale_image(img, out.scaling)
        img = img.cpu().numpy()
        if self.valid_wh0 is not None:
            img = img[: self.valid_wh0[0], : self.valid_wh0[1]]
        return img
