"""Filter-stage protocol, domain ordering and registry.

Port of ``thz_image_explorer_tpu/pipeline/stage.py`` (reference
``filters/filter.rs`` + the ``filter_macros`` crate): a stage is a
function ``cube -> cube`` over its parameters, wrapped in a class that
carries identity and metadata; ``@register_filter`` fills a registry.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import numpy as np

from thz_image_explorer_tpu_torch.data import ScanCube


class FilterDomain(enum.IntEnum):
    """Chain ordering domains (``filters/filter.rs:231-243``). The enum
    order is the chain order."""

    TIME_BEFORE_FFT_PRIO_FIRST = 0
    TIME_BEFORE_FFT = 1
    FREQUENCY = 2
    TIME_AFTER_FFT = 3
    TIME_AFTER_FFT_PRIO_LAST = 4


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Display metadata (``filters/filter.rs:84-93``)."""

    name: str
    description: str
    domain: FilterDomain
    hyperlink: Optional[tuple[Optional[str], str]] = None


class FilterStage:
    """Base class for pipeline filter stages.

    Subclasses define ``config()`` and ``apply(cube, context) -> cube``
    (which returns a new cube and leaves its input as it is), plus
    parameter attributes. ``active`` is the per-filter on/off toggle; an
    inactive stage is identity (``data_thread.rs:1185-1188``).

    A FREQUENCY stage is its ``fd_weight_vector(freq)``: its whole effect
    is that per-frequency weight on the complex spectrum and the
    amplitudes, the phases left alone. The executor builds it once a run,
    applies it (``ops/bandpass.weigh_spectrum``) in place of ``apply``,
    and the publish factors the same tensor out of its raw-spectrum sums.
    So an ``apply`` written beside it is not called by the executor; the
    built-in FD stages' ``apply`` is that same product. A FREQUENCY stage
    without ``fd_weight_vector`` runs its ``apply``, and the publish
    refuses it (``NotImplementedError``).
    """

    #: stable identifier used in the chain and the command API
    uuid: str = ""
    active: bool = True
    #: marks the deconvolution stage: it runs only on an explicit Apply and
    #: is subject to the executor's rerun-suppression rule
    #: (``data_thread.rs:1139-1150``). A class attribute, not a name match,
    #: so an extension named "Deconvolution ..." stays a normal filter.
    is_deconvolution: bool = False

    def config(self) -> FilterConfig:
        raise NotImplementedError

    def reset(self, time: np.ndarray, shape: tuple[int, ...]) -> None:
        """Called when a new scan is loaded (``data_thread.rs:1027-1060``)."""

    def clamp_params(self, cube: ScanCube, time: np.ndarray) -> None:
        """Clamp range-dependent parameters persistently against the
        stage's input, right before ``apply`` (the reference clamps inside
        ``filter``, e.g. ``band_pass_td_before_fft.rs:134-138``). ``time``
        is the host copy of ``cube.time``."""

    def apply(self, cube: ScanCube, context: "StageContext") -> ScanCube:
        raise NotImplementedError

    def host_time_out(self, time: np.ndarray, cube: ScanCube,
                      valid_wh: Optional[tuple[int, int]]) -> np.ndarray:
        """The host copy of the time axis ``apply`` gives ``cube`` (whose
        host axis is ``time``). Only a stage that changes the axis's length
        overrides it: the executor replans from it without reading the new
        axis back from the device."""
        return time

    def show_data(self, cube: ScanCube, pixel: tuple[int, int]) -> None:
        """Update host-side preview caches for the UI (the reference's
        ``#[static_field]`` copy-back, ``data_thread.rs:1322-1334``). A
        no-op here: ``Explorer.set_selected_pixel`` calls it only on stages
        whose class overrides it, with the final slot (data and spectra,
        ``Pipeline.materialize_output``) and the pixel in that slot's
        downscaled coordinates."""

    def param_owner(self, key: str) -> Optional[object]:
        """The object that holds parameter ``key``: the stage's ``params``
        dataclass when it has that field (the deconvolution's), else the
        stage when it has the attribute, else None."""
        params = getattr(self, "params", None)
        if params is not None and hasattr(params, key):
            return params
        return self if hasattr(self, key) else None

    @property
    def name(self) -> str:
        return self.config().name

    @property
    def domain(self) -> FilterDomain:
        return self.config().domain


@dataclasses.dataclass
class StageContext:
    """Per-run services handed to stages: progress reporting (a fraction,
    None when done), cooperative cancellation, the PSF the deconvolution
    uses (the reference routes it through ``gui_settings.psf``), the
    valid (width, height) of the stage's input, the host copy of its
    time axis, and the mesh (``parallel.mesh.Mesh``) whose rank's block the
    stage runs on (None: a whole cube on one device)."""

    progress: Callable[[Optional[float]], None] = lambda _f: None
    cancelled: Callable[[], bool] = lambda: False
    psf: Optional[object] = None
    valid_wh: Optional[tuple[int, int]] = None
    time: Optional[np.ndarray] = None
    mesh: Optional[object] = None

    def check_cancel(self) -> bool:
        return self.cancelled()


_REGISTRY: dict[str, type] = {}


def register_filter(cls):
    """Class decorator: register a stage type under its slug uuid. Only a
    uuid declared on the class itself counts, so a subclass never takes
    over its parent's key (``filter_macros/src/lib.rs:45-69``)."""
    uuid = cls.__dict__.get("uuid") or _slug(cls.__name__)
    existing = _REGISTRY.get(uuid)
    if existing is not None and existing is not cls:
        raise ValueError(
            f"filter uuid {uuid!r} already registered by {existing.__name__}; "
            f"declare a distinct `uuid` on {cls.__name__}"
        )
    cls.uuid = uuid
    _REGISTRY[uuid] = cls
    return cls


def _slug(name: str) -> str:
    """CamelCase -> snake_case, keeping acronym runs together
    (``TimeBandPassBeforeFFT`` -> ``time_band_pass_before_fft``)."""
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0 and (
            not name[i - 1].isupper()
            or (i + 1 < len(name) and name[i + 1].islower())
        ):
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


def registered_filters() -> dict[str, type]:
    """A copy of the registry: uuid -> stage class."""
    return dict(_REGISTRY)


def instantiate_filters() -> dict[str, FilterStage]:
    """Fresh instances of every registered stage, uuid-keyed."""
    return {uuid: cls() for uuid, cls in _REGISTRY.items()}


def build_chain(filters: dict[str, FilterStage]) -> tuple[list[str], int, int, int]:
    """The ordered stage chain and the scaling/fft/ifft indices
    (``main.rs:178-268``): ``[initial, scaling, <PrioFirst...>,
    <TimeBeforeFFT...>, fft, <Frequency...>, ifft, <TimeAfterFFT...>,
    <PrioLast...>]``."""
    by_domain: dict[FilterDomain, list[str]] = {d: [] for d in FilterDomain}
    for uuid, f in filters.items():
        by_domain[f.domain].append(uuid)
    for d in by_domain:
        by_domain[d].sort()

    chain = ["initial", "scaling"]
    chain += by_domain[FilterDomain.TIME_BEFORE_FFT_PRIO_FIRST]
    chain += by_domain[FilterDomain.TIME_BEFORE_FFT]
    fft_index = len(chain)
    chain.append("fft")
    chain += by_domain[FilterDomain.FREQUENCY]
    ifft_index = len(chain)
    chain.append("ifft")
    chain += by_domain[FilterDomain.TIME_AFTER_FFT]
    chain += by_domain[FilterDomain.TIME_AFTER_FFT_PRIO_LAST]
    return chain, 1, fft_index, ifft_index
