"""The plain reference of the benchmark: plain PyTorch and numpy that
imports neither JAX nor the JAX package nor anything of the program.

:class:`Reference` makes the scan again from the seed (``portbench.scan``)
and gives the published series of any session state, and its chain's
slots and final cube for the outputs' own references
(``portbench/outputs/``); the comparison that decides ``correct`` is
``portbench.check``.
"""

from __future__ import annotations

import torch

from portbench import scan
from portbench.reference import chain, deconv
from portbench.reference.numerics import Numerics


def state_key(state: dict) -> tuple:
    return (float(state["fft_window_low"]), float(state.get("fft_window_high", 7.0)),
            None if state.get("tilt") is None else tuple(float(a) for a in state["tilt"]))


class Reference:
    """The published series of a configuration's session for one seed, in
    float64 (or, as the control, in TF32: ``tf32=True``)."""

    def __init__(self, cfg: dict, seed: int, device, tf32: bool = False):
        self.cfg = cfg
        self.num = Numerics(device, tf32)
        self.time, raw = scan.make_scan(cfg, seed, device)
        self.time = self.time.numpy()
        self.raw = raw
        self.pixel = scan.selected_pixel(cfg, seed)
        self._slots_key, self._slots = None, None
        self._published: dict = {}

    def slots(self, state: dict) -> dict:
        """The chain's slots in ``state`` (``chain.chain``); those of the
        last state are kept for the next call."""
        if self._slots_key != state_key(state):
            self._slots = None
            self._slots = chain.chain(self.raw, self.time, self.cfg, state, self.num)
            self._slots_key = state_key(state)
        return self._slots

    def final(self, state: dict) -> tuple[torch.Tensor, object]:
        """``(the final (X, Y, T) cube, its time axis)`` in ``state``: the
        chain's last slot, deconvolved where the state says an Apply ran."""
        sl = self.slots(state)
        final = sl["final"]
        if state.get("deconvolved"):
            final = deconv.deconvolve(final, sl["time"], self.cfg, self.num)
        return final, sl["time"]

    def published(self, state: dict) -> dict:
        """Every series the Explorer publishes in ``state`` (host float64)."""
        key = state_key(state) + (bool(state.get("deconvolved")),)
        out = self._published.get(key)
        if out is None:
            out = chain.published(self.raw, self.time, self.cfg, state, self.pixel, self.num,
                                  slots=self.slots(state))
            self._published[key] = out
        return out

    def close(self):
        self._slots = self.raw = None
        if self.num.device.type == "cuda":
            torch.cuda.empty_cache()
