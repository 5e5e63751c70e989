"""view3d: the page's live 3-D view (``WebApp.voxels``), judged against the
plain reference's voxels (``portbench/reference/voxel.py``).

The page's answer is ``n``, ``threshold``, ``extent`` and, as base64, the
voxels' (n, 3) f32 positions and (n, 4) uint8 rgba. Each voxel is decoded
back to its (x, y, t) through the reference's geometry; the reference
computes every opacity of the final cube in the step's state (its contrast,
sigma, radius, opacity threshold and ``max_points``, under the state key
``view3d``) and its ``max_points``-th largest opacity, as low as ``r_lo``
where traces within rounding of the threshold are dropped.

The page sends 6-bit opacities (``q / 63``, rounded) for a cube under 2**26
voxels and float16 ones above, each made uint8 (``trunc(255 alpha)``) with the
rgb; a voxel of opacity under half a step (packed) or a float16 zero is not
drawn. Where the reference's own rounding cannot decide (a trace's envelope
maximum within ``TRACE_BAND`` of the opacity threshold), either answer is
legal. The numbers, each the widest over the sampled views:

``view_count_gap``
    how far ``n`` lies outside the counts the reference allows (its top
    ``max_points`` that the page draws), over ``max_points``. Exact: a view
    that draws too few or too many voxels.
``view_set_gap``
    the share (of ``max_points``) of the page's voxels that are not among
    the largest: their reference opacity lies below ``r_lo`` by more than
    ``BAND``, or their position decodes to no voxel, or to one already
    drawn. Ties at the top (every kept trace has one voxel at exactly 1)
    are legal in any order, so this is no comparison of sets.
``view_alpha_gap``
    the widest distance of a voxel's page opacity outside the rounding of
    its reference opacity, in steps of 1/63: ``|q - 63 alpha| - 0.5``
    (packed; plus any uint8 code that is not ``q``'s), or the distance of
    the reference opacity from ``[a, a + 1) / 255`` widened by float16's
    rounding (float16).

The voxels' rgb (the jet map) is not compared.
"""

from __future__ import annotations

import base64
import math

import numpy as np
import torch

from portbench.reference import voxel
from portbench.reference.numerics import Numerics

NUMBERS = ("view_count_gap", "view_set_gap", "view_alpha_gap")
#: cubes of fewer voxels are sent with 6-bit opacities (the page's format)
PACKED_BELOW = 2 ** 26
ALPHA_STEPS = 63
#: the opacity band within which an order among voxels is rounding
BAND = 2e-4
#: the relative band of a trace's envelope maximum (and range) around the
#: opacity threshold (and 1e-6) within which keeping it or not is rounding
TRACE_BAND = 1e-4
#: the relative rounding of a float16 opacity
F16_ROUNDING = 2.0 ** -11
#: how far from a whole voxel index a decoded position may lie
POSITION_TOLERANCE = 1e-2


def capture(result: dict) -> dict:
    """The page's answer as returned (a new dict each call)."""
    return result


# ------------------------------------------------------------- reference
def _view_params(state: dict) -> dict:
    v = state["view3d"]
    return dict(contrast=float(v["contrast"]), sigma=float(v["sigma"]), radius=int(v["radius"]),
                threshold=float(v["threshold"]), max_points=int(v["max_points"]))


def reference(ref, state: dict) -> dict:
    """The reference's view in ``state``: every opacity where its trace may
    be kept, ``r_lo``, the counts the page may draw, the geometry."""
    v = _view_params(state)
    final, time = ref.final(state)
    shape = tuple(final.shape)
    norm, lmax, rng = voxel.envelope(final, v["contrast"], v["sigma"], v["radius"], ref.num)
    thr = v["threshold"]
    sure = (lmax >= thr * (1 + TRACE_BAND)) & (rng > 1e-6 * (1 + TRACE_BAND))
    maybe = (lmax >= thr * (1 - TRACE_BAND)) & (rng > 1e-6 * (1 - TRACE_BAND))
    a_lo = torch.where(sure[:, None], norm, 0.0).reshape(-1)
    a_hi = torch.where(maybe[:, None], norm, 0.0).reshape(-1)
    k = min(v["max_points"], a_lo.numel())
    packed = a_lo.numel() < PACKED_BELOW
    # the smallest opacity the page draws
    drawn = 0.5 / ALPHA_STEPS if packed else 2.0 ** -25
    r_lo = float(torch.topk(a_lo, k).values[-1])
    n_lo = min(k, int((a_lo > drawn + BAND).sum()))
    n_hi = min(k, int((a_hi > drawn - BAND).sum()))
    span = float(time[-1] - time[0]) if len(time) > 1 else 1.0
    geo = voxel.geometry(shape, span, (shape[0], shape[1], ref.raw.shape[2]))
    return dict(a_hi=a_hi, r_lo=r_lo, n_lo=n_lo, n_hi=n_hi, k=k, packed=packed, shape=shape,
                geo=geo)


# ---------------------------------------------------------------- decode
def decode(got: dict, want: dict) -> dict:
    """The page's voxels: flat indices, whether each decodes to a voxel not
    drawn before, uint8 alpha."""
    n = int(got.get("n", 0))
    if n == 0 or "positions" not in got:
        empty = np.zeros(0, np.int64)
        return dict(n=0, idx=empty, valid=empty.astype(bool), alpha=empty)
    pos = np.frombuffer(base64.b64decode(got["positions"]), np.float32).reshape(n, 3)
    rgba = np.frombuffer(base64.b64decode(got["rgba"]), np.uint8).reshape(n, 4)
    (sx, sy, sz), (hx, hy, hz) = want["geo"]["spacing"], want["geo"]["half"]
    pos = pos.astype(np.float64)
    xyz = np.stack([(hx - pos[:, 1]) / sx, (pos[:, 0] + hy) / sy, (hz - pos[:, 2]) / sz], -1)
    whole = np.rint(xyz)
    gx, gy, gz = want["shape"]
    valid = np.all(np.abs(xyz - whole) <= POSITION_TOLERANCE, axis=1)
    valid &= np.all((whole >= 0) & (whole < np.array([gx, gy, gz])), axis=1)
    extent = np.asarray(got.get("extent", [np.nan] * 3), np.float64)
    if not np.allclose(extent, want["geo"]["extent"], rtol=1e-6, atol=0.0):
        valid[:] = False
    whole = np.where(valid[:, None], whole, 0).astype(np.int64)
    idx = (whole[:, 0] * gy + whole[:, 1]) * gz + whole[:, 2]
    first = np.zeros(n, bool)
    first[np.unique(np.where(valid, idx, -1), return_index=True)[1]] = True
    valid &= first
    return dict(n=n, idx=idx, valid=valid, alpha=rgba[:, 3].astype(np.int64))


def _packed_code(q: np.ndarray) -> np.ndarray:
    """The uint8 alpha the page sends for the 6-bit opacity ``q``."""
    return (np.clip((q / np.float32(ALPHA_STEPS)).astype(np.float32), 0, 1)
            * np.float32(255)).astype(np.uint8).astype(np.int64)


def compare(got: dict, want: dict) -> dict:
    """The numbers of one view."""
    dec = decode(got, want)
    k, n = want["k"], dec["n"]
    count_gap = max(0, want["n_lo"] - n, n - want["n_hi"]) / max(k, 1)
    idx, valid = dec["idx"], dec["valid"]
    a_hi = want["a_hi"]
    a_ref = a_hi[torch.as_tensor(idx, device=a_hi.device)].double().cpu().numpy()
    legal = valid & (a_ref >= want["r_lo"] - BAND)
    set_gap = float(n - legal.sum()) / max(k, 1)
    a_ref, alpha = a_ref[valid], dec["alpha"][valid]
    if want["packed"]:
        q = np.rint(alpha * ALPHA_STEPS / 255.0)
        code = np.abs(alpha - _packed_code(q)) * ALPHA_STEPS / 255.0
        excess = np.maximum(0.0, np.abs(q - ALPHA_STEPS * a_ref) - 0.5) + code
    else:
        lo, hi = alpha / 255.0, (alpha + 1) / 255.0
        ref_lo, ref_hi = a_ref * (1 - F16_ROUNDING), a_ref * (1 + F16_ROUNDING)
        excess = ALPHA_STEPS * np.maximum(0.0, np.maximum(lo - ref_hi, ref_lo - hi))
    return dict(view_count_gap=float(count_gap), view_set_gap=set_gap,
                view_alpha_gap=float(excess.max(initial=0.0)))


# --------------------------------------------------------------- control
class _BFloat16(Numerics):
    """bfloat16 throughout: the envelope of the second control."""

    def __init__(self, device):
        super().__init__(device)
        self.dtype = torch.bfloat16


def page_answer(alpha: torch.Tensor, k: int, shape, geo: dict) -> dict:
    """What the page answers for the opacity volume ``alpha`` (flat): its
    ``k`` largest, in the page's format (6-bit or float16 opacities, f32
    positions, uint8 rgba, base64)."""
    vals, idx = torch.topk(alpha.float(), min(k, alpha.numel()))
    thr = max(float(vals[-1]), 0.0)
    idx = idx.cpu().numpy()
    if alpha.numel() < PACKED_BELOW:
        q = torch.clamp(torch.round(vals * ALPHA_STEPS), 0, ALPHA_STEPS).cpu().numpy()
        keep = q >= max(math.floor(thr * ALPHA_STEPS), 1.0)
        op = (q / ALPHA_STEPS).astype(np.float32)
    else:
        op = vals.to(torch.float16).float().cpu().numpy()
        keep = (op >= max(thr, 1e-30)) & (op > 0)
    idx, op = idx[keep], op[keep]
    rgb = voxel.colour(op, thr).astype(np.float32)
    rgba = np.concatenate([rgb, op[:, None]], axis=-1)
    return {"n": int(len(idx)), "threshold": thr, "extent": list(geo["extent"]),
            "positions": base64.b64encode(
                voxel.positions(idx, shape, geo).astype(np.float32).tobytes()).decode(),
            "rgba": base64.b64encode(
                (np.clip(rgba, 0, 1) * np.float32(255)).astype(np.uint8).tobytes()).decode()}


def control(ctl, state: dict, precision: str = "tf32") -> dict:
    """The page's answer with the reference in the program's place: the
    chain in ``ctl``'s arithmetic (the TF32 reference), the envelope in
    it too (``"tf32"``) or in bfloat16 (``"bf16"``)."""
    v = _view_params(state)
    final, time = ctl.final(state)
    shape = tuple(final.shape)
    num = ctl.num if precision == "tf32" else _BFloat16(ctl.num.device)
    norm, lmax, rng = voxel.envelope(final, v["contrast"], v["sigma"], v["radius"], num)
    kept = (lmax >= v["threshold"]) & (rng > 1e-6)
    alpha = torch.where(kept[:, None], norm, 0.0).reshape(-1)
    span = float(time[-1] - time[0]) if len(time) > 1 else 1.0
    geo = voxel.geometry(shape, span, (shape[0], shape[1], ctl.raw.shape[2]))
    return page_answer(alpha, v["max_points"], shape, geo)
