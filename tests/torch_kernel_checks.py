"""How K3, the tracker trip (ldso_tpu_torch/ops/cuda_kernels.tracker_trip),
is held against its plain version (frontend/tracker.tracker_trip_ref): the
tolerances, the edge cases and the comparison that `chip_smoke.py` and the
tests share. It imports torch and the port only (no jax), so
`chip_smoke.py` can import it on the machine with the card.

Two float32 evaluations of the trip differ by more than the rounding of
their sums. Each point's residual carries the rounding of its warped
coordinates (a few ulps of Ku, Kv times the image gradient), so
  * stats agree to TRIP_STATS_TOL relative, numTerms exactly;
  * H agrees to TRIP_H_RTOL relative or TRIP_H_SCALE of its largest entry;
  * b agrees to TRIP_B_RTOL relative or TRIP_B_SCALE of its largest entry:
    its pose entries are small sums of large terms of either sign, while
    its affine entries (scaled by 10 and 1000) set the largest
    (tests/test_torch_tracker.py::test_tracker_trip_float32_against_float64
    measures both float32 versions against float64);
  * a point whose |residual| lies within TRIP_CUT_MARGIN of its member's
    cutoff may be good in one evaluation and saturated in the other: it
    joins or leaves H, b and the good count at once. `trip_allowance`
    bounds what such points can move, and the comparison adds it to the
    tolerance (0 when no point is that close).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ldso_tpu_torch.frontend import affine, tracker
from ldso_tpu_torch.frontend.tracker import _calc_gs, _calc_res
from ldso_tpu_torch.ops.preprocess import FramePyramid

TRIP_STATS_TOL = 1e-4
TRIP_H_RTOL = 1e-3
TRIP_H_SCALE = 1e-5
TRIP_B_RTOL = 1e-3
TRIP_B_SCALE = 1e-4
TRIP_CUT_MARGIN = 0.05
TRIP_CASES = ("scene", "out_of_bounds", "saturating", "nan_intensity",
              "nan_patch")


def _ok_mask(bufs, ref, lvl, calib):
    """calcRes's ok mask, rebuilt from its buffers: a valid point in
    bounds, in front of the camera, with a finite sample."""
    Ku = calib.fx[lvl] * bufs["u"] + calib.cx[lvl]
    Kv = calib.fy[lvl] * bufs["v"] + calib.cy[lvl]
    inb = ((Ku > 2) & (Kv > 2) & (Ku < calib.w[lvl] - 3)
           & (Kv < calib.h[lvl] - 3) & (bufs["idepth"] > 0))
    return ref.valid[lvl][None, :] & inb & torch.isfinite(bufs["residual"])


def trip_allowance(ref, pyr, lvl, T, aff, expo, cutoff, calib, cfg,
                   flow) -> Tuple[torch.Tensor, ...]:
    """What the points at the cutoff can move, per output: (stats (B,6),
    H (B,8,8), b (B,8) of absolute allowances, and the relative share
    k / max(#good, 1) of H and b that k such points move through the good
    count (B,)). A point is at the cutoff when it is ok and its |residual|
    is within TRIP_CUT_MARGIN of it; its allowance is the absolute value
    of each term it adds to H and b, and its change of E and of the
    saturated share."""
    bufs, stats = _calc_res(ref, pyr, lvl, T, aff, expo, cutoff, calib, cfg,
                            flow)
    ok = _ok_mask(bufs, ref, lvl, calib)
    r = bufs["residual"]
    cut = cutoff[:, None]
    at = ok & (torch.abs(torch.abs(r) - cut) <= TRIP_CUT_MARGIN)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    k = at.sum(1).to(r.dtype)
    n_good = torch.clamp(bufs["good"].sum(1), min=1.0)

    # |J| of every point, as _calc_gs forms J
    fx, fy = calib.fx[lvl], calib.fy[lvl]
    rel = affine.from_to(ref.ref_exposure, expo, ref.ref_aff, aff)
    dxf, dyf = bufs["dx"] * fx, bufs["dy"] * fy
    u, v, idep = bufs["u"], bufs["v"], bufs["idepth"]
    J = torch.stack([
        idep * dxf, idep * dyf, -idep * (u * dxf + v * dyf),
        -(u * v * dxf + (1.0 + v * v) * dyf), u * v * dyf + (1.0 + u * u) * dxf,
        u * dyf - v * dxf,
        (rel[:, 0:1] * (ref.ref_aff[1] - bufs["color"][None, :])).expand_as(u),
        -torch.ones_like(u)], dim=-1)
    # only the points at the cutoff, NaN-free
    hw = torch.where(at, bufs["hw"], zero)
    ra = torch.where(at, torch.abs(r), zero)
    Ja = torch.where(at[..., None], torch.abs(J), zero)
    scale = tracker._scale_vec(r.device)
    H = (Ja * hw[..., None]).transpose(1, 2) @ Ja / n_good[:, None, None]
    H = H * scale[:, None] * scale[None, :]
    b = (Ja * (hw * ra)[..., None]).sum(1) / n_good[:, None] * scale
    max_energy = 2.0 * cfg.huber_th * cut - cfg.huber_th * cfg.huber_th
    e_jump = torch.abs(max_energy - hw * ra * ra * (2.0 - hw))
    s = torch.zeros_like(stats)
    s[:, 0] = torch.where(at, e_jump, zero).sum(1)
    s[:, 5] = k / torch.clamp(stats[:, 1], min=1.0)
    return s, H, b, k / n_good


def trip_err(got, want, allowance=None):
    """Hold `got` (stats, H, b) to `want` within the trip's tolerances plus
    `allowance` (trip_allowance's, or None). Returns (max |got - want| over
    the three, the largest error as a share of its tolerance, numTerms
    equal). A NaN on one side only is an infinite error; NaN on both sides
    agrees."""
    inf = float("inf")
    worst, share = 0.0, 0.0
    outs = (("stats", TRIP_STATS_TOL, None), ("H", TRIP_H_RTOL, TRIP_H_SCALE),
            ("b", TRIP_B_RTOL, TRIP_B_SCALE))
    for i, (_, rtol, scale_share) in enumerate(outs):
        g, p = got[i], want[i]
        if scale_share is None:
            atol = torch.full_like(p, TRIP_STATS_TOL)
        else:
            atol = torch.full_like(p, scale_share * float(
                torch.max(torch.abs(torch.nan_to_num(p, nan=0.0)))))
        tol = torch.nan_to_num(rtol * torch.abs(p), nan=0.0) + atol
        if allowance is not None:
            tol = tol + allowance[i]
            if i:
                rel_k = allowance[3].reshape((-1,) + (1,) * (p.dim() - 1))
                tol = tol + rel_k * torch.nan_to_num(torch.abs(p), nan=0.0)
        both_nan = torch.isnan(g) & torch.isnan(p)
        d = torch.where(both_nan, torch.zeros_like(g),
                        torch.nan_to_num(torch.abs(g - p), nan=inf))
        worst = max(worst, float(torch.max(d)))
        share = max(share, float(torch.max(d / torch.clamp(tol, min=1e-30))))
    return worst, share, bool(torch.equal(got[0][:, 1], want[0][:, 1]))


def trip_plain_dropping_masked(ref, pyr, lvl, T, aff, expo, cut, calib, cfg,
                               flow):
    """The plain version with the rows that are not good set to 0 before
    `_calc_gs`, so they add nothing to H and b where the plain version
    adds 0 times their terms (NaN where the intensity is NaN): K3's
    function on a level with NaNs."""
    bufs, stats = _calc_res(ref, pyr, lvl, T, aff, expo, cut, calib, cfg,
                            flow)
    keep = bufs["good"] > 0
    bufs = {k: torch.where(keep, v, torch.zeros_like(v)) if v.dim() == 2
            else v for k, v in bufs.items()}
    H, b, _ = _calc_gs(bufs, lvl, ref, aff, expo, calib)
    return stats, H, b


def trip_case(case: str, pyr, lvl, T, aff, cfg):
    """An edge case of TRIP_CASES at level lvl from a batch of poses T and
    affines aff about the truth: (pyr, T, aff, cutoff, plain function).
      scene: as given, the production cutoff;
      out_of_bounds: even members 100 m to the side, odd ones 100 m behind,
        so no point is in bounds (numTerms 0);
      saturating: a brightness offset of 40 against the production cutoff
        of 20, so most terms saturate;
      nan_intensity, nan_patch: a NaN patch over the top half of the
        level's second quarter of columns (where the point lists, filled
        in raster order up to their caps, land at every level), in its
        intensity channel or in all three (the plain version's H
        and b turn NaN there: the plain function with the masked rows
        dropped is the one to hold K3 to)."""
    B = T.shape[0]
    cut = torch.full((B,), cfg.coarse_cutoff_th, dtype=torch.float32,
                     device=T.device)
    plain = tracker.tracker_trip_ref
    if case == "out_of_bounds":
        T = T.clone()
        T[0::2, 0, 3] += 100.0
        T[1::2, 2, 3] -= 100.0
    elif case == "saturating":
        aff = aff + torch.tensor([0.0, 40.0], dtype=aff.dtype,
                                 device=aff.device)
    elif case in ("nan_intensity", "nan_patch"):
        dI = list(pyr.dI)
        lv = dI[lvl].clone()
        h, w = lv.shape[:2]
        chans = slice(0, 1) if case == "nan_intensity" else slice(0, 3)
        lv[:h // 2, w // 4:w // 2, chans] = float("nan")
        dI[lvl] = lv
        pyr = FramePyramid(dI=tuple(dI), abs_grad=())
        plain = trip_plain_dropping_masked
    elif case != "scene":
        raise ValueError(f"unknown trip case {case!r}")
    return pyr, T, aff, cut, plain
