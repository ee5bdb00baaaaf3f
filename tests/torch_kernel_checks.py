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
    tolerance (0 when no point is that close);
  * at a converged pose, where an LM step may land, E is a sum of
    residuals of a fraction of a grey level and b cancels: their error is
    each residual's own rounding, `trip_floor`, which the lm mode's check
    adds.
"""

from __future__ import annotations

import contextlib
import math
import types
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
# ulps of a residual's warped coordinates (and intensity) that the floors of
# E and b allow each evaluation at a converged pose (trip_floor): float32
# against float64 stays within a quarter of them on a 640x480 plane scene,
# so two float32 evaluations stay within half (tests/test_torch_tracker.py
# ::test_converged_trip_float32_against_float64). E's errors, of one sign
# per point's square, average out more than b's terms of either sign.
TRIP_E_ULPS = 2.0
TRIP_B_ULPS = 16.0
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


def trip_floor(ref, pyr, lvl, T, aff, expo, cutoff, calib, cfg):
    """The rounding floors of E and b (stats (B, 6), b (B, 8)) at a pose
    where they are small sums (a converged one, where an LM step lands):
    each residual carries a few float32 ulps of its warped coordinates
    times its image gradient, and of its intensity, dr = (|Ku dx| + |Kv dy|
    + |I|) 2^-23, which moves an ok point's energy by up to
    2 min(|r|, huber) dr (TRIP_E_ULPS of them) and a good point's b by
    hw |J| dr (TRIP_B_ULPS of them; / max(#good, 1), scaled as b). There E
    sums residuals of a fraction of a grey level and b terms of either
    sign, so each residual's own rounding, not the sum's, sets their
    error."""
    bufs, _ = _calc_res(ref, pyr, lvl, T, aff, expo, cutoff, calib, cfg,
                        False)
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
    Ku = fx * u + calib.cx[lvl]
    Kv = fy * v + calib.cy[lvl]
    r = bufs["residual"]
    intensity = r + rel[:, 0:1] * bufs["color"][None, :] + rel[:, 1:2]
    good = bufs["good"] > 0
    ok = _ok_mask(bufs, ref, lvl, calib)
    dr = (torch.abs(Ku * bufs["dx"]) + torch.abs(Kv * bufs["dy"])
          + torch.abs(intensity)) * 2.0 ** -23
    zero = torch.zeros_like(dr)
    stats = torch.zeros(r.shape[0], 6, dtype=r.dtype, device=r.device)
    stats[:, 0] = TRIP_E_ULPS * torch.where(
        ok & ~torch.isnan(dr),
        2.0 * torch.clamp(torch.abs(r), max=cfg.huber_th) * dr, zero).sum(1)
    w = torch.where(good, TRIP_B_ULPS * bufs["hw"] * dr, zero)
    Ja = torch.where(good[..., None], torch.abs(J), torch.zeros_like(J))
    n = torch.clamp(good.sum(1), min=1).to(J.dtype)
    return stats, (Ja * w[..., None]).sum(1) / n[:, None] * \
        tracker._scale_vec(u.device)


def trip_err(got, want, allowance=None, floor=None):
    """Hold `got` (stats, H, b) to `want` within the trip's tolerances plus
    `allowance` (trip_allowance's, or None) and `floor` (trip_floor's, or
    None). Returns (max |got - want| over
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
        if floor is not None and i != 1:
            tol = tol + floor[i // 2]
        both_nan = torch.isnan(g) & torch.isnan(p)
        d = torch.where(both_nan, torch.zeros_like(g),
                        torch.nan_to_num(torch.abs(g - p), nan=inf))
        worst = max(worst, float(torch.max(d)))
        share = max(share, float(torch.max(d / torch.clamp(tol, min=1e-30))))
    return worst, share, bool(torch.equal(got[0][:, 1], want[0][:, 1]))


def trip_case(case: str, pyr, lvl, T, aff, cfg):
    """An edge case of TRIP_CASES at level lvl from a batch of poses T and
    affines aff about the truth: (pyr, T, aff, cutoff).
      scene: as given, the production cutoff;
      out_of_bounds: even members 100 m to the side, odd ones 100 m behind,
        so no point is in bounds (numTerms 0);
      saturating: a brightness offset of 40 against the production cutoff
        of 20, so most terms saturate;
      nan_intensity, nan_patch: a NaN patch over the top half of the
        level's second quarter of columns (where the point lists, filled
        in raster order up to their caps, land at every level), in its
        intensity channel or in all three: the plain version's H and b
        turn NaN for a member whose masked points sample it (0 times a NaN
        term), and K3 is held to the plain version there too."""
    B = T.shape[0]
    cut = torch.full((B,), cfg.coarse_cutoff_th, dtype=torch.float32,
                     device=T.device)
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
    elif case != "scene":
        raise ValueError(f"unknown trip case {case!r}")
    return pyr, T, aff, cut


# ---------------------------------------------------------------------------
# K3's cutoff and lm modes (ops/cuda_kernels.cutoff_trip, lm_trip) against
# their plain versions (frontend/tracker.cutoff_trip_ref, lm_trip_ref)
# ---------------------------------------------------------------------------
#
# A member with nothing to do (cutoff: not run, at most 60% saturated or at
# the cutoff limit; lm: done) keeps its state bit for bit in both versions.
# A live cutoff member doubles cutoff_rep exactly and is held to the trip's
# tolerances at the new cutoff. A live LM member is held in parts:
#   * the step: two float32 solves of the damped system differ by their
#     rounding, which the condition number kappa of that system amplifies:
#     |inc_a - inc_b| <= STEP_COND_FACTOR kappa 2^-23 |inc|_inf per
#     component (tests/test_torch_tracker.py::
#     test_lm_step_float32_against_float64 measures torch's solve_ex and
#     K3's elimination, emulated, each within half of it from float64),
#     scaled by the parameter scales, plus STEP_ATOL for se3_exp and the
#     4x4 product (sin and cos of two libraries, fused multiply-adds);
#   * the trip at the kernel's own new pose: the trip's tolerances above,
#     with the rounding floors of E and b (trip_floor), since the step may
#     land where the residuals are small;
#   * the accept test: the two may decide differently only where the new
#     mean energy lies within ACCEPT_RTOL of the old one (the step's and
#     the trip's differences move the new energy by less); each version's
#     outputs then follow its own decision bit for bit (the candidate or
#     the old state, lam halved or grown 4x, exactly);
#   * done: equal except where |inc| lies within DONE_RTOL of 1e-3.

STEP_COND_FACTOR = 4.0
STEP_ATOL = 2e-6
ACCEPT_RTOL = 1e-3
DONE_RTOL = 1e-2
_EPS32 = 2.0 ** -23


def bits(a, b) -> torch.Tensor:
    """Per-member bitwise equality of two (B, ...) tensors of float32 or
    bool, NaN payloads included: (B,) bool."""
    if a.dtype == torch.bool:
        eq = a == b
    else:
        eq = a.view(torch.int32) == b.view(torch.int32)
    return eq.reshape(eq.shape[0], -1).all(1)


@contextlib.contextmanager
def plain_trip(fn):
    """The plain modes (cutoff_trip_ref, lm_trip_ref) with `fn` as their
    trip (another evaluation of tracker_trip_ref, as the CPU tests' emulated
    kernel is)."""
    saved = tracker.tracker_trip_ref
    tracker.tracker_trip_ref = fn
    try:
        yield
    finally:
        tracker.tracker_trip_ref = saved


def mode_state(plain, ref, pyr, lvl, T, aff, expo, cut, calib, cfg, flow):
    """A state of the cutoff and LM loops at these poses, from the plain
    trip: (stats, H, b, cutoff_rep, run, lam, done). Its members cover each
    branch of both modes (for B >= 8): member 1 is not `run`, member 2 sits
    at the cutoff limit (cutoff_rep 64), members 3 and 6 are done; the
    others run, over 60% saturated (a saturated share of 0.9 is written
    into their stats), with lam from 1e-6 to 0.5."""
    stats, H, b = plain(ref, pyr, lvl, T, aff, expo, cut, calib, cfg, flow)
    B = T.shape[0]
    dev = T.device
    stats = stats.clone()
    stats[:, 5] = 0.9
    rep = torch.ones(B, dtype=torch.float32, device=dev)
    run = torch.ones(B, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    lam = torch.tensor([0.01, 0.5, 1e-6, 0.01, 1e-3, 2e-3, 0.01, 0.1] * (
        -(-B // 8)), dtype=torch.float32, device=dev)[:B]
    if B >= 8:
        run[1] = False
        rep[2] = 64.0
        done[3] = done[6] = True
    return stats, H, b, rep, run, lam, done


def _faults(what, mask, idx=None):
    """[what and the members where `mask` holds] (members idx[mask] when
    the mask runs over a subset idx), or []."""
    if not bool(mask.any()):
        return []
    members = mask.nonzero()[:, 0]
    if idx is not None:
        members = idx[members]
    return [f"{what}: members {members.tolist()}"]


def cutoff_err(args, state, got, want):
    """Hold K3's cutoff mode (`got`) to its plain version (`want`) on args
    = (ref, pyr, lvl, T, aff, expo, calib, cfg, flow) and state = (stats,
    H, b, cutoff_rep, run). Returns (max |got - want| over the live
    members' stats, H and b, that error as a share of its tolerance, a list
    of faults)."""
    ref, pyr, lvl, T, aff, expo, calib, cfg, flow = args
    stats, H, b, rep, run = state
    more = (stats[:, 5] > 0.6) & (rep < tracker._CUTOFF_LIMIT) & run
    faults = _faults("cutoff_rep", ~bits(got[3], want[3]))
    for i, name in enumerate(("stats", "H", "b")):
        faults += _faults(f"idle {name}", ~more & ~bits(got[i], state[i]))
    if not bool(more.any()):
        return 0.0, 0.0, faults
    idx = more.nonzero()[:, 0]
    cut = cfg.coarse_cutoff_th * want[3][idx]
    allowance = trip_allowance(ref, pyr, lvl, T[idx], aff[idx], expo, cut,
                               calib, cfg, flow)
    err, share, same_n = trip_err([g[idx] for g in got[:3]],
                                  [w[idx] for w in want[:3]], allowance)
    if not same_n or share > 1.0:
        faults.append(f"live trips: {err} ({share:.3g} of the tolerance), "
                      f"numTerms equal {same_n}")
    return err, share, faults


def _step_tol(H, b, lam, cfg, inc):
    """STEP_COND_FACTOR kappa 2^-23 |inc|_inf per member: the rounding of a
    float32 solve of the damped system over its active parameters."""
    idx = [i for i in range(8) if i < 6
           or (i == 6 and cfg.affine_opt_mode_a >= 0)
           or (i == 7 and cfg.affine_opt_mode_b >= 0)]
    Hd = H.double()
    Hl = Hd + torch.diag_embed(torch.diagonal(Hd, dim1=-2, dim2=-1)
                               * lam.double()[:, None])
    Hs = Hl[:, idx][:, :, idx]
    kappa = torch.linalg.cond(Hs)
    kappa = torch.where(torch.isfinite(kappa), kappa,
                        torch.full_like(kappa, float("inf")))
    return (STEP_COND_FACTOR * kappa * _EPS32
            * inc.double().abs().amax(1)).float()


def lm_err(args, state, got, cand, want, plain):
    """Hold K3's lm mode (`got`) to its plain version (`want`), part by
    part as the notes above say. args = (ref, pyr, lvl, T, aff, expo,
    calib, cfg, flow), state = (stats, H, b, lam, done, cutoff); `cand` is
    K3's lm mode on the same state with every live member's old energy
    set to +inf, so that it accepts: its candidate T, aff, stats, H, b;
    `plain` the plain trip (tracker_trip_ref). Returns (max |got - want| of the
    step and the candidate trip, the largest error as a share of its
    tolerance, a list of faults, the floors' largest shares of the
    candidate trip: {"E": trip_floor's E over |E|, "b": its b over the
    member's max |b|}, over the live members)."""
    ref, pyr, lvl, T, aff, expo, calib, cfg, flow = args
    stats, H, b, lam, done, cutoff = state
    live = ~done
    outs_in = (T, aff, stats, H, b, lam)
    names = ("T", "aff", "stats", "H", "b", "lam")
    faults = []
    for i, name in enumerate(names):
        faults += _faults(f"idle {name}", done & ~bits(got[i], outs_in[i]))
    faults += _faults("idle done", done & ~got[6])
    floors = dict(E=0.0, b=0.0)
    if not bool(live.any()):
        return 0.0, 0.0, faults, floors
    idx = live.nonzero()[:, 0]
    inc, T_new, aff_n = tracker.lm_step_ref(T, aff, H, b, lam, cfg)
    # the step. A NaN in H or b (a masked point's NaN term) makes every
    # increment NaN, and both versions set a non-finite increment to 0: that
    # member must not move (the identity times T may turn a -0 into +0)
    fin = torch.isfinite(inc[idx])
    frozen = ~fin.any(1)
    faults += _faults("step partly non-finite", fin.any(1) & ~fin.all(1),
                      idx)

    def same(a, b):
        return (a == b).reshape(a.shape[0], -1).all(1)
    for name, mine in (("kernel", cand), ("plain", (T_new, aff_n))):
        moved = ~same(mine[0][idx], T[idx]) | ~same(mine[1][idx], aff[idx])
        faults += _faults(f"{name} moved on a non-finite step",
                          frozen & moved, idx)
    worst, share = 0.0, 0.0
    step = fin.all(1)
    if bool(step.any()):
        js = idx[step]
        tol = _step_tol(H[js], b[js], lam[js], cfg, inc[js])
        scale = tracker._scale_vec(T.device)
        dT = torch.abs(cand[0][js] - T_new[js]).amax((1, 2))
        daff = torch.abs(cand[1][js] - aff_n[js])
        tol_T = tol * float(scale[:6].max()) + STEP_ATOL
        tol_aff = (tol[:, None] * scale[6:8]
                   + STEP_ATOL * (1.0 + torch.abs(aff_n[js])))
        worst = max(float(dT.max()), float(daff.max()))
        share = max(float((dT / tol_T).max()),
                    float((daff / tol_aff).max()))
        if share > 1.0:
            faults.append(f"step: |dT| {dT.tolist()} against "
                          f"{tol_T.tolist()}, |daff| {daff.tolist()}")
    # the candidate trip at the kernel's own new pose
    c_args = (ref, pyr, lvl, cand[0][idx], cand[1][idx], expo, cutoff[idx],
              calib, cfg, flow)
    c_plain = plain(*c_args)
    floor = trip_floor(*c_args[:-1])
    err, c_share, same_n = trip_err([c[idx] for c in cand[2:5]], c_plain,
                                    trip_allowance(*c_args), floor)
    # (over the members whose E and b are finite)
    finite = (torch.isfinite(c_plain[0][:, 0])
              & torch.isfinite(c_plain[2]).all(1))
    if bool(finite.any()):
        e_abs = torch.clamp(torch.abs(c_plain[0][:, 0]), min=1e-30)
        b_max = torch.clamp(torch.nan_to_num(torch.abs(c_plain[2]), nan=0.0)
                            .amax(1), min=1e-30)
        floors = dict(E=float((floor[0][:, 0] / e_abs)[finite].max()),
                      b=float((floor[1].amax(1) / b_max)[finite].max()))
    worst, share = max(worst, err), max(share, c_share)
    if not same_n or c_share > 1.0:
        got_c = [c[idx] for c in cand[2:5]]
        parts = [trip_err([g if j == i else w for j, (g, w) in enumerate(
            zip(got_c, c_plain))], c_plain, trip_allowance(*c_args),
            floor)[1] for i in range(3)]
        faults.append(f"candidate trip: {err} ({c_share:.3g} of the "
                      f"tolerance; stats, H, b {parts}), numTerms equal "
                      f"{same_n}")
    # the accept test
    # (the whole batch, as the plain lm mode ran it: the card's reductions
    # may order their sums by the batch's shape)
    w_mine = [x[idx] for x in (T_new, aff_n) + tuple(plain(
        ref, pyr, lvl, T_new, aff_n, expo, cutoff, calib, cfg, flow))]

    def mean(st):
        return st[:, 0] / torch.clamp(st[:, 1], min=1.0)
    acc_g = got[5][idx] < lam[idx]
    acc_w = want[5][idx] < lam[idx]
    close = (torch.abs(mean(w_mine[2]) - mean(stats[idx]))
             <= ACCEPT_RTOL * torch.abs(mean(stats[idx])))
    faults += _faults("accept differs", (acc_g != acc_w) & ~close, idx)
    # each version's outputs follow its own decision, bit for bit
    for name, out, acc, mine in (
            ("kernel", got, acc_g, [c[idx] for c in cand]),
            ("plain", want, acc_w, w_mine)):
        for i in range(5):
            exp = tracker._where(acc, mine[i], outs_in[i][idx])
            faults += _faults(f"{name} {names[i]} off its decision",
                              ~bits(out[i][idx], exp), idx)
        lam_exp = torch.where(acc, lam[idx] * 0.5, torch.clamp(
            lam[idx] * 4.0, min=tracker._LAMBDA_EXTRAPOLATION_LIMIT))
        faults += _faults(f"{name} lam", ~bits(out[5][idx], lam_exp), idx)
    # done
    n_inc = torch.linalg.norm(inc[idx], dim=1)
    near = torch.abs(n_inc - 1e-3) <= DONE_RTOL * 1e-3
    faults += _faults("done differs", (got[6][idx] != want[6][idx]) & ~near,
                      idx)
    return worst, share, faults, floors


def lm_candidate(lm_fn, args, state):
    """`lm_fn` (a K3 wrapper or the plain version) on the state with every
    live member's old mean energy +inf: each accepts, so its outputs are
    its candidate T, aff, stats, H, b."""
    ref, pyr, lvl, T, aff, expo, calib, cfg, flow = args
    stats, H, b, lam, done, cutoff = state
    st = stats.clone()
    st[:, 0] = torch.where(done, stats[:, 0],
                           torch.full_like(stats[:, 0], float("inf")))
    return lm_fn(ref, pyr, lvl, T, aff, expo, st, H, b, lam, done, cutoff,
                 calib, cfg, flow)


def mode_errs(cutoff_fn, lm_fn, plain, ref, pyr, lvl, T, aff, expo, cut,
              calib, cfg, flow):
    """`cutoff_fn` and `lm_fn` (K3's wrappers, cuda_kernels.cutoff_trip and
    lm_trip) against the plain modes with `plain` as their trip, from
    mode_state's state at these poses. Returns (max error, its share of
    the tolerance, faults, {"state": the lm mode's state, "floor_E",
    "floor_b": lm_err's floor shares})."""
    stats, H, b, rep, run, lam, done = mode_state(
        plain, ref, pyr, lvl, T, aff, expo, cut, calib, cfg, flow)
    args = (ref, pyr, lvl, T, aff, expo, calib, cfg, flow)
    c_state = (stats, H, b, rep, run)
    got = cutoff_fn(ref, pyr, lvl, T, aff, expo, *c_state, calib, cfg, flow)
    with plain_trip(plain):
        want = tracker.cutoff_trip_ref(ref, pyr, lvl, T, aff, expo, *c_state,
                                       calib, cfg, flow)
    e_c, s_c, faults = cutoff_err(args, c_state, got, want)
    faults = [f"cutoff {f}" for f in faults]
    cutoff = cfg.coarse_cutoff_th * rep
    l_state = (stats, H, b, lam, done, cutoff)
    got = lm_fn(ref, pyr, lvl, T, aff, expo, *l_state, calib, cfg, flow)
    cand = lm_candidate(lm_fn, args, l_state)
    with plain_trip(plain):
        want = tracker.lm_trip_ref(ref, pyr, lvl, T, aff, expo, *l_state,
                                   calib, cfg, flow)
    e_l, s_l, f_l, floors = lm_err(args, l_state, got, cand, want, plain)
    faults += [f"lm {f}" for f in f_l]
    return (max(e_c, e_l), max(s_c, s_l), faults,
            dict(state=l_state, floor_E=floors["E"], floor_b=floors["b"]))


def solve_like_k3(H, b, lam, cfg):
    """`_solve_inc`'s function computed the way K3's lm_step computes it, in
    the input's dtype: the damped augmented system with an inactive
    parameter as an identity row and column and a zero right-hand side,
    Gaussian elimination with partial pivoting (the first largest
    |pivot|), back substitution. For the tests that bound what two float32
    solves may differ by (the kernel's fused multiply-adds round in places
    this does not)."""
    B = H.shape[0]
    act = torch.tensor([True] * 6 + [cfg.affine_opt_mode_a >= 0,
                                     cfg.affine_opt_mode_b >= 0],
                       device=H.device)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    eye = torch.eye(8, dtype=H.dtype, device=H.device)
    Hl = H + torch.diag_embed(diag * lam[:, None]) + eye * 1e-12
    M = torch.where(act[:, None] & act[None, :], Hl, eye.expand(B, 8, 8))
    M = torch.cat([M, torch.where(act, -b, torch.zeros_like(b))[..., None]],
                  dim=2)
    rows = torch.arange(B, device=H.device)
    for k in range(8):
        piv = k + torch.argmax(torch.abs(M[:, k:, k]), dim=1)
        top, low = M[rows, k].clone(), M[rows, piv].clone()
        M[rows, k], M[rows, piv] = low, top
        lk = M[:, k + 1:, k] / M[:, k, k][:, None]
        M[:, k + 1:, k + 1:] = (M[:, k + 1:, k + 1:]
                                - lk[..., None] * M[:, k, None, k + 1:])
    x = torch.zeros(B, 8, dtype=H.dtype, device=H.device)
    for i in range(7, -1, -1):
        x[:, i] = (M[:, i, 8] - (M[:, i, i + 1:8] * x[:, i + 1:]).sum(1)) \
            / M[:, i, i]
    return torch.where(act, x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# The windowed BA (backend/ba_device.optimize_device) and K12, its nullspace
# projector (ops/cuda_kernels.ba_projector)
# ---------------------------------------------------------------------------

def ba_window(n_frames: int, F: int, n_pts: int = 64, w: int = 160,
              h: int = 120, seed: int = 0, pose_noise: float = 2e-3,
              idepth_noise: float = 0.05, device="cpu"):
    """A BA window of the port alone (so the card tests and chip_smoke.py
    can make one): n_frames of F slots along a lateral path over a
    PlaneScene, the poses after the first `pose_noise` off the truth, a
    grid of about n_pts points hosted in frame 0 with idepths
    `idepth_noise` off, and a marginalization prior of the kind a
    marginalized frame leaves (a diagonal-dominant SPD block and a small
    b over the live parameters, zero padded to 4 + 8F). Returns (W, dIs
    (F, h, w, 3), HM, bM, Config, (w, h))."""
    import numpy as np
    from ldso_tpu_torch.backend.energy_functional import EnergyFunctional
    from ldso_tpu_torch.config import CPARS, Config, PATTERN
    from ldso_tpu_torch.math import lie_np
    from ldso_tpu_torch.ops.interp import bilinear
    from ldso_tpu_torch.ops.preprocess import make_pyramid
    from ldso_tpu_torch.synthetic import PlaneScene, default_calib
    cfg = Config(max_points=max(n_pts, 16))
    calib = default_calib(w, h)
    scene = PlaneScene(freq_hi=18.0, contrast=80.0)
    rng = np.random.RandomState(seed)
    ef = EnergyFunctional(cfg, calib, F=F, P=cfg.max_points, device=device)
    dIs = []
    for i in range(n_frames):
        T = lie_np.se3_exp(np.array([0.06 * i, 0.01 * i, 0.0, 0.0, 0.0,
                                     0.0]))
        img, idep = scene.render(calib, T, device=device)
        if i == 0:
            idep0 = idep
        dIs.append(make_pyramid(img, calib.levels).dI[0])
        if i > 0 and pose_noise > 0:
            T = lie_np.se3_exp(rng.randn(6) * pose_noise) @ T
        ef.insert_frame(T, exposure=1.0, aff=np.zeros(2), is_first=(i == 0))
    side = int(np.sqrt(n_pts))
    gx, gy = np.meshgrid(np.linspace(12, w - 12, side),
                         np.linspace(12, h - 12, side))
    u, v = gx.reshape(-1), gy.reshape(-1)
    idep = idep0.cpu().numpy()[v.astype(int), u.astype(int)]
    idep = idep * (1.0 + rng.randn(len(idep)) * idepth_noise)
    patt = torch.tensor(PATTERN, dtype=torch.float32, device=device)
    uv = [torch.tensor(a, dtype=torch.float32, device=device)[:, None]
          + patt[None, :, k] for k, a in enumerate((u, v))]
    ptc = bilinear(dIs[0], uv[0], uv[1]).cpu().numpy()
    gsq = np.sum(ptc[..., 1:3] ** 2, -1)
    weights = np.sqrt(cfg.outlier_th_sum_component
                      / (cfg.outlier_th_sum_component + gsq))
    ef.insert_points(0, u, v, ptc[..., 0], weights, idep,
                     np.full(len(u), 8.0 * cfg.outlier_th, np.float32))
    dIs = torch.stack(dIs + [torch.zeros_like(dIs[0])] * (F - n_frames))
    n, n_full = CPARS + 8 * n_frames, CPARS + 8 * F
    A = rng.randn(n, n) * 0.1
    HM = np.zeros((n_full, n_full), np.float32)
    HM[:n, :n] = A @ A.T + np.diag(rng.uniform(0.5, 2.0, n))
    bM = np.zeros(n_full, np.float32)
    bM[:n] = rng.randn(n) * 0.01
    f32 = dict(dtype=torch.float32, device=device)
    return (ef.W, dIs, torch.tensor(HM, **f32), torch.tensor(bM, **f32),
            cfg, (w, h))


# K12 against its plain version: the projector is unique, but the plain
# version's float32 SVD rounds where K12's float64 Jacobi does not. A
# float32 projector of a basis with condition number kappa (its largest
# kept singular value over its smallest) is off by a few 2^-23 kappa per
# entry (tests/test_torch_ba_device.py::test_projector_float32_against_float64
# measures the plain version within PROJ_ULPS / 4 of it against float64 on
# the BA windows of 1 to 8 frames). A float32 SVD's singular values are off
# by a few 2^-23 max(S), so one within PROJ_ULPS 2^-23 max(S) of the gate
# delta max(S) (9.5% of the gate at delta = 1e-5), or within PROJ_GATE_RTOL
# of it, may be kept by one version and dropped by the other: such a window
# is reported and held to no tolerance.
PROJ_ULPS = 8.0
PROJ_GATE_RTOL = 1e-3


def projector_err(got, want, Nn, delta: float):
    """Hold K12's projectors `got` (S, n, n) to the plain version's `want`
    for the bases Nn (S, n, k). Returns (max |got - want|, the largest
    error as a share of its tolerance, the windows with a singular value at
    the gate). The tolerance comes from float64 singular values."""
    S = torch.linalg.svdvals(Nn.double())
    smax = S.amax(-1, keepdim=True)
    gate = delta * smax
    kept = S > gate
    smin = torch.where(kept, S, torch.full_like(S, float("inf"))).amin(-1)
    kappa = torch.where(kept.any(-1), S.amax(-1) / smin,
                        torch.ones_like(smin))
    tol = PROJ_ULPS * _EPS32 * kappa
    margin = torch.maximum(PROJ_GATE_RTOL * gate, PROJ_ULPS * _EPS32 * smax)
    at_gate = (((S - gate).abs() <= margin) & (gate > 0)).any(-1)
    err = (got.double() - want.double()).abs().amax((-2, -1))
    share = torch.where(at_gate, torch.zeros_like(err), err / tol)
    return float(err.max()), float(share.max()), at_gate.nonzero()[:, 0].tolist()


# K12's own steps in plain float64 PyTorch (csrc/ba_projector.cu): the Gram
# matrix summed as the kernel sums it, cyclic two-sided Jacobi on it padded to
# 8x8 in the kernel's pair order with its stop rule, the eigenvalue gate and
# P summed over the kept columns in column order. Every operation is one
# IEEE float64 operation in the kernel's order (the kernel contracts no
# multiply-add), so the float64 values are the kernel's; K12 is held to it
# within PROJ_EMU_ULPS float32 ulps of P's largest entry (a float32 entry
# is one rounding of them, so the difference is expected to be 0).
PROJ_TOL = 1e-15             # the Jacobi's stop tolerance (kOrthTol)
PROJ_MAX_SWEEPS = 30         # kMaxSweeps
PROJ_EMU_ULPS = 2.0
_PROJ_COLS = 8


def projector_pairs(rnd: int):
    """The 4 disjoint (p, q) pairs of Jacobi round `rnd` (0..6): the
    round-robin tournament, player 0 fixed and the others moving one seat
    per round."""
    return [(0 if w == 0 else 1 + (w - 1 + rnd) % 7, 1 + (6 - w + rnd) % 7)
            for w in range(_PROJ_COLS // 2)]


def _sqrt(x):
    """A correctly rounded float64 square root, as the kernel's: torch's
    own on the CPU (its vectorised kernel) is not, numpy's is."""
    import numpy as np
    return torch.from_numpy(np.sqrt(x.cpu().numpy())).to(x.device)


def _lane_sum(partials):
    """(..., L) per-lane sums -> (...): lane 0's value after the xor
    butterfly over offsets L / 2, ..., 2, 1."""
    h = partials.shape[-1] // 2
    while h:
        partials = partials[..., :h] + partials[..., h:2 * h]
        h //= 2
    return partials[..., 0]


def projector_emulated(Nn, delta: float, drop: int = -1):
    """K12's algorithm on one (n, k) basis, on Nn's device: returns (P (n,
    n) float32, sweeps, rotations). `drop` >= 0 leaves out the kept
    direction of that rank (a planted fault for the tests)."""
    n, k = Nn.shape
    C = _PROJ_COLS
    f64 = dict(dtype=torch.float64, device=Nn.device)
    L = 8                    # lanes per Gram entry (kGroup)
    A = torch.zeros((-(-n // L) * L, C), **f64)
    A[:n, :k] = Nn.double()
    # lane l sums rows l, l + L, ... in order; then the lanes' tree
    prod = A.T[:, None, :] * A.T[None, :, :]
    acc = torch.zeros((C, C, L), **f64)
    for m in range(A.shape[0] // L):
        acc = acc + prod[..., L * m:L * (m + 1)]
    G = _lane_sum(acc)
    V = torch.eye(C, **f64)
    sweeps, rotations = PROJ_MAX_SWEEPS, 0
    off = ~torch.eye(C, dtype=torch.bool, device=Nn.device)
    tol2 = PROJ_TOL * PROJ_TOL
    for sweep in range(PROJ_MAX_SWEEPS):
        d = G.diagonal()
        ok = G * G <= tol2 * (d[:, None] * d[None, :]).abs()
        if bool(ok[off].all()):
            sweeps = sweep + 1
            break
        for rnd in range(C - 1):
            pq = torch.tensor(projector_pairs(rnd), device=Nn.device)
            p, q = pq[:, 0], pq[:, 1]
            a, b, g = G[p, p], G[q, q], G[p, q]
            rot = g * g > tol2 * (a * b).abs()
            d = b - a
            g2 = torch.where(d >= 0, 2.0 * g, -2.0 * g)
            r = _sqrt(d * d + g2 * g2)
            den = d.abs() + r
            r2 = 2.0 * r
            w = 1.0 / _sqrt(r2 * den)
            c, s, t = den * w, g2 * w, g2 * (r2 * (w * w))
            one, zero = torch.ones_like(c), torch.zeros_like(c)
            c, s, t = (torch.where(rot, c, one), torch.where(rot, s, zero),
                       torch.where(rot, t, zero))
            # new column p = c p - s q, new column q = s p + c q
            al = torch.empty(C, **f64)
            be = torch.empty(C, **f64)
            pa = torch.empty(C, dtype=torch.long, device=Nn.device)
            al[p], al[q], be[p], be[q] = c, c, -s, s
            pa[p], pa[q] = q, p
            Gn = ((al[:, None] * al[None, :]) * G
                  + (be[:, None] * be[None, :]) * G[pa][:, pa]) \
                + ((al[:, None] * be[None, :]) * G[:, pa]
                   + (be[:, None] * al[None, :]) * G[pa, :])
            for j in rot.nonzero()[:, 0].tolist():
                pj, qj = int(p[j]), int(q[j])
                Gn[pj, pj] = a[j] - t[j] * g[j]
                Gn[qj, qj] = b[j] + t[j] * g[j]
                Gn[pj, qj] = Gn[qj, pj] = 0.0
            G = Gn
            V = al[None, :] * V + be[None, :] * V[:, pa]
            rotations += int(rot.sum())
    lam = G.diagonal()
    d32 = float(torch.tensor(delta, dtype=torch.float32))
    gate = (d32 * d32) * lam.max()
    kept = ((lam > gate) & (lam > 0)).nonzero()[:, 0].tolist()
    if drop >= 0:
        del kept[drop]
    U = torch.zeros((n, 0), **f64)
    if kept:
        acc = torch.zeros((n, len(kept)), **f64)
        for m in range(k):
            acc = acc + A[:n, m, None] * V[m, kept][None, :]
        U = acc * (1.0 / _sqrt(lam[kept]))[None, :]
    P = torch.zeros((n, n), **f64)
    for col in range(U.shape[1]):
        P = P + U[:, col, None] * U[None, :, col]
    return P.to(torch.float32), sweeps, rotations


def projector_emu_err(got, want):
    """|K12 - projector_emulated| on one window, and its share of
    PROJ_EMU_ULPS float32 ulps of the largest |entry|."""
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 23) if scale > 0 \
        else 2.0 ** -149
    return err, err / (PROJ_EMU_ULPS * ulp)


PROJ_N = 4 + 8 * 8           # rows at the main path's 8 window slots


def _unit_columns(Q, theta):
    """7 unit columns: Q's first six and one at angle theta to the sixth
    (so the pair's singular values are sqrt(1 +- cos theta))."""
    import numpy as np
    cols = Q[:, :6].copy()
    last = np.cos(theta) * Q[:, 5] + np.sin(theta) * Q[:, 6]
    return np.concatenate([cols, last[:, None]], 1)


def planted_bases(delta: float, n: int = PROJ_N, seed: int = 12):
    """Planted (n, 7) bases of unit columns, as orth_basis gives them, with
    what makes K12's work hard: {name: float32 numpy array}. A repeated
    column, a zero column (a rank-6 basis each), condition numbers 1e3 and
    10^4.5 (a pair of columns at angle 2 atan(1 / kappa)), and a smallest
    singular value at 1.01 and 0.99 times the gate delta max(S)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    Q = np.linalg.qr(rng.randn(n, 7))[0]
    out = {}
    rep = Q.copy()
    rep[:, 4] = rep[:, 2]
    out["repeated_column"] = rep
    zero = Q.copy()
    zero[:, 3] = 0.0
    out["zero_column"] = zero
    for name, kappa in (("kappa_1e3", 1e3), ("kappa_1e4.5", 10 ** 4.5)):
        out[name] = _unit_columns(Q, 2.0 * np.arctan(1.0 / kappa))
    for name, f in (("gate_1.01", 1.01), ("gate_0.99", 0.99)):
        # smallest over largest singular value tan(theta / 2)
        out[name] = _unit_columns(Q, 2.0 * np.arctan(f * delta))
    return {name: B.astype(np.float32) for name, B in out.items()}


# The device LM under vmap against single calls. The batched program sums in
# another order (batched products and einsums), and the LM's relinearizations
# compound float32 rounding, so a batch member differs from its single call
# by rounding. The yardstick is how far float32 rounding takes the single
# call itself: the same function run in float64 on the same window
# (`ba_f64`, the plain versions under float64_plain). A member is at fault
# when it is farther from that float64 result than BA_F64_FACTOR times the
# farthest single call of the batch (and than the floors), in a pose, an
# idepth or the stats, or when its residual bookkeeping is not its single
# call's.
# float32 rounding is what both calls carry, whatever the order of their
# sums, so the yardstick does not move with the order a given build sums in
# (the activation's, the batch's); one reordering of the points, the
# yardstick before, varied 4.5x between runs. BA_F64_FACTOR was fixed from
# readings in the activation's earlier order (PERF.md section 7): on the
# card the farthest batch member of phase 3's last 8 windows came within
# 0.49, 0.94 and 0.65 times the farthest single replay's distance (pose,
# idepth, stats; tests/tools/batched_ba_orders.py), on the CPU the 3
# windows of tests/test_torch_ba_device.py's recorded run within 3.6
# times (stats: the batched einsums sum the energy in another order).
BA_F64_FACTOR = 4.0
BA_ORDER_FLOORS = dict(pose=1e-6, idepth=1e-5, stats=1e-6)
BA_BOOKKEEPING = ("res_exist", "res_active", "res_state", "pt_num_good_res")


def reordered_ba(fn, W, *rest):
    """fn(W, *rest) (one device-LM call -> (W, stats)) on W with its point
    slots reversed, the outputs put back in order."""
    from ldso_tpu_torch.backend.window import Window
    P = W.pt_valid.shape[0]
    assert P != W.frame_valid.shape[0]

    def flip(W):
        return Window(*(x.flip(0) if x.dim() and x.shape[0] == P else x
                        for x in W))
    Wr, stats = fn(flip(W), *rest)
    return flip(Wr), stats


def ba_diffs(a, b):
    """Between two device-LM results (W, stats): the largest pose entry
    difference, idepth difference relative to |idepth| over valid points,
    stats difference relative, and whether the bookkeeping is equal."""
    from ldso_tpu_torch.backend.window import current_poses
    (Wa, sa), (Wb, sb) = a, b
    good = Wb.pt_valid
    return dict(
        pose=float(torch.abs(current_poses(Wa) - current_poses(Wb)).max()),
        idepth=float((torch.abs(Wa.idepth - Wb.idepth)
                      / torch.abs(Wb.idepth).clamp(min=1e-6))[good].max())
        if bool(good.any()) else 0.0,
        stats=float((torch.abs(sa - sb) / torch.abs(sb).clamp(min=1e-6))
                    .max()),
        bookkeeping=all(torch.equal(getattr(Wa, n), getattr(Wb, n))
                        for n in BA_BOOKKEEPING))


class _TorchFloat64(types.ModuleType):
    """torch, with torch.float32 read as torch.float64 (float64_plain)."""

    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


class _PlainKernels(types.ModuleType):
    """ops/cuda_kernels with the device LM's kernels (K6, K7, K12) replaced
    by their plain versions on either device (float64_plain)."""

    def __getattr__(self, name):
        from ldso_tpu_torch.backend import ba, ba_device
        from ldso_tpu_torch.ops import cuda_kernels
        plain = dict(
            ba_linearize=ba.linearize_ref,
            ba_accumulate_top=ba._accumulate_top_ref,
            ba_accumulate_sc=ba._sc_sums_ref,
            ba_projector=ba_device.nullspace_projector_ref)
        return plain[name] if name in plain else getattr(cuda_kernels, name)


@contextlib.contextmanager
def float64_plain():
    """While inside, the device LM (backend/ba, ba_device, window,
    math/lie) runs its plain versions in float64 on whatever device its
    inputs are on: every `torch.float32` those modules name reads
    float64, their device constants are made in float64, and K6, K7 and
    K12 are their plain versions. The inputs are to be float64
    (`window_f64`). The yardstick of the batched BA: the same function
    with float32's rounding taken out."""
    from ldso_tpu_torch.backend import ba, ba_device, window
    from ldso_tpu_torch.math import lie
    from ldso_tpu_torch.ops import cuda_kernels, scatter
    from ldso_tpu_torch.utils import static
    proxy = _TorchFloat64("torch")
    kernels = _PlainKernels("cuda_kernels")
    const = static.device_const

    def const64(values, device, dtype=torch.float32):
        return const(values, device,
                     torch.float64 if dtype == torch.float32 else dtype)
    saved = []
    for m in (ba, ba_device, window, lie, cuda_kernels, scatter, static):
        for name, new in (("torch", proxy), ("device_const", const64),
                          ("cuda_kernels", kernels)):
            if name in m.__dict__:
                saved.append((m, name, m.__dict__[name]))
                setattr(m, name, new)
    try:
        yield
    finally:
        for m, name, old in reversed(saved):
            setattr(m, name, old)


def window_f64(W, *rest):
    """A device-LM input (W, dIs, HM, bM, newest) or result (W, stats)
    with its float tensors in float64, on their device."""
    from ldso_tpu_torch.backend.window import Window

    def f(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.double()
        return x
    return (Window(*(f(x) for x in W)),) + tuple(f(x) for x in rest)


def ba_f64(fn, W, *rest):
    """fn(W, *rest) (one device-LM call -> (W, stats)) in float64 through
    float64_plain, on the inputs' device: the reference a batch member and
    its single call are both held to."""
    with float64_plain():
        return fn(*window_f64(W, *rest))


def _linearize_depth_residual_op_order(u, v, color, weights, energy_th,
                                       idepth, R, t, affLL, dI_target,
                                       calib, cfg, outlier_slack,
                                       parts=None):
    """frontend/immature.linearize_depth_residual as it rounded before it
    took the JAX package's jitted order: the JAX package's activation run
    op by op (a true division by the focal length, every product and sum
    a separate rounding, interp.bilinear's blend). Frozen here so that
    7e's yardstick can be held on windows of both orders
    (`activation_op_order`)."""
    from ldso_tpu_torch.backend.window import RES_IN, RES_OOB, RES_OUTLIER
    from ldso_tpu_torch.frontend import immature as im
    from ldso_tpu_torch.ops.interp import bilinear
    from ldso_tpu_torch.utils.static import device_const
    fx, fy = calib.fx[0], calib.fy[0]
    cx, cy = calib.cx[0], calib.cy[0]
    W, H = calib.w[0], calib.h[0]
    dev = u.device
    patt = im._patt(dev)
    N = u.shape[0]
    if R.dim() == 2:
        R = R.expand(N, 3, 3)
        t = t.expand(N, 3)
        affLL = affLL.expand(N, 2)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    fx_t, fy_t = device_const((float(fx), float(fy)), dev)
    x = (u[:, None] + patt[None, :, 0] - cx) / fx_t
    y = (v[:, None] + patt[None, :, 1] - cy) / fy_t

    def row(i):
        return ((R[:, i, 0:1] * x + R[:, i, 1:2] * y + R[:, i, 2:3])
                + t[:, i:i + 1] * idepth[:, None])
    p0, p1, p2 = row(0), row(1), row(2)
    drescale = p2.reciprocal()
    uu = p0 * drescale
    vv = p1 * drescale
    Ku = uu * fx + cx
    Kv = vv * fy + cy
    inb = (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < W - 3) & (Kv < H - 3)
    hit = bilinear(dI_target, Ku, Kv)
    pix_ok = inb & torch.isfinite(hit[..., 0])
    oob = ~torch.all(pix_ok, dim=-1)
    r = hit[..., 0] - (affLL[:, None, 0] * color + affLL[:, None, 1])
    hw = im._huber_w(torch.abs(r), cfg)
    w2 = weights * weights
    energy = im._sum8(torch.where(pix_ok, w2 * hw * r * r * (2.0 - hw), zero))
    dxI = hit[..., 1] * fx
    dyI = hit[..., 2] * fy
    d_id = (dxI * drescale * (t[:, 0:1] - t[:, 2:3] * uu)
            + dyI * drescale * (t[:, 1:2] - t[:, 2:3] * vv))
    hww = hw * w2
    Hdd = im._sum8(torch.where(pix_ok, hww * d_id * d_id, zero))
    bd = im._sum8(torch.where(pix_ok, hww * r * d_id, zero))
    lim = energy_th * outlier_slack
    over = energy > lim
    if parts is not None:
        parts.update(energy=energy, lim=lim, inb=~oob, taps=(Ku, Kv))
    energy = torch.where(over, lim, energy)
    i32 = lambda c: torch.full((), c, dtype=torch.int32, device=dev)  # noqa: E731
    state = torch.where(oob, i32(RES_OOB),
                        torch.where(over, i32(RES_OUTLIER), i32(RES_IN)))
    return (energy, torch.where(oob, zero, Hdd), torch.where(oob, zero, bd),
            state)


@contextlib.contextmanager
def activation_op_order():
    """While inside, the plain activation (the CPU path of K5) rounds its
    residual in the earlier order (`_linearize_depth_residual_op_order`)."""
    from ldso_tpu_torch.frontend import immature as im
    keep = im.linearize_depth_residual
    im.linearize_depth_residual = _linearize_depth_residual_op_order
    try:
        yield
    finally:
        im.linearize_depth_residual = keep


def recorded_ba_windows(n_frames: int = 30, w: int = 160, h: int = 120,
                        earlier_activation: bool = False) -> list:
    """The device-LM inputs (W, dIs, HM, bM, newest, cfg, img_w, img_h,
    trips) of every BA of the port's FullSystem on the CPU over the first
    `n_frames` bench frames at w x h (Config() with loop closing off; with
    `earlier_activation` the activation in its earlier order): the windows
    7e's yardstick is held on here."""
    import dataclasses
    from ldso_tpu_torch.backend.energy_functional import EnergyFunctional
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.examples.time_modes import bench_frames
    from ldso_tpu_torch.system.full_system import FullSystem
    calib, _, images = bench_frames(n_frames, w, h, "cpu")
    fs = FullSystem(calib, dataclasses.replace(
        Config(), enable_loop_closing=False), device="cpu")
    seen = []
    inputs = EnergyFunctional.device_lm_inputs

    def recorded(self, *a, **k):
        seen.append(inputs(self, *a, **k))
        return seen[-1]
    EnergyFunctional.device_lm_inputs = recorded
    try:
        with (activation_op_order() if earlier_activation
              else contextlib.nullcontext()):
            for i, img in enumerate(images):
                fs.add_active_frame(img, i, 1.0, i * 0.05)
    finally:
        EnergyFunctional.device_lm_inputs = inputs
    return seen


def ba_batch_err(batched, singles, reference):
    """Hold a vmapped device LM's members (batched: [(W, stats)] per
    member) to their single calls (singles) with the float64 results of
    their windows (reference, `ba_f64`) as the yardstick: each member's
    distance from its float64 result against BA_F64_FACTOR times the
    largest single call's (at least the floors), its residual bookkeeping
    equal to its single call's. Returns (the largest member distance per
    quantity, the tolerance per quantity, a list of faults)."""
    near = {k: max(ba_diffs(window_f64(*s), r)[k]
                   for s, r in zip(singles, reference))
            for k in BA_ORDER_FLOORS}
    tol = {k: max(BA_F64_FACTOR * near[k], BA_ORDER_FLOORS[k])
           for k in BA_ORDER_FLOORS}
    worst = dict.fromkeys(BA_ORDER_FLOORS, 0.0)
    faults = []
    for i, (b, s, r) in enumerate(zip(batched, singles, reference)):
        d = ba_diffs(window_f64(*b), r)
        for k in worst:
            worst[k] = max(worst[k], d[k])
            if d[k] > tol[k]:
                faults.append(f"member {i}: {k} {d[k]:.3g} from float64 > "
                              f"{tol[k]:.3g}")
        if not ba_diffs(b, s)["bookkeeping"]:
            faults.append(f"member {i}: residual bookkeeping differs")
    return worst, tol, faults


def ba_batch_readings(batched, singles, reference) -> list:
    """Per member, the distances (ba_diffs) from its float64 result of the
    batch member and of its single call, and of the member from the
    single: the readings BA_F64_FACTOR is set from."""
    return [dict(member=i, batch_f64=ba_diffs(window_f64(*b), r),
                 single_f64=ba_diffs(window_f64(*s), r),
                 batch_single=ba_diffs(b, s))
            for i, (b, s, r) in enumerate(zip(batched, singles, reference))]


def _live_trips(run, call, trips: int) -> int:
    """The trips after which the device LM stops moving on `call` (its
    `done` masks the rest): the fewest of 1 .. trips whose run gives the
    full run's bits."""
    full = run(*call, trips)
    for t in range(1, trips):
        W, stats = run(*call, t)
        if torch.equal(stats, full[1]) and all(
                torch.equal(a, b) for a, b in zip(W, full[0])):
            return t
    return trips


def ba_batch_plants(batched, tol, calls=None, run=None, trips=None) -> dict:
    """Faults planted in a batch's results ([(W, stats)] per member), each
    of which ba_batch_err must refuse: member 0 given its neighbour's
    result (the batch handing a member another window), and member 1's
    newest pose moved by 10 times the pose tolerance `tol` (a translation
    along x of the newest valid frame's linearization point T_eval).
    With each member's inputs `calls` ((W, dIs, HM, bM, newest) each) and
    `run(W, dIs, HM, bM, newest, trips)` (one device-LM call; the batch
    ran `trips`), two faults of a batched path near the tolerance, each a
    real run of member 2 in its place: its last live trip lost (the run
    stops one trip before the LM's `done`), and 1 in 256 of its valid
    points masked (pt_valid false, at least one point)."""
    S = len(batched)
    out = {}
    swapped = list(batched)
    swapped[0] = batched[1 % S]
    out["neighbour's window"] = swapped
    W, stats = batched[1 % S]
    newest = int(W.frame_valid.nonzero()[-1])
    T = W.T_eval.clone()
    T[newest, 0, 3] += 10.0 * tol["pose"]
    moved = list(batched)
    moved[1 % S] = (W._replace(T_eval=T), stats)
    out["pose moved 10x the tolerance"] = moved
    if calls is not None:
        m = 2 % S
        live = _live_trips(run, calls[m], trips)
        planted = list(batched)
        planted[m] = run(*calls[m], live - 1)
        out["last live trip lost"] = planted
        W = calls[m][0]
        valid = W.pt_valid.nonzero()[:, 0]
        pv = W.pt_valid.clone()
        pv[valid[::256]] = False
        planted = list(batched)
        planted[m] = run(W._replace(pt_valid=pv), *calls[m][1:], trips)
        out["1 in 256 points masked"] = planted
    return out


def ba_plant_readings(batched, singles, reference, **plants) -> dict:
    """Per fault of ba_batch_plants(batched, tol, **plants): the planted
    batch's farthest member from float64 over the tolerance, per quantity
    (`over_tol`), and ba_batch_err's faults (none: the fault got
    through)."""
    _, tol, _ = ba_batch_err(batched, singles, reference)
    out = {}
    for name, planted in ba_batch_plants(batched, tol, **plants).items():
        worst, _, faults = ba_batch_err(planted, singles, reference)
        out[name] = dict(over_tol={k: worst[k] / tol[k] for k in tol},
                         faults=faults)
    return out


# ---------------------------------------------------------------------------
# K4: the epipolar trace of the candidate arena (csrc/immature_trace.cu)
# against its plain version (frontend/immature.trace_arena_ref)
# ---------------------------------------------------------------------------
#
# K4 runs the plain version's operations in its order (the plain version
# writes its contractions out in one fixed order, K4 contracts no
# multiply-add), so on the card the two give the same bits. The check
# still holds them as two float32 evaluations of one function, with the
# tolerances of tests/test_torch_immature.py::test_trace_twice:
#   * dead and inactive lanes (not valid, no host, sticky OOB) bitwise, in
#     all 7 fields the trace writes;
#   * an active lane's status exactly; idepth_min, idepth_max, last_u,
#     last_v and last_interval within TRACE_RTOL relative (TRACE_ATOL
#     absolute), quality within TRACE_QUALITY_RTOL;
#   * a lane may differ beyond that only where the plain version's own
#     numbers tie (`trace_ties`): its search's best energy has a rival step
#     within TRACE_TIE_ULPS float32 ulps (an 8-term sum's reordering moves
#     it by a few), the step count sits within rounding of an integer, the
#     re-score's best has a rival within the same margin, a GN `worse`
#     (e > be) or `done` (|step| < threshold) test, the outlier test or
#     the sign or finiteness of a new interval bound lies within rounding
#     of its threshold. Such a lane is a flip: it is reported by index,
#     and the flips are held to TRACE_TIE_SHARE of the live lanes.
#
# TRACE_TIE_SHARE comes from the plain version's own spread: the plain
# version with its 8-tap sums in the other order (`reordered_taps`) against
# itself on the 13 cases of the bench scene at 640x480 (trace_cases, 50,877
# live lanes in all; measured with the tree as the plain version's order
# and left to right as the other, which are now swapped) differs beyond the
# tolerances in 2 lanes, both at ties, 1 in 3,881 in the worst case
# (0.026%); tests/test_torch_trace_kernel.py::
# test_tie_share_covers_the_plain_spread holds that spread to a tenth of
# the share, which is ten times it.

TRACE_RTOL = 1e-4
TRACE_ATOL = 1e-4
TRACE_QUALITY_RTOL = 2e-3
TRACE_TIE_ULPS = 16.0
TRACE_TIE_SHARE = 0.01
# the ulps of u_min by which two evaluations of the projection may differ
# (trace_ties's `start`)
TRACE_START_ULPS = 1.0
TRACE_CLOSE = ("idepth_min", "idepth_max", "last_u", "last_v",
               "last_interval")
_EPS32 = 2.0 ** -23


def plain_trace(arena, dI, KRKis, Kts, affs, calib, cfg):
    """The plain version's trace and its intermediate values (parts)."""
    from ldso_tpu_torch.frontend import immature
    parts = {}
    out = immature.trace_arena_ref(arena, dI, KRKis, Kts, affs, calib, cfg,
                                   parts)
    return out, parts


@contextlib.contextmanager
def reordered_taps():
    """While inside, the plain versions sum their 8 taps in the other
    order: the trace (left to right, as the JAX package's jitted trace)
    in `_sum8`'s tree, the activation (the tree) left to right. The same
    functions in another order, whose spread TRACE_TIE_SHARE and
    ACT_TIE_SHARE cover."""
    from ldso_tpu_torch.frontend import immature
    tree, left_to_right = immature._sum8, immature._tap_sum
    immature._sum8, immature._tap_sum = left_to_right, tree
    try:
        yield
    finally:
        immature._sum8, immature._tap_sum = tree, left_to_right


def _near(a, b, scale=None, ulps: float = TRACE_TIE_ULPS):
    """|a - b| within `ulps` float32 ulps of the larger of |a|, |b| (or of
    `scale`)."""
    if scale is None:
        scale = torch.maximum(torch.abs(a), torch.abs(b))
    return torch.abs(a - b) <= ulps * _EPS32 * scale


def _rival(e, idx):
    """(N,) whether another column of e (N, S) ties with column idx."""
    best = torch.gather(e, 1, idx[:, None].long())
    others = torch.ones_like(e, dtype=torch.bool)
    others.scatter_(1, idx[:, None].long(), False)
    return (others & _near(e, best.expand_as(e))).any(dim=1)


def trace_ties(parts, cfg, start: bool = False) -> torch.Tensor:
    """(N,) bool: the searched lanes where the plain version's own numbers
    tie, so that another float32 evaluation may take the other branch.

    With `start`, for another evaluation of the projection too (the JAX
    package's, whose XLA contracts multiply-adds): the search starts at
    u_min - frac(1000 u_min) dxn (the reference's randShift), so a few ulps
    of u_min move every step and the GN's first position by 1000 times
    them, TRACE_START_ULPS ulps of u_min; a GN `done` test within that of
    its threshold is then a tie as well."""
    tie = _rival(parts["energies"], parts["best_idx"])
    x = parts["steps_f"]
    tie |= _near(x, torch.round(x))
    if "re_sum" in parts:
        tie |= _rival(parts["re_sum"], parts["re_idx"])
    th = torch.full_like(x, cfg.trace_gn_threshold)
    shift = 1000.0 * TRACE_START_ULPS * _EPS32 * torch.abs(parts["u_min"])
    for it, b_abs in zip(parts.get("gn", ()), parts.get("gn_b_abs", ())):
        moved = torch.abs(it["moved"])
        done = _near(moved, th, moved + b_abs / it["Hc"])
        if start:
            done |= torch.abs(moved - th) <= shift
        tie |= it["upd"] & (_near(it["e"], it["be"]) | done)
    tie |= _near(parts["best_energy"], parts["outlier_th"])
    for num, den, a1, a2, pr_a, kt_a in parts["bounds"]:
        tie |= _near(num, torch.zeros_like(num),
                     torch.abs(a1) + torch.abs(pr_a))
        tie |= _near(den, torch.zeros_like(den),
                     torch.abs(kt_a) + torch.abs(a2))
    return tie & parts["do_search"]


def _differs(got, want, rtol, atol):
    """(N,) lanes where got and want (float) disagree beyond the tolerance
    (NaN must meet NaN, an infinity its equal)."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    fin = torch.isfinite(got) & torch.isfinite(want)
    far = torch.abs(got - want) > atol + rtol * torch.abs(want)
    same_inf = ~fin & (got == want)
    return (nan_g != nan_w) | (~nan_g & ~nan_w & ~same_inf & (~fin | far))


def trace_err(plain, got, parts, cfg, share: float = TRACE_TIE_SHARE,
              start: bool = False):
    """K4's output arena `got` against the plain version's `plain` (and
    its `parts`, plain_trace's) on the same inputs. Returns a report:
    lanes, live (active) and searched lanes, the plain version's tie
    lanes, `flips` (lanes that differ, all at ties), `faults` ({what:
    lanes} that differ outside a tie, or a dead lane written), `max_err`
    (the largest |got - plain| over the active lanes' float fields, NaNs
    and infinities aside) and `ok`. `start` as trace_ties's."""
    active = parts["active"]
    dead = ~active
    ties = trace_ties(parts, cfg, start)
    faults, max_err = {}, 0.0
    differ = torch.zeros_like(active)
    for f in ("status",) + TRACE_CLOSE + ("quality",):
        g, w = getattr(got.pool, f), getattr(plain.pool, f)
        if f == "status":
            d = g != w
        else:
            rtol = TRACE_QUALITY_RTOL if f == "quality" else TRACE_RTOL
            d = _differs(g, w, rtol, TRACE_ATOL)
            fin = active & torch.isfinite(g) & torch.isfinite(w)
            if bool(fin.any()):
                max_err = max(max_err, float(torch.abs(g - w)[fin].max()))
        bad = dead & ~(g.view(torch.int32) == w.view(torch.int32))
        if bool(bad.any()):
            faults[f"{f} of a dead lane"] = _idx(bad)
        d = d & active
        differ |= d
        if bool((d & ~ties).any()):
            faults[f] = _idx(d & ~ties)
    for f in got.pool._fields:
        if f not in TRACE_CLOSE + ("status", "quality") and \
                getattr(got.pool, f) is not getattr(plain.pool, f) and \
                not bits(getattr(got.pool, f), getattr(plain.pool, f)).all():
            faults[f"{f} (not written by the trace)"] = [-1]
    flips = _idx(differ & ties)
    live = int(active.sum())
    return dict(lanes=int(active.numel()), live=live,
                searched=int(parts["do_search"].sum()),
                ties=int(ties.sum()), flips=flips, faults=faults,
                max_err=max_err,
                ok=not faults and len(flips) <= share * max(live, 1))


def _idx(mask):
    return [int(i) for i in torch.nonzero(mask).reshape(-1).tolist()]


# the bench frames that host candidates (window slots 0-2), and the targets
# of a first trace and of a narrowing one
TRACE_HOSTS = (0, 2, 4)
TRACE_TARGETS = (6, 8)
TRACE_SLOTS = 8                      # the main path's window slots
TRACE_LANES = 4096                   # 2 * Config().max_immature
# the searches of tests/test_torch_immature.py::test_trace_searches, the
# default (packed bilinear), a search whose step cap at 640x480 is K4's
# limit (immature.MAX_STEPS: 100 steps, 99 scored), and the nearest
# searches with K4's most re-score steps (cuda_kernels.TRACE_MAX_REFINE)
TRACE_VARIANTS = {
    "packed": dict(),
    "rotated": dict(trace_packed=False),
    "nearest packed": dict(trace_search_nearest=True, trace_refine_steps=0),
    "nearest packed refine 2": dict(trace_search_nearest=True,
                                    trace_refine_steps=2),
    "nearest rotated": dict(trace_packed=False, trace_search_nearest=True,
                            trace_refine_steps=0),
    "nearest rotated refine 2": dict(trace_packed=False,
                                     trace_search_nearest=True,
                                     trace_refine_steps=2),
    "long search": dict(max_pix_search=0.09),
    "nearest packed refine 15": dict(trace_search_nearest=True,
                                     trace_refine_steps=15),
    "nearest rotated refine 15": dict(trace_packed=False,
                                      trace_search_nearest=True,
                                      trace_refine_steps=15)}
# planted lanes of the `planted` case, by lane % 17
TRACE_PLANTS = {1: "sticky OOB", 2: "border", 3: "skipped",
                4: "badcondition", 5: "idepth_min < 0", 6: "steps at the cap",
                7: "uninitialised", 8: "was an outlier"}


def trace_scene(w: int, h: int, device, n_lanes: int = TRACE_LANES,
                seed: int = 14) -> dict:
    """The bench scene (examples/time_modes.bench_frames) at w x h: an
    arena of n_lanes candidates at random pixels of frames TRACE_HOSTS
    (window slots 0-2, overflow dropped, so every lane is live), the
    frames' pyramids, poses, calibration and Config()."""
    import dataclasses
    import numpy as np
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.examples import time_modes
    from ldso_tpu_torch.frontend import immature
    from ldso_tpu_torch.ops.preprocess import make_pyramid, upload_image
    calib, poses, images = time_modes.bench_frames(max(TRACE_TARGETS) + 1, w,
                                                   h, device)
    cfg = dataclasses.replace(Config(), enable_loop_closing=False)
    pyrs = {k: make_pyramid(upload_image(images[k], device), calib.levels)
            for k in TRACE_HOSTS + TRACE_TARGETS}
    rng = np.random.RandomState(seed)
    arena = immature.empty_arena(n_lanes, cfg, device)
    per = -(-n_lanes // len(TRACE_HOSTS)) + 1
    ys, xs = np.mgrid[8:h - 8, 8:w - 8]
    cells = (ys * w + xs).reshape(-1)
    for slot, k in enumerate(TRACE_HOSTS):
        status = np.zeros(h * w, np.int32)
        status[rng.choice(cells, min(per, cells.size), replace=False)] = 1
        pool = immature.make_pool(
            torch.from_numpy(status.reshape(h, w)).to(device),
            pyrs[k].dI[0], per, cfg)
        arena = immature.arena_add(arena, pool, slot)
    return dict(calib=calib, poses=poses, cfg=cfg, pyrs=pyrs, arena=arena)


def trace_inputs(scene: dict, target: int):
    """(KRKis, Kts, affs) of TRACE_SLOTS slots against bench frame
    `target`, formed in float64 on the host as
    FullSystem._trace_new_coarse forms them; each host gets its own
    brightness transfer."""
    import numpy as np
    calib, poses = scene["calib"], scene["poses"]
    dev = scene["arena"].host.device
    K, Ki = calib.K(0), calib.Ki(0)
    KRKis = np.tile(np.eye(3), (TRACE_SLOTS, 1, 1))
    Kts = np.zeros((TRACE_SLOTS, 3))
    affs = np.tile([1.0, 0.0], (TRACE_SLOTS, 1))
    for slot, k in enumerate(TRACE_HOSTS):
        T = poses[target] @ np.linalg.inv(poses[k])
        KRKis[slot] = K @ T[:3, :3] @ Ki
        Kts[slot] = K @ T[:3, 3]
        affs[slot] = (np.exp(0.02 * slot), 1.5 * slot)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in (KRKis, Kts, affs))


def _plant(scene, arena, dI, ins, cfg):
    """The narrowed arena with TRACE_PLANTS's lanes, dead lanes between live
    ones, and the target with NaN pixels: all three channels on 8 rows, the
    intensity alone on 3 columns."""
    import numpy as np
    from ldso_tpu_torch.frontend import immature
    _, parts = plain_trace(arena, dI, *ins, scene["calib"], cfg)
    W, H = scene["calib"].w[0], scene["calib"].h[0]
    p = arena.pool
    lane = torch.arange(p.u.shape[0], device=p.u.device)
    at = {k: (lane % 17) == k for k in TRACE_PLANTS}
    status = torch.where(at[1], immature.IPS_OOB, p.status)
    status = torch.where(at[8], immature.IPS_OUTLIER, status)
    edge = torch.tensor([2.0, 3.0, 4.0, 4.5, 5.0, 6.0, W - 7.0, W - 6.0,
                         W - 5.0, W - 4.5, W - 4.0, W - 3.0],
                        device=p.u.device)
    u = torch.where(at[2], edge[lane % edge.numel()], p.u)
    v = torch.where(at[2] & (lane % 2 == 0), edge[lane % edge.numel()]
                    * (H / W), p.v)
    idmin = torch.where(at[5], torch.full_like(p.idepth_min, -0.05),
                        p.idepth_min)
    idmin = torch.where(at[6], torch.full_like(idmin, 0.02), idmin)
    idmin = torch.where(at[7], torch.zeros_like(idmin), idmin)
    idmax = torch.where(at[3], idmin * (1.0 + 1e-4) + 1e-4, p.idepth_max)
    idmax = torch.where(at[6], torch.full_like(idmax, 5.0), idmax)
    idmax = torch.where(at[7], torch.full_like(idmax, float("inf")), idmax)
    # a gradient across the search line only: the error bound explodes
    d = torch.stack([parts["dxn"], parts["dyn"]], -1)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    n = torch.stack([-d[:, 1], d[:, 0]], -1)
    G = n[:, :, None] * n[:, None, :] + 1e-6 * d[:, :, None] * d[:, None, :]
    gradH = torch.where(at[4][:, None, None] & torch.isfinite(G), G, p.gradH)
    valid = p.valid & (lane % 9 != 0)
    host = torch.where(lane % 13 == 0, torch.full_like(arena.host, -1),
                       arena.host)
    pool = p._replace(u=u, v=v, status=status.to(torch.int32),
                      idepth_min=idmin, idepth_max=idmax, gradH=gradH,
                      valid=valid)
    pool = pool._replace(**{f: getattr(pool, f).contiguous()
                            for f in pool._fields})
    dI = dI.clone()
    dI[H // 2 - 4:H // 2 + 4] = float("nan")
    dI[:, W // 3:W // 3 + 3, 0] = float("nan")
    return immature.ImmatureArena(pool=pool, host=host.contiguous()), dI


def trace_cases(scene: dict):
    """{name: (arena, dI, KRKis, Kts, affs, cfg)}: each search of
    TRACE_VARIANTS on the scene's uninitialised arena against frame
    TRACE_TARGETS[0] and on the arena that trace made (in the same search)
    against TRACE_TARGETS[1]; then the planted lanes (`_plant`) on the
    default search's narrowed arena, against a target with NaN pixels."""
    import dataclasses
    from ldso_tpu_torch.frontend import immature
    calib, arena = scene["calib"], scene["arena"]
    t0, t1 = TRACE_TARGETS
    in0, in1 = trace_inputs(scene, t0), trace_inputs(scene, t1)
    dI0, dI1 = scene["pyrs"][t0].dI[0], scene["pyrs"][t1].dI[0]
    cases = {}
    for name, kw in TRACE_VARIANTS.items():
        cfg = dataclasses.replace(scene["cfg"], **kw)
        cases[f"{name} uninitialised"] = (arena, dI0, *in0, cfg)
        narrowed = immature.trace_arena_ref(arena, dI0, *in0, calib, cfg)
        cases[f"{name} narrowing"] = (narrowed, dI1, *in1, cfg)
    cfg = scene["cfg"]
    narrowed = cases["packed narrowing"][0]
    planted, dI = _plant(scene, narrowed, dI1, in1, cfg)
    cases["planted"] = (planted, dI, *in1, cfg)
    return cases


# ---------------------------------------------------------------------------
# K5: the keyframe's activation of the candidate arena
# (csrc/immature_activate.cu) against its plain version
# (frontend/immature.activate_arena_ref)
# ---------------------------------------------------------------------------
#
# K5 runs the plain version's operations in its order, so on the card the
# two give the same bits. The check still holds them as two float32
# evaluations of one function, with the tolerances of
# tests/test_torch_immature.py::test_activate:
#   * a dead lane (not valid, or no host) bitwise, in all five outputs;
#   * a live lane's to_opt, remove, ok and n_good exactly, its idepth
#     within ACT_RTOL relative (ACT_ATOL absolute);
#   * a lane may differ beyond that only where the plain version's own
#     numbers tie (`activate_ties`): within TRACE_TIE_ULPS float32 ulps of
#     one of the function's exact decisions (the gate's rounding to a pixel
#     and its distance test, an outlier state, the LM's accept test and its
#     convergence test, the final Hdd >= min_idepth_h_act), or the accept
#     test within ACT_ACCEPT_ULPS (`accept_ties`). Such a lane is a flip:
#     it is reported by index, and the flips are held to ACT_TIE_SHARE of
#     the live lanes (the trace's share, which
#     tests/test_torch_activate_kernel.py::
#     test_tie_share_covers_the_plain_spread holds against the plain
#     version's own spread under another order of its sums).

ACT_RTOL = 1e-4
ACT_ATOL = 1e-6
ACT_TIE_SHARE = 0.01
# the float32 ulps of the larger energy within which the LM's accept test
# e2 < e is a tie. Wider than TRACE_TIE_ULPS: an earlier step that moves
# an idepth by one ulp moves a tap's pixel, and the energies then part by
# more than a sum's reordering does. Set from the plain version's own
# spread: with the activation in the JAX package's jitted order and its
# tap sums in the other order (reordered_taps) on activate_cases at
# 640x480, 1 of 15,724 live lanes flips at an accept test, 145.3 ulps
# from a tie (tests/tools/activate_accept_ties.py; in the earlier order 2
# lanes, 73.4 and 126.5 ulps, and the margin was 256). 150 ulps ties 350
# live lanes (2.2%) that TRACE_TIE_ULPS does not (298 at 128, 605 at
# 256); on the card K5 is bitwise its plain version and the margin
# excuses no lane of phases 2 and 3 (chip_smoke.py's K5 lines).
ACT_ACCEPT_ULPS = 150.0
# the relative margin of the LM's accept test within which the JAX package
# (whose XLA contracts the projections' multiply-adds) may decide the other
# way (activate_ties's `jax`): its per-target energies differ from the
# port's by up to 4e-3 relative on the bench scene's arena (2e-4 at the
# 99th percentile), the lanes whose idepth parts by more than ACT_RTOL
# have an accept test within 2e-4 of it, and the sums over the targets
# average the per-target differences
ACT_JAX_RTOL = 1e-3
ACT_EXACT = ("to_opt", "remove", "ok", "n_good")


def plain_activate(inputs, calib):
    """The plain version's activation of `inputs` (activate_inputs's
    tuple) and its intermediate values (parts)."""
    from ldso_tpu_torch.frontend import immature
    parts = {}
    out = immature.activate_arena_ref(*inputs[:13], calib, inputs[13], parts)
    return out, parts


def activate_ties(parts, cfg, jax: bool = False,
                  accept_ulps: float = ACT_ACCEPT_ULPS) -> torch.Tensor:
    """(N,) bool: the live lanes where the plain version's own numbers tie,
    so that another float32 evaluation may take the other branch: an
    accept test within `accept_ulps`. With `jax`, for the JAX package's
    evaluation too: an accept test within ACT_JAX_RTOL of its threshold is
    then a tie as well."""
    reached, gate = parts["reached"], parts["gate"]
    tie = torch.zeros_like(reached)
    for x in parts["pixel"]:
        tie |= reached & _near(x, torch.round(x))
    tie |= gate & _near(parts["dist"], parts["dist_th"])
    to_opt = parts["to_opt"]
    for energy, lim, m in parts.get("outlier", ()):
        tie |= to_opt & m & _near(energy, lim)
    for it in parts.get("lm", ()):
        conv = torch.abs(it["step"])
        th = 1e-4 * torch.abs(it["idepth"])
        tie |= to_opt & it["upd"] & _near(conv, th)
        if jax:
            scale = torch.maximum(torch.abs(it["e2"]), torch.abs(it["e"]))
            tie |= to_opt & it["upd"] & (torch.abs(it["e2"] - it["e"])
                                         <= ACT_JAX_RTOL * scale)
    tie |= to_opt & _near(parts["Hc"], torch.full_like(
        parts["Hc"], cfg.min_idepth_h_act))
    return tie & parts["live"] | accept_ties(parts, accept_ulps)


def accept_ties(parts, ulps: float = ACT_ACCEPT_ULPS) -> torch.Tensor:
    """(N,) bool: the live lanes whose LM made an accept test e2 < e
    within `ulps` float32 ulps of the larger energy."""
    tie = torch.zeros_like(parts["reached"])
    for it in parts.get("lm", ()):
        tie |= parts["to_opt"] & it["upd"] & _near(it["e2"], it["e"],
                                                    ulps=ulps)
    return tie & parts["live"]


def activate_err(plain, got, parts, cfg, share: float = ACT_TIE_SHARE):
    """K5's outputs `got` (to_opt, remove, idepth, ok, n_good) against the
    plain version's `plain` (and its `parts`, plain_activate's) on the same
    inputs. Returns a report: lanes, live and optimised lanes, the plain
    version's tie lanes, `flips` (lanes that differ, all at ties), `faults`
    ({what: lanes} that differ outside a tie, or a dead lane written),
    `margin_ties` and `margin_flips` (the tie lanes and flips that only
    ACT_ACCEPT_ULPS's margin over TRACE_TIE_ULPS makes ties), `max_err`
    (the largest |got - plain| idepth over the optimised lanes, NaNs and
    infinities aside) and `ok`."""
    live = parts["live"]
    dead = ~live
    ties = activate_ties(parts, cfg)
    margin = ties & ~activate_ties(parts, cfg, accept_ulps=TRACE_TIE_ULPS)
    names = ("to_opt", "remove", "idepth", "ok", "n_good")
    faults, max_err = {}, 0.0
    differ = torch.zeros_like(live)
    for name, g, w in zip(names, got, plain):
        if name == "idepth":
            d = _differs(g, w, ACT_RTOL, ACT_ATOL)
            fin = parts["to_opt"] & torch.isfinite(g) & torch.isfinite(w)
            if bool(fin.any()):
                max_err = max(max_err, float(torch.abs(g - w)[fin].max()))
            same = g.view(torch.int32) == w.view(torch.int32)
        else:
            d = g != w
            same = ~d
        bad = dead & ~same
        if bool(bad.any()):
            faults[f"{name} of a dead lane"] = _idx(bad)
        d = d & live
        differ |= d
        if bool((d & ~ties).any()):
            faults[name] = _idx(d & ~ties)
    flips = _idx(differ & ties)
    n_live = int(live.sum())
    return dict(lanes=int(live.numel()), live=n_live,
                optimised=int(parts["to_opt"].sum()), ties=int(ties.sum()),
                flips=flips, faults=faults, max_err=max_err,
                margin_ties=int(margin.sum()),
                margin_flips=_idx(differ & margin),
                ok=not faults and len(flips) <= share * max(n_live, 1))


# the bench frames of the window's slots: slots 0-2 host the arena's
# candidates (trace_scene's TRACE_HOSTS), the newest slot is nf - 1; past
# the main path's 8 slots, bench frames 9, 10, ... up to K5's 32 slots
# (cuda_kernels.ACTIVATE_MAX_SLOTS)
ACT_WINDOW = (0, 2, 4, 6, 8, 1, 3, 5)
ACT_SLOT_FRAMES = ACT_WINDOW + tuple(range(9, 33))
ACT_FRAMES = (2, 4, 8)               # the windows of activate_cases
ACT_OCCUPIED = 0.02                  # the share of occupied level-1 cells
# planted lanes of the `planted` case, by lane % 19
ACT_PLANTS = {1: "border", 2: "NaN pixels", 3: "Hdd under the gate",
              4: "converges at the first step", 5: "energy at the limit",
              6: "host == newest", 7: "host out of range", 8: "outlier",
              9: "uninitialised", 10: "no idepth_max", 11: "wide interval"}


def activate_scene(w: int, h: int, device, n_lanes: int = TRACE_LANES,
                   seed: int = 15, slots: int = TRACE_SLOTS) -> dict:
    """The bench scene at w x h with an activation arena: trace_scene's
    n_lanes candidates (hosted by window slots 0-2) after one trace against
    bench frame 6, so their intervals and statuses are a trace's; the
    level-0 images and poses of the bench frames of the first `slots`
    window slots (ACT_SLOT_FRAMES, at least ACT_WINDOW); a random occupancy
    of ACT_OCCUPIED of the level-1 cells and its distance map (K1 on the
    card, its plain version on the CPU)."""
    import numpy as np
    from ldso_tpu_torch.examples import time_modes
    from ldso_tpu_torch.frontend import immature
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.ops.preprocess import make_pyramid, upload_image
    scene = trace_scene(w, h, device, n_lanes)
    calib, cfg = scene["calib"], scene["cfg"]
    arena = immature.trace_arena_ref(scene["arena"], scene["pyrs"][6].dI[0],
                                     *trace_inputs(scene, 6), calib, cfg)
    frames = ACT_SLOT_FRAMES[:max(slots, len(ACT_WINDOW))]
    _, poses, images = time_modes.bench_frames(max(frames) + 1, w, h, device)
    dI = {k: make_pyramid(upload_image(images[k], device),
                          calib.levels).dI[0] for k in frames}
    rng = np.random.RandomState(seed)
    w1, h1 = calib.w[1], calib.h[1]
    occ = torch.from_numpy(rng.rand(h1, w1) < ACT_OCCUPIED).to(device)
    dist_map = cuda_kernels.distance_transform(occ, cfg.dist_map_steps)
    return dict(calib=calib, cfg=cfg, poses=poses, arena=arena, dI=dI,
                dist_map=dist_map)


def activate_inputs(scene: dict, nf: int, arena=None, dIs=None,
                    marg=(), min_act_dist: float = 2.0,
                    slots: int = TRACE_SLOTS):
    """The activation's inputs with a window of nf frames (ACT_SLOT_FRAMES's
    first nf) in `slots` slots, the tables formed in float64 on the host as
    FullSystem._activate_points forms them: (arena, dist_map, KRKis, Kts,
    Rs, ts, affs, masks, dIs, min_act_dist, marg_flags, newest, nf, cfg).
    `marg` lists flagged slots; slots past nf are flagged too."""
    import numpy as np
    calib, poses = scene["calib"], scene["poses"]
    dev = scene["dist_map"].device
    F = slots
    T = [poses[k] for k in ACT_SLOT_FRAMES[:nf]]
    newest = nf - 1
    K1, Ki0 = calib.K(1), calib.Ki(0)
    KRKis = np.tile(np.eye(3), (F, 1, 1))
    Kts = np.zeros((F, 3))
    Rs = np.tile(np.eye(3), (F, F, 1, 1))
    ts = np.zeros((F, F, 3))
    affs = np.tile([1.0, 0.0], (F, F, 1))
    masks = np.zeros((F, F), bool)
    for i in range(nf):
        T_rel = T[newest] @ np.linalg.inv(T[i])
        KRKis[i] = K1 @ T_rel[:3, :3] @ Ki0
        Kts[i] = K1 @ T_rel[:3, 3]
        for j in range(nf):
            if j != i:
                T_ht = T[j] @ np.linalg.inv(T[i])
                Rs[i, j], ts[i, j] = T_ht[:3, :3], T_ht[:3, 3]
                masks[i, j] = True
    marg_flags = np.arange(F) >= nf
    marg_flags[list(marg)] = True
    if dIs is None:
        dIs = torch.stack([scene["dI"][ACT_SLOT_FRAMES[k]] for k in range(F)])
    f32 = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=dev)
    return (scene["arena"] if arena is None else arena, scene["dist_map"],
            f32(KRKis), f32(Kts), f32(Rs), f32(ts), f32(affs),
            torch.as_tensor(masks, device=dev), dIs.contiguous(),
            f32([min_act_dist]).reshape(()),
            torch.as_tensor(marg_flags, device=dev), newest, nf,
            scene["cfg"])


def _plant_activation(scene: dict, inputs):
    """The window of 8 frames with ACT_PLANTS's lanes, dead lanes between
    live ones (not valid, or no host), two (host, target) pairs masked,
    slot 1 flagged for marginalization and NaN pixels in two targets (all
    three channels on 8 rows of slot 3, the intensity alone on 3 columns
    of slot 4)."""
    import numpy as np
    from ldso_tpu_torch.frontend import immature
    calib = scene["calib"]
    arena = inputs[0]
    _, parts = plain_activate(inputs, calib)
    W, H = calib.w[0], calib.h[0]
    p = arena.pool
    dev = p.u.device
    lane = torch.arange(p.u.shape[0], device=dev)
    at = {k: (lane % 19) == k for k in ACT_PLANTS}
    edge = torch.tensor([2.0, 3.0, 4.0, W - 5.0, W - 4.0, W - 3.0],
                        device=dev)
    u = torch.where(at[1], edge[lane % edge.numel()], p.u)
    v = torch.where(at[1] & (lane % 2 == 0), edge[lane % edge.numel()]
                    * (H / W), p.v)
    weights = torch.where(at[3][:, None], p.weights * 0.05, p.weights)
    weights = torch.where(at[4][:, None], torch.zeros_like(weights), weights)
    # the energy of the lane's first evaluation at slack 1 against its
    # first live target: that evaluation's outlier test meets its limit
    F = TRACE_SLOTS
    e_first = torch.full_like(p.energy_th, float("nan"))
    for energy, _, m in reversed(parts["outlier"][F:2 * F]):
        e_first = torch.where(m, energy, e_first)
    energy_th = torch.where(at[5] & torch.isfinite(e_first), e_first,
                            p.energy_th)
    status = torch.where(at[8], immature.IPS_OUTLIER, p.status)
    status = torch.where(at[9], immature.IPS_UNINITIALIZED, status)
    idmax = torch.where(at[10], torch.full_like(p.idepth_max, float("inf")),
                        p.idepth_max)
    last_int = torch.where(at[11], torch.full_like(p.last_interval, 9.0),
                           p.last_interval)
    newest = inputs[11]
    host = torch.where(at[6], torch.full_like(arena.host, newest),
                       arena.host)
    host = torch.where(at[7], torch.full_like(host, F + 2), host)
    host = torch.where(lane % 11 == 0, torch.full_like(host, -1), host)
    valid = p.valid & (lane % 13 != 0)
    pool = p._replace(u=u, v=v, weights=weights, energy_th=energy_th,
                      status=status.to(torch.int32), idepth_max=idmax,
                      last_interval=last_int, valid=valid)
    pool = pool._replace(**{f: getattr(pool, f).contiguous()
                            for f in pool._fields})
    masks = inputs[7].clone()
    masks[0, 3] = masks[1, 5] = False
    marg = inputs[10].clone()
    marg[1] = True
    dIs = inputs[8].clone()
    dIs[3, H // 2 - 4:H // 2 + 4] = float("nan")
    dIs[4, :, W // 3:W // 3 + 3, 0] = float("nan")
    planted = immature.ImmatureArena(pool=pool, host=host.contiguous())
    return (planted, *inputs[1:7], masks, dIs, inputs[9], marg,
            *inputs[11:])


def activate_cases(scene: dict):
    """{name: activate_inputs's tuple}: windows of ACT_FRAMES frames on the
    scene's arena, slot 2 flagged for marginalization in the window of 4,
    then the planted lanes (`_plant_activation`) in the window of 8."""
    cases = {}
    for nf in ACT_FRAMES:
        cases[f"window {nf}"] = activate_inputs(
            scene, nf, marg=(2,) if nf == 4 else ())
    cases["planted"] = _plant_activation(scene, cases[f"window {TRACE_SLOTS}"])
    return cases


# ---------------------------------------------------------------------------
# K6 and K7: the windowed BA's linearization (ops/cuda_kernels.ba_linearize)
# and accumulation (ba_accumulate_top, ba_accumulate_sc) against their plain
# versions (backend/ba.linearize_ref, _accumulate_top_ref, _sc_sums_ref)
# ---------------------------------------------------------------------------
#
# K6 runs the plain version's operations in its order (the plain version
# writes its projections, 8-tap sums and energy sum out in K6's order, K6
# contracts no multiply-add), so on the card the two give the same bits:
# `lin_err` wants every field and the energy sum bitwise (a NaN equal to a
# NaN).
#
# K7 sums over the points in point order, the plain versions in einsum's
# and matmul's order: two float32 sums of the same terms. A float32 sum of
# n terms in any order lies within about n 2^-24 of their magnitudes' sum
# from the exact one, so `acc_err` holds each entry to ACC_RTOL times its
# own magnitude sum (`acc_scale`: the plain version on the magnitudes of its
# inputs, which bounds the magnitudes of every product it sums). That is
# the floor that holds the entries whose terms cancel (b and the residual
# column near convergence, where they are rounding-sized) without loosening
# the others; the report also gives each output's error relative to its
# largest entry. ACC_RTOL is 1e-4: the sequential bound for the ~2,000
# terms of the largest host's sums is 1.2e-4, their typical rounding some
# 1e-6 (tests/test_torch_ba_kernels.py::test_acc_err_passes_a_reordered_sum
# holds the plain version with its points reversed within a tenth of it),
# and a sum missing one of 256 points moves its entries by some 4e-3
# (test_acc_err_catches_planted_faults). NaN entries must match (K7 skips
# masked residuals but writes NaN where the plain version's 0 x term is
# NaN), counts exactly.

ACC_RTOL = 1e-4
BA_SLOTS = 8                 # the main path's window slots
BA_POINTS = 2048             # Config().max_points
# the planted lanes of `ba_plant`, by the point index they start at (every
# 23rd point from there): the kinds the CPU tests and chip_smoke.py name
BA_PLANTS = {1: "centre out of bounds", 2: "outlier", 3: "sticky OOB",
             4: "masked point", 5: "linearized", 6: "not existing",
             7: "at the Huber threshold"}
BA_PLANT_STRIDE = 23


def ba_scene(n_frames: int, F: int, n_pts: int, w: int, h: int,
             seed: int = 0, device="cpu"):
    """A BA window of the port alone at any size (the CPU tests and
    chip_smoke.py's phase 2): n_frames of F slots along a lateral path over
    a PlaneScene (the poses after the first 2e-3 off the truth), n_pts
    points on a grid hosted by the frames in turn (their idepths 5% off;
    the second half with a depth prior), linearized by the plain version,
    its energy thresholds set and its residuals applied; every 5th point's
    residuals fixed (linearized, res_toZero); then the frames' states and
    the points' idepths moved by small steps (so J delta is not 0). Returns
    dict(W (the window a linearization starts from), W_lin (it linearized
    and applied, the input of an accumulation), dIs, cfg, calib, w, h)."""
    import numpy as np
    from ldso_tpu_torch.backend import ba, ba_device
    from ldso_tpu_torch.backend.energy_functional import EnergyFunctional
    from ldso_tpu_torch.config import Config, PATTERN
    from ldso_tpu_torch.math import lie_np
    from ldso_tpu_torch.ops.interp import bilinear
    from ldso_tpu_torch.ops.preprocess import make_pyramid
    from ldso_tpu_torch.synthetic import PlaneScene, default_calib
    cfg = Config(max_points=n_pts)
    calib = default_calib(w, h)
    scene = PlaneScene(freq_hi=18.0, contrast=80.0)
    rng = np.random.RandomState(seed)
    ef = EnergyFunctional(cfg, calib, F=F, P=n_pts, device=device)
    dIs, ideps = [], []
    for i in range(n_frames):
        T = lie_np.se3_exp(np.array([0.03 * i, 0.01 * i, 0.0, 0.0, 0.0,
                                     0.0]))
        img, idep = scene.render(calib, T, device=device)
        dIs.append(make_pyramid(img, calib.levels).dI[0])
        ideps.append(idep.cpu().numpy())
        if i > 0:
            T = lie_np.se3_exp(rng.randn(6) * 2e-3) @ T
        ef.insert_frame(T, exposure=1.0, aff=np.zeros(2), is_first=(i == 0))
    side = int(np.ceil(np.sqrt(n_pts)))
    gx, gy = np.meshgrid(np.linspace(8, w - 9, side),
                         np.linspace(8, h - 9, side))
    u, v = gx.reshape(-1)[:n_pts], gy.reshape(-1)[:n_pts]
    host = np.arange(n_pts) % n_frames
    idep = np.array([ideps[f][int(y), int(x)] for f, x, y in zip(host, u, v)])
    idep = idep * (1.0 + rng.randn(n_pts) * 0.05)
    patt = torch.tensor(PATTERN, dtype=torch.float32, device=device)
    color = np.zeros((n_pts, 8), np.float32)
    gsq = np.zeros((n_pts, 8), np.float32)
    for f in range(n_frames):
        sel = host == f
        uv = [torch.tensor(a[sel], dtype=torch.float32, device=device)[:, None]
              + patt[None, :, k] for k, a in enumerate((u, v))]
        ptc = bilinear(dIs[f], uv[0], uv[1]).cpu().numpy()
        color[sel] = ptc[..., 0]
        gsq[sel] = np.sum(ptc[..., 1:3] ** 2, -1)
    weights = np.sqrt(cfg.outlier_th_sum_component
                      / (cfg.outlier_th_sum_component + gsq))
    th = np.full(n_pts, 8.0 * cfg.outlier_th, np.float32)
    half = n_pts // 2
    for lo, hi, prior in ((0, half, False), (half, n_pts, True)):
        ef.insert_points(host[lo:hi], u[lo:hi], v[lo:hi], color[lo:hi],
                         weights[lo:hi], idep[lo:hi], th[lo:hi],
                         has_depth_prior=prior)
    dIs = torch.stack(dIs + [torch.zeros_like(dIs[0])] * (F - n_frames))

    def lin(W):
        out, _ = ba.linearize_ref(W, dIs, ba.make_precalc(W), cfg, w, h)
        W = ba.set_new_frame_energy_th(W._replace(**out), n_frames - 1, cfg)
        return ba.apply_res(W)
    W = lin(ba_device._reset_oob_dev(ef.W))
    fixed = torch.zeros(n_pts, dtype=torch.bool, device=device)
    fixed[::5] = True
    W = ba.fix_linearization(W, fixed & W.pt_valid)
    f32 = dict(dtype=torch.float32, device=device)
    step = torch.zeros((F, 10), **f32)
    step[1:n_frames, :8] = torch.tensor(rng.randn(n_frames - 1, 8) * 1e-3,
                                        **f32)
    W = W._replace(state=W.state + step, idepth=W.idepth * (
        1.0 + torch.tensor(rng.randn(n_pts) * 0.01, **f32)))
    return dict(W=W, W_lin=lin(W), dIs=dIs, cfg=cfg, calib=calib, w=w, h=h,
                n_frames=n_frames)


def _every(P: int, start: int, device):
    m = torch.zeros(P, dtype=torch.bool, device=device)
    m[start::BA_PLANT_STRIDE] = True
    return m


def ba_plant(scene: dict):
    """The scene's window with BA_PLANTS planted (points moved an image
    width left of the border, colours off by 250 grey levels, residuals OOB before, points
    invalid, residuals linearized or not existing) and a NaN patch in the
    second frame's image; its Config's Huber threshold set to one tap's
    |residual| bit for bit (the plain version's own arithmetic), so that
    tap sits on the threshold. Returns (W, dIs, cfg)."""
    import dataclasses
    from ldso_tpu_torch.backend import ba
    from ldso_tpu_torch.backend.window import RES_OOB
    W, dIs, cfg = scene["W"], scene["dIs"].clone(), scene["cfg"]
    P, F = W.P, W.F
    dev = W.state.device
    at = {k: _every(P, k, dev) for k in BA_PLANTS}
    h, w = dIs.shape[1], dIs.shape[2]
    dIs[1, h // 3:h // 3 + h // 8, w // 3:w // 3 + w // 6] = float("nan")
    W = W._replace(
        pt_u=torch.where(at[1], torch.full_like(W.pt_u, -float(w)), W.pt_u),
        pt_color=torch.where(at[2][:, None], W.pt_color + 250.0, W.pt_color),
        res_state=torch.where(at[3][:, None], torch.full_like(
            W.res_state, RES_OOB), W.res_state),
        pt_valid=W.pt_valid & ~at[4],
        res_linearized=W.res_linearized | at[5][:, None],
        res_exist=W.res_exist & ~(at[6][:, None]
                                  & (torch.arange(F, device=dev) % 2 == 0)))
    # the Huber threshold: |resid| of tap 0 of point 7's residual in the
    # slot after its host's
    p = 7
    pc = ba.make_precalc(W)
    seen = {}

    def hit_fn(Ku, Kv):
        seen["hit"] = ba._bilinear_frames(
            dIs, torch.arange(F, device=dev)[None, :, None], Ku, Kv)
        return seen["hit"]
    hh = W.pt_host
    ba._residual_core(W, pc, cfg, scene["w"], scene["h"], pc.R0[hh],
                      pc.t0[hh], pc.KRKi[hh], pc.Kt[hh], pc.aff[hh],
                      pc.b0[hh][:, None].expand(P, F), hit_fn,
                      W.pt_color[:, None, :], W.pt_weights[:, None, :],
                      W.idepth_zero, W.idepth, torch.zeros((P, F), device=dev),
                      torch.zeros((P, F), dtype=torch.bool, device=dev),
                      W.res_energy)
    aff = pc.aff[hh][:, :, None, :]
    resid = seen["hit"][..., 0] - (aff[..., 0] * W.pt_color[:, None, :]
                                   + aff[..., 1])
    t = (int(hh[p]) + 1) % scene["n_frames"]
    cfg = dataclasses.replace(cfg, huber_th=float(torch.abs(resid[p, t, 0])))
    return W, dIs, cfg


def lin_cases(scene: dict):
    """K6's cases on a scene: name -> (W, dIs, cfg, tgt): the window, its
    newest frame's column, the planted window (whole and the column) and
    the planted window with both affine parameters off (modes < 0)."""
    import dataclasses
    W, dIs, cfg = scene["W"], scene["dIs"], scene["cfg"]
    newest = scene["n_frames"] - 1
    Wp, dIp, cfgp = ba_plant(scene)
    off = dataclasses.replace(cfgp, affine_opt_mode_a=-1.0,
                              affine_opt_mode_b=-1.0)
    return {"window": (W, dIs, cfg, None), "column": (W, dIs, cfg, newest),
            "planted": (Wp, dIp, cfgp, None),
            "planted column": (Wp, dIp, cfgp, 1),
            "affine off": (Wp, dIp, off, None)}


def linearized(W, dIs, cfg, w: int, h: int):
    """W linearized by the plain version, its newest frame's energy
    threshold set and its residuals applied: an accumulation's input."""
    from ldso_tpu_torch.backend import ba
    out, _ = plain_lin(W, dIs, cfg, w, h)
    W = ba.set_new_frame_energy_th(W._replace(**out),
                                   int(W.frame_valid.sum()) - 1, cfg)
    return ba.apply_res(W)


def plain_lin(W, dIs, cfg, w: int, h: int, tgt=None):
    from ldso_tpu_torch.backend import ba
    return ba.linearize_ref(W, dIs, ba.make_precalc(W), cfg, w, h, tgt)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.float32:
        return ((a.view(torch.int32) == b.view(torch.int32))
                | (torch.isnan(a) & torch.isnan(b)))
    return a == b


def lin_err(got, want) -> dict:
    """K6's (fields, energy sum) against the plain version's: the entries
    of each field that are not bitwise equal, the largest difference, and
    whether the energy sums are; ok when all are bitwise."""
    (gf, ge), (wf, we) = got, want
    bad = {k: int((~_bits_equal(gf[k], wf[k])).sum()) for k in wf}
    err = max(float(torch.nan_to_num(torch.abs(
        gf[k].float() - wf[k].float()), nan=0.0).max()) for k in wf)
    energy = bool(_bits_equal(ge, we).all())
    return dict(ok=energy and not any(bad.values()), not_bitwise=bad,
                max_abs_err=err, energy_bitwise=energy)


def _magnitudes(W, pc=None):
    """W (and its precalc) with every Jacobian piece, residual and step of
    the accumulations replaced by its magnitude (the idepth step as
    idepth - 0), so that the plain versions' sums become sums of their
    terms' magnitudes."""
    a = torch.abs
    W = W._replace(JIdx=a(W.JIdx), Jpdc=a(W.Jpdc), Jpdxi=a(W.Jpdxi),
                   JabF=a(W.JabF), Jpdd=a(W.Jpdd), resF=a(W.resF),
                   res_toZero=a(W.res_toZero),
                   idepth=a(W.idepth - W.idepth_zero),
                   idepth_zero=torch.zeros_like(W.idepth_zero))
    if pc is None:
        return W, None
    return W, pc._replace(adHTdelta=a(pc.adHTdelta), c_delta=a(pc.c_delta))


def acc_cases(W):
    """K7's calls on a linearized and applied window: name -> (part, the
    arguments after W): the top part in modes 0 and 1 over the valid
    points and in mode 2 over every third valid point, the Schur part with
    the shifted prior over the valid points (build_system's) and without
    over every third (accumulate_marg's), fed the top part's per-point
    sums."""
    from ldso_tpu_torch.backend import ba
    pc = ba.make_precalc(W)
    marg = W.pt_valid & (torch.arange(W.P, device=W.pt_valid.device) % 3
                         == 0)
    tops = {m: ba._accumulate_top_ref(W, pc, m, W.pt_valid) for m in (0, 1)}
    t2 = ba._accumulate_top_ref(W, pc, 2, marg)
    return {"top mode 0": ("top", (pc, 0, W.pt_valid)),
            "top mode 1": ("top", (pc, 1, W.pt_valid)),
            "top mode 2": ("top", (pc, 2, marg)),
            "sc build": ("sc", (tops[0][1] + tops[1][1],
                                tops[0][2] + tops[1][2],
                                tops[0][3] + tops[1][3], True, W.pt_valid)),
            "sc marg": ("sc", (t2[1], t2[2], t2[3], False, marg))}


def plain_acc(part: str, W, args) -> dict:
    """The plain version of K7's `part` ("top" or "sc") as a dict of its
    outputs (cuda_kernels.TOP_OUTPUTS or SC_OUTPUTS)."""
    from ldso_tpu_torch.backend import ba
    from ldso_tpu_torch.ops.cuda_kernels import TOP_OUTPUTS
    if part == "top":
        return dict(zip(TOP_OUTPUTS, ba._accumulate_top_ref(W, *args)))
    return ba._sc_sums_ref(W, *args)


def kernel_acc(part: str, W, args) -> dict:
    """K7's `part` through its wrapper (the plain version on the CPU)."""
    from ldso_tpu_torch.ops import cuda_kernels as ck
    if part == "top":
        return dict(zip(ck.TOP_OUTPUTS, ck.ba_accumulate_top(W, *args)))
    return ck.ba_accumulate_sc(W, *args)


def acc_scale(part: str, W, args) -> dict:
    """Each output entry's magnitude sum: the plain version on the
    magnitudes of its inputs (`_magnitudes`; the Schur part's per-point
    sums bd and Hcd as magnitudes too)."""
    if part == "top":
        Wm, pc = _magnitudes(W, args[0])
        return plain_acc("top", Wm, (pc,) + tuple(args[1:]))
    Hdd, bd, Hcd, shift, mask = args
    return plain_acc("sc", _magnitudes(W)[0],
                     (Hdd, torch.abs(bd), torch.abs(Hcd), shift, mask))


def acc_err(got: dict, want: dict, scale: dict,
            rtol: float = ACC_RTOL) -> dict:
    """K7's outputs against the plain version's: integer outputs exact;
    float outputs NaN where the plain version's are and within rtol times
    each entry's magnitude sum elsewhere. Returns dict(ok, faults, worst:
    {output: largest err / tolerance}, rel_largest: {output: largest err
    over the output's largest entry}, max_abs_err)."""
    faults, worst, rel, max_abs = [], {}, {}, 0.0
    for k, w in want.items():
        g = got[k]
        if not w.is_floating_point():
            if not torch.equal(g.to(w.dtype), w):
                faults.append(f"{k}: counts differ")
            continue
        if tuple(g.shape) != tuple(w.shape):
            faults.append(f"{k}: shape {tuple(g.shape)} != {tuple(w.shape)}")
            continue
        nan_w, nan_g = torch.isnan(w), torch.isnan(g)
        if not torch.equal(nan_w, nan_g):
            faults.append(f"{k}: NaN at {int((nan_w != nan_g).sum())} "
                          f"entries where the other is not")
        ok = ~nan_w & ~nan_g
        err = torch.where(ok, torch.abs(g - w), torch.zeros_like(w))
        tol = rtol * torch.nan_to_num(scale[k].reshape(w.shape), nan=0.0)
        ratio = torch.where(err > 0, err / torch.clamp(tol, min=1e-38),
                            torch.zeros_like(err))
        worst[k] = float(ratio.max()) if ratio.numel() else 0.0
        big = float(torch.where(ok, torch.abs(w), torch.zeros_like(w)).max()) \
            if w.numel() else 0.0
        rel[k] = float(err.max()) / big if big > 0 else float(err.max())
        max_abs = max(max_abs, float(err.max()) if err.numel() else 0.0)
        if worst[k] > 1.0:
            faults.append(f"{k}: error {worst[k]:.3g} x its tolerance")
    return dict(ok=not faults, faults=faults, worst=worst, rel_largest=rel,
                max_abs_err=max_abs)


def _seq(terms):
    """sum_k terms[k] in order from 0.0, each add its own rounding."""
    acc = torch.zeros_like(terms[0])
    for x in terms:
        acc = acc + x
    return acc


def _tree8(x):
    """The last axis (8) by the tree ((x0 + x1) + (x2 + x3)) + ((x4 + x5)
    + (x6 + x7))."""
    x = x[..., 0::2] + x[..., 1::2]
    x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0] + x[..., 1]


def _acc_chunks(host, listed, F: int, chunk: int):
    """K7's chunks of a window: the points in `listed` by host, in point
    order within a host, cut into chunks of `chunk` (a host with none has
    one empty chunk). Returns (M (T, chunk) point indices, -1 past a
    chunk's end, and per host its chunks' rows of M in order (F, n) padded
    with -1)."""
    rows, per_host = [], []
    for h in range(F):
        pts = torch.nonzero(listed & (host == h))[:, 0]
        n = max(1, -(-pts.numel() // chunk))
        per_host.append(list(range(len(rows), len(rows) + n)))
        for c in range(n):
            part = pts[c * chunk:(c + 1) * chunk]
            rows.append(torch.nn.functional.pad(part, (0, chunk - part.numel()),
                                                value=-1))
    width = max(len(c) for c in per_host)
    order = torch.tensor([c + [-1] * (width - len(c)) for c in per_host],
                         dtype=torch.long)
    return torch.stack(rows), order


def _chunk_sums(M, order, include, terms):
    """Each entry summed over every chunk's included points in order from
    0.0, then over each host's chunks in order from 0.0: M, order from
    `_acc_chunks`; include (P, X) bool, terms (P, X, ...) float32 per
    point. Returns (F, X, ...)."""
    M = M.to(terms.device)
    acc = torch.zeros((M.shape[0],) + tuple(terms.shape[1:]),
                      dtype=terms.dtype, device=terms.device)
    ext = (None,) * (terms.dim() - include.dim())
    for i in range(M.shape[1]):
        idx = M[:, i]
        ok = (idx >= 0)[:, None] & include[idx.clamp(min=0)]
        acc = torch.where(ok[(...,) + ext], acc + terms[idx.clamp(min=0)], acc)
    tot = torch.zeros((order.shape[0],) + tuple(acc.shape[1:]),
                      dtype=acc.dtype, device=acc.device)
    for c in range(order.shape[1]):
        idx = order[:, c].to(acc.device)
        tot = torch.where((idx >= 0).reshape((-1,) + (1,) * (acc.dim() - 1)),
                          tot + acc[idx.clamp(min=0)], tot)
    return tot


def _nonfinite_bits(x):
    """(P, F, ..., n) -> (F,) int: bit c set where entry c of the last axis
    is not finite at any point of that column."""
    bad = ~torch.isfinite(x)
    bad = bad.reshape(x.shape[0], x.shape[1], -1, x.shape[-1]).any(2).any(0)
    weights = 2 ** torch.arange(x.shape[-1], device=x.device)
    return (bad.long() * weights).sum(-1)


def _bit(words, bit):
    return (words >> bit) & 1 == 1


# K7's order of sums: these mirror csrc/ba_accumulate.cu's kChunk (a
# host's listed points in chunks of ACC_CHUNK), kRes (Hcc_sc and bc_sc per
# point-stage block of ACC_RESIDUALS // F whole points) and kHccSplit (the
# blocks in ACC_HCC_RUNS runs of consecutive ones)
ACC_CHUNK = 32
ACC_RESIDUALS = 32
ACC_HCC_RUNS = 8


def acc_emulated(part: str, W, args) -> dict:
    """K7's `part` in K7's own order of operations and sums (csrc/
    ba_accumulate.cu), written out in float32 PyTorch: every multiply and
    add rounded on its own (K7 is built with --fmad=false), a residual's
    sums over its taps by sum8's tree, a host's listed points in chunks of
    ACC_CHUNK summed in order and the chunks in order, Hcc_sc and bc_sc
    per point-stage block of ACC_RESIDUALS // F points and the blocks in
    ACC_HCC_RUNS runs, NaN from the same flags. On the card K7 gives these
    bits. The arguments and outputs are plain_acc's."""
    P, F = W.P, W.F
    dev = W.state.device
    host = W.pt_host.clamp(0, F - 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    nan = torch.full((), float("nan"), device=dev)
    ji0, ji1 = W.JIdx[:, :, 0], W.JIdx[:, :, 1]              # (P, F, 8)
    jab0, jab1 = W.JabF[:, :, 0], W.JabF[:, :, 1]
    jd0, jd1 = W.Jpdd[..., 0], W.Jpdd[..., 1]                  # (P, F)
    if part == "top":
        pc, mode, pt_mask = args
        mask = (W.res_active & W.res_exist & W.frame_valid[None, :]
                & pt_mask[:, None])
        if mode == 0:
            mask = mask & ~W.res_linearized
        elif mode == 1:
            mask = mask & W.res_linearized
        res = W.resF if mode == 0 else W.res_toZero
        if mode == 1:
            dp = pc.adHTdelta[host]                                # (P, F, 8)
            dd = (W.idepth - W.idepth_zero)[:, None]
            Jp = [(_seq([W.Jpdxi[:, :, x, j] * dp[..., j] for j in range(6)])
                   + _seq([W.Jpdc[:, :, x, j] * pc.c_delta[j]
                           for j in range(4)])) + W.Jpdd[..., x] * dd
                  for x in range(2)]
            res = res + (((ji0 * Jp[0][..., None] + ji1 * Jp[1][..., None])
                          + jab0 * dp[..., 6:7]) + jab1 * dp[..., 7:8])
        jc, xi = W.Jpdc[:, :, None], W.Jpdxi[:, :, None]          # (P, F, 1, 2, .)
        rows = torch.cat([ji0[..., None] * jc[..., 0, :]
                          + ji1[..., None] * jc[..., 1, :],
                          ji0[..., None] * xi[..., 0, :]
                          + ji1[..., None] * xi[..., 1, :],
                          jab0[..., None], jab1[..., None], res[..., None]],
                         dim=-1)                                   # (P, F, 8, 13)
        jr0, jr1 = _tree8(ji0 * res), _tree8(ji1 * res)
        j00, j01, j11 = _tree8(ji0 * ji0), _tree8(ji0 * ji1), _tree8(ji1 * ji1)
        g0 = j00 * jd0 + j01 * jd1
        g1 = j01 * jd0 + j11 * jd1
        mf = mask.to(torch.float32)
        terms = [mf * (jr0 * jd0 + jr1 * jd1), mf * (g0 * jd0 + g1 * jd1)]
        terms += [mf * (W.Jpdc[:, :, 0, c] * g0 + W.Jpdc[:, :, 1, c] * g1)
                  for c in range(4)]
        point = [_seq([x[:, t] for t in range(F)]) for x in terms]
        iu, ju = torch.triu_indices(13, 13, device=dev)
        prod = _tree8((rows[..., iu] * rows[..., ju]).transpose(-1, -2))
        M, order = _acc_chunks(host.cpu(), pt_mask.cpu(), F, ACC_CHUNK)
        tot = _chunk_sums(M, order, mask, prod)                    # (F, F, 91)
        nf = _nonfinite_bits(rows)                                 # (F,)
        bad = _bit(nf[None, :, None], iu) | _bit(nf[None, :, None], ju)
        tot = torch.where(bad, nan, tot)
        acc = torch.zeros((F, F, 13, 13), dtype=torch.float32, device=dev)
        acc[:, :, iu, ju] = tot
        acc[:, :, ju, iu] = tot
        return dict(acc=acc, Hdd=point[1], bd=point[0],
                    Hcd=torch.stack(point[2:], -1), nres=mask.sum())
    Hdd_tot, bd_tot, Hcd_tot, shift, pt_mask = args
    act = (W.res_active & W.res_exist & W.frame_valid[None, :]
           & pt_mask[:, None])
    j00, j01, j11 = _tree8(ji0 * ji0), _tree8(ji0 * ji1), _tree8(ji1 * ji1)
    a00, a01 = _tree8(jab0 * ji0), _tree8(jab0 * ji1)
    a10, a11 = _tree8(jab1 * ji0), _tree8(jab1 * ji1)
    g0 = j00 * jd0 + j01 * jd1
    g1 = j01 * jd0 + j11 * jd1
    af = act.to(torch.float32)
    JpJdF = torch.stack(
        [(W.Jpdxi[:, :, 0, i] * g0 + W.Jpdxi[:, :, 1, i] * g1) * af
         for i in range(6)]
        + [(a00 * jd0 + a01 * jd1) * af, (a10 * jd0 + a11 * jd1) * af], -1)
    ngood = act.sum(1)
    has = (ngood > 0) & pt_mask
    Hd = Hdd_tot + W.pt_prior
    Hd = torch.where(torch.isnan(Hd), Hd, torch.clamp(Hd, min=1e-10))
    HdiF = torch.where(has, torch.ones_like(Hd) / Hd, zero)
    bdSum = bd_tot + (W.pt_prior * (W.idepth - W.idepth_zero) if shift
                      else zero)
    bdSum = torch.where(has, bdSum, zero)
    Hcd = torch.where(has[:, None], Hcd_tot, zero)
    nfj = _nonfinite_bits(JpJdF)
    nf_h = bool((~torch.isfinite(HdiF)).any())
    nf_hb = bool((~torch.isfinite(HdiF * bdSum)).any())
    nf_c = (~torch.isfinite(Hcd)).any(0)                         # (4,)
    # Hcc_sc and bc_sc: per block of `per` points in order, then the blocks
    # in runs of `run` consecutive ones, then the runs
    per = ACC_RESIDUALS // F
    nb = -(-P // per)
    x = HdiF[:, None] * Hcd                                        # (P, 4)
    e = torch.cat([(x[:, :, None] * Hcd[:, None, :]).reshape(P, 16),
                   x * bdSum[:, None]], -1)                        # (P, 20)
    e = torch.nn.functional.pad(e, (0, 0, 0, nb * per - P)).reshape(nb, per,
                                                                     20)
    n_in = torch.clamp(P - torch.arange(nb, device=dev) * per, max=per)
    blocks = torch.zeros((nb, 20), dtype=torch.float32, device=dev)
    for u in range(per):
        blocks = torch.where((u < n_in)[:, None], blocks + e[:, u], blocks)
    run = -(-nb // ACC_HCC_RUNS)
    hcc = _seq([_seq(list(blocks[g * run:(g + 1) * run])
                     or [torch.zeros_like(blocks[0])])
                for g in range(ACC_HCC_RUNS)])
    # accD (t1, i, t2, j), accE (t1, i, c), accEB (t1, i) per point
    left = HdiF[:, None, None] * JpJdF                             # (P, F, 8)
    D = left[:, :, :, None, None] * JpJdF[:, None, None]
    E = left[..., None] * Hcd[:, None, None, :]
    EB = (HdiF * bdSum)[:, None, None] * JpJdF
    terms = torch.cat([D.permute(0, 1, 3, 2, 4).reshape(P, F, -1),
                       E.reshape(P, F, 32), EB], -1)               # (P, F, .)
    M, order = _acc_chunks(host.cpu(), pt_mask.cpu(), F, ACC_CHUNK)
    tot = _chunk_sums(M, order, has[:, None].expand(P, F), terms)  # (F, F, .)
    nD = F * 64
    accD = tot[..., :nD].reshape(F, F, F, 8, 8)
    accE = tot[..., nD:nD + 32].reshape(F, F, 8, 4)
    accEB = tot[..., nD + 32:]
    t1i = _bit(nfj[:, None], torch.arange(8, device=dev))         # (F, 8)
    bad_d = nf_h | t1i[:, None, :, None] | t1i[None, :, None, :]
    accD = torch.where(bad_d[None], nan, accD)
    accE = torch.where((nf_h | t1i[:, :, None] | nf_c)[None], nan, accE)
    accEB = torch.where((nf_hb | t1i)[None], nan, accEB)
    return dict(HdiF=HdiF, bdSum=bdSum, Hcd=Hcd, JpJdF=JpJdF, ngood=ngood,
                Hcc_sc=hcc[:16].reshape(4, 4), bc_sc=hcc[16:], accE=accE,
                accEB=accEB, accD=accD)


def acc_emulated_err(got: dict, emu: dict) -> dict:
    """K7's outputs against acc_emulated's: {output: entries whose bits
    differ (NaN against NaN counts as equal)} for the outputs that are not
    bitwise; empty when all are."""
    bad = {k: int((~_bits_equal(got[k], v.to(got[k].dtype))).sum())
           for k, v in emu.items()}
    return {k: n for k, n in bad.items() if n}


# ---------------------------------------------------------------------------
# the keyframe's dispatch with no host read (system/full_system)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def watched_keyframes(fs, sleep_cycles: int):
    """While inside, each keyframe `fs` makes (its make_keyframe) queues
    `sleep_cycles` of the card's sleep before its activation and runs its
    dispatch from the activation through the new candidates under
    torch.cuda.set_sync_debug_mode("error"), so a read of the card there
    raises. Yields a list that gets (the span's host ms, finish.ready()
    when the dispatch returned) per keyframe. On the card only."""
    import time
    rows, span = [], {}
    activate, new_traces = fs._activate_points, fs._make_new_traces

    def watched_activate(*a, **k):
        torch.cuda.synchronize()
        torch.cuda._sleep(sleep_cycles)
        torch.cuda.set_sync_debug_mode("error")
        span["t"] = time.perf_counter()
        return activate(*a, **k)

    def watched_new_traces(*a, **k):
        out = new_traces(*a, **k)
        span["ms"] = (time.perf_counter() - span["t"]) * 1e3
        torch.cuda.set_sync_debug_mode(0)
        return out

    def make_keyframe(shell, pyr):
        fin = fs.make_keyframe_dispatch(shell, pyr)
        rows.append((span.pop("ms"), fin.ready()))
        fin()
    fs._activate_points = watched_activate
    fs._make_new_traces = watched_new_traces
    fs.make_keyframe = make_keyframe
    try:
        yield rows
    finally:
        torch.cuda.set_sync_debug_mode(0)
        del fs._activate_points, fs._make_new_traces, fs.make_keyframe


# ---------------------------------------------------------------------------
# K2: the frame's pyramid and the readers' rectification
# (csrc/preprocess.cu against ops/preprocess.make_pyramid_ref, rectify_ref)
# ---------------------------------------------------------------------------

PYR_LEVELS = 4                 # Calibration.create's levels at 640x480


def _b_grad_table():
    """A (256,) b_grad table that varies over the clamped range 5..250."""
    k = torch.arange(256, dtype=torch.float64)
    return (0.5 + 1.5 * torch.sin(k / 40.0) ** 2).to(torch.float32)


def pyramid_cases(device="cpu") -> dict:
    """K2's pyramid cases, {name: (frame, levels, b_grad or None)} on
    `device`: the bench scene's 640x480 uint8 frame at the main path's 4
    levels without and with a b_grad table; a float32 frame of it with
    sub-integer noise and steps of more than 255 (a column at 900, a row
    at -700, so both differences are zeroed there); the uint16 8.8 frame;
    widths and heights whose levels end odd (97x61 over 3 levels, 1241x376
    and 620x188 over 5); 6 levels at 640x480 (the launch's shared memory
    over 48 KB); one level (the readers' images); a frame smaller than one
    tile (37x23 over 3 levels); a level-0 width that is not a multiple of
    4 (642x482 over 4 levels: most quads of four pixels are not 16-byte
    aligned there); the 640x480 frame one byte past an aligned address
    (every load one byte at a time)."""
    import numpy as np
    from ldso_tpu_torch.examples.time_modes import bench_frames
    _, _, images = bench_frames(1, 640, 480, "cpu")
    u8 = torch.from_numpy(images[0])
    rng = np.random.RandomState(21)
    f32 = u8.to(torch.float32) + torch.from_numpy(
        rng.rand(480, 640).astype(np.float32))
    f32[100:140, 300] = 900.0
    f32[200, 50:400] = -700.0
    b = _b_grad_table()
    odd = lambda h, w: torch.from_numpy(  # noqa: E731
        (rng.rand(h, w) * 255).astype(np.uint8))
    cases = {
        "uint8 640x480": (u8, PYR_LEVELS, None),
        "uint8 640x480 b_grad": (u8, PYR_LEVELS, b),
        "float32 steps": (f32, PYR_LEVELS, None),
        "float32 steps b_grad": (f32, PYR_LEVELS, b),
        "uint16": ((u8.to(torch.int32) * 256 + 77).to(torch.uint16),
                   PYR_LEVELS, b),
        "uint8 97x61": (odd(61, 97), 3, None),
        "uint8 1241x376": (odd(376, 1241), 5, b),
        "float32 620x188": (odd(188, 620).to(torch.float32) * 0.73, 5, None),
        "6 levels": (f32, 6, b),
        "1 level": (f32, 1, None),
        "uint8 37x23": (odd(23, 37), 3, b),
        "uint8 642x482": (odd(482, 642), 4, None),
        "float32 642x482 b_grad": (odd(482, 642).to(torch.float32) * 0.91,
                                   4, b),
        "uint8 640x480 offset": (u8, PYR_LEVELS, None),
    }
    out = {k: (img.to(device), L, None if g is None else g.to(device))
           for k, (img, L, g) in cases.items()}
    img, L, g = out["uint8 640x480 offset"]
    out["uint8 640x480 offset"] = (_offset_by(img, 1), L, g)
    return out


def _offset_by(t: torch.Tensor, k: int) -> torch.Tensor:
    """A contiguous copy of `t` whose data starts `k` elements past the
    start of its buffer (an address a kernel's vector loads cannot use)."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    out = buf[k:].view(t.shape)
    out.copy_(t)
    return out


def rectify_cases(device="cpu") -> dict:
    """K2's rectify cases, {name: (raw, G, vignette_inv, remap_x,
    remap_y)} on `device`: a 640x480 raw frame onto 600x440 through a
    warp with an invalid border (remap_x = -1) and coordinates past every
    edge (the clamps to w - 1.001 and h - 1.001 and to 0); uint8 raw with
    a 256-entry response table, with and without the inverse vignette;
    int32 raw (the readers' uint16 frames) with a 65,536-entry table;
    uint8 raw without a table (raw as float); float32 raw with and
    without the vignette (no table: the plain version applies none); an
    output of 597x437, whose pixel count is not a multiple of the
    kernel's four pixels a thread; the maps one float past an aligned
    address (no vector loads)."""
    import numpy as np
    from ldso_tpu_torch.examples.time_modes import bench_frames
    _, _, images = bench_frames(1, 640, 480, "cpu")
    raw8 = torch.from_numpy(images[0])
    rng = np.random.RandomState(22)
    h_org, w_org, h, w = 480, 640, 440, 600
    G8 = np.cumsum(rng.rand(256)).astype(np.float32)
    G8 = torch.from_numpy(G8 / G8[-1] * 255.0)
    G16 = np.cumsum(rng.rand(65536)).astype(np.float32)
    G16 = torch.from_numpy(G16 / G16[-1] * 255.0)
    vig = torch.from_numpy(
        (1.0 / (0.6 + 0.4 * rng.rand(h_org, w_org))).astype(np.float32))

    def maps(h, w):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        rr = ((xx - w / 2) ** 2 + (yy - h / 2) ** 2) / (w / 2) ** 2
        rx = (xx - w / 2) * (1.1 + 0.08 * rr) + w_org / 2
        ry = (yy - h / 2) * (1.1 + 0.08 * rr) + h_org / 2 - 3.0
        rx[rr > 1.15] = -1.0                 # invalid corners
        rx[:, :3] = w_org + 5.0               # past the right edge: clamped
        ry[:4] = -2.5                         # above the top: clamped to 0
        return (torch.from_numpy(rx.astype(np.float32)),
                torch.from_numpy(ry.astype(np.float32)))
    rx, ry = maps(h, w)
    raw16 = torch.from_numpy(
        (images[0].astype(np.int32) * 256
         + rng.randint(0, 256, (h_org, w_org))).astype(np.int32))
    rawf = raw8.to(torch.float32) * 1.37
    cases = {
        "uint8 G vignette": (raw8, G8, vig),
        "uint8 G": (raw8, G8, None),
        "int32 G vignette": (raw16, G16, vig),
        "uint8 raw": (raw8, None, None),
        "float32 vignette": (rawf, None, vig),
        "float32": (rawf, None, None),
    }
    on = lambda t: None if t is None else t.to(device)  # noqa: E731
    out = {k: (raw.to(device), on(G), on(v), rx.to(device), ry.to(device))
           for k, (raw, G, v) in cases.items()}
    rx5, ry5 = maps(437, 597)
    out["uint8 G onto 597x437"] = (raw8.to(device), on(G8), on(vig),
                                   rx5.to(device), ry5.to(device))
    out["uint8 G maps offset"] = (raw8.to(device), on(G8), None,
                                  _offset_by(rx.to(device), 1),
                                  _offset_by(ry.to(device), 1))
    return out


def pyramid_bitwise(got, want) -> bool:
    """Two FramePyramids with every level's dI and abs_grad bit for bit."""
    pairs = list(zip(got.dI, want.dI)) + list(zip(got.abs_grad,
                                                  want.abs_grad))
    return (len(got.dI) == len(want.dI)
            and all(a.shape == b.shape and a.dtype == b.dtype
                    for a, b in pairs)
            and all(bool(bits(a, b).all()) for a, b in pairs))
