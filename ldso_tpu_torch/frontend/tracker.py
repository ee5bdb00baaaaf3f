"""Coarse tracker: frame-to-keyframe direct SE(3) image alignment.

Counterpart of ldso_tpu/frontend/tracker.py (reference CoarseTracker,
src/frontend/CoarseTracker.cc):
  * `make_tracker_ref` <- makeCoarseDepthL0 (:258-438): splat active-point
    inverse depths, downsample, dilate, extract fixed-capacity per-level
    point lists.
  * `track_frame` <- trackNewestCoarse (:61-217) + calcRes (:440-572) +
    calcGSSSE (:574-632): coarse-to-fine LM over [se3, a, b].
  * `track_frame_hypotheses` / `rank_hypotheses`: the reference's motion
    retries (FullSystem.cc:189-311) as a leading batch dimension.
  * `tracker_trip_ref`: one trip's warp and reduce (`_calc_res` then
    `_calc_gs`); `cutoff_trip_ref` and `lm_trip_ref`: one trip of the
    cutoff adaptation and one LM iteration around it. They are the plain
    versions of the hand-written kernel K3 (csrc/tracker_trip.cu) in its
    three modes. Every trip goes through a wrapper
    (`ops/cuda_kernels.tracker_trip`, `cutoff_trip`, `lm_trip`): the plain
    version on the CPU, one launch of the kernel on the card.

Every function here runs on a batch of poses: the JAX package's
`lax.while_loop` LMs become Python loops of fixed trip counts over a batch
whose finished members are frozen by masks, which is what `vmap` of a
while loop does. Nothing in `track_frame`, `track_frame_hypotheses` or
`rank_hypotheses` reads the host, so on the card `track_frame` is one
CUDA graph replay (frontend/track_graph.py) and returns before the frame
is tracked. The per-level iteration caps and abort rules are the
reference's.

Parameter order: [tx ty tz wx wy wz a b] with SCALE_XI_ROT on slots 0-2
and SCALE_XI_TRANS on 3-5 (CoarseTracker.cc:141-145).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ldso_tpu_torch.config import (Config, SCALE_A, SCALE_B, SCALE_XI_ROT,
                                   SCALE_XI_TRANS)
from ldso_tpu_torch.camera.calib import Calibration
from ldso_tpu_torch.frontend import affine, track_graph
from ldso_tpu_torch.math import lie
from ldso_tpu_torch.math.rounding import rounded
from ldso_tpu_torch.ops import cuda_kernels
from ldso_tpu_torch.ops.interp import bilinear
from ldso_tpu_torch.ops.preprocess import FramePyramid
from ldso_tpu_torch.ops.scatter import segment_sum
from ldso_tpu_torch.utils.static import device_const, nonzero_padded

_LAMBDA_EXTRAPOLATION_LIMIT = 0.001
# the cutoff doubles from 1 while under 50 (CoarseTracker.cc:89-94): at
# most 6 times, 1 -> 64
_CUTOFF_LIMIT = 50.0
_CUTOFF_TRIPS = 6


class TrackerRef(NamedTuple):
    """Reference-keyframe tracking template (CoarseTracker pc_* lists)."""
    points: Tuple[torch.Tensor, ...]   # per level (cap_l, 4) [u, v, idepth, color]
    valid: Tuple[torch.Tensor, ...]    # per level (cap_l,) bool
    ref_exposure: torch.Tensor         # 0-d f32
    ref_aff: torch.Tensor              # (2,) [a, b]


# ---------------------------------------------------------------------------
# makeCoarseDepthL0
# ---------------------------------------------------------------------------

def _dilate(idep, wsum, diagonal: bool):
    """Fill holes from 4 neighbours (diagonal for fine levels, cross for
    coarse; CoarseTracker.cc:313-398)."""
    if diagonal:
        shifts = ((1, 1), (-1, -1), (1, -1), (-1, 1))
    else:
        shifts = ((0, 1), (0, -1), (1, 0), (-1, 0))
    s = torch.zeros_like(idep)
    num = torch.zeros_like(wsum)
    cnt = torch.zeros_like(wsum)
    zero = torch.zeros((), dtype=idep.dtype, device=idep.device)
    for dy, dx in shifts:
        w_n = torch.roll(wsum, (-dy, -dx), dims=(0, 1))
        i_n = torch.roll(idep, (-dy, -dx), dims=(0, 1))
        has = w_n > 0
        s = s + torch.where(has, i_n, zero)
        num = num + torch.where(has, w_n, zero)
        cnt = cnt + has.to(idep.dtype)
    hole = (wsum <= 0) & (cnt > 0)
    idep = torch.where(hole, s / torch.clamp(cnt, min=1.0), idep)
    wsum = torch.where(hole, num / torch.clamp(cnt, min=1.0), wsum)
    return idep, wsum


def _sum2x2(a):
    H, W = a.shape
    return a[:(H // 2) * 2, :(W // 2) * 2].reshape(
        H // 2, 2, W // 2, 2).sum(dim=(1, 3))


def make_tracker_ref(proj_u, proj_v, proj_idepth, weight, point_valid,
                     ref_dI, ref_exposure, ref_aff, calib: Calibration,
                     caps: Tuple[int, ...]) -> TrackerRef:
    """proj_*: (NP,) projections of the active points into the reference
    KF, weight (NP,) = sqrt(1e-3 / (HdiF + 1e-12)), point_valid (NP,) bool,
    ref_dI: the reference pyramid's (H,W,3) levels; ref_exposure (0-d)
    and ref_aff (2,) float32 tensors on the points' device (a host value
    there would be an upload). Reads nothing back from the card, so a
    CUDA graph can capture it (FullSystem's TRACKER_REF_GRAPHS)."""
    dev = proj_u.device
    levels = calib.levels
    W0, H0 = calib.w[0], calib.h[0]
    f32 = dict(dtype=torch.float32, device=dev)
    proj_u = proj_u.to(torch.float32)
    proj_v = proj_v.to(torch.float32)
    proj_idepth = proj_idepth.to(torch.float32)
    weight = weight.to(torch.float32)

    # splat (CoarseTracker.cc:264-283); float sums in point order on
    # every device (ops/scatter.py)
    ui = torch.clamp(torch.floor(proj_u + 0.5).long(), 0, W0 - 1)
    vi = torch.clamp(torch.floor(proj_v + 0.5).long(), 0, H0 - 1)
    w_eff = torch.where(point_valid, weight, torch.zeros_like(weight))
    flat = vi * W0 + ui
    idep0 = segment_sum(w_eff * proj_idepth, flat, H0 * W0).reshape(H0, W0)
    wsum0 = segment_sum(w_eff, flat, H0 * W0).reshape(H0, W0)

    ideps, wsums = [idep0], [wsum0]
    for lvl in range(1, levels):
        ideps.append(_sum2x2(ideps[-1]))
        wsums.append(_sum2x2(wsums[-1]))

    points, valids = [], []
    for lvl in range(levels):
        idep, wsum = _dilate(ideps[lvl], wsums[lvl], diagonal=(lvl < 2))
        wl, hl = calib.w[lvl], calib.h[lvl]
        color = ref_dI[lvl][..., 0]
        ys, xs = torch.meshgrid(torch.arange(hl, device=dev),
                                torch.arange(wl, device=dev), indexing="ij")
        border = (xs >= 2) & (xs < wl - 2) & (ys >= 2) & (ys < hl - 2)
        idep_n = idep / torch.where(wsum > 0, wsum, torch.ones_like(wsum))
        ok = border & (wsum > 0) & (idep_n > 0) & torch.isfinite(color)

        cap = caps[lvl]
        flat_ok = ok.reshape(-1)
        idx = nonzero_padded(flat_ok, cap, 0)
        got = torch.arange(cap, device=dev) < flat_ok.sum()
        pu = xs.reshape(-1)[idx].to(torch.float32)
        pv = ys.reshape(-1)[idx].to(torch.float32)
        pid = idep_n.reshape(-1)[idx]
        pc = color.reshape(-1)[idx]
        points.append(torch.stack([pu, pv, pid, pc], dim=-1))
        valids.append(got)

    return TrackerRef(points=tuple(points), valid=tuple(valids),
                      ref_exposure=torch.as_tensor(ref_exposure, **f32),
                      ref_aff=torch.as_tensor(ref_aff, **f32))


def make_tracker_ref_from_idepth(idepth_map, pyr: FramePyramid,
                                 calib: Calibration, caps: Tuple[int, ...],
                                 ref_exposure=1.0, ref_aff=(0.0, 0.0),
                                 stride: int = 1) -> TrackerRef:
    """Build a TrackerRef from a dense idepth map (synthetic ground truth)."""
    H, W = idepth_map.shape
    dev = idepth_map.device
    ys, xs = torch.meshgrid(torch.arange(0, H, stride, device=dev),
                            torch.arange(0, W, stride, device=dev),
                            indexing="ij")
    u = xs.reshape(-1).to(torch.float32)
    v = ys.reshape(-1).to(torch.float32)
    idep = idepth_map[ys, xs].reshape(-1)
    return make_tracker_ref(u, v, idep, torch.ones_like(idep), idep > 0,
                            pyr.dI, ref_exposure,
                            torch.tensor(ref_aff, dtype=torch.float32,
                                         device=dev), calib, caps)


# ---------------------------------------------------------------------------
# trackNewestCoarse, batched over B poses
# ---------------------------------------------------------------------------

def _Ki(calib: Calibration, lvl: int, device):
    return device_const(tuple(map(tuple, calib.Ki(lvl).tolist())), device)


def _calc_res(ref: TrackerRef, pyr_new: FramePyramid, lvl: int, T, aff_new,
              new_exposure, cutoff, calib: Calibration, cfg: Config,
              compute_flow: bool = True):
    """Masked batched calcRes (CoarseTracker.cc:440-572).

    T (B,4,4), aff_new (B,2), cutoff (B,). Returns per-point buffers (B,N)
    and stats (B,6) = [E, numTerms, flowT, 0, flowRT, satRatio]."""
    fx, fy = calib.fx[lvl], calib.fy[lvl]
    cx, cy = calib.cx[lvl], calib.cy[lvl]
    wl, hl = calib.w[lvl], calib.h[lvl]
    pts = ref.points[lvl]
    pvalid = ref.valid[lvl]
    x, y, idep, color = pts[:, 0], pts[:, 1], pts[:, 2], pts[:, 3]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    Ki = _Ki(calib, lvl, x.device)
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    RKi = R @ Ki

    rel = affine.from_to(ref.ref_exposure, new_exposure, ref.ref_aff, aff_new,
                         exact=True)
    a_rel, b_rel = rel[:, 0:1], rel[:, 1:2]

    p_ref = torch.stack([x, y, torch.ones_like(x)], dim=-1)            # (N,3)
    tid = t[:, None, :] * idep[None, :, None]                           # (B,N,3)
    pt = torch.einsum("bij,nj->bni", RKi, p_ref) + tid
    u = pt[..., 0] / pt[..., 2]
    v = pt[..., 1] / pt[..., 2]
    Ku = fx * u + cx
    Kv = fy * v + cy
    new_idepth = idep[None, :] / pt[..., 2]

    inb = (Ku > 2) & (Kv > 2) & (Ku < wl - 3) & (Kv < hl - 3) & (new_idepth > 0)
    ok = pvalid[None, :] & inb

    hit = bilinear(pyr_new.dI[lvl], Ku, Kv)                              # (B,N,3)
    ok = ok & torch.isfinite(hit[..., 0])

    residual = hit[..., 0] - (a_rel * color[None, :] + b_rel)
    abs_r = torch.abs(residual)
    hw = torch.where(abs_r < cfg.huber_th, torch.ones_like(abs_r),
                     cfg.huber_th / torch.clamp(abs_r, min=1e-12))
    cut = cutoff[:, None]
    sat = abs_r > cut
    max_energy = 2.0 * cfg.huber_th * cut - cfg.huber_th * cfg.huber_th
    e_term = torch.where(sat, max_energy.expand_as(abs_r),
                         hw * residual * residual * (2.0 - hw))
    E = torch.sum(torch.where(ok, e_term, zero), dim=1)
    num_terms = torch.sum(ok, dim=1).to(torch.float32)
    num_sat = torch.sum(ok & sat, dim=1).to(torch.float32)
    good = ok & ~sat

    if compute_flow:
        # flow indicators over all points (the reference samples every
        # 32nd point at level 0; same statistic, deterministic)
        pK = p_ref @ Ki.T
        ptT = pK[None] + tid
        ptT2 = pK[None] - tid
        pt3 = torch.einsum("bij,nj->bni", RKi, p_ref) - tid

        def _px(p):
            return fx * p[..., 0] / p[..., 2] + cx, fy * p[..., 1] / p[..., 2] + cy

        KuT, KvT = _px(ptT)
        KuT2, KvT2 = _px(ptT2)
        Ku3, Kv3 = _px(pt3)
        m = ok.to(torch.float32)
        n_flow = torch.sum(m, dim=1) + 0.1
        flow_t = torch.sum(m * ((KuT - x) ** 2 + (KvT - y) ** 2
                                + (KuT2 - x) ** 2 + (KvT2 - y) ** 2),
                           dim=1) / (2.0 * n_flow)
        flow_rt = torch.sum(m * ((Ku - x) ** 2 + (Kv - y) ** 2
                                 + (Ku3 - x) ** 2 + (Kv3 - y) ** 2),
                            dim=1) / (2.0 * n_flow)
    else:
        flow_t = torch.zeros_like(E)
        flow_rt = torch.zeros_like(E)

    bufs = dict(u=u, v=v, idepth=new_idepth, dx=hit[..., 1], dy=hit[..., 2],
                residual=residual, hw=hw, color=color,
                good=good.to(torch.float32))
    stats = torch.stack([E, num_terms, flow_t, torch.zeros_like(flow_t),
                         flow_rt, num_sat / torch.clamp(num_terms, min=1.0)],
                        dim=1)
    return bufs, stats


def _scale_vec(device):
    return device_const((SCALE_XI_ROT,) * 3 + (SCALE_XI_TRANS,) * 3
                  + (SCALE_A, SCALE_B), device)


def _calc_gs(bufs, lvl, ref: TrackerRef, aff_new, new_exposure,
             calib: Calibration):
    """Batched 8x8 H, b from the warped buffers (calcGSSSE,
    CoarseTracker.cc:574-632)."""
    fx, fy = calib.fx[lvl], calib.fy[lvl]
    rel = affine.from_to(ref.ref_exposure, new_exposure, ref.ref_aff, aff_new,
                         exact=True)
    a_rel = rel[:, 0:1]
    b0 = ref.ref_aff[1]

    dxf = bufs["dx"] * fx
    dyf = bufs["dy"] * fy
    u, v, idep = bufs["u"], bufs["v"], bufs["idepth"]
    J = torch.stack([
        idep * dxf,
        idep * dyf,
        -idep * (u * dxf + v * dyf),
        -(u * v * dxf + (1.0 + v * v) * dyf),
        u * v * dyf + (1.0 + u * u) * dxf,
        u * dyf - v * dxf,
        (a_rel * (b0 - bufs["color"][None, :])).expand_as(u),
        -torch.ones_like(u),
    ], dim=-1)                                                      # (B,N,8)

    w = bufs["hw"] * bufs["good"]
    n = torch.clamp(torch.sum(bufs["good"], dim=1), min=1.0)[:, None, None]
    Jw = J * w[..., None]
    H = (Jw.transpose(1, 2) @ J) / n
    b = (Jw.transpose(1, 2) @ bufs["residual"][..., None])[..., 0] / n[..., 0]

    scale = _scale_vec(u.device)
    H = H * scale[:, None] * scale[None, :]
    b = b * scale
    return H, b, scale


def tracker_trip_ref(ref: TrackerRef, pyr_new: FramePyramid, lvl: int, T,
                     aff_new, new_exposure, cutoff, calib: Calibration,
                     cfg: Config, compute_flow: bool = True):
    """One trip's warp and reduce for a batch of poses, `_calc_res` then
    `_calc_gs`: (stats (B,6), H (B,8,8), b (B,8)). The plain version of
    K3 (ops/cuda_kernels.tracker_trip)."""
    bufs, stats = _calc_res(ref, pyr_new, lvl, T, aff_new, new_exposure,
                            cutoff, calib, cfg, compute_flow)
    H, b, _ = _calc_gs(bufs, lvl, ref, aff_new, new_exposure, calib)
    return stats, H, b


def trips_per_track(cfg: Config, levels: int, coarsest: int) -> int:
    """K3 launches of one `_track_batch`: per level from `coarsest` down,
    1 + _CUTOFF_TRIPS cutoff trips and coarse_lm_iterations[lvl] LM trips,
    and the level's repeat block as many again."""
    return 2 * sum(1 + _CUTOFF_TRIPS + cfg.coarse_lm_iterations[lvl]
                   for lvl in range(min(coarsest, levels - 1) + 1))


def _solve_inc(H, b, lam, cfg: Config):
    """LM-damped batched 8x8 solve with the affine fix-mode variants
    (CoarseTracker.cc:106-137)."""
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    Hl = H + torch.diag_embed(diag * lam[:, None])
    eye = torch.eye(8, dtype=H.dtype, device=H.device) * 1e-12
    opt_a = cfg.affine_opt_mode_a >= 0
    opt_b = cfg.affine_opt_mode_b >= 0
    B = H.shape[0]
    zeros = torch.zeros(B, 8, dtype=H.dtype, device=H.device)
    if opt_a and opt_b:
        idx = list(range(8))
    elif not opt_a and not opt_b:
        idx = list(range(6))
    elif opt_a:
        idx = list(range(7))
    else:
        idx = [0, 1, 2, 3, 4, 5, 7]
    ix = device_const(tuple(idx), H.device, torch.int64)
    Hs = Hl[:, ix][:, :, ix] + eye[:len(idx), :len(idx)]
    sol = torch.linalg.solve_ex(Hs, -b[:, ix])[0]
    return zeros.index_copy(1, ix, sol)


def _where(mask, a, b):
    """Per-batch select for state tensors of any rank."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def cutoff_trip_ref(ref: TrackerRef, pyr_new: FramePyramid, lvl: int, T,
                    aff, new_exposure, stats, H, b, cutoff_rep, run,
                    calib: Calibration, cfg: Config,
                    compute_flow: bool = True):
    """One trip of the cutoff adaptation until < 60% saturated
    (CoarseTracker.cc:89-94) for a batch: a member that is `run`, more than
    60% saturated and under the cutoff limit doubles cutoff_rep and takes
    the trip's stats, H and b at coarse_cutoff_th * cutoff_rep; the others
    keep theirs. aff is fixed here, so selecting H and b per member equals
    computing them from the selected residuals. Returns (stats, H, b,
    cutoff_rep). The plain version of K3's cutoff mode
    (ops/cuda_kernels.cutoff_trip)."""
    more = (stats[:, 5] > 0.6) & (cutoff_rep < _CUTOFF_LIMIT) & run
    cutoff_rep = torch.where(more, cutoff_rep * 2.0, cutoff_rep)
    stats_n, H_n, b_n = tracker_trip_ref(
        ref, pyr_new, lvl, T, aff, new_exposure,
        cfg.coarse_cutoff_th * cutoff_rep, calib, cfg, compute_flow)
    return (_where(more, stats_n, stats), _where(more, H_n, H),
            _where(more, b_n, b), cutoff_rep)


def lm_step_ref(T, aff, H, b, lam, cfg: Config):
    """The step of one LM iteration (CoarseTracker.cc:106-148): the damped
    solve, the extrapolation below lambda 1e-3, the scaling, non-finite
    increments set to 0. Returns (inc (B,8) before the scaling, the new T
    (B,4,4) = se3_exp(inc[:6]) @ T, the new aff (B,2))."""
    inc = _solve_inc(H, b, lam, cfg)
    extrap = torch.where(
        lam < _LAMBDA_EXTRAPOLATION_LIMIT,
        rounded(torch.sqrt, rounded(
            torch.sqrt,
            _LAMBDA_EXTRAPOLATION_LIMIT / torch.clamp(lam, min=1e-12))),
        torch.ones_like(lam))
    inc = inc * extrap[:, None]
    inc_scaled = inc * _scale_vec(T.device)
    inc_scaled = torch.where(torch.isfinite(inc_scaled), inc_scaled,
                             torch.zeros_like(inc_scaled))
    # the step's exponential with its square root, sine and cosine rounded
    # once, as XLA:CPU gives them: torch's float32 cosine biased the
    # tracked poses (ROADMAP 3a)
    T_new = lie.se3_exp_exact(inc_scaled[:, :6]) @ T
    aff_n = aff + inc_scaled[:, 6:8]
    return inc, T_new, aff_n


def lm_trip_ref(ref: TrackerRef, pyr_new: FramePyramid, lvl: int, T, aff,
                new_exposure, stats, H, b, lam, done, cutoff,
                calib: Calibration, cfg: Config, compute_flow: bool = True):
    """One LM iteration for a batch (CoarseTracker.cc:106-183): for a member
    that is not done, the damped step from H, b and lam, the trip at the
    new pose, and the accept test on the mean energy, which selects the new
    T, aff, H, b and stats and halves lam (else lam grows 4x); done when
    |inc| <= 1e-3. A done member keeps T, aff, H, b, stats and lam. Returns
    (T, aff, stats, H, b, lam, done). The plain version of K3's lm mode
    (ops/cuda_kernels.lm_trip)."""
    live = ~done
    inc, T_new, aff_n = lm_step_ref(T, aff, H, b, lam, cfg)
    stats_n, Hn, bn = tracker_trip_ref(ref, pyr_new, lvl, T_new, aff_n,
                                       new_exposure, cutoff, calib, cfg,
                                       compute_flow)
    accept = (stats_n[:, 0] / torch.clamp(stats_n[:, 1], min=1.0)
              < stats[:, 0] / torch.clamp(stats[:, 1], min=1.0))
    take = accept & live
    T = _where(take, T_new, T)
    aff = _where(take, aff_n, aff)
    H = _where(take, Hn, H)
    b = _where(take, bn, b)
    stats = _where(take, stats_n, stats)
    lam = torch.where(live, torch.where(
        accept, lam * 0.5,
        torch.clamp(lam * 4.0, min=_LAMBDA_EXTRAPOLATION_LIMIT)), lam)
    done = done | (torch.linalg.norm(inc, dim=1) <= 1e-3)
    return T, aff, stats, H, b, lam, done


def _level_block(ref, pyr_new, lvl, state, run, new_exposure, min_res_abort,
                 calib, cfg: Config, max_iterations: int):
    """One pyramid level for the batch members in `run`: cutoff adaptation
    + LM loop. Returns the updated state and the per-member repeat flag.

    Both loops run their full trip counts, each trip masked per member (a
    member that is done or not running keeps T, aff, H, b, stats and lam),
    as `lax.while_loop` under `vmap` runs them: the results are those of
    loops that stop early, and nothing here reads the host. Every trip is
    one call of a K3 wrapper (ops/cuda_kernels: tracker_trip, cutoff_trip,
    lm_trip), one launch on the card."""
    T, aff, ok_flag, last_res, flow = state
    flow_here = lvl == 0
    B = T.shape[0]
    dev = T.device
    base_cut = torch.full((B,), cfg.coarse_cutoff_th, dtype=torch.float32,
                          device=dev)

    cutoff_rep = torch.ones(B, dtype=torch.float32, device=dev)
    stats, H, b = cuda_kernels.tracker_trip(ref, pyr_new, lvl, T, aff,
                                            new_exposure, base_cut, calib,
                                            cfg, compute_flow=flow_here)
    for _ in range(_CUTOFF_TRIPS):
        stats, H, b, cutoff_rep = cuda_kernels.cutoff_trip(
            ref, pyr_new, lvl, T, aff, new_exposure, stats, H, b, cutoff_rep,
            run, calib, cfg, compute_flow=flow_here)
    cutoff = cfg.coarse_cutoff_th * cutoff_rep

    lam = torch.full((B,), 0.01, dtype=torch.float32, device=dev)
    done = ~run
    for _ in range(max_iterations):
        T, aff, stats, H, b, lam, done = cuda_kernels.lm_trip(
            ref, pyr_new, lvl, T, aff, new_exposure, stats, H, b, lam, done,
            cutoff, calib, cfg, compute_flow=flow_here)

    # zero surviving terms score inf, not 0 (FullSystem.cc:117-123)
    rms = torch.where(stats[:, 1] > 0,
                      rounded(torch.sqrt, stats[:, 0]
                              / torch.clamp(stats[:, 1], min=1.0)),
                      torch.full_like(stats[:, 0], float("inf")))
    new_last = torch.cat([last_res[:, :lvl], rms[:, None],
                          last_res[:, lvl + 1:]], dim=1)
    new_ok = ok_flag & (rms <= 1.5 * min_res_abort[lvl])
    new_state = (T, aff, new_ok, new_last, stats[:, 2:5])
    out = tuple(_where(run, n, o) for n, o in
                zip(new_state, (state[0], state[1], ok_flag, last_res, flow)))
    return out, run & (cutoff_rep > 1.0)


def _track_batch(ref: TrackerRef, pyr_new: FramePyramid, T_init, aff_init,
                 new_exposure, min_res_abort, calib: Calibration, cfg: Config,
                 coarsest: int):
    """Coarse-to-fine LM for a batch of initial poses T_init (B,4,4), with
    aff_init (2,), new_exposure () and min_res_abort (L,) tensors on T's
    device. A fixed sequence of kernels for given shapes: the level repeat
    always runs, masked to the members that want it."""
    dev = T_init.device
    T = T_init.to(torch.float32)
    B = T.shape[0]
    aff = aff_init.to(torch.float32).expand(B, 2).clone()
    nlv = calib.levels
    state = (T, aff, torch.ones(B, dtype=torch.bool, device=dev),
             torch.full((B, nlv), float("nan"), dtype=torch.float32, device=dev),
             torch.full((B, 3), 1000.0, dtype=torch.float32, device=dev))
    have_repeated = torch.zeros(B, dtype=torch.bool, device=dev)

    for lvl in range(min(coarsest, nlv - 1), -1, -1):
        max_it = cfg.coarse_lm_iterations[lvl]
        run = state[2].clone()
        state, repeat = _level_block(ref, pyr_new, lvl, state, run,
                                     new_exposure, min_res_abort, calib, cfg,
                                     max_it)
        # repeat the level once if the cutoff had to be raised
        # (CoarseTracker.cc:192-195)
        rerun = repeat & ~have_repeated & state[2]
        state, _ = _level_block(ref, pyr_new, lvl, state, rerun,
                                new_exposure, min_res_abort, calib, cfg,
                                max_it)
        have_repeated = have_repeated | repeat

    T, aff, ok, last_res, flow = state
    # final affine sanity gates (CoarseTracker.cc:203-214)
    if cfg.affine_opt_mode_a != 0:
        ok = ok & (torch.abs(aff[:, 0]) <= 1.2)
    if cfg.affine_opt_mode_b != 0:
        ok = ok & (torch.abs(aff[:, 1]) <= 200.0)
    rel = affine.from_to(ref.ref_exposure, new_exposure, ref.ref_aff, aff,
                         exact=True)
    if cfg.affine_opt_mode_a == 0:
        ok = ok & (torch.abs(torch.log(rel[:, 0])) <= 1.5)
    if cfg.affine_opt_mode_b == 0:
        ok = ok & (torch.abs(rel[:, 1]) <= 200.0)
    if cfg.affine_opt_mode_a < 0:
        aff = torch.stack([torch.zeros_like(aff[:, 0]), aff[:, 1]], dim=1)
    if cfg.affine_opt_mode_b < 0:
        aff = torch.stack([aff[:, 0], torch.zeros_like(aff[:, 1])], dim=1)
    touched = min(coarsest, calib.levels - 1) + 1
    ok = ok & torch.all(torch.isfinite(last_res[:, :touched]), dim=1)
    return T, aff, ok, last_res, flow


# the Config fields the tracker reads: its CUDA graphs are keyed on these,
# so FullSystems whose configs differ elsewhere (a BA or trace knob) share
# them (tests/test_torch_tracker.py checks the tracker reads no other)
CONFIG_FIELDS = ("affine_opt_mode_a", "affine_opt_mode_b", "coarse_cutoff_th",
                 "coarse_lm_iterations", "huber_th")


def graph_key(cfg: Config) -> tuple:
    return tuple(getattr(cfg, f) for f in CONFIG_FIELDS)


def _on(x, device) -> torch.Tensor:
    """x as a float32 tensor on `device`. A value that is not already there
    would be a synchronous upload, which only the CPU may take."""
    if isinstance(x, torch.Tensor) and x.device == device:
        return x.to(torch.float32)
    if device.type != "cpu":
        raise TypeError(f"the tracker takes its inputs as tensors on {device}; "
                        f"got {type(x).__name__}")
    return torch.as_tensor(x, dtype=torch.float32)


def _track(ref: TrackerRef, pyr_new: FramePyramid, T_inits, aff_init,
           new_exposure, min_res_abort, calib: Calibration, cfg: Config,
           coarsest: int):
    """_track_batch on the CPU; on the card, its CUDA graph for these
    shapes (frontend/track_graph.py), captured at the first call."""
    dev = ref.ref_aff.device
    args = (_on(T_inits, dev), _on(aff_init, dev), _on(new_exposure, dev),
            _on(min_res_abort, dev))
    if dev.type == "cpu":
        return _track_batch(ref, pyr_new, *args, calib, cfg, coarsest)
    L, P = len(ref.points), len(pyr_new.dI)

    def program(*xs):
        r = TrackerRef(points=xs[:L], valid=xs[L:2 * L], ref_exposure=xs[2 * L],
                       ref_aff=xs[2 * L + 1])
        pyr = FramePyramid(dI=xs[2 * L + 2:2 * L + 2 + P], abs_grad=())
        return _track_batch(r, pyr, *xs[2 * L + 2 + P:], calib, cfg, coarsest)

    inputs = (*ref.points, *ref.valid, ref.ref_exposure, ref.ref_aff,
              *pyr_new.dI, *args)
    return track_graph.replay((calib, graph_key(cfg), coarsest, L, P),
                              program, inputs)


def track_frame(ref: TrackerRef, pyr_new: FramePyramid, T_init, aff_init,
                new_exposure, min_res_abort, calib: Calibration, cfg: Config,
                coarsest: int):
    """Full coarse-to-fine direct alignment of one frame. On the card the
    inputs are tensors on it, and the call returns before the frame is
    tracked: nothing reads the host.

    Returns (T (4,4), aff (2,), ok, last_residuals (L,), flow (3,)); T maps
    the reference KF camera to the new camera (refToNew)."""
    T_init = _on(T_init, ref.ref_aff.device)
    out = _track(ref, pyr_new, T_init[None], aff_init, new_exposure,
                 min_res_abort, calib, cfg, coarsest)
    return tuple(o[0] for o in out)


def track_frame_hypotheses(ref: TrackerRef, pyr_new: FramePyramid, T_inits,
                           aff_init, new_exposure, min_res_abort,
                           calib: Calibration, cfg: Config, coarsest: int):
    """Track a batch of motion hypotheses T_inits (M,4,4) at once."""
    return _track(ref, pyr_new, T_inits, aff_init, new_exposure,
                  min_res_abort, calib, cfg, coarsest)


def rank_hypotheses(ref: TrackerRef, pyr_new: FramePyramid, T_inits,
                    aff_init, new_exposure, calib: Calibration, cfg: Config,
                    coarsest: int):
    """Initial coarsest-level mean Huber energy of each hypothesis (one warp
    pass, no LM); hypotheses with <= 10 in-bounds points rank inf."""
    dev = ref.ref_aff.device
    T_inits = _on(T_inits, dev)
    M = T_inits.shape[0]
    aff = _on(aff_init, dev).expand(M, 2)
    cut = torch.full((M,), cfg.coarse_cutoff_th, dtype=torch.float32,
                     device=dev)
    stats, _, _ = cuda_kernels.tracker_trip(
        ref, pyr_new, coarsest, T_inits, aff, _on(new_exposure, dev), cut,
        calib, cfg, compute_flow=False)
    E, num = stats[:, 0], stats[:, 1]
    return torch.where(num > 10.0, E / torch.clamp(num, min=1.0),
                       torch.full_like(E, float("inf")))
