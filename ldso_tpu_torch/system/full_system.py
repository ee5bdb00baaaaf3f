"""FullSystem: the top-level visual-odometry orchestrator, synchronous mode.

Counterpart of ldso_tpu/system/full_system.py (reference
src/frontend/FullSystem.cc) in the reference's `linearizeOperation`
semantics: every frame is tracked, and every keyframe is mapped, before
the next frame enters.

  addActiveFrame (:68-157)  -> add_active_frame: pyramid -> init or track
  trackNewCoarse (:179-382) -> _track_new_coarse: the frame step (the
                               pyramid, hypothesis 0, the retrack gate and
                               the candidate trace), then the
                               rank-then-refine retry over the 83 motion
                               hypotheses when the retrack gate trips
  makeKeyFrame   (:410-591) -> make_keyframe: trace -> flag marg -> insert
                               -> activate -> windowed BA -> post-BA flags
                               -> tracker reference -> point marg -> new
                               candidates -> frame marg
  makeNonKeyFrame (:593-600), initializeFromInitializer (:1326-1400)
  loop closing (makeKeyFrame :585-589) -> loop/loopclosing.LoopClosing,
                               inline at the end of make_keyframe

The pipelined drivers of system/pipeline.py use the hooks below them: the
device-resident tracking chain (`TrackChain`, `track_chain_dispatch`,
`track_chain_consume`), the keyframe split into `make_keyframe_dispatch`
and its `finish` closure, and the (ref, shell, event) tracking reference
that a tracking thread reads while the mapping thread republishes it.
`FullSystem(calib, cfg)` places every tensor on the CUDA card (and raises
where there is none); `device="cpu"` runs it on the CPU. From the
activation through the new candidates the keyframe's dispatch reads
nothing from the card, as the JAX package's does. The activation is one
captured program (`_activate_fused` in ACTIVATE_GRAPHS, a graph per
window size) through the hand-written kernels of ops/cuda_kernels.py:
K1's distance map, then K5's gate and depth-only LM over every lane of
the candidate arena; its rows, the BA's stats, the post-BA row and the
point marginalization's result go home as HostCopys that finish() reads,
and the post-BA flags, the tracker reference and the new candidates are
one captured program each (POST_BA_GRAPHS, TRACKER_REF_GRAPHS,
NEW_TRACES_GRAPHS). The bootstrap's frames are one captured program each
too (frontend/initializer.INIT_GRAPHS, captured at the first frame), and
so is every tracked frame, as the JAX package's `_frame_step` and
`_frame_step_chain` are: the strict frame step (`frame_step`,
FRAME_STEP_GRAPHS) and the pipelines' chain step (`chain_step`,
CHAIN_STEP_GRAPHS), each one replay and one pull a frame.
"""

from __future__ import annotations

import collections
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ldso_tpu_torch import native
from ldso_tpu_torch.config import Config, PATTERN
from ldso_tpu_torch.camera.calib import Calibration
from ldso_tpu_torch.backend.energy_functional import (EnergyFunctional,
                                                      device_lm,
                                                      insert_points_dev)
from ldso_tpu_torch.backend.window import (RES_IN, RES_OOB, RES_OUTLIER,
                                           Window, aff_g2l, current_poses)
from ldso_tpu_torch.frontend import detector, immature, initializer, tracker
from ldso_tpu_torch.io.ldso_binary import load_ldso_binary, save_ldso_binary
from ldso_tpu_torch.loop.loopclosing import LoopClosing
from ldso_tpu_torch.math import lie_np
from ldso_tpu_torch.ops import cuda_kernels
from ldso_tpu_torch.ops import select as select_ops
from ldso_tpu_torch.ops.interp import bilinear
from ldso_tpu_torch.ops.preprocess import (FramePyramid, _to_intensity,
                                           make_pyramid, to_device,
                                           upload_image)
from ldso_tpu_torch.slam_map import FrameShell, GlobalMap, MapPointRecord
from ldso_tpu_torch.utils.device import (DEFAULT_DEVICE, HostCopy,
                                         entry_device, record_event)
from ldso_tpu_torch.utils.graphs import Programs
from ldso_tpu_torch.utils.static import device_const, nonzero_padded
from ldso_tpu_torch.utils.timing import StageTimer

RETRY_K = 8          # retry hypotheses LM-refined after the coarse ranking

# the keyframe's captured programs (utils/graphs.Programs), each a CUDA
# graph per key that FullSystem.warm_retrack_programs captures before a
# run: the post-BA flags and their packed row (`post_ba_packed`), the
# tracker reference (`tracker_ref_fused`), the new candidates
# (`new_candidates`, or `add_candidates` behind another selection's map)
POST_BA_GRAPHS = Programs()
TRACKER_REF_GRAPHS = Programs()
NEW_TRACES_GRAPHS = Programs()
# the activation pass (`_activation_program`), a graph per window size
# (the frames in the window, 1..F), all captured when the system is built
ACTIVATE_GRAPHS = Programs()


def _occupancy(W: Window, newest: int, w1: int, h1: int):
    """The (h1, w1) occupancy of the window's points projected into the
    newest keyframe at pyramid level 1. A point out of bounds sets a spare
    cell that is then cut, so nothing waits for the device."""
    cp = W.center_proj[:, newest]
    ok = (W.pt_valid & W.res_exist[:, newest]
          & torch.isfinite(cp[:, 0]) & (cp[:, 2] > 0))
    uu = (0.5 * cp[:, 0] - 0.25 + 0.5).to(torch.int64)
    vv = (0.5 * cp[:, 1] - 0.25 + 0.5).to(torch.int64)
    inb = ok & (uu > 0) & (vv > 0) & (uu < w1) & (vv < h1)
    cell = torch.where(inb, vv * w1 + uu, torch.full_like(uu, h1 * w1))
    occ = torch.zeros(h1 * w1 + 1, dtype=torch.bool, device=cell.device)
    # index_fill_ takes its value as a scalar: an indexed assignment of a
    # Python value copies it to the card first, and waits
    occ.index_fill_(0, cell, True)
    return occ[:h1 * w1].reshape(h1, w1)


def _gate_candidates_fused(W: Window, newest: int, arena, KRKis, Kts,
                           min_act_dist, marg_flags, cfg: Config,
                           w1: int, h1: int):
    """Occupancy splat of the active points' projections into the newest
    keyframe + chamfer distance map + candidate gating. Returns (to_opt,
    remove, idm)."""
    # distances >= 17 are decision-equivalent for the default gates, so
    # cfg.dist_map_steps (18) sweeps give the reference's 40-sweep gating
    dist_map = cuda_kernels.distance_transform(
        _occupancy(W, newest, w1, h1), cfg.dist_map_steps)
    h = torch.clamp(arena.host, 0, KRKis.shape[0] - 1).long()
    pool = arena.pool._replace(valid=arena.pool.valid & (arena.host >= 0))
    return immature.gate_candidates(pool, KRKis[h], Kts[h], dist_map,
                                    min_act_dist, marg_flags[h], cfg)


def _activate_fused(W: Window, arena, dIs, KRKis, Kts, Rs, ts, affs, masks,
                    min_act_dist, marg_flags, newest: int, nf: int,
                    cfg: Config, calib: Calibration, w1: int, h1: int):
    """The whole activation pass on the device with no host read
    (activatePointsMT, FullSystem.cc:1052-1206; the JAX package's
    `_activate_fused`): the occupancy splat and K1's distance map, K5 over
    every lane of the arena (the gate and the depth-only LM;
    ops/cuda_kernels.activate_arena), the k-th accepted candidate into the
    k-th free point slot (overflow drops), the insertion and the arena's
    cleanup. Returns (W', arena', packed) with packed (N, 4) int32 rows
    [slot, host, inserted, removed] per lane, the one result the host
    mirrors need."""
    dist_map = cuda_kernels.distance_transform(
        _occupancy(W, newest, w1, h1), cfg.dist_map_steps)
    to_opt, remove, new_id, ok, n_good = cuda_kernels.activate_arena(
        arena, dist_map, KRKis, Kts, Rs, ts, affs, masks, dIs, min_act_dist,
        marg_flags, newest, nf, calib, cfg)
    okn = ok & to_opt & (n_good >= 1)
    N = arena.host.shape[0]
    P = W.P
    free = nonzero_padded(~W.pt_valid, N, P)
    rank = torch.cumsum(okn.to(torch.int64), 0) - 1
    slot = torch.where(okn, free[torch.clamp(rank, 0, N - 1)],
                       torch.full_like(rank, P))
    pl = arena.pool
    hostc = arena.host
    W = insert_points_dev(
        W, slot, okn, torch.clamp(hostc, min=0), pl.u, pl.v, new_id,
        torch.zeros_like(new_id), pl.energy_th, pl.color, pl.weights)
    remove = remove | to_opt
    arena = immature.arena_mask(arena, remove)
    packed = torch.stack([slot.to(torch.int32), hostc.to(torch.int32),
                          okn.to(torch.int32), remove.to(torch.int32)], 1)
    return W, arena, packed


# the window fields the activation pass reads or writes
ACT_FIELDS = ("frame_valid", "center_proj", "pt_valid", "pt_host", "pt_u",
              "pt_v", "pt_color", "pt_weights", "idepth", "idepth_zero",
              "pt_prior", "pt_energy_th", "pt_num_good_res",
              "pt_max_rel_baseline", "pt_idepth_hessian", "res_exist",
              "res_active", "res_linearized", "res_state", "res_energy")
_NO_WINDOW = Window(*([None] * len(Window._fields)))


def activation_upload_size(F: int) -> int:
    """The floats of the activation's one upload for F window slots."""
    return F * 12 + F * F * 15 + 1 + F


def activation_tables(up, F: int):
    """The activation's tables on the device from its one upload `up`
    (FullSystem._activation_upload): (KRKis (F, 3, 3), Kts (F, 3), Rs (F,
    F, 3, 3), ts (F, F, 3), affs (F, F, 2), masks (F, F) bool,
    min_act_dist (0-d), marg_flags (F,) bool), views of `up` but the
    masks."""
    cut = np.cumsum([0, F * 9, F * 3, F * F * 9, F * F * 3, F * F * 2,
                     F * F, 1, F])
    KRKis, Kts, Rs, ts, affs, masks, mad, marg = (
        up[cut[k]:cut[k + 1]] for k in range(8))
    return (KRKis.view(F, 3, 3), Kts.view(F, 3), Rs.view(F, F, 3, 3),
            ts.view(F, F, 3), affs.view(F, F, 2), masks.view(F, F) > 0.5,
            mad.view(()), marg > 0.5)


def _activation_program(nf: int, cfg: Config, calib: Calibration, w1: int,
                        h1: int):
    """`_activate_fused` for a window of nf frames (the newest nf - 1)
    over (ACT_FIELDS..., the arena's fields..., dIs, the activation's
    upload): the ACT_FIELDS, the arena's fields and the packed rows."""
    nw = len(ACT_FIELDS)
    na = len(immature.ImmaturePool._fields) + 1

    def program(*xs):
        W = _NO_WINDOW._replace(**dict(zip(ACT_FIELDS, xs[:nw])))
        dIs, up = xs[nw + na:]
        W, arena, packed = _activate_fused(
            W, _arena_of(xs[nw:nw + na]), dIs,
            *activation_tables(up, W.F), nf - 1, nf, cfg, calib, w1, h1)
        return (tuple(getattr(W, f) for f in ACT_FIELDS) + _arena_flat(arena)
                + (packed,))
    return program


def _col(x, i):
    """x[:, i] for a 0-d integer tensor i: a 0-d tensor as an index would
    be read on the host, index_select reads it on the card."""
    i = torch.as_tensor(i, device=x.device)
    return torch.index_select(x, 1, i.reshape(1)).squeeze(1)


def _flag_removal(W: Window, marg_frame_targets, host_flagged, newest,
                  prev):
    """flagPointsForRemoval decision logic (FullSystem.cc:1208-1270);
    newest and prev are 0-d integer tensors (prev -1 when there is no
    second-newest frame). Returns (drop, marg_cand) bool masks."""
    nres = torch.sum(W.res_exist, dim=1)
    vis_in_marg = torch.sum(W.res_exist & (W.res_state == RES_IN)
                            & marg_frame_targets[None, :], dim=1)
    last0 = _col(W.res_state, newest)
    last0_exist = _col(W.res_exist, newest)
    prev = torch.as_tensor(prev, device=W.res_state.device)
    prev_c = torch.clamp(prev, min=0)
    last1 = _col(W.res_state, prev_c)
    last1_exist = _col(W.res_exist, prev_c) & (prev >= 0)

    is_oob = ((nres >= 3) & (W.pt_num_good_res > 14)
              & (nres - vis_in_marg < 3))
    is_oob = is_oob | (last0_exist & (last0 == RES_OOB))
    is_oob = is_oob | ((nres >= 2) & last0_exist & last1_exist
                       & (last0 == RES_OUTLIER) & (last1 == RES_OUTLIER))
    no_res = W.pt_valid & ((W.idepth < 0) | (nres == 0))
    oob_or_flagged = W.pt_valid & ~no_res & (is_oob | host_flagged)
    is_inlier = (nres >= 3) & (W.pt_num_good_res >= 4)
    drop = no_res | (oob_or_flagged & ~is_inlier)
    return drop, oob_or_flagged & is_inlier


def _program(family: Programs, static, fn, inputs):
    """fn(*inputs) as one captured program of `family` on the card (the
    graph of this key, captured at its first call, which a FullSystem's
    warm-up makes; a capture that fails raises), eagerly on the CPU."""
    if inputs[0].device.type == "cuda":
        return family.replay(static, fn, tuple(inputs))
    return tuple(fn(*inputs))


def _kf_row(up, F: int):
    """The keyframe's one upload [marg flags (F), newest, prev, the newest
    frame's exposure] as (flags (F,) bool, newest, prev (0-d int64),
    exposure (0-d float32))."""
    return up[:F] > 0.5, up[F].long(), up[F + 1].long(), up[F + 2]


# the window fields the post-BA program reads
POST_BA_FIELDS = ("pt_valid", "pt_host", "pt_num_good_res", "idepth",
                  "res_exist", "res_active", "res_state", "state", "T_eval",
                  "prior")
_PostBAPart = collections.namedtuple("_PostBAPart", POST_BA_FIELDS)


def post_ba_packed(W, flags, newest, prev):
    """The post-BA program (the JAX package's `_post_ba_dev`): drop the
    points with no residual left (removeOutliers, FullSystem.cc:1402-1420),
    decide point removal and marginalization (flagPointsForRemoval) and
    pack what the host shells need. W: a Window (or a tuple of its
    POST_BA_FIELDS); flags (F,) the frames' marginalization flags; newest
    and prev 0-d integer tensors. Returns (W', packed, drop,
    marg): packed the float32 row [poses (F*16), affines (F*2), dead (P),
    drop (P), marg (P), priors (F*8), state deltas (F*8)] in the JAX
    package's order (`unpack_post_ba`), drop and marg device masks for
    the point marginalization."""
    F = flags.shape[0]
    nres = torch.sum(W.res_exist, dim=1)
    dead = W.pt_valid & (nres == 0)
    W = W._replace(pt_valid=W.pt_valid & ~dead,
                   res_exist=W.res_exist & ~dead[:, None],
                   res_active=W.res_active & ~dead[:, None])
    host_flagged = flags[torch.clamp(W.pt_host, max=F - 1)]
    drop, marg = _flag_removal(W, flags, host_flagged, newest, prev)
    packed = torch.cat([t.reshape(-1).to(torch.float32) for t in (
        current_poses(W), aff_g2l(W), dead, drop, marg, W.prior,
        W.state[:, :8])])
    return W, packed, drop, marg


def unpack_post_ba(pk: np.ndarray, F: int, P: int):
    """post_ba_packed's row read on the host (float64): (poses (F, 4, 4),
    affines (F, 2), dead (P,) bool, priors (F, 8), state deltas (F, 8))."""
    base = F * 18 + 3 * P
    return (pk[:F * 16].reshape(F, 4, 4), pk[F * 16:F * 18].reshape(F, 2),
            pk[F * 18:F * 18 + P] > 0.5, pk[base:base + F * 8].reshape(F, 8),
            pk[base + F * 8:base + F * 16].reshape(F, 8))


def _post_ba_program(*xs):
    """post_ba_packed over (POST_BA_FIELDS..., the keyframe's upload):
    (pt_valid, res_exist, res_active, packed, drop, marg)."""
    W = _PostBAPart(*xs[:-1])
    flags, newest, prev, _ = _kf_row(xs[-1], W.state.shape[0])
    W, packed, drop, marg = post_ba_packed(W, flags, newest, prev)
    return W.pt_valid, W.res_exist, W.res_active, packed, drop, marg


# the window fields the tracker reference reads
REF_FIELDS = ("center_proj", "pt_valid", "res_exist", "res_state",
              "pt_idepth_hessian", "state")
_RefPart = collections.namedtuple("_RefPart", REF_FIELDS)


def tracker_ref_fused(W, newest, ref_dI, ref_exposure, calib: Calibration,
                      caps):
    """setCoarseTrackingRef + makeCoarseDepthL0 (CoarseTracker.cc:240-438)
    as one program (the JAX package's `_make_tracker_ref_fused`): every
    active point with an inlier residual in the newest keyframe, splatted
    at its centre projection there with its idepth Hessian's weight, and
    the reference's affine from the window's state. W: a Window (or a tuple
    of its REF_FIELDS); newest a 0-d integer tensor; ref_dI the newest
    keyframe's pyramid levels; ref_exposure a 0-d float32 tensor."""
    cp = _col(W.center_proj, newest)
    valid = (W.pt_valid & _col(W.res_exist, newest)
             & (_col(W.res_state, newest) == RES_IN))
    hdif = 1.0 / torch.clamp(W.pt_idepth_hessian, min=1e-12)
    weight = torch.sqrt(1e-3 / (hdif + 1e-12))
    ref_aff = _col(aff_g2l(W).T, newest)
    return tracker.make_tracker_ref(cp[:, 0], cp[:, 1], cp[:, 2], weight,
                                    valid, ref_dI, ref_exposure, ref_aff,
                                    calib, caps)


def _tracker_ref_program(calib: Calibration, caps):
    """tracker_ref_fused over (REF_FIELDS..., the keyframe's upload, the
    pyramid's levels): the TrackerRef's tensors, flat."""
    def program(*xs):
        n = len(REF_FIELDS)
        W = _RefPart(*xs[:n])
        _, newest, _, expo = _kf_row(xs[n], W.state.shape[0])
        ref = tracker_ref_fused(W, newest, xs[n + 1:], expo, calib, caps)
        return ref.points + ref.valid + (ref.ref_exposure, ref.ref_aff)
    return program


def add_candidates(arena, status, dI0, host_idx, cap: int, cfg: Config):
    """makeNewTraces' arena half: compact the live candidates into a
    prefix, then add the status map's candidates hosted by `host_idx` (a
    0-d integer tensor) into the free lanes."""
    return immature.arena_add_from_status(immature.arena_compact(arena),
                                          status, dI0, host_idx, cap, cfg)


def new_candidates(arena, dI0, abs_grad0, host_idx, gp, cap: int,
                   cfg: Config):
    """makeNewTraces on the pure-VO path as one program: the detector's
    status map (`gp` its grid), then `add_candidates`."""
    status = detector.detect_status_map(dI0, abs_grad0, *gp)
    return add_candidates(arena, status, dI0, host_idx, cap, cfg)


def _arena_flat(arena) -> tuple:
    return tuple(arena.pool) + (arena.host,)


def _arena_of(xs) -> immature.ImmatureArena:
    return immature.ImmatureArena(pool=immature.ImmaturePool(*xs[:-1]),
                                  host=xs[-1])


def _candidates_program(gp, cap: int, cfg: Config):
    """The new candidates over (the arena's fields..., dI0, then abs_grad0
    when `gp` is the detector's grid or the status map when it is None,
    the keyframe's upload): the arena's fields."""
    n = len(immature.ImmaturePool._fields) + 1

    def program(*xs):
        arena, (dI0, second, up) = _arena_of(xs[:n]), xs[n:]
        host = _kf_row(up, up.shape[0] - 3)[1]
        if gp is None:
            out = add_candidates(arena, second, dI0, host, cap, cfg)
        else:
            out = new_candidates(arena, dI0, second, host, gp, cap, cfg)
        return _arena_flat(out)
    return program


def _motion_hypotheses(lastF_2_slast, fh_2_slast):
    """The reference's 83 retry initializations (FullSystem.cc:189-311),
    host numpy."""
    inv = np.linalg.inv
    const = inv(fh_2_slast) @ lastF_2_slast
    tries = [const, inv(fh_2_slast) @ inv(fh_2_slast) @ lastF_2_slast]
    half = lie_np.se3_exp(0.5 * lie_np.se3_log(fh_2_slast))
    tries += [inv(half) @ lastF_2_slast, lastF_2_slast, np.eye(4)]
    # LDSO sweeps rotDelta 0.02/0.03/0.04 (FullSystem.cc:225-226)
    for rot_delta in (0.02, 0.03, 0.04):
        for axes in ((1, 0, 0), (0, 1, 0), (0, 0, 1),
                     (-1, 0, 0), (0, -1, 0), (0, 0, -1),
                     (1, 1, 0), (0, 1, 1), (1, 0, 1),
                     (-1, 1, 0), (0, -1, 1), (-1, 0, 1),
                     (1, -1, 0), (0, 1, -1), (1, 0, -1),
                     (-1, -1, 0), (0, -1, -1), (-1, 0, -1),
                     (-1, -1, -1), (-1, -1, 1), (-1, 1, -1), (-1, 1, 1),
                     (1, -1, -1), (1, -1, 1), (1, 1, -1), (1, 1, 1)):
            q = np.array([rot_delta * axes[0], rot_delta * axes[1],
                          rot_delta * axes[2], 1.0])
            P = np.eye(4)
            P[:3, :3] = lie_np.quat_to_rotmat(q)
            tries.append(const @ P)
    return tries


class TrackChain(NamedTuple):
    """Device-resident tracking state of the pipelined frame loop (JAX
    counterpart: full_system.py:461-475): the constant-velocity motion
    hypothesis of the next frame comes from these tensors, so a frame can
    be dispatched before the previous one's pose reached the host."""
    T_slast: torch.Tensor       # (4, 4) previous frame, camera-from-world
    T_sprelast: torch.Tensor    # (4, 4) the frame before that
    aff: torch.Tensor           # (2,) previous frame's brightness affine
    rmse: torch.Tensor          # (L,) previous frame's per-level residuals


def _inv(A):
    """4x4 inverse without the error check's host read."""
    return torch.linalg.inv_ex(A)[0]


def _chain_prep(chain: TrackChain, T_ref_cw):
    """Hypothesis 0 (the host _motion_hypotheses tries[0]) relative to the
    tracking reference, on the device, and the chain's affine and RMSE."""
    lastF_2_slast = chain.T_slast @ _inv(T_ref_cw)
    fh_2_slast = chain.T_sprelast @ _inv(chain.T_slast)
    T0 = _inv(fh_2_slast) @ lastF_2_slast
    return T0, chain.aff, chain.rmse


def _chain_update(chain: TrackChain, packed, T0, T_ref_cw) -> TrackChain:
    """Advance the chain from a chain step's packed result; on tracking
    failure take the predicted pose and keep the previous affine and
    residuals (trackNewCoarse's fallback, FullSystem.cc:355-365)."""
    L = chain.rmse.shape[0]
    T = packed[:16].reshape(4, 4)
    aff = packed[16:18]
    res = packed[20:20 + L]
    ok = (packed[18] > 0.5) & torch.isfinite(res[0])
    return TrackChain(torch.where(ok, T, T0) @ T_ref_cw, chain.T_slast,
                      torch.where(ok, aff, chain.aff),
                      torch.where(ok, res, chain.rmse))


# the frame step (`frame_step`: the pyramid, hypothesis 0's track, the
# retrack gate and the candidate arena's trace) and the pipelines' chain
# step (`chain_step`: the chain's hypothesis, the pyramid, the track and
# the chain's advance), each one captured program per key on the card, as
# the JAX package's `_frame_step` and `_frame_step_chain` are one device
# program each. FullSystem.warm_retrack_programs captures both for every
# FRAME_DTYPES when a card system is built; a replay of a key with no
# graph raises
FRAME_STEP_GRAPHS = Programs(capture_on_replay=False)
CHAIN_STEP_GRAPHS = Programs(capture_on_replay=False)
# the frame dtypes the steps' graphs are captured for: uint8 frames as they
# are uploaded (the synthetic scenes, the bench) and float32 ones (the
# dataset readers' rectified frames); any other is made float32 first
FRAME_DTYPES = (torch.uint8, torch.float32)


def frame_image(image, device) -> torch.Tensor:
    """A frame on `device` in one of FRAME_DTYPES: uploaded as upload_image
    does, a uint16 (8.8 fixed point) or float64 frame then turned into the
    float32 intensities make_pyramid would make of it, on the device."""
    img = upload_image(image, device)
    return img if img.dtype in FRAME_DTYPES else _to_intensity(img)


def _frame_row(up):
    """The frame step's upload (FullSystem._frame_upload) [T0 (16), aff0
    (2), exposure, last_rmse[0], commit, T_ref_cw (16), T_hosts (F x 16),
    host_affs (F x 2), host_expos (F)] read on the device as (T0 (4, 4),
    aff0 (2,), exposure (0-d), last0 (0-d), commit (0-d bool), T_ref_cw
    (4, 4), T_hosts (F, 4, 4), host_affs (F, 2), host_expos (F,)). Each
    piece is a copy: it starts where a tensor of its own would, as the
    separate uploads it replaces did."""
    F = (up.shape[0] - 37) // 19
    cut = np.cumsum([0, 16, 2, 1, 1, 1, 16, F * 16, F * 2, F]).tolist()
    T0, aff0, expo, last0, commit, T_ref, T_hosts, affs, expos = (
        up[cut[k]:cut[k + 1]].clone() for k in range(9))
    return (T0.view(4, 4), aff0, expo.view(()), last0.view(()),
            commit.view(()) > 0.5, T_ref.view(4, 4), T_hosts.view(F, 4, 4),
            affs.view(F, 2), expos)


def trace_tables(T_new_cw, aff, exposure, T_hosts, host_affs, host_expos,
                 calib: Calibration):
    """The trace's per-host inputs for a new frame at T_new_cw (4, 4) with
    brightness affine `aff` (2,) and `exposure` (a float or a 0-d tensor),
    against hosts at T_hosts (F, 4, 4) with host_affs (F, 2) and
    host_expos (F,): K R K^-1 (F, 3, 3), K t (F, 3) and the host -> new
    brightness transfer (F, 2). Reads nothing back: K is a kept device
    constant and the inverses are inv_ex's LU with no check of its info."""
    K = device_const(tuple(map(tuple, calib.K(0).tolist())), T_new_cw.device)
    Ki = torch.linalg.inv_ex(K)[0]
    T_rel = torch.einsum("ij,fjk->fik", T_new_cw,
                         torch.linalg.inv_ex(T_hosts)[0])
    # K4 takes contiguous tables; einsum may give a view on the card
    KRKis = torch.einsum("ij,fjk,kl->fil", K, T_rel[:, :3, :3],
                         Ki).contiguous()
    Kts = torch.einsum("ij,fj->fi", K, T_rel[:, :3, 3]).contiguous()
    ra = torch.exp(aff[0] - host_affs[:, 0]) * exposure / host_expos
    affs = torch.stack([ra, aff[1] - ra * host_affs[:, 1]], dim=-1)
    return KRKis, Kts, affs


def _track_hypothesis0(img, ref, T0, aff0, exposure, b_grad,
                       calib: Calibration, cfg: Config):
    """The pyramid of an uploaded frame and its track from T0: the
    tracker's masked program at batch 1, called as it is (a graph's replay
    cannot be recorded inside another capture). Returns (pyr, T, aff, ok,
    res, flow)."""
    nlv = calib.levels
    pyr = make_pyramid(img, nlv, b_grad)
    no_abort = torch.full((nlv,), 1e9, dtype=torch.float32,
                          device=img.device)
    out = tracker._track_batch(ref, pyr, T0[None], aff0, exposure, no_abort,
                               calib, cfg, nlv - 1)
    return (pyr,) + tuple(o[0] for o in out)


def frame_step(img, ref, arena, up, b_grad, calib: Calibration,
               cfg: Config):
    """The strict frame step (the JAX package's `_frame_step` with its
    trace, full_system.py:47-104): the pyramid of the uploaded frame, the
    track of hypothesis 0, the retrack gate on the device, and the trace of
    the whole candidate arena against the new frame, committed only where
    the gate passes. `up` is the one upload (`_frame_row`); its commit bit
    is the caller's commit_trace. Returns (pyr, arena', packed): arena'
    the traced fields where the gate passes and the arena bitwise as it
    went in where it fails; packed [T (16), aff (2), ok, the trace flag,
    res (L), flow (3)] in the JAX layout."""
    (T0, aff0, expo, last0, commit, T_ref, T_hosts, host_affs,
     host_expos) = _frame_row(up)
    pyr, T, aff, ok, res, flow = _track_hypothesis0(img, ref, T0, aff0, expo,
                                                    b_grad, calib, cfg)
    # the retrack gate in float32 (FullSystem.cc:117-123, the JAX
    # program's :67-69), and the caller's commit
    gate = commit & ok & torch.isfinite(res[0]) & (
        ~torch.isfinite(last0) | (res[0] < last0 * cfg.re_track_threshold))
    traced = immature.trace_arena(
        arena, pyr.dI[0], *trace_tables(T @ T_ref, aff, expo, T_hosts,
                                         host_affs, host_expos, calib),
        calib, cfg)
    pool = arena.pool._replace(**{
        f: torch.where(gate, getattr(traced.pool, f), getattr(arena.pool, f))
        for f in cuda_kernels.TRACE_OUTPUTS})
    packed = torch.cat([T.reshape(-1), aff, ok.to(torch.float32)[None],
                        gate.to(torch.float32)[None], res, flow])
    return pyr, arena._replace(pool=pool), packed


def chain_step(img, ref, chain: TrackChain, up, b_grad, calib: Calibration,
               cfg: Config):
    """The pipelines' chain step (the JAX package's `_chain_prep`,
    `_frame_step_chain` and `_chain_update`, full_system.py:106-123 and
    :479-502): hypothesis 0 from the chain against the reference, the
    pyramid and the track, no trace (the mapping side owns the arena), and
    the chain advanced. `up` is the one upload [T_ref_cw (16), exposure].
    Returns (pyr, packed with a zero trace flag, chain')."""
    T_ref = up[:16].clone().view(4, 4)
    expo = up[16:17].clone().view(())
    T0, aff0, _ = _chain_prep(chain, T_ref)
    pyr, T, aff, ok, res, flow = _track_hypothesis0(img, ref, T0, aff0, expo,
                                                    b_grad, calib, cfg)
    packed = torch.cat([T.reshape(-1), aff, ok.to(torch.float32)[None],
                        torch.zeros(1, device=img.device), res, flow])
    return pyr, packed, _chain_update(chain, packed, T0, T_ref)


def _ref_flat(ref: tracker.TrackerRef) -> tuple:
    return (*ref.points, *ref.valid, ref.ref_exposure, ref.ref_aff)


def _ref_of(xs, L: int) -> tracker.TrackerRef:
    return tracker.TrackerRef(points=tuple(xs[:L]), valid=tuple(xs[L:2 * L]),
                              ref_exposure=xs[2 * L], ref_aff=xs[2 * L + 1])


def _frame_step_program(calib: Calibration, cfg: Config, with_lut: bool):
    """frame_step over (the frame, the tracker reference's tensors, the
    arena's fields, the upload[, the gradient LUT]): the pyramid's dI and
    abs_grad levels, the arena's fields and the packed row."""
    L = calib.levels
    na = len(immature.ImmaturePool._fields) + 1

    def program(*xs):
        ref, rest = _ref_of(xs[1:], L), xs[2 * L + 3:]
        pyr, arena, packed = frame_step(
            xs[0], ref, _arena_of(rest[:na]), rest[na],
            rest[na + 1] if with_lut else None, calib, cfg)
        return pyr.dI + pyr.abs_grad + _arena_flat(arena) + (packed,)
    return program


def _chain_step_program(calib: Calibration, cfg: Config, with_lut: bool):
    """chain_step over (the frame, the tracker reference's tensors, the
    chain's four tensors, the upload[, the gradient LUT]): the pyramid's
    dI and abs_grad levels, the packed row and the new chain's tensors."""
    L = calib.levels

    def program(*xs):
        ref, rest = _ref_of(xs[1:], L), xs[2 * L + 3:]
        pyr, packed, chain = chain_step(
            xs[0], ref, TrackChain(*rest[:4]), rest[4],
            rest[5] if with_lut else None, calib, cfg)
        return pyr.dI + pyr.abs_grad + (packed,) + tuple(chain)
    return program


def _tensors(tree):
    """The tensors of a NamedTuple/tuple tree (a pyramid, a tracker ref)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)


def use_on_current_stream(tree, event, device):
    """Hand tensors made on another stream to this thread's current stream:
    wait for the producer's event, and tell the caching allocator that
    this stream uses them, so their memory is not reused while its work
    is queued."""
    if event is None:
        return
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    for t in _tensors(tree):
        t.record_stream(stream)


def loop_feature_depths(W: Window, newest: int) -> Optional[np.ndarray]:
    """(n, 3) [u, v, idepth] rows the new keyframe's ORB features take
    their depths from: every window point with an inlier residual in the
    newest frame at its centre projection there, then the points the
    newest frame hosts at their own pixels; None if there are none."""
    m = (W.pt_valid & W.res_exist[:, newest]
         & (W.res_state[:, newest] == RES_IN))
    mh = W.pt_valid & (W.pt_host == newest)
    pui = torch.cat([W.center_proj[:, newest][m],
                     torch.stack([W.pt_u, W.pt_v, W.idepth], 1)[mh]])
    return pui.cpu().numpy() if len(pui) else None


class FullSystem:
    def __init__(self, calib: Calibration, cfg: Config,
                 b_grad_lut: Optional[np.ndarray] = None, vocab=None,
                 device=DEFAULT_DEVICE):
        self.calib = calib
        self.cfg = cfg.validate()
        self.device = entry_device(device)
        dev = self.device
        self.b_grad = (torch.as_tensor(np.asarray(b_grad_lut, np.float32),
                                       device=dev)
                       if b_grad_lut is not None else None)

        self.ef = EnergyFunctional(cfg, calib, device=dev)
        self.selector = select_ops.PixelSelector(calib.w[0], calib.h[0], cfg,
                                                 dev)
        self.global_map = GlobalMap()
        self.timer = StageTimer()
        self.loop_closing: Optional[LoopClosing] = None
        if cfg.enable_loop_closing:
            self.loop_closing = LoopClosing(calib, cfg, self.global_map,
                                            vocab=vocab, device=dev)

        self.initialized = False
        self.is_lost = False
        self.init_failed = False
        self.init_state: Optional[initializer.InitializerState] = None
        self.first_pyr: Optional[FramePyramid] = None
        self.first_shell: Optional[FrameShell] = None

        self.all_frames: List[FrameShell] = []
        self.window_frames: List[FrameShell] = []
        self.ef.window_shells = self.window_frames   # shared list object
        self._traced_this_frame = False
        self._frame_pyr: Optional[FramePyramid] = None
        self.window_pyrs: List[FramePyramid] = []
        self.marg_flags: List[bool] = []
        self._imm_cap = cfg.max_immature
        self.imm_arena = immature.empty_arena(2 * cfg.max_immature, cfg, dev)
        # dead lanes of the arena's shape: what a frame step that does not
        # commit its trace traces (`_frame_step_dispatch`)
        self._idle_arena = immature.empty_arena(2 * cfg.max_immature, cfg,
                                                dev)
        self.imm_live: List[bool] = []
        self.dIs = torch.zeros((self.ef.F, calib.h[0], calib.w[0], 3),
                               dtype=torch.float32, device=dev)

        # the tracking reference as ONE (ref, shell, event) tuple: a tracking
        # thread reads it in one load while the mapping thread republishes
        # it, so it never pairs a new ref with an old shell; the event
        # (None on the CPU) marks the ref's completion on its stream
        self._tracker_ref_pair = (None, None, None)
        self.track_chain: Optional[TrackChain] = None   # pipelined tracking
        self._retrack_warm = False
        self.last_coarse_rmse = np.full(calib.levels, np.nan)
        self.first_coarse_rmse = -1.0
        self.current_min_act_dist = 2.0
        self.rng = np.random.RandomState(cfg.seed)
        self._marg_priors = None
        self._marg_deltas = None
        self._act_pull = None          # the activation's result (finish)
        # the arena's counts staged by the last finish(), with the arena's
        # host and valid tensors they counted
        self._imm_counts = None
        self._n_retry_sweeps = 0
        # live viewer hooks (FullSystem::setViewer; viz_live.LiveViewer)
        self.viewer = None
        if dev.type == "cuda":
            self.warm_retrack_programs()

    def _f32(self, a):
        """A host value as float32 on the system's device, without waiting
        for the copy (ops/preprocess.to_device)."""
        return to_device(torch.from_numpy(np.asarray(a, np.float32)),
                         self.device)

    @property
    def tracker_ref(self) -> Optional[tracker.TrackerRef]:
        return self._tracker_ref_pair[0]

    @property
    def tracker_ref_shell(self) -> Optional[FrameShell]:
        return self._tracker_ref_pair[1]

    def _current_tracker_ref(self):
        """One load of the (ref, shell) pair, made usable on this thread's
        stream."""
        ref, shell, event = self._tracker_ref_pair
        use_on_current_stream(ref, event, self.device)
        return ref, shell

    # ------------------------------------------------------------ frame entry
    def add_active_frame(self, image, frame_id: int, exposure: float = 1.0,
                         timestamp: float = 0.0) -> FrameShell:
        """image: rectified (H, W) numpy array or tensor — float32
        photometric-linear, uint8 raw intensities or uint16 8.8 fixed point."""
        t_frame = time.time()
        shell = FrameShell(id=frame_id, timestamp=timestamp, exposure=exposure)
        self.all_frames.append(shell)
        if self.is_lost:
            shell.pose_valid = False
            return shell
        img = upload_image(image, self.device)
        if not self.initialized:
            with self.timer.stage("pyramid"):
                pyr = make_pyramid(img, self.calib.levels, self.b_grad)
            with self.timer.stage("initialize"):
                self._do_initialize(shell, pyr)
            return shell

        with self.timer.stage("track"):
            ok = self._track_new_coarse(shell, img)
        pyr = self._frame_pyr
        if not ok:
            self.is_lost = True
            return shell
        if self.viewer is not None:
            self.viewer.publish_cam_pose(shell)
            self.viewer.publish_frame(image)
        if self._keyframe_decision(shell):
            with self.timer.stage("keyframe"):
                self.make_keyframe(shell, pyr)
        else:
            with self.timer.stage("non_keyframe"):
                self.make_non_keyframe(shell, pyr)
        self.timer.log_frame(frame_id, (time.time() - t_frame) * 1000.0)
        return shell

    # ---------------------------------------------------------- initialization
    def _do_initialize(self, shell: FrameShell, pyr: FramePyramid):
        cfg, calib = self.cfg, self.calib
        if self.init_state is None:
            self.init_state = initializer.set_first(pyr, calib, cfg,
                                                    self.selector)
            # the bootstrap frame's graph, for these level capacities
            initializer.capture_frame_program(self.init_state, pyr, calib,
                                              cfg)
            self.first_pyr = pyr
            self.first_shell = shell
            shell.T_cw = np.eye(4)
            return
        done = initializer.track_frame(self.init_state, self.first_pyr, pyr,
                                       calib, cfg, self.first_shell.exposure,
                                       shell.exposure)
        if done:
            self._initialize_from_initializer(shell, pyr)
        else:
            shell.pose_valid = False

    def _initialize_from_initializer(self, shell: FrameShell, pyr: FramePyramid):
        """FullSystem::initializeFromInitializer (:1326-1400)."""
        cfg = self.cfg
        st = self.init_state
        L0 = st.levels[0]
        valid = L0.valid.cpu().numpy()
        iR = L0.iR.cpu().numpy()[valid]
        rescale = 1.0 / max(iR.mean(), 1e-5)

        first = self.first_shell
        first.T_cw = np.eye(4)
        first.kf_id = self.global_map.num_frames()
        self.ef.insert_frame(first.T_cw, first.exposure, first.aff, is_first=True)
        self.window_frames.append(first)
        self.window_pyrs.append(self.first_pyr)
        self.imm_live.append(False)
        self.marg_flags.append(False)
        self.dIs[0] = self.first_pyr.dI[0]
        self.global_map.add_keyframe(first)

        # sub-select ~desired density of init points, activate immediately
        u_all = L0.u.cpu().numpy()[valid] + 0.5
        v_all = L0.v.cpu().numpy()[valid] + 0.5
        keep_p = min(cfg.desired_point_density / max(len(u_all), 1), 1.0)
        keep = self.rng.rand(len(u_all)) < keep_p
        u = u_all[keep]
        v = v_all[keep]
        idep = iR[keep] * rescale

        patt = torch.tensor(PATTERN, dtype=torch.float32, device=self.device)
        ptc = bilinear(self.first_pyr.dI[0], self._f32(u)[:, None] + patt[None, :, 0],
                       self._f32(v)[:, None] + patt[None, :, 1])
        color = ptc[..., 0].cpu().numpy()
        gsq = torch.sum(ptc[..., 1:3] ** 2, -1).cpu().numpy()
        weights = np.sqrt(cfg.outlier_th_sum_component
                          / (cfg.outlier_th_sum_component + gsq))
        finite = np.isfinite(color).all(axis=1)
        eth = np.full(len(u), 8.0 * cfg.outlier_th
                      * cfg.overall_energy_th_weight ** 2, np.float32)
        self.ef.insert_points(0, u[finite], v[finite], color[finite],
                              weights[finite], idep[finite], eth[finite],
                              has_depth_prior=True)

        T_first_to_new = st.T.copy()
        T_first_to_new[:3, 3] /= rescale
        shell.T_cw = T_first_to_new
        shell.aff = st.aff.copy()
        self.initialized = True
        self.make_keyframe(shell, pyr)

    # ---------------------------------------------------- pipelined tracking
    def chain_reset(self):
        """(Re)build the device tracking chain from the host mirrors."""
        L = self.calib.levels
        frames = [f for f in self.all_frames if f.pose_valid]
        T_slast = frames[-1].T_cw if frames else np.eye(4)
        T_sprelast = frames[-2].T_cw if len(frames) >= 2 else T_slast
        aff = frames[-1].aff if frames else np.zeros(2)
        rmse = np.where(np.isfinite(self.last_coarse_rmse[:L]),
                        self.last_coarse_rmse[:L], np.inf)
        self.track_chain = TrackChain(self._f32(T_slast), self._f32(T_sprelast),
                                      self._f32(aff), self._f32(rmse))

    def _chain_step(self, img, ref, chain: TrackChain, up):
        """The chain step (`chain_step`) on an uploaded frame `img` (one of
        FRAME_DTYPES) against the tracking reference `ref`, from `chain`,
        on the upload `up` [T_ref_cw (16), exposure]: on the card one
        replay of CHAIN_STEP_GRAPHS. Returns (pyr, packed, the new
        chain)."""
        L = self.calib.levels
        out = _program(*self._chain_step_call(img, ref, chain, up))
        return (FramePyramid(dI=out[:L], abs_grad=out[L:2 * L]), out[2 * L],
                TrackChain(*out[2 * L + 1:]))

    def _chain_step_call(self, img, ref, chain, up):
        """The chain step's (family, static, program, inputs). The program
        reads the Config's tracker fields alone, so it is keyed on them."""
        calib, lut = self.calib, self.b_grad is not None
        return (CHAIN_STEP_GRAPHS, (calib, tracker.graph_key(self.cfg), lut),
                _chain_step_program(calib, self.cfg, lut),
                (img,) + _ref_flat(ref) + tuple(chain) + (up,)
                + ((self.b_grad,) if lut else ()))

    def track_chain_dispatch(self, shell: FrameShell, image):
        """Track a frame from the chain's motion hypothesis and advance the
        chain on the device. Returns (pyr, packed result as a HostCopy,
        ref_shell used). Nothing here waits for the card: the frame and the
        one upload [T_ref_cw, exposure] go through pinned memory and the
        step is one graph replay, so the call returns before the frame is
        tracked, and the HostCopy turns ready once it is (the JAX
        package's dispatch, pipeline.py:95-98)."""
        ref, ref_shell = self._current_tracker_ref()
        up = self._f32(np.r_[np.ravel(ref_shell.T_cw), shell.exposure])
        pyr, packed, self.track_chain = self._chain_step(
            frame_image(image, self.device), ref, self.track_chain, up)
        if self.viewer is not None:
            self.viewer.publish_frame(image)
        return pyr, HostCopy(packed), ref_shell

    def track_chain_consume(self, shell: FrameShell, packed,
                            ref_shell: FrameShell) -> bool:
        """Apply a chain step's result (a HostCopy or an array) to the host
        mirrors. False when the retrack gate trips (FullSystem.cc:117-123,
        evaluated in float64 as the JAX package does): the caller then
        retracks the frame on the host retry path."""
        cfg = self.cfg
        nlv = self.calib.levels
        pk = packed.numpy() if isinstance(packed, HostCopy) else packed
        pk = np.asarray(pk, np.float64)
        T = pk[:16].reshape(4, 4)
        aff = pk[16:18]
        ok = pk[18] > 0.5
        res = pk[20:20 + nlv]
        flow = pk[20 + nlv:23 + nlv]
        res0 = float(res[0]) if np.isfinite(res[0]) else np.inf
        if not (ok and np.isfinite(res0)
                and (not np.isfinite(self.last_coarse_rmse[0])
                     or res0 < self.last_coarse_rmse[0]
                     * cfg.re_track_threshold)):
            return False
        shell.T_cw = T @ ref_shell.T_cw
        shell.aff = aff.copy()
        self.last_coarse_rmse = res.copy()
        if self.first_coarse_rmse < 0:
            self.first_coarse_rmse = res0
        self._last_flow = flow.copy()
        self._last_rmse = res0
        if self.viewer is not None:
            self.viewer.publish_cam_pose(shell)
        return True

    def set_viewer(self, viewer):
        """Attach a live viewer (FullSystem::setViewer; viz_live.LiveViewer):
        each tracked pose and frame (the pipelines' dispatch publishes the
        frame too, which the JAX package's does not), and the map after each
        keyframe. The hooks take host values, and a frame as it is."""
        self.viewer = viewer

    def warm_retrack_programs(self):
        """Build what a run would otherwise first build mid-run: the
        kernels' library (compiled from source on first use), the frame
        step's and the chain step's graphs for each of FRAME_DTYPES
        (`_capture_steps`), the tracker's CUDA graph for the retry batch
        (frontend/track_graph), each captured on placeholder inputs of
        this system's shapes, the device LM's graph for each of its trip
        counts (EnergyFunctional.warm_ba_programs), the point
        marginalization's graph (EnergyFunctional.warm_marg_program), the
        keyframe's activation, post-BA, tracker-reference and
        new-candidate programs (`_capture_keyframe`) and, with loop
        closing, the native host library. The bootstrap's graph, keyed on
        set_first's level capacities, is captured at the first frame
        (_do_initialize). The constructor calls it on the card; repeat
        calls are free."""
        if self._retrack_warm:
            return
        if self.device.type == "cuda":
            cuda_kernels._load()
            self._capture_steps()
            self._capture_tracker()
            self.ef.warm_ba_programs(self.dIs, self.cfg.max_opt_iterations,
                                     self.calib.w[0], self.calib.h[0])
            self.ef.warm_marg_program(self.dIs, self.calib.w[0],
                                      self.calib.h[0])
            self._capture_keyframe()
        if self.loop_closing is not None:
            native.get_lib()
        self._retrack_warm = True

    def _placeholder_ref(self) -> tracker.TrackerRef:
        """A tracking reference of this system's shapes, all zeros."""
        dev = self.device
        caps = self.cfg.tracker_caps[:self.calib.levels]
        return tracker.TrackerRef(
            points=tuple(torch.zeros(c, 4, dtype=torch.float32, device=dev)
                         for c in caps),
            valid=tuple(torch.zeros(c, dtype=torch.bool, device=dev)
                        for c in caps),
            ref_exposure=torch.ones((), dtype=torch.float32, device=dev),
            ref_aff=torch.zeros(2, dtype=torch.float32, device=dev))

    def _capture_steps(self):
        """Capture the frame step and the chain step for each of
        FRAME_DTYPES on placeholder inputs of this system's shapes (the
        arena as built, a zero frame, identity poses), so that no step
        captures mid-run (FRAME_STEP_GRAPHS, CHAIN_STEP_GRAPHS)."""
        calib, dev = self.calib, self.device
        ref = self._placeholder_ref()
        up = self._frame_upload(np.eye(4), np.zeros(2), 1.0, True, np.eye(4))
        chain_up = self._f32(np.r_[np.eye(4).ravel(), 1.0])
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        chain = TrackChain(eye, eye, torch.zeros(2, device=dev),
                           torch.full((calib.levels,), float("inf"),
                                      device=dev))
        for dtype in FRAME_DTYPES:
            img = torch.zeros(calib.h[0], calib.w[0], dtype=dtype, device=dev)
            for family, static, fn, inputs in (
                    self._frame_step_call(img, ref, self.imm_arena, up),
                    self._chain_step_call(img, ref, chain, chain_up)):
                family.capture(static, fn, inputs)

    def _capture_tracker(self):
        """Track placeholder inputs of this system's shapes at the retry
        batch RETRY_K, so that its tracker graph exists before the first
        frame (hypothesis 0 is tracked inside the frame and chain
        steps)."""
        calib, dev = self.calib, self.device
        f32 = dict(dtype=torch.float32, device=dev)
        pyr = FramePyramid(dI=tuple(torch.zeros(calib.h[lvl], calib.w[lvl], 3,
                                                **f32)
                                    for lvl in range(calib.levels)),
                           abs_grad=())
        tracker.track_frame_hypotheses(
            self._placeholder_ref(), pyr,
            torch.eye(4, **f32).expand(RETRY_K, 4, 4), torch.zeros(2, **f32),
            torch.ones((), **f32), torch.full((calib.levels,), 1e9, **f32),
            calib, self.cfg, calib.levels - 1)

    def _capture_keyframe(self):
        """Capture the activation's graphs (`_capture_activation`) and run
        the keyframe's three other programs once on placeholder inputs of
        this system's shapes (the window and arena as built, zero images,
        an upload of zeros), so that their graphs exist before the first
        frame: ACTIVATE_GRAPHS, POST_BA_GRAPHS, TRACKER_REF_GRAPHS and
        NEW_TRACES_GRAPHS (the arena half alone where another selection
        makes the map)."""
        self._capture_activation()
        calib, dev = self.calib, self.device
        f32 = dict(dtype=torch.float32, device=dev)
        up = torch.zeros(self.ef.F + 3, **f32)
        dI = tuple(torch.zeros(calib.h[lvl], calib.w[lvl], 3, **f32)
                   for lvl in range(calib.levels))
        second = torch.zeros(calib.h[0], calib.w[0], **f32)
        if self._detector_grid() is None:
            second = second.to(torch.int32)
        for call in (self._post_ba_call(self.ef.W, up),
                     self._tracker_ref_call(self.ef.W, up, dI),
                     self._candidates_call(self.imm_arena, dI[0], second,
                                           up)):
            _program(*call)

    def _capture_activation(self):
        """Capture the activation program for every window size (1..F
        frames) on this system's window, arena and images and an upload of
        zeros, so that no activation captures mid-run (ACTIVATE_GRAPHS).
        None for a one-level pyramid: the pass reads pyramid level 1."""
        if self.calib.levels < 2:
            return
        up = torch.zeros(activation_upload_size(self.ef.F),
                         dtype=torch.float32, device=self.device)
        for nf in range(1, self.ef.F + 1):
            family, static, fn, inputs = self._activation_call(
                self.ef.W, self.imm_arena, self.dIs, up, nf)
            family.capture(static, fn, inputs)

    def _post_ba_call(self, W, up):
        """The post-BA program's (family, static, program, inputs)."""
        return (POST_BA_GRAPHS, (), _post_ba_program,
                tuple(getattr(W, f) for f in POST_BA_FIELDS) + (up,))

    def _tracker_ref_call(self, W, up, dI):
        """The tracker reference's (family, static, program, inputs) on
        the newest keyframe's pyramid levels dI."""
        calib = self.calib
        caps = tuple(self.cfg.tracker_caps[:calib.levels])
        return (TRACKER_REF_GRAPHS, (calib, caps),
                _tracker_ref_program(calib, caps),
                tuple(getattr(W, f) for f in REF_FIELDS) + (up,) + tuple(dI))

    def _detector_grid(self):
        """The detector's grid when the new candidates' status map is in
        their program (pure VO: point_selection 1, no loop closing), else
        None."""
        cfg = self.cfg
        if cfg.point_selection == 1 and self.loop_closing is None:
            return detector.detect_grid_params(
                self.calib.h[0], self.calib.w[0],
                int(cfg.desired_immature_density))
        return None

    def _candidates_call(self, arena, dI0, second, up):
        """The new candidates' (family, static, program, inputs): `second`
        is the level-0 gradient magnitude where the detector's map is in
        the program (`_detector_grid`), else the status map."""
        cfg, cap = self.cfg, self._imm_cap
        gp = self._detector_grid()
        # keyed on the whole (frozen) Config the program closes over
        return (NEW_TRACES_GRAPHS, (gp, cap, cfg),
                _candidates_program(gp, cap, cfg),
                _arena_flat(arena) + (dI0, second, up))

    # ---------------------------------------------------------------- tracking
    def _frame_step(self, img, ref, T0, aff0, exposure: float, T_ref_cw,
                    commit_trace: bool = True):
        """The strict frame step (`frame_step`, the JAX package's fused
        `_frame_step`): `_frame_step_dispatch`, then the one read of its
        packed row. Returns (pyr, the packed row as float64 [T (16), aff
        (2), ok, the trace flag, res (L), flow (3)])."""
        with self.timer.stage("track.step_dispatch"):
            pyr, packed = self._frame_step_dispatch(
                img, ref, T0, aff0, exposure, T_ref_cw, commit_trace)
        with self.timer.stage("track.step_pull"):
            return pyr, packed.numpy().astype(np.float64)

    def _frame_step_dispatch(self, img, ref, T0, aff0, exposure: float,
                             T_ref_cw, commit_trace: bool = True):
        """The frame step's device half on a host frame (or a tensor),
        hypothesis 0's T0 (4, 4) and aff0 (2,) and the reference's T_ref_cw
        (host arrays): one pinned upload (`_frame_upload`) and, on the
        card, one replay of FRAME_STEP_GRAPHS; nothing waits for the card.
        With commit_trace the candidate arena takes the step's arena,
        traced where the retrack gate passed and bitwise as it was where
        it failed. Without it the step traces an idle arena of dead lanes
        and the arena is left alone (the mapping side owns it: the
        pipelines' retry path). Returns (pyr, the packed row as a
        HostCopy)."""
        arena = self.imm_arena if commit_trace else self._idle_arena
        up = self._frame_upload(T0, aff0, exposure, commit_trace, T_ref_cw)
        out = _program(*self._frame_step_call(frame_image(img, self.device),
                                              ref, arena, up))
        L = self.calib.levels
        if commit_trace:
            self.imm_arena = _arena_of(out[2 * L:-1])
        return FramePyramid(dI=out[:L], abs_grad=out[L:2 * L]), \
            HostCopy(out[-1])

    def _frame_step_call(self, img, ref, arena, up):
        """The frame step's (family, static, program, inputs); keyed on the
        whole (frozen) Config the program closes over, the arena's lanes
        and the window's slots."""
        calib, cfg, lut = self.calib, self.cfg, self.b_grad is not None
        static = (calib, cfg, arena.host.shape[0], self.ef.F, lut)
        return (FRAME_STEP_GRAPHS, static,
                _frame_step_program(calib, cfg, lut),
                (img,) + _ref_flat(ref) + _arena_flat(arena) + (up,)
                + ((self.b_grad,) if lut else ()))

    def _window_tables(self):
        """The window's host poses, affines and exposures padded to its F
        slots with the identity: (T_hosts (F, 4, 4), host_affs (F, 2),
        host_expos (F,)), float64."""
        F = self.ef.F
        T_hosts = np.tile(np.eye(4), (F, 1, 1))
        host_affs = np.zeros((F, 2))
        host_expos = np.ones(F)
        for i, fr in enumerate(self.window_frames):
            T_hosts[i] = fr.T_cw
            host_affs[i] = fr.aff
            host_expos[i] = fr.exposure or 1.0
        return T_hosts, host_affs, host_expos

    def _frame_upload(self, T0, aff0, exposure: float, commit: bool,
                      T_ref_cw):
        """The frame step's one upload, pinned and without a wait: [T0
        (16), aff0 (2), exposure, last_coarse_rmse[0], commit, T_ref_cw
        (16), T_hosts (F x 16), host_affs (F x 2), host_expos (F)] as
        float32 (`_frame_row` reads it on the device). Without commit the
        host tables are the identity's: the mapping side may be changing
        the window, and the step's trace is not kept."""
        if commit:
            tables = self._window_tables()
        else:
            F = self.ef.F
            tables = (np.tile(np.eye(4), (F, 1, 1)), np.zeros((F, 2)),
                      np.ones(F))
        return self._f32(np.concatenate(
            [np.ravel(T0), np.ravel(aff0),
             [exposure, self.last_coarse_rmse[0], float(commit)],
             np.ravel(T_ref_cw)] + [np.ravel(t) for t in tables]))

    def _trace_transforms(self, T_new_cw, aff, exposure: float):
        """The trace's per-host inputs (`trace_tables`) for a new frame at
        T_new_cw (a device (4, 4)) with brightness affine `aff` (a device
        (2,)) against the window as it stands, whose poses, affines and
        exposures go up pinned and without a wait."""
        T_hosts, host_affs, host_expos = self._window_tables()
        return trace_tables(T_new_cw, aff, float(np.float32(exposure)),
                            self._f32(T_hosts), self._f32(host_affs),
                            self._f32(host_expos), self.calib)

    def _trace_arena(self, pyr, KRKis, Kts, affs):
        """Trace the whole candidate arena against the new frame: on the
        card one K4 launch, with no read of the live watermark (dead lanes
        pass through the trace untouched)."""
        self.imm_arena = immature.trace_arena(
            self.imm_arena, pyr.dI[0], KRKis, Kts, affs, self.calib, self.cfg)

    def _track_new_coarse(self, shell: FrameShell, img,
                          commit_trace: bool = True, neighbors=None) -> bool:
        """trackNewCoarse (FullSystem.cc:179-382). neighbors: the (slast,
        sprelast) shells of the motion hypotheses; the pipelined retry path
        passes the frames before `shell`, since all_frames has run ahead of
        it. commit_trace=False leaves the candidate arena alone (the mapping
        side owns it)."""
        cfg, calib = self.cfg, self.calib
        tracker_ref, ref_shell = self._current_tracker_ref()
        # the ref this (re)track used, for the caller's keyframe decision
        self._last_track_ref = ref_shell
        lastF_T = ref_shell.T_cw
        slast = sprelast = None
        if neighbors is not None:
            if all(n is not None and n.pose_valid for n in neighbors):
                slast, sprelast = neighbors
        elif (len(self.all_frames) >= 3 and self.all_frames[-2].pose_valid
                and self.all_frames[-3].pose_valid):
            slast, sprelast = self.all_frames[-2], self.all_frames[-3]
        if slast is not None and ref_shell.pose_valid:
            slast_2_sprelast = sprelast.T_cw @ np.linalg.inv(slast.T_cw)
            lastF_2_slast = slast.T_cw @ np.linalg.inv(lastF_T)
            aff_last = slast.aff.copy()
            tries = _motion_hypotheses(lastF_2_slast, slast_2_sprelast)
        else:
            tries = [np.eye(4)]
            aff_last = np.zeros(2)
        coarsest = calib.levels - 1
        nlv = calib.levels

        pyr, pk = self._frame_step(img, tracker_ref, tries[0], aff_last,
                                   shell.exposure, ref_shell.T_cw,
                                   commit_trace)
        self._frame_pyr = pyr
        T, aff, ok = pk[:16].reshape(4, 4), pk[16:18], pk[18] > 0.5
        # the trace flag: the step committed its trace (JAX's :875-883)
        self._traced_this_frame = bool(pk[19] > 0.5)
        res, flow = pk[20:20 + nlv], pk[20 + nlv:23 + nlv]
        res0 = float(res[0]) if np.isfinite(res[0]) else np.inf
        best = (T, aff, res, flow) if (ok and np.isfinite(res0)) else None
        achieved = res if best else np.full(calib.levels, np.nan)
        retrack_ok = best is not None and (
            not np.isfinite(self.last_coarse_rmse[0])
            or res0 < self.last_coarse_rmse[0] * cfg.re_track_threshold)

        if not retrack_ok and len(tries) > 1:
            # rank all retry initializations with one coarsest-level warp,
            # then LM-refine the best RETRY_K as one batch
            self._n_retry_sweeps += 1
            aff0 = self._f32(aff_last)
            expo = self._f32(shell.exposure)
            rest = tries[1:]
            res_best = res0 if best is not None else np.inf
            min_abort = self._f32(np.where(np.isfinite(achieved), achieved, 1e9))
            with self.timer.stage("track.sweep_rank"):
                scores = tracker.rank_hypotheses(
                    tracker_ref, pyr, self._f32(np.stack(rest)), aff0,
                    expo, calib, cfg, coarsest).cpu().numpy()
            order = np.argsort(scores)[:RETRY_K]
            chunk = [rest[int(i)] for i in order]
            while len(chunk) < RETRY_K:
                chunk = chunk + [chunk[-1]]
            with self.timer.stage("track.sweep"):
                Tb, affb, okb, resb, flowb = tracker.track_frame_hypotheses(
                    tracker_ref, pyr, self._f32(np.stack(chunk)), aff0,
                    expo, min_abort, calib, cfg, coarsest)
                pk = torch.cat([Tb.reshape(-1, 16), affb,
                                okb.to(torch.float32)[:, None], resb, flowb],
                               dim=1).cpu().numpy().astype(np.float64)
            Tn = pk[:, :16].reshape(-1, 4, 4)
            affn = pk[:, 16:18]
            okn = pk[:, 18] > 0.5
            resn = pk[:, 19:19 + nlv]
            flown = pk[:, 19 + nlv:22 + nlv]
            resn0 = np.where(okn & np.isfinite(resn[:, 0]), resn[:, 0], np.inf)
            k = int(np.argmin(resn0))
            if np.isfinite(resn0[k]) and resn0[k] < res_best:
                best = (Tn[k], affn[k], resn[k], flown[k])

        if best is None:
            # total failure: take the predicted pose and hope to recover
            shell.T_cw = tries[0] @ ref_shell.T_cw
            shell.aff = aff_last.copy()
            self._last_flow = np.zeros(3)
            self._last_rmse = np.inf
            return bool(np.isfinite(shell.T_cw).all())

        T, aff, res, flow = best
        shell.T_cw = np.asarray(T, np.float64) @ ref_shell.T_cw
        shell.aff = np.asarray(aff, np.float64)
        self.last_coarse_rmse = np.asarray(res, np.float64)
        if self.first_coarse_rmse < 0:
            self.first_coarse_rmse = float(res[0])
        self._last_flow = np.asarray(flow, np.float64)
        self._last_rmse = float(res[0])
        return bool(np.isfinite(self._last_rmse))

    def _keyframe_decision(self, shell: FrameShell, ref=None) -> bool:
        """Optical-flow + affine heuristic (FullSystem.cc:125-147). ref: the
        shell the frame was tracked against (the current tracking reference
        unless the pipelined consumer passes the one of its dispatch)."""
        cfg, calib = self.cfg, self.calib
        ref = ref or self.tracker_ref_shell
        if cfg.keyframes_per_second > 0:
            last_kf = self.window_frames[-1]
            return (len(self.all_frames) == 1
                    or (shell.timestamp - last_kf.timestamp)
                    > 0.95 / cfg.keyframes_per_second)
        ef_, et_ = ref.exposure or 1.0, shell.exposure or 1.0
        a_new = 0.0 if cfg.kf_affine_frame_zero else shell.aff[0]
        rel_a = float(np.exp(a_new - ref.aff[0]) * et_ / ef_)
        wh = calib.w[0] + calib.h[0]
        f = self._last_flow
        b = (cfg.kf_global_weight * cfg.max_shift_weight_t * np.sqrt(max(f[0], 0)) / wh
             + cfg.kf_global_weight * cfg.max_shift_weight_r * np.sqrt(max(f[1], 0)) / wh
             + cfg.kf_global_weight * cfg.max_shift_weight_rt * np.sqrt(max(f[2], 0)) / wh
             + cfg.kf_global_weight * cfg.max_affine_weight * abs(np.log(rel_a)))
        b2 = 2.0 * self.first_coarse_rmse < self._last_rmse
        return len(self.all_frames) == 1 or b > 1 or b2

    # ------------------------------------------------------------ keyframe ops
    def _trace_new_coarse(self, shell: FrameShell, pyr: FramePyramid):
        """traceNewCoarse (:1012-1050) with host float64 transforms."""
        calib = self.calib
        if not any(self.imm_live):
            return
        K = calib.K(0)
        Ki = calib.Ki(0)
        F = self.ef.F
        KRKis = np.tile(np.eye(3), (F, 1, 1))
        Kts = np.zeros((F, 3))
        affs = np.tile(np.array([1.0, 0.0]), (F, 1))
        for i, host in enumerate(self.window_frames):
            T_rel = shell.T_cw @ np.linalg.inv(host.T_cw)
            KRKis[i] = K @ T_rel[:3, :3] @ Ki
            Kts[i] = K @ T_rel[:3, 3]
            ef_, et_ = host.exposure or 1.0, shell.exposure or 1.0
            ra = np.exp(shell.aff[0] - host.aff[0]) * et_ / ef_
            affs[i] = (ra, shell.aff[1] - ra * host.aff[1])
        self._trace_arena(pyr, self._f32(KRKis), self._f32(Kts), self._f32(affs))

    def _flag_frames_for_marginalization(self):
        """flagFramesForMarginalization (:647-723)."""
        cfg = self.cfg
        nf = len(self.window_frames)
        pt_host = self.ef.pt_host_np
        pt_valid = self.ef.pt_valid_np
        flags = [False] * nf
        # the counts the previous keyframe's finish() staged, while the
        # arena's live lanes are still those it counted; else (the first
        # keyframe) one read
        staged, self._imm_counts = self._imm_counts, None
        if (staged is not None and staged[1] is self.imm_arena.host
                and staged[2] is self.imm_arena.pool.valid):
            imm_counts = staged[0].numpy()[:self.ef.F]
        else:
            imm_counts = immature.arena_counts(self.imm_arena,
                                               self.ef.F).cpu().numpy()
        newest = self.window_frames[-1]
        flagged = 0
        for i, fr in enumerate(self.window_frames):
            n_imm = int(imm_counts[i]) if self.imm_live[i] else 0
            n_act = int((pt_valid & (pt_host == i)).sum())
            n_in = n_imm + n_act
            n_out = getattr(fr, "_n_dead_points", 0)
            rel_a = (np.exp(fr.aff[0] - newest.aff[0])
                     * (fr.exposure or 1.0) / (newest.exposure or 1.0))
            if ((n_in < cfg.min_points_remaining * (n_in + n_out)
                 or abs(np.log(rel_a)) > cfg.max_log_aff_fac_in_window)
                    and nf - flagged > cfg.min_frames):
                flags[i] = True
                flagged += 1

        # distance-score marginalization when the window is full (:693-723)
        if nf - flagged >= cfg.max_frames:
            T = [fr.T_cw for fr in self.window_frames]
            newest_kf_id = self.window_frames[-1].kf_id
            best_score, best_i = 1.0, -1
            for i, fr in enumerate(self.window_frames):
                if fr.kf_id > newest_kf_id - cfg.min_frame_age or fr.kf_id == 0:
                    continue
                dist_score = 0.0
                for j, fr2 in enumerate(self.window_frames):
                    if fr2.kf_id > newest_kf_id - cfg.min_frame_age + 1 or j == i:
                        continue
                    d = np.linalg.norm((T[j] @ np.linalg.inv(T[i]))[:3, 3])
                    dist_score += 1.0 / (1e-5 + d)
                d_last = np.linalg.norm((T[nf - 1] @ np.linalg.inv(T[i]))[:3, 3])
                dist_score *= -np.sqrt(d_last)
                if dist_score < best_score:
                    best_score, best_i = dist_score, i
            if best_i >= 0:
                flags[best_i] = True
        self.marg_flags = flags

    def _activate_points(self):
        """activatePointsMT (:1052-1206): distance-map gate, batched
        depth-only LM, point insertion, candidate cleanup, as one device
        pass (`_activate_fused`; on the card one graph replay) that reads
        nothing back: its result rides home as one HostCopy that finish()
        applies. The reference's greedy incremental map update is a
        single-pass test against the initial map (the JAX package's
        documented deviation)."""
        cfg = self.cfg
        n_points = int(self.ef.pt_valid_np.sum())
        d = cfg.desired_point_density
        delta = 0.0
        if n_points < d * 0.66:
            delta -= 0.8
        if n_points < d * 0.8:
            delta -= 0.5
        elif n_points < d * 0.9:
            delta -= 0.2
        elif n_points < d:
            delta -= 0.1
        if n_points > d * 1.5:
            delta += 0.8
        if n_points > d * 1.3:
            delta += 0.5
        if n_points > d * 1.15:
            delta += 0.2
        if n_points > d:
            delta += 0.1
        self.current_min_act_dist = float(np.clip(
            self.current_min_act_dist + delta, 0.0, 4.0))
        if not any(self.imm_live):
            return          # no slot hosts candidates: nothing to activate
        self._activation_pass()

    def _activation_pass(self):
        """The activation pass over the window as it stands (on the card one
        replay of ACTIVATE_GRAPHS) on its one upload; its packed rows go
        home while the BA (queued behind it) runs, and finish() applies
        them first (_consume_activation)."""
        nf = len(self.window_frames)
        out = _program(*self._activation_call(
            self.ef.W, self.imm_arena, self.dIs, self._activation_upload(),
            nf))
        nw = len(ACT_FIELDS)
        self.ef.W = self.ef.W._replace(**dict(zip(ACT_FIELDS, out[:nw])))
        self.imm_arena = _arena_of(out[nw:-1])
        self._act_pull = (HostCopy(out[-1]), nf)

    def _activation_call(self, W, arena, dIs, up, nf: int):
        """The activation program's (family, static, program, inputs) for a
        window of nf frames, the window's images dIs and the activation's
        upload `up`."""
        calib = self.calib
        # keyed on the whole (frozen) Config the program closes over
        static = (nf, self.cfg, calib, calib.w[1], calib.h[1])
        return (ACTIVATE_GRAPHS, static, _activation_program(*static),
                tuple(getattr(W, f) for f in ACT_FIELDS) + _arena_flat(arena)
                + (dIs, up))

    def _activation_upload(self):
        """The activation's host tables for the window as it stands, formed
        in float64 and uploaded as one pinned float32 buffer without a
        wait (`activation_tables` reads it on the device): [KRKis, Kts, Rs,
        ts, affs, masks, min_act_dist, marg_flags]."""
        calib = self.calib
        nf = len(self.window_frames)
        newest = nf - 1
        K1 = calib.K(1)
        Ki0 = calib.Ki(0)
        T = [fr.T_cw for fr in self.window_frames]
        F = self.ef.F
        KRKis = np.tile(np.eye(3), (F, 1, 1))
        Kts = np.zeros((F, 3))
        for i in range(nf):
            T_rel = T[newest] @ np.linalg.inv(T[i])
            KRKis[i] = K1 @ T_rel[:3, :3] @ Ki0
            Kts[i] = K1 @ T_rel[:3, 3]
        marg_flags = np.asarray(self.marg_flags + [True] * (F - nf))
        Rs = np.tile(np.eye(3), (F, F, 1, 1))
        ts = np.zeros((F, F, 3))
        affs_a = np.tile(np.array([1.0, 0.0]), (F, F, 1))
        masks = np.zeros((F, F), bool)
        for i in range(nf):
            fi = self.window_frames[i]
            for j in range(nf):
                if j == i:
                    continue
                T_ht = T[j] @ np.linalg.inv(T[i])
                Rs[i, j] = T_ht[:3, :3]
                ts[i, j] = T_ht[:3, 3]
                fj = self.window_frames[j]
                ef_, et_ = fi.exposure or 1.0, fj.exposure or 1.0
                ra = np.exp(fj.aff[0] - fi.aff[0]) * et_ / ef_
                affs_a[i, j] = (ra, fj.aff[1] - ra * fi.aff[1])
                masks[i, j] = True
        return self._f32(np.concatenate([
            KRKis.ravel(), Kts.ravel(), Rs.ravel(), ts.ravel(),
            affs_a.ravel(), masks.ravel(), [self.current_min_act_dist],
            marg_flags.ravel()]))

    def _consume_activation(self):
        """Apply the activation's result to the host mirrors: the inserted
        points' slots and hosts, and the dead-candidate counters of their
        host keyframes. The one read of the activation, in finish() (the
        JAX package's _consume_activation)."""
        pull = self._act_pull
        if pull is None:
            return
        self._act_pull = None
        packed, nf = pull
        pk = packed.numpy().astype(np.int64)
        slot, host_np = pk[:, 0], pk[:, 1]
        ins = (pk[:, 2] > 0) & (slot < self.ef.P)
        self.ef.pt_valid_np[slot[ins]] = True
        self.ef.pt_host_np[slot[ins]] = host_np[ins]
        rm = pk[:, 3] > 0
        for i, n_rm in zip(*np.unique(host_np[rm], return_counts=True)):
            if 0 <= i < nf and self.imm_live[i]:
                fr = self.window_frames[i]
                fr._n_dead_points = getattr(fr, "_n_dead_points", 0) + int(n_rm)

    def _kf_upload(self):
        """The keyframe's one upload, pinned and without a wait: [the
        window's marginalization flags padded to F slots, newest, prev,
        the newest frame's exposure] as float32 (`_kf_row` reads it on the
        device). The post-BA, tracker-reference and new-candidate programs
        take it as an input, so their graphs' keys do not change from
        keyframe to keyframe."""
        F = self.ef.F
        nf = len(self.window_frames)
        row = np.zeros(F + 3, np.float32)
        flags = np.asarray(self.marg_flags[:F], np.float32)
        row[:len(flags)] = flags
        row[F:] = (nf - 1, nf - 2,
                   np.float32(self.window_frames[nf - 1].exposure))
        return self._f32(row)

    def _post_ba(self, up):
        """Drop zero-residual points (removeOutliers, FullSystem.cc:1402-1420)
        and decide point removal/marginalization (flagPointsForRemoval) as
        one program (`post_ba_packed`; on the card one replay of
        POST_BA_GRAPHS) on the keyframe's upload `up`. Returns (the packed
        row as a HostCopy for finish to read, drop_dev, marg_dev)."""
        W = self.ef.W
        pt_valid, res_exist, res_active, packed, drop, marg = _program(
            *self._post_ba_call(W, up))
        self.ef.W = W._replace(pt_valid=pt_valid, res_exist=res_exist,
                               res_active=res_active)
        return HostCopy(packed), drop, marg

    def make_keyframe(self, shell: FrameShell, pyr: FramePyramid):
        """makeKeyFrame (:410-591), synchronous: dispatch and finish in one
        call (the reference's linearizeOperation semantics)."""
        self.make_keyframe_dispatch(shell, pyr)()

    def make_keyframe_dispatch(self, shell: FrameShell, pyr: FramePyramid):
        """The device half of makeKeyFrame: trace, frame-marginalization
        flags, insert, activation, windowed BA, post-BA flags, the tracker
        reference (published before point marginalization, as
        setCoarseTrackingRef at :507-514 precedes marginalizePointsF), point
        marginalization and new candidates. Returns a finish() closure for
        the host half (pose sync, the tracker reference republished with
        the post-BA anchor, point retirement, covisibility edges, frame
        marginalization, loop closing); finish.ready() says whether the
        device results it reads are in. finish() must run before the next
        dispatch: it renumbers the window and registers the keyframe."""
        cfg, calib = self.cfg, self.calib
        if not self._traced_this_frame:
            with self.timer.stage("kf.trace"):
                self._trace_new_coarse(shell, pyr)
        self._traced_this_frame = False
        with self.timer.stage("kf.flag_marg"):
            self._flag_frames_for_marginalization()

        shell.kf_id = self.global_map.num_frames()
        with self.timer.stage("kf.insert"):
            idx, self.dIs = self.ef.insert_keyframe(
                shell.T_cw, shell.exposure, shell.aff, self.dIs, pyr.dI[0])
        self.window_frames.append(shell)
        self.window_pyrs.append(pyr)
        self.imm_live.append(False)
        self.marg_flags.append(False)
        with self.timer.stage("kf.activate"):
            self._activate_points()

        # from the BA through the new candidates nothing reads the card:
        # the BA's stats (with the device LM), the post-BA row and the
        # point marginalization's result go home as HostCopys that
        # finish() reads
        with self.timer.stage("kf.ba"):
            stats = self.ef.optimize(self.dIs, cfg.max_opt_iterations,
                                     calib.w[0], calib.h[0],
                                     defer_stats=device_lm(cfg))
        with self.timer.stage("kf.post_ba"):
            up = self._kf_upload()
            post, drop_dev, marg_dev = self._post_ba(up)
        with self.timer.stage("kf.tracker_ref"):
            pending_ref = self._dispatch_tracker_ref(up)
            self._publish_tracker_ref(pending_ref)
        with self.timer.stage("kf.marg_points"):
            # one graph replay on the card; `marg` is its one HostCopy
            marg = self.ef.marginalize_and_drop_dispatch(
                marg_dev, drop_dev, self.dIs, calib.w[0], calib.h[0])
        with self.timer.stage("kf.new_traces"):
            self._make_new_traces(pyr, up)
        pulls = [marg, post] + ([stats] if isinstance(stats, HostCopy)
                                else [])

        def finish():
            rmse = stats
            if isinstance(stats, HostCopy):
                with self.timer.stage("kf.post_ba.stats"):
                    rmse = self.ef.consume_stats(stats)
            with self.timer.stage("kf.post_ba.activation"):
                self._consume_activation()
            with self.timer.stage("kf.post_ba.pull"):
                pk = post.numpy().astype(np.float64)
            self.is_lost = self.is_lost or self.ef.is_lost
            num_kfs = self.global_map.num_frames() + 1
            if num_kfs <= 4:
                if ((num_kfs == 2 and rmse > 20) or (num_kfs == 3 and rmse > 13)
                        or (num_kfs == 4 and rmse > 9)):
                    self.init_failed = True
            if self.is_lost:
                return
            T, A, dead, self._marg_priors, self._marg_deltas = \
                unpack_post_ba(pk, self.ef.F, self.ef.P)
            rec, really_marg, dropped = self.ef.marginalize_and_drop_consume(
                marg)
            if dead.any():
                self._count_dead(dead)
                self.ef.pt_valid_np &= ~dead
            for i, sh in enumerate(self.window_frames):
                sh.T_cw = T[i].copy()
                sh.aff = A[i].copy()
                if sh.kf_id >= self.global_map.latest_optimized_kf_id:
                    sh.S_cw = sh.T_cw.copy()
            # the shells now carry the post-BA poses: republish so later
            # dispatches anchor to them
            self._publish_tracker_ref(pending_ref)
            if really_marg.any():
                self._record_retired(really_marg, rec)
            only_drop = dropped & ~really_marg
            if only_drop.any():
                self._count_dead(only_drop)

            # covisibility edges (:532-567)
            if len(self.window_frames) >= 2:
                ref = self.window_frames[-2]
                first = self.window_frames[0]
                shell.add_pose_rel(ref.kf_id,
                                   shell.T_cw @ np.linalg.inv(ref.T_cw))
                if first is not ref:
                    shell.add_pose_rel(first.kf_id,
                                       shell.T_cw @ np.linalg.inv(first.T_cw))
            for fr in self.window_frames[:-1]:
                for kfid in list(fr.pose_rel.keys()):
                    other = self.global_map.keyframes.get(kfid)
                    if other is not None:
                        _, info, is_loop = fr.pose_rel[kfid]
                        fr.pose_rel[kfid] = (
                            fr.T_cw @ np.linalg.inv(other.T_cw), info, is_loop)

            with self.timer.stage("kf.marg_frames"):
                i = 0
                while i < len(self.window_frames):
                    if self.marg_flags[i]:
                        self._marginalize_frame_full(i)
                        i = 0
                    else:
                        i += 1
            self.global_map.add_keyframe(shell)
            if self.viewer is not None:
                self.viewer.publish_keyframes(self.global_map,
                                              self.window_frames)
            # the arena's counts for the next keyframe's frame flags, on
            # their way home (the arena changes only on the keyframe path)
            self._imm_counts = (HostCopy(immature.arena_counts_and_watermark(
                self.imm_arena, self.ef.F)), self.imm_arena.host,
                self.imm_arena.pool.valid)
            if self.loop_closing is not None:
                with self.timer.stage("kf.loop"):
                    self._loop_closing_step(shell, pyr)

        def ready() -> bool:
            """Whether the device results finish() reads are in: the
            point marginalization's, the post-BA row and the BA's stats
            (their HostCopys' events; always on the CPU)."""
            return all(p.is_ready() for p in pulls)

        finish.ready = ready
        return finish

    def _loop_closing_step(self, shell: FrameShell, pyr: FramePyramid):
        """Loop closing inline after the keyframe (makeKeyFrame :585-589;
        the reference hands it to its thread). Feature depths come from
        every window point projected into the new keyframe through the
        BA's centre projections (LoopClosing.cc:281-283 reads the same
        idepth map), plus the points it hosts at their own pixels."""
        pui = loop_feature_depths(self.ef.W, len(self.window_frames) - 1)
        self.loop_closing.make_kf_record(shell, pyr, pui)
        window_ids = [f.kf_id for f in self.window_frames]
        if self.loop_closing.insert_keyframe(shell, window_ids):
            with self.timer.stage("kf.loop.pgo"):
                self.loop_closing.run_pose_graph_if_needed()

    def make_non_keyframe(self, shell: FrameShell, pyr: FramePyramid):
        if not self._traced_this_frame:
            self._trace_new_coarse(shell, pyr)
        self._traced_this_frame = False

    def _count_dead(self, mask: np.ndarray):
        for h in self.ef.pt_host_np[mask]:
            if h < len(self.window_frames):
                fr = self.window_frames[h]
                fr._n_dead_points = getattr(fr, "_n_dead_points", 0) + 1

    def _record_retired(self, mask: np.ndarray, rec: np.ndarray):
        """Retire points into their host keyframe shells (world map) from a
        (P, 4) [u, v, idepth, _] record."""
        calib = self.calib
        fx, fy = calib.fx[0], calib.fy[0]
        cx, cy = calib.cx[0], calib.cy[0]
        hosts = self.ef.pt_host_np
        for p in np.nonzero(mask)[0]:
            h = hosts[p]
            if h < len(self.window_frames):
                fr = self.window_frames[h]
                fr.map_points.append(MapPointRecord(
                    host_kf_id=fr.kf_id, u=(rec[p, 0] - cx) / fx,
                    v=(rec[p, 1] - cy) / fy, idepth=float(rec[p, 2])))
                fr._n_dead_points = getattr(fr, "_n_dead_points", 0) + 1

    def flush_active_points(self):
        """Retire all still-active window points into the global map (end
        of run; DSOViewer.h:115-152 saves active + marginalized points)."""
        mask = self.ef.pt_valid_np.copy()
        if mask.any():
            W = self.ef.W
            rec = torch.stack([W.pt_u, W.pt_v, W.idepth], dim=1).cpu().numpy()
            self._record_retired(mask, rec)

    def _dispatch_tracker_ref(self, up):
        """setCoarseTrackingRef + makeCoarseDepthL0 (CoarseTracker.cc:240-438):
        splat the window idepths into the newest keyframe's pyramid, one
        program (`tracker_ref_fused`; on the card one replay of
        TRACKER_REF_GRAPHS) on the keyframe's upload `up` (`_kf_upload`).
        Returns the (ref, shell, event) tuple without publishing it; the
        event marks the ref's completion on this thread's stream."""
        newest = len(self.window_frames) - 1
        out = _program(*self._tracker_ref_call(
            self.ef.W, up, self.window_pyrs[newest].dI))
        L = self.calib.levels
        ref = tracker.TrackerRef(points=out[:L], valid=out[L:2 * L],
                                 ref_exposure=out[2 * L],
                                 ref_aff=out[2 * L + 1])
        return ref, self.window_frames[newest], record_event(self.device)

    def _publish_tracker_ref(self, pair):
        """Publish a (ref, shell, event) tuple in one assignment, so a
        concurrent reader never sees a new ref paired with the old shell."""
        self._tracker_ref_pair = pair
        self.first_coarse_rmse = -1.0

    def _update_tracker_ref(self):
        """Dispatch and publish in one step (the synchronous path)."""
        self._publish_tracker_ref(self._dispatch_tracker_ref(
            self._kf_upload()))

    def _make_new_traces(self, pyr: FramePyramid, up):
        """makeNewTraces (:1272-1324): candidate selection per
        setting_pointSelection (0 = DSO gradient selector, 1 = LDSO
        corner-aware detector, 2 = random), hosted by the newest keyframe
        (the upload `up`'s). The arena's update is one program (on the
        card one replay of NEW_TRACES_GRAPHS); on the pure-VO path the
        detector's status map is in it too."""
        cfg = self.cfg
        H, W = self.calib.h[0], self.calib.w[0]
        dev = self.device
        if self._detector_grid() is not None:
            second = pyr.abs_grad[0]        # pure VO: the map is in it
        elif cfg.point_selection == 1:
            # the features are read on the host here, as the JAX package
            # reads them; the map's unpicked cells go to a spare cell
            feats = detector.detect_corners(
                pyr.dI[0], pyr.abs_grad[0], int(cfg.desired_immature_density),
                max_feats=self._imm_cap)
            u = torch.clamp(feats["u"].to(torch.int64), 3, W - 4)
            v = torch.clamp(feats["v"].to(torch.int64), 3, H - 4)
            cell = torch.where(feats["valid"], v * W + u,
                               torch.full_like(u, H * W))
            status = torch.zeros(H * W + 1, dtype=torch.int32, device=dev)
            status.index_fill_(0, cell, 1)
            second = status[:H * W].reshape(H, W)
        elif cfg.point_selection == 2:
            n_want = int(cfg.desired_immature_density)
            xs = self.rng.randint(20, W - 20, n_want)
            ys = self.rng.randint(20, H - 20, n_want)
            status_np = np.zeros((H, W), np.int32)
            status_np[ys, xs] = 1
            second = to_device(torch.from_numpy(status_np), dev)
        else:
            status, _ = self.selector.make_maps(pyr,
                                                cfg.desired_immature_density)
            second = status.to(torch.int32)
        self.imm_arena = _arena_of(_program(*self._candidates_call(
            self.imm_arena, pyr.dI[0], second, up)))
        self.imm_live[len(self.window_frames) - 1] = True

    def _marginalize_frame_full(self, i: int):
        """marginalizeFrame (:602-645): drop the hosted points, Schur the
        frame onto HM/bM in float64, compact the window, arena and images."""
        hosted = self.ef.pt_valid_np & (self.ef.pt_host_np == i)
        if hosted.any():
            self._count_dead(hosted)
            self.ef.pt_valid_np &= ~hosted
        self.ef.marginalize_frame(
            i, pre_drop=torch.as_tensor(hosted, device=self.device),
            prior_delta=(self._marg_priors[i], self._marg_deltas[i]))
        keep = [j for j in range(self.ef.F) if j != i] + [i]
        self._marg_priors = self._marg_priors[keep]
        self._marg_deltas = self._marg_deltas[keep]
        self.window_frames.pop(i)
        self.window_pyrs.pop(i)
        self.imm_live.pop(i)
        self.marg_flags.pop(i)
        self.imm_arena = immature.arena_marg_shift(self.imm_arena, i)
        self.dIs = self.dIs[torch.tensor(keep, device=self.device)]

    # ------------------------------------------------------------------ output
    def save_all(self, path: str):
        """Map snapshot (FullSystem::saveAll, FullSystem.cc:1872-1893).
        `.bin`/`.map` paths take the reference's byte-compatible binary
        layout (io/ldso_binary.py); anything else the richer npz snapshot
        of GlobalMap.save."""
        if path.endswith((".bin", ".map")):
            save_ldso_binary(self.global_map, path)
        else:
            self.global_map.save(path)

    def load_all(self, path: str):
        """Reload a map snapshot (FullSystem::loadAll, :1895-1918); with
        loop closing, the retrieval database is refilled from it."""
        if path.endswith((".bin", ".map")):
            self.global_map = load_ldso_binary(path)
        else:
            self.global_map = GlobalMap.load(path)
        if self.loop_closing is not None:
            self.loop_closing.global_map = self.global_map
            if self.loop_closing.vocab is not None:
                for kf in self.global_map.get_all_kfs():
                    if kf.feat_desc is not None and len(kf.feat_desc):
                        self.loop_closing._add_to_db(kf)

    def trajectory(self, keyframes_only: bool = False):
        """(timestamps, poses T_cw) of all (key)frames."""
        frames = [f for f in self.all_frames
                  if f.pose_valid and (f.is_keyframe or not keyframes_only)]
        return ([f.timestamp for f in frames], [f.T_cw.copy() for f in frames])
