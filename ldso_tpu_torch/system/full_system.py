"""FullSystem: the top-level visual-odometry orchestrator, synchronous mode.

Counterpart of ldso_tpu/system/full_system.py (reference
src/frontend/FullSystem.cc) in the reference's `linearizeOperation`
semantics: every frame is tracked, and every keyframe is mapped, before
the next frame enters.

  addActiveFrame (:68-157)  -> add_active_frame: pyramid -> init or track
  trackNewCoarse (:179-382) -> _track_new_coarse: hypothesis 0, then the
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
where there is none); `device="cpu"` runs it on the CPU. On the card the
activation gate's distance map runs the hand-written kernel of
ops/cuda_kernels.py.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ldso_tpu_torch import native
from ldso_tpu_torch.config import Config, PATTERN
from ldso_tpu_torch.camera.calib import Calibration
from ldso_tpu_torch.backend.energy_functional import (EnergyFunctional,
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
from ldso_tpu_torch.ops.preprocess import (FramePyramid, make_pyramid,
                                           to_device, upload_image)
from ldso_tpu_torch.slam_map import FrameShell, GlobalMap, MapPointRecord
from ldso_tpu_torch.utils.device import DEFAULT_DEVICE, entry_device
from ldso_tpu_torch.utils.static import nonzero_padded
from ldso_tpu_torch.utils.timing import StageTimer

RETRY_K = 8          # retry hypotheses LM-refined after the coarse ranking


def _gate_candidates(pool, KRKi, Kt, dist_map, min_act_dist: float, marg_flag,
                     w1: int, h1: int, cfg: Config):
    """Activation gating for the arena candidates (activatePointsMT
    candidate loop, FullSystem.cc:1089-1160). Returns (to_opt, remove, idm)."""
    st = pool.status
    valid = pool.valid
    id_max = pool.idepth_max
    finite_max = torch.isfinite(id_max)
    drop = valid & (~finite_max | (st == immature.IPS_OUTLIER))
    can = (valid & ~drop
           & ((st == immature.IPS_GOOD) | (st == immature.IPS_SKIPPED)
              | (st == immature.IPS_BADCONDITION) | (st == immature.IPS_OOB))
           & (pool.last_interval < 8.0)
           & (pool.quality > cfg.min_trace_quality)
           & (id_max + pool.idepth_min > 0))
    kill = valid & ~drop & ~can & (marg_flag | (st == immature.IPS_OOB))

    idm = 0.5 * (torch.where(finite_max, id_max, torch.zeros_like(id_max))
                 + pool.idepth_min)
    p = (torch.einsum("nij,nj->ni", KRKi,
                      torch.stack([pool.u, pool.v, torch.ones_like(pool.u)], -1))
         + Kt * idm[:, None])
    z_ok = p[:, 2] > 1e-6
    zs = torch.where(z_ok, p[:, 2], torch.ones_like(p[:, 2]))
    uu = p[:, 0] / zs
    vv = p[:, 1] / zs
    ui = torch.clamp((uu + 0.5).to(torch.int64), 0, w1 - 1)
    vi = torch.clamp((vv + 0.5).to(torch.int64), 0, h1 - 1)
    inb = z_ok & (ui > 0) & (vi > 0) & (ui < w1) & (vi < h1)
    kill = kill | (can & ~inb)
    can = can & inb
    dist = dist_map[vi, ui] + (uu - torch.floor(uu))
    to_opt = can & (dist >= min_act_dist * pool.my_type.to(torch.float32))
    return to_opt, drop | kill, idm


def _gate_candidates_fused(W: Window, newest: int, arena, KRKis, Kts,
                           min_act_dist: float, marg_flags, cfg: Config,
                           w1: int, h1: int):
    """Occupancy splat of the active points' projections into the newest
    keyframe + chamfer distance map + candidate gating."""
    dev = KRKis.device
    cp = W.center_proj[:, newest]
    ok = (W.pt_valid & W.res_exist[:, newest]
          & torch.isfinite(cp[:, 0]) & (cp[:, 2] > 0))
    uu = (0.5 * cp[:, 0] - 0.25 + 0.5).to(torch.int64)
    vv = (0.5 * cp[:, 1] - 0.25 + 0.5).to(torch.int64)
    inb = ok & (uu > 0) & (vv > 0) & (uu < w1) & (vv < h1)
    occ = torch.zeros(h1 * w1, dtype=torch.bool, device=dev)
    occ[(vv * w1 + uu)[inb]] = True       # mask first: no "drop" scatter
    occ = occ.reshape(h1, w1)
    # distances >= 17 are decision-equivalent for the default gates, so
    # cfg.dist_map_steps (18) sweeps give the reference's 40-sweep gating
    dist_map = cuda_kernels.distance_transform(occ, cfg.dist_map_steps)
    h = torch.clamp(arena.host, 0, KRKis.shape[0] - 1).long()
    pool = arena.pool._replace(valid=arena.pool.valid & (arena.host >= 0))
    return _gate_candidates(pool, KRKis[h], Kts[h], dist_map, min_act_dist,
                            marg_flags[h], w1, h1, cfg)


def _flag_removal(W: Window, marg_frame_targets, host_flagged, newest: int,
                  prev: int):
    """flagPointsForRemoval decision logic (FullSystem.cc:1208-1270).
    Returns (drop, marg_cand) bool masks."""
    nres = torch.sum(W.res_exist, dim=1)
    vis_in_marg = torch.sum(W.res_exist & (W.res_state == RES_IN)
                            & marg_frame_targets[None, :], dim=1)
    last0 = W.res_state[:, newest]
    last0_exist = W.res_exist[:, newest]
    prev_c = max(prev, 0)
    last1 = W.res_state[:, prev_c]
    last1_exist = W.res_exist[:, prev_c] & (prev >= 0)

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


def _tensors(tree):
    """The tensors of a NamedTuple/tuple tree (a pyramid, a tracker ref)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)


def record_event(device) -> Optional[torch.cuda.Event]:
    """An event recorded on `device`'s current stream (None on the CPU)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


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


class HostCopy:
    """A device result on its way to the host: copied with non_blocking=True
    into pinned memory and an event recorded after the copy. `is_ready()`
    queries the event; `numpy()` waits on it. On the CPU both are
    immediate."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = record_event(t.device)
        else:
            self._host = t
            self._event = None

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


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

    def _frame_step_chain(self, img, ref, T0, aff0, exposure: float):
        """The chain step: pyramid + tracking of hypothesis 0, no trace (the
        mapping side owns the candidate arena). The packed layout is the
        JAX package's: T (16), aff (2), ok, a zero trace flag, the L level
        residuals, the 3 flow values."""
        nlv = self.calib.levels
        pyr = make_pyramid(img, nlv, self.b_grad)
        no_abort = torch.full((nlv,), 1e9, dtype=torch.float32,
                              device=self.device)
        T, aff, ok, res, flow = tracker.track_frame(
            ref, pyr, T0, aff0, self._f32(exposure), no_abort, self.calib,
            self.cfg, nlv - 1)
        packed = torch.cat([T.reshape(-1), aff, ok.to(torch.float32)[None],
                            torch.zeros(1, device=self.device), res, flow])
        return pyr, packed

    def track_chain_dispatch(self, shell: FrameShell, image):
        """Track a frame from the chain's motion hypothesis and advance the
        chain on the device. Returns (pyr, packed result as a HostCopy,
        ref_shell used). Nothing here waits for the card: the uploads go
        through pinned memory and the tracker is one graph replay, so the
        call returns before the frame is tracked, and the HostCopy turns
        ready once it is (the JAX package's dispatch, pipeline.py:95-98)."""
        ref, ref_shell = self._current_tracker_ref()
        T_ref = self._f32(ref_shell.T_cw)
        T0, aff0, _ = _chain_prep(self.track_chain, T_ref)
        pyr, packed = self._frame_step_chain(upload_image(image, self.device),
                                             ref, T0, aff0, shell.exposure)
        self.track_chain = _chain_update(self.track_chain, packed, T0, T_ref)
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
        """Build what a run would otherwise first build mid-run: K1's
        library (compiled from source on first use), the tracker's CUDA
        graphs for one frame and for the retry batch (frontend/track_graph,
        captured on placeholder inputs of this system's shapes) and, with
        loop closing, the native host library. The constructor calls it on
        the card; repeat calls are free."""
        if self._retrack_warm:
            return
        if self.device.type == "cuda":
            cuda_kernels._load()
            self._capture_tracker()
        if self.loop_closing is not None:
            native.get_lib()
        self._retrack_warm = True

    def _capture_tracker(self):
        """Track placeholder inputs of this system's shapes at batch 1 and
        RETRY_K, so both tracker graphs exist before the first frame."""
        calib, dev = self.calib, self.device
        caps = self.cfg.tracker_caps[:calib.levels]
        f32 = dict(dtype=torch.float32, device=dev)
        ref = tracker.TrackerRef(
            points=tuple(torch.zeros(c, 4, **f32) for c in caps),
            valid=tuple(torch.zeros(c, dtype=torch.bool, device=dev)
                        for c in caps),
            ref_exposure=torch.ones((), **f32), ref_aff=torch.zeros(2, **f32))
        pyr = FramePyramid(dI=tuple(torch.zeros(calib.h[lvl], calib.w[lvl], 3,
                                                **f32)
                                    for lvl in range(calib.levels)),
                           abs_grad=())
        for batch in (1, RETRY_K):
            tracker.track_frame_hypotheses(
                ref, pyr, torch.eye(4, **f32).expand(batch, 4, 4),
                torch.zeros(2, **f32), torch.ones((), **f32),
                torch.full((calib.levels,), 1e9, **f32), calib, self.cfg,
                calib.levels - 1)

    # ---------------------------------------------------------------- tracking
    def _frame_step(self, img, ref, T0, aff0, exposure: float, T_ref_cw,
                    commit_trace: bool = True):
        """Pyramid + tracking of hypothesis 0 + the candidate trace against
        the new frame when tracking clears the retrack gate and
        commit_trace is set (the JAX package's fused `_frame_step`)."""
        cfg, calib = self.cfg, self.calib
        dev = self.device
        nlv = calib.levels
        pyr = make_pyramid(upload_image(img, dev), nlv, self.b_grad)
        no_abort = torch.full((nlv,), 1e9, dtype=torch.float32, device=dev)
        T, aff, ok, res, flow = tracker.track_frame(
            ref, pyr, T0, aff0, self._f32(exposure), no_abort, calib, cfg,
            nlv - 1)
        out = torch.cat([T.reshape(-1), aff, ok.to(torch.float32)[None], res,
                         flow]).cpu().numpy()
        T_np, aff_np, ok_np = out[:16].reshape(4, 4), out[16:18], out[18] > 0.5
        res_np, flow_np = out[19:19 + nlv], out[19 + nlv:22 + nlv]
        # the gate in float32, as the fused JAX program evaluates it
        last0 = np.float32(self.last_coarse_rmse[0])
        accept = commit_trace and bool(ok_np and np.isfinite(res_np[0]) and (
            not np.isfinite(last0)
            or res_np[0] < last0 * np.float32(cfg.re_track_threshold)))
        if accept:
            F = self.ef.F
            T_hosts = np.tile(np.eye(4), (F, 1, 1))
            host_affs = np.zeros((F, 2))
            host_expos = np.ones(F)
            for i, fr in enumerate(self.window_frames):
                T_hosts[i] = fr.T_cw
                host_affs[i] = fr.aff
                host_expos[i] = fr.exposure or 1.0
            K = torch.tensor(calib.K(0), dtype=torch.float32, device=dev)
            Ki = torch.linalg.inv(K)
            T_new_cw = T @ self._f32(T_ref_cw)
            T_rel = torch.einsum("ij,fjk->fik", T_new_cw,
                                 torch.linalg.inv(self._f32(T_hosts)))
            KRKis = torch.einsum("ij,fjk,kl->fil", K, T_rel[:, :3, :3], Ki)
            Kts = torch.einsum("ij,fj->fi", K, T_rel[:, :3, 3])
            ha = self._f32(host_affs)
            ra = torch.exp(aff[0] - ha[:, 0]) * float(np.float32(exposure)) \
                / self._f32(host_expos)
            affs = torch.stack([ra, aff[1] - ra * ha[:, 1]], dim=-1)
            self._trace_arena(pyr, KRKis, Kts, affs)
        return pyr, T_np, aff_np, ok_np, res_np, flow_np, accept

    def _trace_arena(self, pyr, KRKis, Kts, affs):
        """Trace the live prefix of the candidate arena (lanes past the
        watermark are dead, and trace leaves dead lanes untouched)."""
        n = immature.arena_watermark(self.imm_arena)
        if n > 0:
            self.imm_arena = immature.trace_arena_prefix(
                self.imm_arena, pyr.dI[0], KRKis, Kts, affs, self.calib,
                self.cfg, n)

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
        aff0 = self._f32(aff_last)

        pyr, T, aff, ok, res, flow, accepted = self._frame_step(
            img, tracker_ref, self._f32(tries[0]), aff0, shell.exposure,
            ref_shell.T_cw, commit_trace)
        self._frame_pyr = pyr
        self._traced_this_frame = accepted
        res = res.astype(np.float64)
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
            nlv = calib.levels
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
        imm_counts = immature.arena_counts(self.imm_arena, self.ef.F).cpu().numpy()
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
        depth-only LM, point insertion, candidate cleanup. The reference's
        greedy incremental map update is a single-pass test against the
        initial map (the JAX package's documented deviation)."""
        cfg, calib = self.cfg, self.calib
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

        nf = len(self.window_frames)
        newest = nf - 1
        w1, h1 = calib.w[1], calib.h[1]
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

        n = immature.arena_watermark(self.imm_arena)
        if n == 0:
            return
        full = self.imm_arena
        arena = immature.ImmatureArena(
            pool=immature.ImmaturePool(*[x[:n] for x in full.pool]),
            host=full.host[:n])
        W = self.ef.W
        dev = self.device
        to_opt, remove, idm = _gate_candidates_fused(
            W, newest, arena, self._f32(KRKis), self._f32(Kts),
            self.current_min_act_dist,
            torch.as_tensor(marg_flags, device=dev), cfg, w1, h1)
        hostc = arena.host
        to_opt = to_opt & (hostc >= 0) & (hostc < nf) & (hostc != newest)
        remove = remove & (hostc >= 0) & (hostc < nf)

        act = immature.activate_arena(
            arena, idm, to_opt, self._f32(Rs), self._f32(ts), self._f32(affs_a),
            torch.as_tensor(masks, device=dev), self.dIs, calib, cfg)
        new_id = act[:, 0]
        okn = (act[:, 1] > 0.5) & to_opt & (act[:, 2] >= 1)

        # k-th ok candidate -> k-th free point slot; overflow drops
        P = W.P
        free = nonzero_padded(~W.pt_valid, n, P)
        rank = torch.cumsum(okn.to(torch.int64), 0) - 1
        slot = torch.where(okn, free[torch.clamp(rank, 0, n - 1)],
                           torch.full_like(rank, P))
        pl = arena.pool
        self.ef.W = insert_points_dev(
            W, slot, okn, torch.clamp(hostc, min=0), pl.u, pl.v, new_id,
            torch.zeros_like(new_id), pl.energy_th, pl.color, pl.weights)
        remove = remove | to_opt
        valid = full.pool.valid.clone()
        valid[:n] = arena.pool.valid & ~remove
        self.imm_arena = full._replace(pool=full.pool._replace(valid=valid))

        # host mirrors + per-frame dead-candidate counters
        slot_np = slot.cpu().numpy()
        host_np = hostc.cpu().numpy().astype(np.int64)
        ok_np = okn.cpu().numpy()
        rm_np = remove.cpu().numpy()
        ins = ok_np & (slot_np < self.ef.P)
        self.ef.pt_valid_np[slot_np[ins]] = True
        self.ef.pt_host_np[slot_np[ins]] = host_np[ins]
        for i, n_rm in zip(*np.unique(host_np[rm_np], return_counts=True)):
            if 0 <= i < nf and self.imm_live[i]:
                fr = self.window_frames[i]
                fr._n_dead_points = getattr(fr, "_n_dead_points", 0) + int(n_rm)

    def _post_ba(self):
        """Drop zero-residual points (removeOutliers, FullSystem.cc:1402-1420)
        and decide point removal/marginalization (flagPointsForRemoval), on
        the device. Returns (the window's poses, affines, dropped dead
        points, marg priors and deltas as device tensors for finish to read,
        drop_dev, marg_dev)."""
        W = self.ef.W
        F = self.ef.F
        nf = len(self.window_frames)
        dev = self.device
        nres = torch.sum(W.res_exist, dim=1)
        dead = W.pt_valid & (nres == 0)
        W = W._replace(pt_valid=W.pt_valid & ~dead,
                       res_exist=W.res_exist & ~dead[:, None],
                       res_active=W.res_active & ~dead[:, None])
        flags = torch.as_tensor(np.concatenate(
            [np.asarray(self.marg_flags, bool), np.zeros(F - nf, bool)]),
            device=dev)
        host_flagged = flags[torch.clamp(W.pt_host, max=F - 1)]
        drop, marg = _flag_removal(W, flags, host_flagged, nf - 1, nf - 2)
        self.ef.W = W
        state = (current_poses(W), aff_g2l(W), dead, W.prior, W.state[:, :8])
        return state, drop, marg

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

        with self.timer.stage("kf.ba"):
            rmse = self.ef.optimize(self.dIs, cfg.max_opt_iterations,
                                    calib.w[0], calib.h[0])
        with self.timer.stage("kf.post_ba"):
            post, drop_dev, marg_dev = self._post_ba()
        with self.timer.stage("kf.tracker_ref"):
            pending_ref = self._dispatch_tracker_ref()
            self._publish_tracker_ref(pending_ref)
        with self.timer.stage("kf.marg_points"):
            marg = self.ef.marginalize_and_drop_dispatch(
                marg_dev, drop_dev, self.dIs, calib.w[0], calib.h[0])
        landed = record_event(self.device)
        with self.timer.stage("kf.new_traces"):
            self._make_new_traces(pyr, idx)

        def finish():
            self.is_lost = self.is_lost or self.ef.is_lost
            num_kfs = self.global_map.num_frames() + 1
            if num_kfs <= 4:
                if ((num_kfs == 2 and rmse > 20) or (num_kfs == 3 and rmse > 13)
                        or (num_kfs == 4 and rmse > 9)):
                    self.init_failed = True
            if self.is_lost:
                return
            T, A, dead, priors, deltas = (t.cpu().numpy() for t in post)
            self._marg_priors = priors.astype(np.float64)
            self._marg_deltas = deltas.astype(np.float64)
            rec, really_marg, dropped = self.ef.marginalize_and_drop_consume(
                marg)
            if dead.any():
                self._count_dead(dead)
                self.ef.pt_valid_np &= ~dead
            for i, sh in enumerate(self.window_frames):
                sh.T_cw = T[i].astype(np.float64)
                sh.aff = A[i].astype(np.float64)
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
            if self.loop_closing is not None:
                with self.timer.stage("kf.loop"):
                    self._loop_closing_step(shell, pyr)

        def ready() -> bool:
            """Whether the point-marginalization result, the last device
            result finish() reads, is in (an event query; always on the
            CPU)."""
            return landed is None or landed.query()

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

    def _dispatch_tracker_ref(self):
        """setCoarseTrackingRef + makeCoarseDepthL0 (CoarseTracker.cc:240-438):
        splat the window idepths into the newest keyframe's pyramid. Returns
        the (ref, shell, event) tuple without publishing it; the event marks
        the ref's completion on this thread's stream."""
        W = self.ef.W
        newest = len(self.window_frames) - 1
        shell = self.window_frames[newest]
        cp = W.center_proj[:, newest]
        valid = (W.pt_valid & W.res_exist[:, newest]
                 & (W.res_state[:, newest] == RES_IN))
        hdif = 1.0 / torch.clamp(W.pt_idepth_hessian, min=1e-12)
        weight = torch.sqrt(1e-3 / (hdif + 1e-12))
        ref = tracker.make_tracker_ref(
            cp[:, 0], cp[:, 1], cp[:, 2], weight, valid,
            self.window_pyrs[newest].dI, float(np.float32(shell.exposure)),
            aff_g2l(W)[newest], self.calib,
            self.cfg.tracker_caps[:self.calib.levels])
        return ref, shell, record_event(self.device)

    def _publish_tracker_ref(self, pair):
        """Publish a (ref, shell, event) tuple in one assignment, so a
        concurrent reader never sees a new ref paired with the old shell."""
        self._tracker_ref_pair = pair
        self.first_coarse_rmse = -1.0

    def _update_tracker_ref(self):
        """Dispatch and publish in one step (the synchronous path)."""
        self._publish_tracker_ref(self._dispatch_tracker_ref())

    def _make_new_traces(self, pyr: FramePyramid, idx: int):
        """makeNewTraces (:1272-1324): candidate selection per
        setting_pointSelection (0 = DSO gradient selector, 1 = LDSO
        corner-aware detector, 2 = random)."""
        cfg = self.cfg
        H, W = self.calib.h[0], self.calib.w[0]
        dev = self.device
        if cfg.point_selection == 1 and self.loop_closing is None:
            # pure VO: no host-side features needed, one device status map
            gp = detector.detect_grid_params(
                H, W, int(cfg.desired_immature_density))
            status = detector.detect_status_map(pyr.dI[0], pyr.abs_grad[0],
                                                *gp)
        elif cfg.point_selection == 1:
            feats = detector.detect_corners(
                pyr.dI[0], pyr.abs_grad[0], int(cfg.desired_immature_density),
                max_feats=self._imm_cap)
            valid = feats["valid"]
            u = torch.clamp(feats["u"][valid].to(torch.int64), 3, W - 4)
            v = torch.clamp(feats["v"][valid].to(torch.int64), 3, H - 4)
            status = torch.zeros(H * W, dtype=torch.int32, device=dev)
            status[v * W + u] = 1
            status = status.reshape(H, W)
        elif cfg.point_selection == 2:
            n_want = int(cfg.desired_immature_density)
            xs = self.rng.randint(20, W - 20, n_want)
            ys = self.rng.randint(20, H - 20, n_want)
            status_np = np.zeros((H, W), np.int32)
            status_np[ys, xs] = 1
            status = torch.as_tensor(status_np, device=dev)
        else:
            status, _ = self.selector.make_maps(pyr,
                                                cfg.desired_immature_density)
        self.imm_arena = immature.arena_compact(self.imm_arena)
        self.imm_arena = immature.arena_add_from_status(
            self.imm_arena, status, pyr.dI[0], idx, self._imm_cap, cfg)
        self.imm_live[idx] = True

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
