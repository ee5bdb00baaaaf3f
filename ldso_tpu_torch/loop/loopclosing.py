"""Loop detection + correction orchestrator.

Counterpart of ldso_tpu/loop/loopclosing.py (reference LoopClosing,
src/frontend/LoopClosing.cc; SURVEY.md §2 C26, §3.4). Per new keyframe:
BoW transform, database query with a kfGap exclusion window and the
score-as-add-policy gate, then the reference's correction pipeline:
  1. SearchByBoW node-bucketed descriptor matching (FeatureMatcher.cc:66)
  2. PnP-RANSAC on candidate 3D (from feature invD) vs current 2D,
     seeding a scale-1 Sim(3) (LoopClosing.cc:202-240)
  3. ComputeOptimizedPose re-matching: candidate features projected
     through the seed into the current image, window descriptor re-match
     gated by the current idepths (LoopClosing.cc:271-405)
  4. Sim(3) GN with 3D-3D + 2D reprojection edges, inlier gating, a second
     pass, scale sanity check (LoopClosing.cc:415-496)
  5. a loop `poseRel` edge with its 7x7 GN information + a pose-graph run
As in the JAX package, a failed PnP seed falls back to Umeyama RANSAC on
mutual-depth 3D-3D matches (PARITY.md).

The orchestration is host code; features, PnP, Umeyama and the Sim(3)
refinement run in float32 on `device` (the casts of the JAX module), and
so does the pose graph (posegraph.run_pose_graph, as the JAX package's CLI
runs it). RANSAC hypotheses come from one torch.Generator on
the device seeded with cfg.seed, in place of the JAX module's PRNG key.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.spatial import cKDTree

from ldso_tpu_torch.config import Config
from ldso_tpu_torch.camera.calib import Calibration
from ldso_tpu_torch.frontend import detector
from ldso_tpu_torch.loop import matcher, posegraph
from ldso_tpu_torch.loop.database import KeyframeDatabase
from ldso_tpu_torch.loop.pnp import pnp_ransac
from ldso_tpu_torch.loop.sim3_solver import refine_sim3, umeyama_ransac
from ldso_tpu_torch.loop.vocab import Vocabulary
from ldso_tpu_torch.slam_map import FrameShell, GlobalMap
from ldso_tpu_torch.utils.device import DEFAULT_DEVICE, entry_device

MIN_BOW_MATCHES = 10    # nmatches gates (LoopClosing.cc:163,197,407)
MIN_PNP_INLIERS = 10    # cntInliers < 10 (LoopClosing.cc:226)
MIN_SIM3_INLIERS = 15   # inliers < 15 (LoopClosing.cc:479)
VOCAB_MIN_TRAIN_KFS = 8
FEAT_DEPTH_RADIUS = 1.5  # px: the reference's 1-px-dilated idepth map


class LoopClosing:
    def __init__(self, calib: Calibration, cfg: Config, global_map: GlobalMap,
                 vocab: Optional[Vocabulary] = None,
                 device=DEFAULT_DEVICE):
        self.calib = calib
        self.cfg = cfg
        self.global_map = global_map
        self.vocab = vocab
        self.device = entry_device(device)
        self.db: Optional[KeyframeDatabase] = (
            KeyframeDatabase(vocab) if vocab is not None else None)
        self._pending_train: list = []
        self.generator = torch.Generator(self.device)
        self.generator.manual_seed(cfg.seed)
        self.n_loops_closed = 0
        self.loop_pairs: list = []      # (kf_id, candidate_kf_id) per close
        self._db_order: list = []       # kf ids in database-insertion order
        self._db_ids: set = set()
        self.need_pose_graph = False

    def _K(self):
        c = self.calib
        return c.fx[0], c.fy[0], c.cx[0], c.cy[0]

    def _f32(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ---------------------------------------------------------------- records
    def make_kf_record(self, kf: FrameShell, pyr, point_uv_idepth):
        """Detect ORB features on the keyframe and attach inverse depths
        from the window's active points within 1.5 px (the reference's
        features carry invD from point activation, Feature.h:77-93; the
        radius mirrors ComputeOptimizedPose's 1-px-dilated idepth map,
        LoopClosing.cc:277-318)."""
        feats = detector.detect_corners(pyr.dI[0], pyr.abs_grad[0],
                                        int(self.cfg.desired_immature_density))
        sel = torch.nonzero(feats["valid"] & feats["is_corner"])[:, 0]
        uv = torch.stack([feats["u"][sel], feats["v"][sel]], 1)
        kf.feat_uv = uv.cpu().numpy()
        kf.feat_desc = detector.desc_to_numpy(feats["desc"][sel])
        kf.feat_angle = feats["angle"][sel].cpu().numpy().astype(np.float32)
        kf.feat_idepth = np.full(len(sel), -1.0, np.float32)
        if point_uv_idepth is not None and len(point_uv_idepth) and len(sel):
            d, j = cKDTree(point_uv_idepth[:, :2]).query(
                kf.feat_uv, distance_upper_bound=FEAT_DEPTH_RADIUS)
            found = np.isfinite(d)
            kf.feat_idepth[found] = point_uv_idepth[j[found], 2]

    def _refresh_feat_depths(self, sh: FrameShell):
        """Attach depths to features that lacked one at record time from
        the keyframe's since-matured map points (the reference's
        Feature.invD fills at point activation over the keyframe's life,
        Feature.h:77-93)."""
        if (sh.feat_uv is None or sh.feat_idepth is None
                or not sh.map_points):
            return
        if getattr(sh, "_feat_depth_mp_n", -1) == len(sh.map_points):
            return
        sh._feat_depth_mp_n = len(sh.map_points)
        need = sh.feat_idepth <= 0
        if not need.any():
            return
        fx, fy, cx, cy = self._K()
        pid = np.asarray([p.idepth for p in sh.map_points], np.float32)
        pu = np.asarray([p.u for p in sh.map_points], np.float32) * fx + cx
        pv = np.asarray([p.v for p in sh.map_points], np.float32) * fy + cy
        ok = pid > 0
        if not ok.any():
            return
        d, j = cKDTree(np.stack([pu[ok], pv[ok]], 1)).query(
            sh.feat_uv[need], distance_upper_bound=FEAT_DEPTH_RADIUS)
        found = np.isfinite(d)
        sh.feat_idepth[np.nonzero(need)[0][found]] = pid[ok][j[found]]

    def _ensure_vocab(self, kf: FrameShell):
        if self.vocab is not None:
            return True
        if kf.feat_desc is not None and len(kf.feat_desc):
            self._pending_train.append(kf.feat_desc)
        if len(self._pending_train) >= VOCAB_MIN_TRAIN_KFS:
            corpus = np.concatenate(self._pending_train, axis=0)
            self.vocab = Vocabulary.train(corpus, k=8, L=3, seed=self.cfg.seed)
            self.db = KeyframeDatabase(self.vocab)
            for old in self.global_map.get_all_kfs():      # backfill
                if old.feat_desc is not None and len(old.feat_desc):
                    self._add_to_db(old)
            return True
        return False

    def _compute_bow(self, kf: FrameShell):
        """ComputeBoW (Frame.cc:88-102): word ids for scoring + the
        FeatureVector node ids (levelsup=4) SearchByBoW buckets by."""
        wids = self.vocab.transform(kf.feat_desc,
                                    np.ones(len(kf.feat_desc), bool))
        kf.feat_word = np.asarray(wids, np.int32)
        kf.feat_node = self.vocab.node_ids(kf.feat_word, levelsup=4)
        kf.bow_vector = self.vocab.bow_vector(wids)

    def _add_to_db(self, kf: FrameShell):
        if kf.bow_vector is None:
            self._compute_bow(kf)
        if kf.kf_id in self._db_ids:
            return
        self.db.add(kf.kf_id, kf.bow_vector)
        self._db_order.append(kf.kf_id)
        self._db_ids.add(kf.kf_id)

    # ------------------------------------------------------------------ main
    def insert_keyframe(self, kf: FrameShell, window_kf_ids) -> bool:
        """Process one new keyframe; True if a loop was closed
        (LoopClosing::Run + DetectLoop + CorrectLoop, :38-269)."""
        if kf.feat_desc is None or len(kf.feat_desc) < 10:
            return False
        if not self._ensure_vocab(kf):
            return False
        if kf.bow_vector is None:
            self._compute_bow(kf)
        cand = self._detect_loop(kf, window_kf_ids)
        if cand is None:
            return False
        ok = self._correct_loop(kf, cand)
        if ok:
            self.n_loops_closed += 1
            self.need_pose_graph = True
            self.loop_pairs.append((kf.kf_id, cand.kf_id))
            # the reference's "Loop detected from kf X to Y" line
            print(f"loop closed: kf {kf.kf_id} -> {cand.kf_id}", flush=True)
        return ok

    def run_pose_graph_if_needed(self):
        if self.need_pose_graph:
            posegraph.run_pose_graph(self.global_map, device=self.device)
            self.need_pose_graph = False
            return True
        return False

    def _detect_loop(self, kf: FrameShell, window_kf_ids) -> Optional[FrameShell]:
        """DetectLoop (:95-143): the query excludes the last kfGap
        database entries; a candidate inside the kf-id range of the
        keyframe's covisibility-connected frames is rejected (and the frame
        stays out of the database); the score threshold only decides
        whether the frame enters the database."""
        cfg = self.cfg
        exclude = (set(self._db_order[-cfg.loop_kf_gap:]) if cfg.loop_kf_gap
                   else set())
        exclude.add(kf.kf_id)
        results = self.db.query(kf.bow_vector, exclude)
        if not results:
            self._add_to_db(kf)
            return None
        best_id, best_score = results[0]
        cand = self.global_map.keyframes.get(best_id)
        connected = set(window_kf_ids) | set(kf.pose_rel.keys())
        connected.discard(kf.kf_id)
        if connected and min(connected) <= best_id <= max(connected):
            return None
        if best_score < cfg.loop_score_th:
            self._add_to_db(kf)
        return cand

    def _backproject(self, uv, idepth):
        fx, fy, cx, cy = self._K()
        z = 1.0 / np.maximum(idepth, 1e-6)
        return np.stack([(uv[:, 0] - cx) / fx * z,
                         (uv[:, 1] - cy) / fy * z, z], 1)

    def _seed_pnp(self, kf: FrameShell, cand: FrameShell, mi, mj):
        """PnP-RANSAC seed from candidate 3D (feature invD backprojection,
        LoopClosing.cc:185-189) vs current 2D pixels (:202-229), 8 px
        inlier radius as cv::solvePnPRansac(..., 8.0, ...) (:209). Returns a
        scale-1 Sim(3) (cand cam -> cur cam, :235-240) or None."""
        has3d = cand.feat_idepth[mj] > 0
        if has3d.sum() < MIN_PNP_INLIERS:
            return None
        X = self._backproject(cand.feat_uv[mj], cand.feat_idepth[mj])
        T, _, n_inl = pnp_ransac(self._f32(X), self._f32(kf.feat_uv[mi]),
                                 torch.as_tensor(has3d, device=self.device),
                                 self._K(), self.generator, inlier_px=8.0)
        if int(n_inl) < MIN_PNP_INLIERS:
            return None
        S = T.cpu().numpy().astype(np.float64)
        return S if np.isfinite(S).all() else None

    def _seed_umeyama(self, kf: FrameShell, cand: FrameShell, mi, mj):
        """Fallback seed: Umeyama RANSAC on mutual-depth 3D-3D matches (a
        deviation from the reference, which fails the candidate: both
        frames carry inverse depths in LDSO, so 3D-3D alignment observes
        scale directly)."""
        id_cur = kf.feat_idepth[mi]
        id_cand = cand.feat_idepth[mj]
        has3d = (id_cur > 0) & (id_cand > 0)
        if has3d.sum() < MIN_PNP_INLIERS:
            return None
        S0, _, n_inl = umeyama_ransac(
            self._f32(self._backproject(cand.feat_uv[mj], id_cand)),
            self._f32(self._backproject(kf.feat_uv[mi], id_cur)),
            torch.as_tensor(has3d, device=self.device), self.generator)
        if int(n_inl) < MIN_PNP_INLIERS:
            return None
        S = S0.cpu().numpy().astype(np.float64)
        return S if np.isfinite(S).all() else None

    def _correct_loop(self, kf: FrameShell, cand: FrameShell) -> bool:
        """SearchByBoW -> PnP seed -> projection re-match -> Sim3 GN ->
        install the poseRel edge (CorrectLoop + ComputeOptimizedPose,
        LoopClosing.cc:145-496)."""
        K = self._K()
        self._refresh_feat_depths(cand)
        for sh in (kf, cand):
            if sh.feat_angle is None and sh.feat_uv is not None:
                sh.feat_angle = np.zeros(len(sh.feat_uv), np.float32)

        # 1. node-bucketed descriptor matching (nnRatio 0.75, :148)
        match = matcher.search_by_bow(kf.feat_desc, kf.feat_node,
                                      cand.feat_desc, cand.feat_node)
        mi = np.nonzero(match >= 0)[0]
        if len(mi) < MIN_BOW_MATCHES:                 # nmatches < 10 (:163)
            return False
        mj = match[mi]

        # 2. seed Sim(3): PnP-RANSAC first (reference), 3D-3D fallback
        S0 = self._seed_pnp(kf, cand, mi, mj)
        if S0 is None:
            S0 = self._seed_umeyama(kf, cand, mi, mj)
        if S0 is None:
            return False

        # 3. ComputeOptimizedPose re-matching (:271-405)
        ci = np.nonzero(cand.feat_idepth > 0)[0]
        if len(ci) == 0:
            return False
        P_ref = self._backproject(cand.feat_uv[ci], cand.feat_idepth[ci])
        pmatch = matcher.search_by_projection(
            P_ref, cand.feat_desc[ci], cand.feat_angle[ci], S0,
            kf.feat_uv, kf.feat_desc, kf.feat_angle, kf.feat_idepth, K,
            window_size=5.0)
        pm = pmatch >= 0
        if pm.sum() < MIN_BOW_MATCHES:                # nmatches < 10 (:407)
            return False
        j = pmatch[pm]
        P_ref_m = self._f32(P_ref[pm])                # candidate frame 3D
        uv_m = self._f32(kf.feat_uv[j])               # current pixels
        P_cur_m = self._f32(self._backproject(kf.feat_uv[j],
                                              kf.feat_idepth[j]))

        # 4. Sim(3) GN with a 3D-3D and a 2D edge per match, Huber, 10
        #    iterations; gate 3D inliers >= 15; 10 more on the inliers
        #    (LoopClosing.cc:415-489)
        m = torch.ones(int(pm.sum()), dtype=torch.float32, device=self.device)
        S1, _, _, inl3d = refine_sim3(self._f32(S0), P_ref_m, uv_m, m,
                                      P_ref_m, P_cur_m, m, K, iterations=10)
        if int(inl3d.sum()) < MIN_SIM3_INLIERS:       # inliers < 15 (:479)
            return False
        m2 = m * inl3d.to(torch.float32)
        S, H, _, _ = refine_sim3(S1, P_ref_m, uv_m, m2, P_ref_m, P_cur_m, m2,
                                 K, iterations=10)
        S_cur_cand = S.cpu().numpy().astype(np.float64)  # cand cam -> cur
        # scale sanity (LoopClosing.cc:488): nan / negative => failed
        s = float(np.cbrt(np.linalg.det(S_cur_cand[:3, :3])))
        if not np.isfinite(s) or s <= 0 or not np.isfinite(S_cur_cand).all():
            return False
        info = H.cpu().numpy().astype(np.float64)
        info = 0.5 * (info + info.T)
        # pose_rel holds S_this_other = S_cur_cand
        kf.add_pose_rel(cand.kf_id, S_cur_cand, info=info, is_loop=True)
        return True
