"""Public map data model + global map.

Rebuild of the reference's public layer (src/Frame.cc, src/Point.cc,
src/Map.cc; SURVEY.md §2 C4-C6, C27): host-side records that outlive the
optimization window. The optimization-side state (the reference's
FrameHessian / PointHessian internals) lives in the device Window; a
FrameShell here is what remains after marginalization — exactly the
reference's dual data model (include/Frame.h:24-46).

Poses:
  * T_cw: SE(3) worldToCam from odometry (the reference's Tcw)
  * S_cw: Sim(3) worldToCam after pose-graph optimization (TcwOpti)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class MapPointRecord:
    """A retired (marginalized) map point: world position support.
    (reference Point: computed from host Sim3 pose x inverse depth,
    src/Point.cc:34-45)."""
    host_kf_id: int
    u: float
    v: float
    idepth: float


@dataclasses.dataclass
class FrameShell:
    """Host record of a frame (reference Frame, include/Frame.h)."""
    id: int
    timestamp: float = 0.0
    T_cw: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))
    aff: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2))
    exposure: float = 1.0
    pose_valid: bool = True
    is_keyframe: bool = False
    kf_id: int = -1
    # Sim(3) pose after loop closing (TcwOpti); starts as the SE3 pose
    S_cw: Optional[np.ndarray] = None
    # relative Sim(3) edges: kf_id -> (S_this_other 4x4, info 7x7, is_loop)
    pose_rel: Dict[int, Tuple[np.ndarray, np.ndarray, bool]] = \
        dataclasses.field(default_factory=dict)
    # retired map points hosted by this KF (filled at marginalization)
    map_points: List[MapPointRecord] = dataclasses.field(default_factory=list)
    # ORB features for loop closing (filled on keyframes when enabled)
    feat_uv: Optional[np.ndarray] = None       # (N,2)
    feat_desc: Optional[np.ndarray] = None     # (N,32) uint8
    feat_idepth: Optional[np.ndarray] = None   # (N,) -1 if unknown
    feat_angle: Optional[np.ndarray] = None    # (N,) IC_Angle orientation
    feat_word: Optional[np.ndarray] = None     # (N,) BoW word ids
    feat_node: Optional[np.ndarray] = None     # (N,) FeatureVector node ids
    bow_vector: Optional[dict] = None

    def get_S_cw(self) -> np.ndarray:
        return self.S_cw if self.S_cw is not None else self.T_cw.copy()

    def add_pose_rel(self, other_kf_id: int, S_rel: np.ndarray,
                     info: Optional[np.ndarray] = None, is_loop: bool = False):
        if info is None:
            info = np.eye(7)
        self.pose_rel[other_kf_id] = (S_rel, info, is_loop)


class GlobalMap:
    """Keyframe set + Sim(3) pose-graph edges (reference Map, src/Map.cc)."""

    def __init__(self):
        self.keyframes: Dict[int, FrameShell] = {}
        self.latest_optimized_kf_id: int = -1

    # ------------------------------------------------------------- save/load
    def save(self, path: str):
        """Map snapshot (FullSystem::saveAll, FullSystem.cc:1872-1893 +
        Frame::save, src/Frame.cc:121-160): keyframes with poses, features
        (uv/idepth/descriptor), retired points, and poseRel edges — as npz."""
        blobs = {"latest_optimized": np.array(self.latest_optimized_kf_id)}
        ids = sorted(self.keyframes)
        blobs["kf_ids"] = np.array(ids, np.int64)
        for k in ids:
            kf = self.keyframes[k]
            p = f"kf{k}_"
            blobs[p + "meta"] = np.array([kf.id, kf.timestamp, kf.exposure])
            blobs[p + "T_cw"] = kf.T_cw
            blobs[p + "S_cw"] = kf.get_S_cw()
            blobs[p + "aff"] = kf.aff
            if kf.feat_uv is not None:
                blobs[p + "feat_uv"] = kf.feat_uv
                blobs[p + "feat_desc"] = kf.feat_desc
                blobs[p + "feat_idepth"] = kf.feat_idepth
            if kf.map_points:
                blobs[p + "points"] = np.array(
                    [[mp.u, mp.v, mp.idepth] for mp in kf.map_points])
            if kf.pose_rel:
                oids = sorted(kf.pose_rel)
                blobs[p + "rel_ids"] = np.array(oids, np.int64)
                blobs[p + "rel_S"] = np.stack(
                    [kf.pose_rel[o][0] for o in oids])
                blobs[p + "rel_info"] = np.stack(
                    [kf.pose_rel[o][1] for o in oids])
                blobs[p + "rel_loop"] = np.array(
                    [kf.pose_rel[o][2] for o in oids])
        np.savez_compressed(path, **blobs)

    @staticmethod
    def load(path: str) -> "GlobalMap":
        """Inverse of save (FullSystem::loadAll, FullSystem.cc:1895-1918)."""
        z = np.load(path, allow_pickle=False)
        gm = GlobalMap()
        gm.latest_optimized_kf_id = int(z["latest_optimized"])
        for k in z["kf_ids"]:
            k = int(k)
            p = f"kf{k}_"
            meta = z[p + "meta"]
            kf = FrameShell(id=int(meta[0]), timestamp=float(meta[1]),
                            exposure=float(meta[2]), kf_id=k,
                            T_cw=z[p + "T_cw"], aff=z[p + "aff"])
            kf.S_cw = z[p + "S_cw"]
            if p + "feat_uv" in z:
                kf.feat_uv = z[p + "feat_uv"]
                kf.feat_desc = z[p + "feat_desc"]
                kf.feat_idepth = z[p + "feat_idepth"]
            if p + "points" in z:
                for row in z[p + "points"]:
                    kf.map_points.append(MapPointRecord(
                        host_kf_id=k, u=float(row[0]), v=float(row[1]),
                        idepth=float(row[2])))
            if p + "rel_ids" in z:
                for j, o in enumerate(z[p + "rel_ids"]):
                    kf.pose_rel[int(o)] = (z[p + "rel_S"][j],
                                           z[p + "rel_info"][j],
                                           bool(z[p + "rel_loop"][j]))
            gm.add_keyframe(kf)
        return gm

    def add_keyframe(self, fr: FrameShell):
        fr.is_keyframe = True
        self.keyframes[fr.kf_id] = fr

    def num_frames(self) -> int:
        return len(self.keyframes)

    def get_all_kfs(self) -> List[FrameShell]:
        return [self.keyframes[k] for k in sorted(self.keyframes)]

    def point_cloud(self) -> np.ndarray:
        """World positions of all retired points under the current
        (optionally loop-corrected) keyframe poses (Point::ComputeWorldPos)."""
        pts = []
        for kf in self.keyframes.values():
            if not kf.map_points:
                continue
            S_wc = np.linalg.inv(kf.get_S_cw())
            # intrinsics are stored per run; caller bakes them in the record
            for mp in kf.map_points:
                if mp.idepth <= 0:
                    continue
                z = 1.0 / mp.idepth
                pc = np.array([mp.u * z, mp.v * z, z, 1.0])
                pts.append((S_wc @ pc)[:3])
        return np.array(pts) if pts else np.zeros((0, 3))
