"""Reference-binary map format: byte-compatible FullSystem::saveAll/loadAll.

Writes and reads the exact little-endian layout of the reference's map
snapshot so maps cross-load between the two systems
(src/frontend/FullSystem.cc:1872-1918, src/Frame.cc:121-200,
src/Feature.cc:39-67, src/Point.cc:49-57):

  int32 nKF
  per keyframe (in kfId order — loadAll resolves poseRel targets by
  indexing allKF[kfId], FullSystem.cc:1895-1904 / Frame.cc:185-199):
    uint64 id, uint64 kfId
    16 x float64 Tcw (row-major)
    int32 nFeature
    per feature:
      int32  status          (IMMATURE=0, VALID=1, OUTLIER=2; Feature.h:38-42)
      float32 u, v, invD
      uint8  isCorner        (C++ bool, 1 byte, no stream padding)
      float32 angle, score
      32 x uint8 descriptor
      if status == VALID:    (Point::save, Point.cc:49-52)
        uint64 point_id
        int32  point_status  (ACTIVE=0, OUTLIER, OUT, MARGINALIZED; Point.h:38-43)
    int32 nPoseRel
    per edge:
      uint64 target kfId
      16 x float64 Tcr       (Sim3 matrix; scale folded into the rotation block)

The reference does NOT serialize TcwOpti (reset to Sim3(Tcw) on load,
Frame.cc:163-165), edge information matrices, or the isLoop flag — the
same losses apply when round-tripping through this format; the native
`GlobalMap.save` npz snapshot keeps them.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

FEAT_IMMATURE, FEAT_VALID, FEAT_OUTLIER = 0, 1, 2
PT_ACTIVE, PT_OUTLIER, PT_OUT, PT_MARGINALIZED = 0, 1, 2, 3

_FEAT_HEAD = struct.Struct("<ifff")          # status, u, v, invD
_FEAT_TAIL = struct.Struct("<Bff")           # isCorner, angle, score
_POINT = struct.Struct("<Qi")                # point id, point status


def save_ldso_binary(global_map, path: str):
    """Write the map in the reference's saveAll layout.

    Every feature we carry is exported with its descriptor/orientation;
    retired map points without a feature record are exported as
    descriptor-less VALID features (the reference's map/viewer only read
    uv+invD from them, Point.cc:34-45)."""
    kfs = sorted(global_map.keyframes.values(), key=lambda f: f.kf_id)
    next_pid = 0
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(kfs)))
        for kf in kfs:
            f.write(struct.pack("<QQ", int(kf.id), int(kf.kf_id)))
            f.write(np.ascontiguousarray(kf.T_cw, "<f8").tobytes())

            feats = []
            written = set()   # (u, v, invD) keys already covered by a feature

            def _key(u, v, invd):
                return (round(float(u), 3), round(float(v), 3),
                        round(float(invd), 6))

            if kf.feat_uv is not None and len(kf.feat_uv):
                desc = kf.feat_desc
                ang = (kf.feat_angle if kf.feat_angle is not None
                       else np.zeros(len(kf.feat_uv), np.float32))
                idep = (kf.feat_idepth if kf.feat_idepth is not None
                        else np.full(len(kf.feat_uv), -1.0, np.float32))
                for i in range(len(kf.feat_uv)):
                    has_pt = idep[i] > 0
                    if has_pt:
                        written.add(_key(kf.feat_uv[i, 0],
                                         kf.feat_uv[i, 1], idep[i]))
                    feats.append((
                        FEAT_VALID if has_pt else FEAT_IMMATURE,
                        float(kf.feat_uv[i, 0]), float(kf.feat_uv[i, 1]),
                        float(idep[i]), True, float(ang[i]), 0.0,
                        desc[i].tobytes(), has_pt, PT_ACTIVE))
            for mp in kf.map_points:
                if _key(mp.u, mp.v, mp.idepth) in written:
                    continue    # already serialized as a VALID feature
                feats.append((FEAT_VALID, float(mp.u), float(mp.v),
                              float(mp.idepth), False, 0.0, 0.0,
                              b"\x00" * 32, True, PT_MARGINALIZED))

            f.write(struct.pack("<i", len(feats)))
            for (st, u, v, invd, is_corner, angle, score, desc,
                 has_pt, pst) in feats:
                f.write(_FEAT_HEAD.pack(st, u, v, invd))
                f.write(_FEAT_TAIL.pack(1 if is_corner else 0, angle, score))
                f.write(desc)
                if has_pt:
                    f.write(_POINT.pack(next_pid, pst))
                    next_pid += 1

            rel = sorted(kf.pose_rel.items())
            f.write(struct.pack("<i", len(rel)))
            for other_id, (S_rel, _info, _is_loop) in rel:
                f.write(struct.pack("<Q", int(other_id)))
                f.write(np.ascontiguousarray(S_rel, "<f8").tobytes())


def load_ldso_binary(path: str):
    """Read a reference saveAll snapshot into a GlobalMap.

    VALID features become retired MapPointRecords (the point cloud);
    features with a non-zero descriptor also restore the per-KF feature
    arrays used by loop closing."""
    from ldso_tpu_torch.slam_map import FrameShell, GlobalMap, MapPointRecord

    with open(path, "rb") as f:
        data = f.read()
    off = 0

    def take(fmt):
        nonlocal off
        s = struct.Struct(fmt)
        vals = s.unpack_from(data, off)
        off += s.size
        return vals

    (n_kf,) = take("<i")
    gm = GlobalMap()
    pending_rel: Dict[int, list] = {}
    for _ in range(n_kf):
        fid, kf_id = take("<QQ")
        T = np.frombuffer(data, "<f8", 16, off).reshape(4, 4).copy()
        off += 16 * 8
        kf = FrameShell(id=int(fid))
        kf.kf_id = int(kf_id)
        kf.is_keyframe = True
        kf.T_cw = T
        kf.S_cw = T.copy()          # TcwOpti = Sim3(Tcw) (Frame.cc:163-165)

        (n_feat,) = take("<i")
        uv, desc, idep, ang = [], [], [], []
        for _ in range(n_feat):
            st, u, v, invd = take("<ifff")
            is_corner, angle, _score = take("<Bff")
            d = np.frombuffer(data, np.uint8, 32, off).copy()
            off += 32
            if st == FEAT_VALID:
                _pid, _pst = take("<Qi")
                kf.map_points.append(MapPointRecord(
                    host_kf_id=int(kf_id), u=float(u), v=float(v),
                    idepth=float(invd)))
            if is_corner or d.any():
                uv.append((u, v))
                desc.append(d)
                idep.append(invd if st == FEAT_VALID else -1.0)
                ang.append(angle)
        if uv:
            kf.feat_uv = np.asarray(uv, np.float32)
            kf.feat_desc = np.stack(desc)
            kf.feat_idepth = np.asarray(idep, np.float32)
            kf.feat_angle = np.asarray(ang, np.float32)

        (n_rel,) = take("<i")
        rels = []
        for _ in range(n_rel):
            (other,) = take("<Q")
            Tcr = np.frombuffer(data, "<f8", 16, off).reshape(4, 4).copy()
            off += 16 * 8
            rels.append((int(other), Tcr))
        pending_rel[int(kf_id)] = rels
        gm.add_keyframe(kf)

    for kf_id, rels in pending_rel.items():
        kf = gm.keyframes[kf_id]
        for other, Tcr in rels:
            kf.add_pose_rel(other, Tcr)
    return gm
