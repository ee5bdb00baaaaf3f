"""Trajectory writers (TUM / KITTI formats), ATE evaluation, PLY export.

Rebuild of FullSystem::printResult / printResultKitti
(src/frontend/FullSystem.cc:1920-1981) and the viewer's saveAsPLYFile
(include/frontend/DSOViewer.h:115-152). ATE evaluation with SE(3)/Sim(3)
Umeyama alignment replaces the reference's offline evaluation step.

Counterpart of ldso_tpu/io/trajectory.py; quaternions go through the
port's host Lie helpers (math/lie_np) in float64."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ldso_tpu_torch.math import lie_np


def write_tum(filename: str, timestamps: Sequence[float],
              poses_cw: Sequence[np.ndarray]):
    """TUM format: 'stamp tx ty tz qx qy qz qw' of camToWorld."""
    with open(filename, "w") as f:
        for ts, T_cw in zip(timestamps, poses_cw):
            T_wc = np.linalg.inv(np.asarray(T_cw, np.float64))
            # drop any Sim3 scale for the quaternion
            R = T_wc[:3, :3]
            s = np.cbrt(np.linalg.det(R))
            q = lie_np.rotmat_to_quat(R / s)
            t = T_wc[:3, 3]
            f.write(f"{ts:.15g} {t[0]:.15g} {t[1]:.15g} {t[2]:.15g} "
                    f"{q[0]:.15g} {q[1]:.15g} {q[2]:.15g} {q[3]:.15g}\n")


def write_kitti(filename: str, frame_ids: Sequence[int],
                poses_cw: Sequence[np.ndarray]):
    """KITTI format: 'id r00 r01 r02 tx r10 ... tz' of camToWorld 3x4
    (the reference prefixes the frame id; FullSystem.cc:1950-1981)."""
    with open(filename, "w") as f:
        for fid, T_cw in zip(frame_ids, poses_cw):
            T_wc = np.linalg.inv(np.asarray(T_cw, np.float64))
            M = T_wc[:3, :4]
            vals = " ".join(f"{x:.9g}" for x in M.reshape(-1))
            f.write(f"{fid} {vals}\n")


def read_tum(filename: str):
    """Returns (timestamps (N,), poses_wc (N,4,4))."""
    ts, poses = [], []
    with open(filename) as f:
        for line in f:
            t = line.split()
            if len(t) < 8 or line.startswith("#"):
                continue
            ts.append(float(t[0]))
            tr = np.array([float(x) for x in t[1:4]])
            q = np.array([float(x) for x in t[4:8]])
            R = lie_np.quat_to_rotmat(q)
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = tr
            poses.append(T)
    return np.asarray(ts), np.stack(poses) if poses else np.zeros((0, 4, 4))


def umeyama_alignment(est_c: np.ndarray, gt_c: np.ndarray,
                      with_scale: bool = True):
    """Similarity (or rigid) alignment est -> gt. Returns (s, R, t)."""
    mu_e = est_c.mean(0)
    mu_g = gt_c.mean(0)
    ec = est_c - mu_e
    gc = gt_c - mu_g
    cov = gc.T @ ec / len(ec)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (ec ** 2).sum() / len(ec)
    s = np.trace(np.diag(D) @ S) / max(var_e, 1e-12) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_poses_cw: Sequence[np.ndarray],
             gt_poses_cw: Sequence[np.ndarray],
             with_scale: bool = True) -> float:
    """Absolute trajectory error after Umeyama alignment of camera centers
    (monocular evaluation uses similarity alignment)."""
    est_c = np.stack([np.linalg.inv(T)[:3, 3] for T in est_poses_cw])
    gt_c = np.stack([np.linalg.inv(T)[:3, 3] for T in gt_poses_cw])
    s, R, t = umeyama_alignment(est_c, gt_c, with_scale)
    aligned = (s * (R @ est_c.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt_c) ** 2, axis=1))))


def save_ply(filename: str, points: np.ndarray,
             colors: Optional[np.ndarray] = None):
    """ASCII PLY point cloud (saveAsPLYFile, DSOViewer.h:115-152)."""
    n = len(points)
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            p = points[i]
            if colors is not None:
                c = colors[i].astype(int)
                f.write(f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n")
