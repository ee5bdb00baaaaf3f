"""Offline visualization: trajectory + map renders to PNG.

Replaces the reference's Pangolin GUI (src/frontend/DSOViewer.cc; SURVEY.md
§2 C31 — the live GL viewer is explicitly out of scope for the TPU build;
PLY dump + offline plots are the supported observability path). Draws the
odometry trajectory in red and the loop-corrected one in yellow/orange,
matching the reference's color convention (README.md:101-104).

matplotlib is imported inside each function, so the package loads without
it; a call raises ImportError where it is missing."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def plot_trajectory(global_map, out_png: str,
                    gt_poses_cw: Optional[np.ndarray] = None,
                    max_points: int = 50000):
    """Top-down (x-z) view of keyframe trajectories + map points."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kfs = global_map.get_all_kfs()
    if not kfs:
        return
    c_odo = np.stack([np.linalg.inv(kf.T_cw)[:3, 3] for kf in kfs])
    c_opt = np.stack([np.linalg.inv(kf.get_S_cw())[:3, 3] for kf in kfs])

    fig, ax = plt.subplots(figsize=(8, 8))
    pts = global_map.point_cloud()
    if len(pts):
        if len(pts) > max_points:
            pts = pts[:: len(pts) // max_points + 1]
        ax.scatter(pts[:, 0], pts[:, 2], s=0.2, c="#999999", alpha=0.4,
                   label="map points")
    ax.plot(c_odo[:, 0], c_odo[:, 2], "-", color="#cc2222", lw=1.2,
            label="odometry (pre-loop)")
    ax.plot(c_opt[:, 0], c_opt[:, 2], "-", color="#e6a817", lw=1.2,
            label="loop-corrected")
    if gt_poses_cw is not None:
        c_gt = np.stack([np.linalg.inv(T)[:3, 3] for T in gt_poses_cw])
        ax.plot(c_gt[:, 0], c_gt[:, 2], "--", color="#2266cc", lw=1.0,
                label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=130)
    plt.close(fig)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as numpy."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plot_depth_map(window, pyr_image, frame_slot: int, out_png: str):
    """Active-point inverse depths over the keyframe image (the viewer's
    per-KF depth overlay). window: backend/window.Window; pyr_image: the
    keyframe's (H, W) image, a tensor or an array."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = _host(window.pt_valid) & (_host(window.pt_host) == frame_slot)
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(_host(pyr_image), cmap="gray", vmin=0, vmax=255)
    if m.any():
        u = _host(window.pt_u)[m]
        v = _host(window.pt_v)[m]
        idep = _host(window.idepth)[m]
        sc = ax.scatter(u, v, c=idep, s=8, cmap="turbo")
        fig.colorbar(sc, ax=ax, label="inverse depth [1/m]")
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_png, dpi=130)
    plt.close(fig)
