"""Host-side (numpy, float64) Lie-group helpers.

Control-flow code on the host (motion-hypothesis generation, pose
bookkeeping) stays in numpy float64. These mirror ldso_tpu_torch.math.lie
exactly (same conventions) for scalars/single matrices."""

from __future__ import annotations

import numpy as np

_EPS = 1e-10


def hat(w):
    return np.array([[0.0, -w[2], w[1]],
                     [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


def so3_exp(w):
    w = np.asarray(w, np.float64)
    th2 = float(w @ w)
    th = np.sqrt(th2)
    W = hat(w)
    if th < 1e-8:
        a, b = 1.0 - th2 / 6.0, 0.5 - th2 / 24.0
    else:
        a, b = np.sin(th) / th, (1.0 - np.cos(th)) / th2
    return np.eye(3) + a * W + b * (W @ W)


def so3_log(R):
    R = np.asarray(R, np.float64)
    a = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]])
    sin_t = np.linalg.norm(a)
    cos_t = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arctan2(sin_t, cos_t)
    if sin_t < 1e-7:
        if cos_t > 0:
            return a * (1.0 + th * th / 6.0)
        # theta ~ pi
        diag = np.clip((np.diag(R) + 1.0) * 0.5, 0.0, None)
        n = np.sqrt(diag)
        k = int(np.argmax(n))
        col = (R + np.eye(3))[:, k]
        n = np.sign(np.where(col == 0, 1.0, col)) * n
        n /= max(np.linalg.norm(n), _EPS)
        if n @ a < 0:
            n = -n
        return th * n
    return a * (th / sin_t)


def _V(w):
    th2 = float(w @ w)
    th = np.sqrt(th2)
    W = hat(w)
    if th < 1e-6:
        a, b = 0.5 - th2 / 24.0, 1.0 / 6.0 - th2 / 120.0
    else:
        a = (1.0 - np.cos(th)) / th2
        b = (th - np.sin(th)) / (th2 * th)
    return np.eye(3) + a * W + b * (W @ W)


def se3_exp(xi):
    xi = np.asarray(xi, np.float64)
    v, w = xi[:3], xi[3:6]
    T = np.eye(4)
    T[:3, :3] = so3_exp(w)
    T[:3, 3] = _V(w) @ v
    return T


def se3_log(T):
    T = np.asarray(T, np.float64)
    w = so3_log(T[:3, :3])
    v = np.linalg.solve(_V(w), T[:3, 3])
    return np.concatenate([v, w])


def quat_to_rotmat(q):
    """(x, y, z, w) -> 3x3."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q)
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def rotmat_to_quat(R):
    """3x3 -> (x, y, z, w)."""
    R = np.asarray(R, np.float64)
    w = so3_log(R)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.array([0.0, 0.0, 0.0, 1.0])
    axis = w / th
    return np.concatenate([axis * np.sin(th / 2), [np.cos(th / 2)]])
