"""Batched SO(3) / SE(3) Lie-group operations on tensors.

Counterpart of ldso_tpu/math/lie.py (Sophus conventions): SE3 tangent
xi = [upsilon(3), omega(3)], group elements as 4x4 matrices. Every function
broadcasts over leading batch dimensions and keeps the dtype and device of
its input. Small-angle branches use Taylor expansions selected with
`torch.where`, exactly as the reference does. Sim(3) comes with loop
closing.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
_SQRT_GUARD = 1e-30


def _safe_sqrt(x):
    return torch.sqrt(x + _SQRT_GUARD)


def _safe_norm(x, dim=-1, keepdim=False):
    return _safe_sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def hat(w):
    """so(3) hat operator: (...,3) -> (...,3,3)."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)


def vee(W):
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(w, n):
    return torch.eye(n, dtype=w.dtype, device=w.device).expand(
        w.shape[:-1] + (n, n))


def so3_exp(omega):
    """Rodrigues: (...,3) -> (...,3,3)."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = _safe_sqrt(theta2)
    small = theta < 1e-4
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    W = hat(omega)
    return (_eye_like(omega, 3) + a[..., None, None] * W
            + b[..., None, None] * (W @ W))


def so3_log(R):
    """(...,3,3) -> (...,3), robust near theta = 0 and theta = pi."""
    a = 0.5 * vee(R - R.transpose(-1, -2))
    sin_t = _safe_norm(a)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.atan2(sin_t, cos_t)

    small = sin_t < 1e-4
    factor = torch.where(small, 1.0 + theta * theta / 6.0,
                         theta / torch.where(small, torch.ones_like(sin_t),
                                             sin_t))
    w_generic = factor[..., None] * a

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    n_abs = _safe_sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    k = torch.argmax(n_abs, dim=-1)
    RpI = R + _eye_like(a, 3)
    idx = k[..., None, None].expand(k.shape + (3, 1))
    col = torch.gather(RpI, -1, idx)[..., 0]
    n = torch.sign(torch.where(col == 0.0, torch.ones_like(col), col)) * n_abs
    n = n / torch.clamp(_safe_norm(n, keepdim=True), min=_EPS)
    flip = torch.sum(n * a, dim=-1) < 0.0
    n = torch.where(flip[..., None], -n, n)
    w_pi = theta[..., None] * n

    near_pi = (sin_t < 1e-4) & (cos_t < 0.0)
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian_coeffs(omega):
    """Coefficients (a, b) of V = I + a*W + b*W^2 (left Jacobian of SO3)."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = _safe_sqrt(theta2)
    small = theta < 1e-4
    one = torch.ones_like(theta)
    safe_t2 = torch.where(small, one, theta2)
    safe_t3 = safe_t2 * torch.where(small, one, theta)
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / safe_t2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / safe_t3)
    return a, b


def se3(R, t):
    """Assemble 4x4 from (...,3,3) and (...,3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def _V(w):
    a, b = _so3_left_jacobian_coeffs(w)
    W = hat(w)
    return (_eye_like(w, 3) + a[..., None, None] * W
            + b[..., None, None] * (W @ W))


def se3_exp(xi):
    """(...,6) [v, w] -> (...,4,4)."""
    v, w = xi[..., :3], xi[..., 3:6]
    t = torch.einsum("...ij,...j->...i", _V(w), v)
    return se3(so3_exp(w), t)


def se3_log(T):
    """(...,4,4) -> (...,6) [v, w]."""
    w = so3_log(T[..., :3, :3])
    v = torch.linalg.solve(_V(w), T[..., :3, 3:4])[..., 0]
    return torch.cat([v, w], dim=-1)


def se3_inv(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    return se3(Rt, t)


def se3_adj(T):
    """Adjoint: (...,4,4) -> (...,6,6) for tangent order [v, w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    A = torch.zeros(T.shape[:-2] + (6, 6), dtype=T.dtype, device=T.device)
    A[..., :3, :3] = R
    A[..., :3, 3:] = hat(t) @ R
    A[..., 3:, 3:] = R
    return A
