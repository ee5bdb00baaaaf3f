"""Batched SO(3) / SE(3) Lie-group operations on tensors.

Counterpart of ldso_tpu/math/lie.py (Sophus conventions): SE3 tangent
xi = [upsilon(3), omega(3)], group elements as 4x4 matrices. Every function
broadcasts over leading batch dimensions and keeps the dtype and device of
its input. Small-angle branches use Taylor expansions selected with
`torch.where`, exactly as the reference does.

Sim(3) (loop closing): tangent xi = [upsilon(3), omega(3), sigma(1)]
(log-scale last), the top-left 3x3 block of the 4x4 is s*R. Everything
that the pose graph and the Sim(3) solvers differentiate with
torch.func.jacfwd is written out of place.
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
    """Assemble 4x4 from (...,3,3) and (...,3). Built out of place, so it
    also runs under torch.func transforms (jacfwd, vmap)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)),
                     t.expand(batch + (3,))[..., None]], dim=-1)
    # the [0 0 0 1] row from fills, not an upload: a CUDA graph capture
    # (frontend/track_graph.py) may not copy from the host
    like = dict(dtype=R.dtype, device=R.device)
    bottom = torch.cat([torch.zeros(batch + (1, 3), **like),
                        torch.ones(batch + (1, 1), **like)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


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


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def _cbrt(x):
    """Real cube root (torch has no cbrt)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def sim3(R, t, s):
    """Assemble 4x4 Sim(3) from rotation, translation, scale."""
    s = torch.as_tensor(s, dtype=R.dtype, device=R.device)
    return se3(s[..., None, None] * R, t)


def sim3_scale(S):
    """Recover scale s = det(sR)^(1/3)."""
    return _cbrt(torch.linalg.det(S[..., :3, :3]))


def sim3_rt(S):
    """Split Sim3 into (R, t, s)."""
    s = sim3_scale(S)
    return S[..., :3, :3] / s[..., None, None], S[..., :3, 3], s


def _sim3_W_coeffs(theta, sigma):
    """W = alpha*I + (beta/theta)*What + (gamma/theta^2)*What^2 with
    W = integral_0^1 e^{sigma u} exp(u*What) du: the three scalar
    coefficients, with every singular limit handled (Taylor branches
    below 1e-4, as ldso_tpu/math/lie.py)."""
    theta2 = theta * theta
    sigma2 = sigma * sigma
    es = torch.exp(sigma)
    t_small = theta < 1e-4
    s_small = torch.abs(sigma) < 1e-4
    one = torch.ones_like(sigma)

    alpha = torch.where(s_small, 1.0 + sigma / 2.0 + sigma2 / 6.0,
                        torch.expm1(sigma) / torch.where(s_small, one, sigma))
    denom = torch.where((sigma2 + theta2) < 1e-12, one, sigma2 + theta2)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    safe_t = torch.where(t_small, torch.ones_like(theta), theta)
    beta_over_t = ((es * (sigma * sin_t - theta * cos_t) + theta)
                   / (denom * safe_t))
    int_cos = (es * (sigma * cos_t + theta * sin_t) - sigma) / denom
    gamma_over_t2 = (alpha - int_cos) / torch.where(
        t_small, torch.ones_like(theta), theta2)

    safe_s2 = torch.where(s_small, one, sigma2)
    safe_s3 = safe_s2 * torch.where(s_small, one, sigma)
    bt_lim = torch.where(s_small, 0.5 + sigma / 3.0 + sigma2 / 8.0,
                         (es * (sigma - 1.0) + 1.0) / safe_s2)
    gt_lim = torch.where(s_small, 1.0 / 6.0 + sigma / 8.0 + sigma2 / 20.0,
                         (es * (sigma2 - 2.0 * sigma + 2.0) - 2.0)
                         / (2.0 * safe_s3))
    beta_over_t = torch.where(t_small, bt_lim, beta_over_t)
    gamma_over_t2 = torch.where(t_small, gt_lim, gamma_over_t2)
    return alpha, beta_over_t, gamma_over_t2


def sim3_W(omega, sigma):
    """The Sim(3) 'V' matrix such that t = W @ upsilon in sim3_exp."""
    theta = _safe_norm(omega)
    alpha, bt, gt2 = _sim3_W_coeffs(theta, sigma)
    Wh = hat(omega)
    return (alpha[..., None, None] * _eye_like(omega, 3)
            + bt[..., None, None] * Wh + gt2[..., None, None] * (Wh @ Wh))


def sim3_exp(xi):
    """(...,7) [v, w, sigma] -> (...,4,4)."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = torch.einsum("...ij,...j->...i", sim3_W(w, sigma), v)
    return sim3(so3_exp(w), t, torch.exp(sigma))


def sim3_log(S):
    """(...,4,4) -> (...,7) [v, w, sigma]."""
    R, t, s = sim3_rt(S)
    sigma = torch.log(s)
    w = so3_log(R)
    v = torch.linalg.solve(sim3_W(w, sigma), t[..., None])[..., 0]
    return torch.cat([v, w, sigma[..., None]], dim=-1)


def sim3_inv(S):
    R, t, s = sim3_rt(S)
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, t)
    return sim3(Rt, t_inv, s_inv)


def sim3_adj(S):
    """Adjoint: (...,4,4) -> (...,7,7), tangent order [v, w, sigma]
    (Sophus: Adj = [[sR, hat(t)R, -t], [0, R, 0], [0, 0, 1]])."""
    R, t, s = sim3_rt(S)
    A = torch.zeros(R.shape[:-2] + (7, 7), dtype=R.dtype, device=R.device)
    A[..., :3, :3] = s[..., None, None] * R
    A[..., :3, 3:6] = hat(t) @ R
    A[..., :3, 6] = -t
    A[..., 3:6, 3:6] = R
    A[..., 6, 6] = 1.0
    return A


def se3_to_sim3(T):
    """Embed SE(3) as Sim(3) with unit scale (identity on matrices)."""
    return T


def sim3_to_se3(S):
    """Project Sim(3) to SE(3) by dropping scale (keeps translation)."""
    R, t, _ = sim3_rt(S)
    return se3(R, t)


# ---------------------------------------------------------------------------
# Quaternion interop (TUM trajectories are t + q)
# ---------------------------------------------------------------------------

def rotmat_to_quat(R):
    """(...,3,3) -> (...,4) quaternion (x, y, z, w), Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _mk(w, x, y, z):
        return torch.stack([x, y, z, w], dim=-1)

    s0 = 2.0 * torch.sqrt(torch.clamp(1.0 + tr, min=_EPS))
    q0 = _mk(torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) / 2.0,
             (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0)
    sx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS))
    q1 = _mk((m21 - m12) / (2.0 * sx), sx / 2.0,
             (m01 + m10) / (2.0 * sx), (m02 + m20) / (2.0 * sx))
    sy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=_EPS))
    q2 = _mk((m02 - m20) / (2.0 * sy), (m01 + m10) / (2.0 * sy),
             sy / 2.0, (m12 + m21) / (2.0 * sy))
    sz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=_EPS))
    q3 = _mk((m10 - m01) / (2.0 * sz), (m02 + m20) / (2.0 * sz),
             (m12 + m21) / (2.0 * sz), sz / 2.0)

    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.gather(cands, -2,
                     idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q):
    """(...,4) (x, y, z, w) -> (...,3,3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                        2 * (x * z + y * w)], -1)
    row1 = torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                        2 * (y * z - x * w)], -1)
    row2 = torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                        1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)
