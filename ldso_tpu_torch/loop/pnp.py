"""Batched RANSAC PnP (replaces cv::solvePnPRansac in LoopClosing.cc:217).

Counterpart of ldso_tpu/loop/pnp.py. Minimal solver: 6-point DLT for the
3x4 projection matrix (one batched SVD over the hypotheses), orthonormalized
to SE(3), then pose-only GN refinement on the inliers with Jacobians from
torch.func.jacfwd.

The RANSAC draw and the scoring are split: `draw_picks` samples the
hypotheses' point indices with a torch.Generator (torch cannot reproduce
jax.random), `pnp_ransac_from_picks` scores given picks, so a test can feed
both packages the same picks.
"""

from __future__ import annotations

import torch

from ldso_tpu_torch.math import lie


def _exp1(exp, xi):
    """exp of one tangent vector, evaluated as a batch of one: under
    torch.func.jacfwd a 0-dim intermediate with a Python scalar promotes
    to float64, a 1-element batch keeps the input's dtype."""
    return exp(xi[None])[0]


def draw_picks(valid: torch.Tensor, n_hyp: int, k: int,
               generator: torch.Generator) -> torch.Tensor:
    """(n_hyp, k) int64 point indices, each drawn uniformly from the valid
    points with replacement (jax.random.categorical over log-probs)."""
    probs = valid.to(torch.float32)
    probs = probs / torch.clamp(probs.sum(), min=1e-9)
    return torch.multinomial(probs, n_hyp * k, replacement=True,
                             generator=generator).reshape(n_hyp, k)


def _dlt_pose(X: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """X (..., 6, 3) points, xn (..., 6, 2) normalized image coordinates.
    Returns T (..., 4, 4) with xn ~ project(R X + t)."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)     # (...,6,4)
    z4 = torch.zeros_like(Xh)
    x, y = xn[..., 0:1], xn[..., 1:2]
    r1 = torch.cat([Xh, z4, -x * Xh], dim=-1)
    r2 = torch.cat([z4, Xh, -y * Xh], dim=-1)
    A = torch.stack([r1, r2], dim=-2).reshape(X.shape[:-2] + (-1, 12))
    _, _, Vt = torch.linalg.svd(A)
    P = Vt[..., -1, :].reshape(X.shape[:-2] + (3, 4))
    # fix sign: points must be in front
    depth = torch.einsum("...nj,...j->...n", Xh, P[..., 2, :])
    P = P * torch.sign(torch.sum(torch.sign(depth), dim=-1) + 0.5)[..., None,
                                                                   None]
    M = P[..., :3]
    U, S, Vt2 = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(U @ Vt2))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = U @ (D[..., :, None] * Vt2)
    scale = torch.sum(S * D, dim=-1) / 3.0
    t = P[..., 3] / torch.clamp(scale, min=1e-12)[..., None]
    return lie.se3(R, t)


def pnp_ransac(X: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
               fxycxy, generator: torch.Generator, inlier_px: float = 3.0,
               n_hyp: int = 256, gn_iters: int = 8):
    """X (N,3) points (candidate frame), uv (N,2) pixels (current frame).
    Returns (T_cur_from_pts (4,4), inlier mask, n_inliers)."""
    picks = draw_picks(valid, n_hyp, 6, generator)
    return pnp_ransac_from_picks(X, uv, valid, fxycxy, picks, inlier_px,
                                 gn_iters)


def pnp_ransac_from_picks(X, uv, valid, fxycxy, picks: torch.Tensor,
                          inlier_px: float = 3.0, gn_iters: int = 8):
    """Score the (H, 6) hypotheses `picks`, keep the one with most inliers
    (first on ties, as jnp.argmax), GN-refine it on its inliers."""
    fx, fy, cx, cy = fxycxy
    xn = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)
    Ts = _dlt_pose(X[picks], xn[picks])                       # (H,4,4)

    def reproj_err(T):
        Pc = torch.einsum("nj,...ij->...ni", X, T[..., :3, :3]) \
            + T[..., None, :3, 3]
        z = Pc[..., 2]
        zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        u = fx * Pc[..., 0] / zs + cx
        v = fy * Pc[..., 1] / zs + cy
        err = torch.hypot(u - uv[:, 0], v - uv[:, 1])
        return torch.where(z > 0, err, torch.full_like(err, 1e9))

    inl = (reproj_err(Ts) < inlier_px) & valid[None, :]       # (H,N)
    best = torch.argmax(inl.sum(dim=1))
    T = Ts[best]
    w = torch.repeat_interleave(inl[best].to(T.dtype), 2)
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
    zero = torch.zeros(6, dtype=T.dtype, device=T.device)
    for _ in range(gn_iters):
        def f(xi, T=T):
            Td = _exp1(lie.se3_exp, xi) @ T
            Pc = X @ Td[:3, :3].T + Td[:3, 3]
            z = torch.clamp(Pc[:, 2], min=1e-6)
            u = fx * Pc[:, 0] / z + cx
            v = fy * Pc[:, 1] / z + cy
            return (torch.stack([u, v], -1) - uv).reshape(-1)

        r = f(zero)
        J = torch.func.jacfwd(f)(zero)
        H = (J * w[:, None]).T @ J
        b = (J * w[:, None]).T @ r
        xi = -torch.linalg.solve(H + 1e-6 * eye6, b)
        xi = torch.where(torch.isfinite(xi), xi, torch.zeros_like(xi))
        T = (lie.se3_exp(xi) @ T).to(X.dtype)
    mask = (reproj_err(T) < inlier_px) & valid
    return T, mask, mask.sum()
