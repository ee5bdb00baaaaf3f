"""Sim(3) relative-pose estimation for loop closing.

Counterpart of ldso_tpu/loop/sim3_solver.py. The reference
(LoopClosing::CorrectLoop + ComputeOptimizedPose,
src/frontend/LoopClosing.cc:145-496) seeds with OpenCV solvePnPRansac and
refines with a g2o graph of EdgePointSim3 (3D-3D) + EdgeProjectPoseOnlySim3
(2D reprojection) edges under Huber kernels. Here:
  * `umeyama_ransac`: closed-form Sim(3) from 3-point minimal sets, all
    hypotheses as one batch (batched 3x3 SVDs); the draw is split from the
    scoring as in loop/pnp.py (`umeyama_ransac_from_picks`);
  * `refine_sim3`: Gauss-Newton over the 7-dof Sim3 with the two residual
    types + Huber weights, Jacobians by torch.func.jacfwd; returns the 7x7
    Hessian used as the poseRel edge information (LoopClosing.cc:490-496).
"""

from __future__ import annotations

import torch

from ldso_tpu_torch.loop.pnp import _exp1, draw_picks
from ldso_tpu_torch.math import lie


def umeyama_sim3(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor):
    """Weighted Umeyama: Sim3 S with Q ~= s R P + t (maps the P-frame to
    the Q-frame). P, Q (..., N, 3); w (..., N). Returns (..., 4, 4)."""
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    muP = torch.sum(wn[..., None] * P, dim=-2)
    muQ = torch.sum(wn[..., None] * Q, dim=-2)
    Pc = P - muP[..., None, :]
    Qc = Q - muQ[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", wn, Qc, Pc)
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = U @ (D[..., :, None] * Vt)
    varP = torch.sum(wn * torch.sum(Pc * Pc, dim=-1), dim=-1)
    s = torch.sum(S * D, dim=-1) / torch.clamp(varP, min=1e-12)
    t = muQ - s[..., None] * torch.einsum("...ij,...j->...i", R, muP)
    return lie.sim3(R, t, s)


def _apply(S, P):
    """S (..., 4, 4) applied to points P (N, 3) -> (..., N, 3)."""
    return (torch.einsum("nj,...ij->...ni", P, S[..., :3, :3])
            + S[..., None, :3, 3])


def umeyama_ransac(P: torch.Tensor, Q: torch.Tensor, valid: torch.Tensor,
                   generator: torch.Generator, inlier_th: float = 0.05,
                   n_hyp: int = 256):
    """RANSAC Sim(3) from 3D-3D correspondences; all hypotheses batched.
    inlier_th: relative 3D error threshold (fraction of point depth).
    Returns (S_best (4,4), inlier mask (N,), n_inliers)."""
    picks = draw_picks(valid, n_hyp, 3, generator)
    return umeyama_ransac_from_picks(P, Q, valid, picks, inlier_th)


def umeyama_ransac_from_picks(P, Q, valid, picks: torch.Tensor,
                              inlier_th: float = 0.05):
    """Score the (H, 3) hypotheses `picks` (first best on ties), then
    polish on the inliers and keep the polish if it has as many."""
    Ss = umeyama_sim3(P[picks], Q[picks],
                      torch.ones(picks.shape, dtype=P.dtype, device=P.device))
    err = torch.linalg.norm(_apply(Ss, P) - Q[None], dim=-1)   # (H,N)
    scale_ref = torch.clamp(torch.linalg.norm(Q, dim=-1), min=0.5)
    inl = (err < inlier_th * scale_ref[None, :]) & valid[None, :]
    best = torch.argmax(inl.sum(dim=1))
    S0 = Ss[best]
    mask = inl[best]
    S1 = umeyama_sim3(P, Q, mask.to(P.dtype))
    err1 = torch.linalg.norm(_apply(S1, P) - Q, dim=-1)
    mask1 = (err1 < inlier_th * scale_ref) & valid
    better = mask1.sum() >= mask.sum()
    S_out = torch.where(better, S1, S0)
    m_out = torch.where(better, mask1, mask)
    return S_out, m_out, m_out.sum()


def _huber_w(r2, delta):
    r = torch.sqrt(r2 + 1e-12)
    return torch.where(r < delta, torch.ones_like(r), delta / r)


def refine_sim3(S_init: torch.Tensor, P_cand: torch.Tensor,
                uv_cur: torch.Tensor, m2d: torch.Tensor,
                P3_cand: torch.Tensor, P3_cur: torch.Tensor,
                m3d: torch.Tensor, fxycxy, iterations: int = 20,
                huber_px: float = 3.0, huber_3d: float = 0.1):
    """GN over S (cand -> cur) with the reference's two residual types:
      * 2D: project S * P_cand into the current image vs uv_cur
        (EdgeProjectPoseOnlySim3, PR.h)
      * 3D: S * P3_cand vs P3_cur (EdgePointSim3)
    Returns (S, H (7,7) GN information, 2D inliers, 3D inliers)."""
    fx, fy, cx, cy = fxycxy
    n2 = uv_cur.shape[0]
    dt = S_init.dtype
    zero = torch.zeros(7, dtype=dt, device=S_init.device)

    def residual_fn(S):
        def f(delta):
            Sd = _exp1(lie.sim3_exp, delta) @ S
            Pc = P_cand @ Sd[:3, :3].T + Sd[:3, 3]
            z = torch.clamp(Pc[:, 2], min=1e-6)
            u = fx * Pc[:, 0] / z + cx
            v = fy * Pc[:, 1] / z + cy
            r2d = torch.stack([u, v], -1) - uv_cur                # (N,2)
            r3d = P3_cand @ Sd[:3, :3].T + Sd[:3, 3] - P3_cur     # (M,3)
            return torch.cat([r2d.reshape(-1), r3d.reshape(-1)])
        return f

    def linearize(S):
        f = residual_fn(S)
        r = f(zero)
        J = torch.func.jacfwd(f)(zero)
        r2d_n = r[:2 * n2].reshape(-1, 2)
        r3d_n = r[2 * n2:].reshape(-1, 3)
        w2 = _huber_w(torch.sum(r2d_n ** 2, -1), huber_px) * m2d
        w3 = _huber_w(torch.sum(r3d_n ** 2, -1), huber_3d) * m3d
        w = torch.cat([torch.repeat_interleave(w2, 2),
                       torch.repeat_interleave(w3, 3)])
        return r, J, w, r2d_n, r3d_n

    S = S_init
    eye7 = torch.eye(7, dtype=dt, device=S.device)
    for _ in range(iterations):
        r, J, w, _, _ = linearize(S)
        H = (J * w[:, None]).T @ J
        b = (J * w[:, None]).T @ r
        delta = -torch.linalg.solve(H + 1e-6 * eye7, b)
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        S = (lie.sim3_exp(delta) @ S).to(S_init.dtype)

    # final information matrix and inlier masks at the solution
    r, J, w, r2d_n, r3d_n = linearize(S)
    H = (J * w[:, None]).T @ J
    inl2d = (torch.sum(r2d_n ** 2, -1) < huber_px ** 2 * 4) & (m2d > 0)
    inl3d = (torch.sum(r3d_n ** 2, -1) < huber_3d ** 2 * 4) & (m3d > 0)
    return S, H, inl2d, inl3d
