"""Sim(3) pose-graph optimization on tensors.

Counterpart of ldso_tpu/loop/posegraph.py, which replaces the vendored g2o
stack of the reference's loop closing (src/Map.cc:75-165
runPoseGraphOptimization; src/internal/PR.h: VertexSim3 with a
left-multiplicative Sim3::exp update, EdgeSim3 with error
e = log(Z^-1 * S_i * S_j^-1)).

Every edge residual and its two 7x7 Jacobian blocks come from one
torch.func.jacfwd over a shared 14-vector (each edge's residual depends
only on its own copy of the increment, so the batched Jacobian is the
per-edge one), and the Gauss-Newton loop is a Python loop over device
tensors. Scatter-adds into vertex space go through ops/scatter.segment_sum,
so the sums run in edge order on every device. Two solvers share that
linearization:
  * dense (`optimize_pose_graph`): the (7N)^2 system assembled and solved
    exactly;
  * matrix-free PCG (`optimize_pose_graph_cg`): H applied edge-wise from
    the cached 7x7 blocks, block-Jacobi preconditioner, O(E) memory.
`run_pose_graph` takes the dense path up to `_DENSE_MAX_VERTICES` padded
vertices and PCG above. The pose graph runs in float64 (the reference's g2o
works in double); the edge-sharded multi-device solver comes with the
multi-device port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ldso_tpu_torch.math import lie
from ldso_tpu_torch.ops.scatter import segment_sum
from ldso_tpu_torch.utils.device import DEFAULT_DEVICE, entry_device


def _edge_residual(Si, Sj, Z_inv):
    """e = log(Z^-1 * S_i * S_j^-1)  (PR.h:151-179, EdgeSim3)."""
    return lie.sim3_log(Z_inv @ Si @ lie.sim3_inv(Sj))


def _edge_res_jac(Si, Sj, Z_inv):
    """Residuals (E,7) and Jacobians (E,7,7) wrt left-multiplied tangent
    increments of both vertices at delta = 0 (g2o differentiates
    numerically; jacfwd is exact)."""

    def f(delta):
        return _edge_residual(lie.sim3_exp(delta[:7]) @ Si,
                              lie.sim3_exp(delta[7:]) @ Sj, Z_inv)

    zero = torch.zeros(14, dtype=Si.dtype, device=Si.device)
    e = _edge_residual(Si, Sj, Z_inv)
    J = torch.func.jacfwd(f)(zero)                      # (E,7,14)
    return e, J[..., :7], J[..., 7:]


def _linearize(S, e_i, e_j, Z_inv, info, edge_valid):
    e, Ji, Jj = _edge_res_jac(S[e_i], S[e_j], Z_inv)
    info_w = info * edge_valid.to(S.dtype)[:, None, None]
    Hii = torch.einsum("eki,ekl,elj->eij", Ji, info_w, Ji)
    Hjj = torch.einsum("eki,ekl,elj->eij", Jj, info_w, Jj)
    Hij = torch.einsum("eki,ekl,elj->eij", Ji, info_w, Jj)
    bi = torch.einsum("eki,ekl,el->ei", Ji, info_w, e)
    bj = torch.einsum("eki,ekl,el->ei", Jj, info_w, e)
    return Hii, Hjj, Hij, bi, bj


def optimize_pose_graph(S_init: torch.Tensor, fixed: torch.Tensor,
                        e_i: torch.Tensor, e_j: torch.Tensor,
                        Z: torch.Tensor, info: torch.Tensor,
                        edge_valid: torch.Tensor, iterations: int = 25,
                        damping: float = 1e-6) -> torch.Tensor:
    """Gauss-Newton over Sim(3) vertices, dense solve.

    S_init (N,4,4); fixed (N,) bool (the newest KF is fixed, Map.cc:110);
    e_i/e_j (E,) vertex ids; Z (E,4,4) measurements S_i_j; info (E,7,7);
    edge_valid (E,) bool. Returns (N,4,4)."""
    N = S_init.shape[0]
    dt = S_init.dtype
    Z_inv = lie.sim3_inv(Z)
    e_i, e_j = e_i.long(), e_j.long()
    free = (~fixed).to(dt)
    fm = torch.repeat_interleave(free, 7)
    diag_add = torch.where(fm > 0, torch.full_like(fm, damping),
                           torch.ones_like(fm))
    S = S_init
    for _ in range(iterations):
        Hii, Hjj, Hij, bi, bj = _linearize(S, e_i, e_j, Z_inv, info,
                                           edge_valid)
        # the four block scatters of the JAX program, in its order
        Hb = segment_sum(
            torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]),
            torch.cat([e_i * N + e_i, e_j * N + e_j, e_i * N + e_j,
                       e_j * N + e_i]), N * N).reshape(N, N, 7, 7)
        b = segment_sum(torch.cat([bi, bj]), torch.cat([e_i, e_j]), N)
        H = Hb.permute(0, 2, 1, 3).reshape(7 * N, 7 * N)
        bf = b.reshape(7 * N)
        # gauge: fixed vertices get identity rows/cols, zero rhs
        H = H * fm[:, None] * fm[None, :]
        H = H + torch.diag(diag_add)
        # scale-balance the solve
        d = torch.sqrt(torch.abs(torch.diagonal(H)) + 1e-8)
        di = 1.0 / d
        Hs = di[:, None] * H * di[None, :]
        delta = -(di * torch.linalg.solve(Hs, di * bf)).reshape(N, 7)
        delta = delta * free[:, None]
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        S = lie.sim3_exp(delta) @ S
    return S


def optimize_pose_graph_cg(S_init: torch.Tensor, fixed: torch.Tensor,
                           e_i: torch.Tensor, e_j: torch.Tensor,
                           Z: torch.Tensor, info: torch.Tensor,
                           edge_valid: torch.Tensor, iterations: int = 25,
                           damping: float = 1e-6,
                           cg_iters: int = 100) -> torch.Tensor:
    """The Gauss-Newton loop of `optimize_pose_graph`, each linear solve a
    matrix-free preconditioned CG from x = 0 (block-Jacobi
    preconditioner from the (N,7,7) diagonal blocks)."""
    N = S_init.shape[0]
    dt = S_init.dtype
    dev = S_init.device
    Z_inv = lie.sim3_inv(Z)
    e_i, e_j = e_i.long(), e_j.long()
    free = (~fixed).to(dt)[:, None]                          # (N,1)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    S = S_init
    for _ in range(iterations):
        Hii, Hjj, Hij, bi, bj = _linearize(S, e_i, e_j, Z_inv, info,
                                           edge_valid)
        b = -segment_sum(torch.cat([bi, bj]), torch.cat([e_i, e_j]), N) * free
        D = segment_sum(torch.cat([Hii, Hjj]), torch.cat([e_i, e_j]), N)
        D = D + damping * eye7
        D = torch.where(free[:, :, None] > 0, D, eye7)
        Minv = torch.linalg.inv(D)

        def hmul(x):
            """(N,7) -> (N,7): (H + damping I) x on the free subspace."""
            xm = x * free
            xi, xj = xm[e_i], xm[e_j]
            yi = (torch.einsum("eij,ej->ei", Hii, xi)
                  + torch.einsum("eij,ej->ei", Hij, xj))
            yj = (torch.einsum("eji,ej->ei", Hij, xi)
                  + torch.einsum("eij,ej->ei", Hjj, xj))
            y = segment_sum(torch.cat([yi, yj]), torch.cat([e_i, e_j]), N)
            return (y + damping * xm) * free

        def pc(r):
            return torch.einsum("nij,nj->ni", Minv, r) * free

        x = torch.zeros((N, 7), dtype=dt, device=dev)
        r = b
        p = pc(r)
        rz = torch.sum(r * p)
        zero = torch.zeros((), dtype=dt, device=dev)
        for _ in range(cg_iters):
            Ap = hmul(p)
            pAp = torch.sum(p * Ap)
            alpha = torch.where(pAp > 1e-20, rz / pAp, zero)
            x = x + alpha * p
            r = r - alpha * Ap
            z = pc(r)
            rz_new = torch.sum(r * z)
            beta = torch.where(rz > 1e-20, rz_new / rz, zero)
            p = z + beta * p
            rz = rz_new
        delta = torch.where(torch.isfinite(x), x, torch.zeros_like(x)) * free
        S = lie.sim3_exp(delta) @ S
    return S


_DENSE_MAX_VERTICES = 1024      # padded; above this run_pose_graph uses PCG


def _pow2(n: int, lo: int = 16) -> int:
    return max(lo, 1 << int(math.ceil(math.log2(max(n, 1)))))


def run_pose_graph(global_map, iterations: int = 25,
                   device=DEFAULT_DEVICE):
    """Host wrapper over the GlobalMap poseRel edges (Map.cc:75-165):
    optimizes every keyframe's S_cw in float64 on `device` with the newest
    fixed, and writes the result back. Vertex and edge counts pad to
    power-of-two buckets as in the JAX package (padding vertices are
    fixed identities, padding edges masked self-edges on the newest)."""
    device = entry_device(device)
    kfs = global_map.get_all_kfs()
    if len(kfs) < 3:
        return
    id_to_idx = {kf.kf_id: k for k, kf in enumerate(kfs)}
    N = len(kfs)
    ei, ej, Zs, infos = [], [], [], []
    for kf in kfs:
        for other_id, (S_rel, info, _is_loop) in kf.pose_rel.items():
            if other_id not in id_to_idx:
                continue
            ei.append(id_to_idx[kf.kf_id])
            ej.append(id_to_idx[other_id])
            Zs.append(S_rel)
            infos.append(info)
    if not ei:
        return
    E = len(ei)

    Nb = _pow2(N)
    S = np.tile(np.eye(4), (Nb, 1, 1))
    S[:N] = np.stack([kf.get_S_cw() for kf in kfs])
    fixed = np.ones(Nb, bool)
    fixed[:N - 1] = False   # newest KF (index N-1) stays pinned (Map.cc:110)
    Eb = _pow2(E)
    eip = np.full(Eb, N - 1, np.int64)
    ejp = np.full(Eb, N - 1, np.int64)
    Zp = np.tile(np.eye(4), (Eb, 1, 1))
    infop = np.tile(np.eye(7), (Eb, 1, 1))
    valid = np.zeros(Eb, bool)
    eip[:E] = ei
    ejp[:E] = ej
    Zp[:E] = np.stack(Zs)
    infop[:E] = np.stack(infos)
    valid[:E] = True

    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    solver = (optimize_pose_graph if Nb <= _DENSE_MAX_VERTICES
              else optimize_pose_graph_cg)
    S_new = solver(f64(S), torch.as_tensor(fixed, device=device),
                   torch.as_tensor(eip, device=device),
                   torch.as_tensor(ejp, device=device), f64(Zp), f64(infop),
                   torch.as_tensor(valid, device=device),
                   iterations=iterations).cpu().numpy()
    for k, kf in enumerate(kfs):
        kf.S_cw = S_new[k]
    global_map.latest_optimized_kf_id = kfs[-1].kf_id
