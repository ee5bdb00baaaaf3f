"""The port's loop-closing math against the JAX package: Sim(3) Lie
algebra, deterministic scatter-add, PnP and Umeyama RANSAC given the same
hypothesis draws, the Sim(3) refinement, and the pose graph (dense, CG,
and run_pose_graph on a drifted GlobalMap)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_utils import close, equal, jax_picks, npy

from ldso_tpu.loop import pnp as jpnp
from ldso_tpu.loop import posegraph as jpg
from ldso_tpu.loop import sim3_solver as jsim
from ldso_tpu.math import lie as jlie
from ldso_tpu_torch.loop import pnp as tpnp
from ldso_tpu_torch.loop import posegraph as tpg
from ldso_tpu_torch.loop import sim3_solver as tsim
from ldso_tpu_torch.math import lie as tlie
from ldso_tpu_torch.ops.scatter import segment_sum
from ldso_tpu_torch.utils.convert import global_map_to_torch

KEY = jax.random.PRNGKey(0)


def _xis(seed, n=12):
    """Sim(3) tangents across scales, including exact zeros of theta and
    sigma and values around the 1e-4 Taylor switch."""
    rng = np.random.RandomState(seed)
    out = []
    for scale in (0.0, 1e-9, 5e-5, 2e-4, 1e-2, 0.5, 2.0):
        for _ in range(n // 6 + 1):
            xi = rng.randn(7) * scale
            out.append(xi)
    rot_only = rng.randn(7) * 0.3
    rot_only[6] = 0.0                       # sigma == 0, theta > 0
    scale_only = np.zeros(7)
    scale_only[6] = 0.2                     # theta == 0, sigma > 0
    return np.stack(out + [rot_only, scale_only])


@pytest.mark.parametrize("dtype,tol", [(np.float64, dict(rtol=0, atol=1e-10)),
                                       (np.float32, dict(rtol=1e-5,
                                                         atol=1e-6))])
def test_sim3_matches(dtype, tol):
    """exp, log (round trips near theta=0 and sigma=0), inv, adj, scale,
    rt split, se3<->sim3 and quaternions: float64 atol 1e-10, float32
    rtol 1e-5 / atol 1e-6."""
    xi = _xis(0)
    if dtype == np.float32:
        # float32 rounding of a scale-7 matrix alone is ~1e-6 absolute
        xi = xi[np.abs(xi).max(axis=1) < 1.0]
    xi = xi.astype(dtype)
    Sj = jlie.sim3_exp(jnp.asarray(xi))
    St = tlie.sim3_exp(torch.from_numpy(xi))
    close(St, Sj, what="sim3_exp", **tol)
    S = npy(Sj).astype(dtype)
    close(tlie.sim3_log(torch.from_numpy(S)), jlie.sim3_log(jnp.asarray(S)),
          what="sim3_log", **tol)
    # round trip where log inverts exp (rotation angle below pi)
    inv = np.linalg.norm(xi[:, 3:6], axis=1) < 3.0
    close(tlie.sim3_log(St)[inv], torch.from_numpy(xi)[inv],
          what="log(exp(xi))", rtol=tol["rtol"],
          atol=1e-9 if dtype == np.float64 else 2e-5)
    close(tlie.sim3_inv(torch.from_numpy(S)), jlie.sim3_inv(jnp.asarray(S)),
          what="sim3_inv", **tol)
    close(tlie.sim3_adj(torch.from_numpy(S)), jlie.sim3_adj(jnp.asarray(S)),
          what="sim3_adj", **tol)
    close(tlie.sim3_scale(torch.from_numpy(S)),
          jlie.sim3_scale(jnp.asarray(S)), what="sim3_scale", **tol)
    for a, b in zip(tlie.sim3_rt(torch.from_numpy(S)),
                    jlie.sim3_rt(jnp.asarray(S))):
        close(a, b, what="sim3_rt", **tol)
    close(tlie.sim3_to_se3(torch.from_numpy(S)),
          jlie.sim3_to_se3(jnp.asarray(S)), what="sim3_to_se3", **tol)
    w, sg = xi[:, 3:6], xi[:, 6]
    if dtype == np.float32:
        # the closed-form W coefficients cancel to O(theta^2) just above the
        # 1e-4 Taylor switch: in float32 both packages are ~2e-6 off the
        # float64 value for theta ~ 0.02, so that band is held in float64
        th = np.linalg.norm(w, axis=1)
        keep = (th < 1e-4) | (th > 0.1)
        w, sg = w[keep], sg[keep]
    close(tlie.sim3_W(torch.from_numpy(w), torch.from_numpy(sg)),
          jlie.sim3_W(jnp.asarray(w), jnp.asarray(sg)), what="sim3_W", **tol)
    R = npy(jlie.so3_exp(jnp.asarray(xi[:, 3:6])))
    close(tlie.rotmat_to_quat(torch.from_numpy(R)),
          jlie.rotmat_to_quat(jnp.asarray(R)), what="rotmat_to_quat", **tol)
    q = np.random.RandomState(1).randn(9, 4).astype(dtype)
    close(tlie.quat_to_rotmat(torch.from_numpy(q)),
          jlie.quat_to_rotmat(jnp.asarray(q)), what="quat_to_rotmat", **tol)
    T = npy(jlie.se3_exp(jnp.asarray(xi[:, :6])))
    equal(tlie.se3_to_sim3(torch.from_numpy(T)), T)


def test_sim3_jacfwd_matches_jax():
    """The pose graph's edge Jacobians (torch.func.jacfwd over a shared
    increment) against jax.jacfwd, float64 atol 1e-10."""
    xi = _xis(3)[:9]
    rng = np.random.RandomState(4)
    Si = npy(jlie.sim3_exp(jnp.asarray(xi)))
    Sj = npy(jlie.sim3_exp(jnp.asarray(xi[::-1] + 0.01 * rng.randn(*xi.shape))))
    Z = npy(jlie.sim3_exp(jnp.asarray(0.1 * rng.randn(*xi.shape))))
    e, Ji, Jj = jax.vmap(jpg._edge_res_jac)(
        jnp.asarray(Si), jnp.asarray(Sj), jlie.sim3_inv(jnp.asarray(Z)))
    et, Jit, Jjt = tpg._edge_res_jac(
        torch.from_numpy(Si), torch.from_numpy(Sj),
        tlie.sim3_inv(torch.from_numpy(Z)))
    for a, b, name in ((et, e, "e"), (Jit, Ji, "Ji"), (Jjt, Jj, "Jj")):
        close(a, b, rtol=0, atol=1e-10, what=name)


@pytest.mark.parametrize("trailing", [(), (3,), (7, 7)])
def test_segment_sum_matches_index_add(trailing):
    """The deterministic scatter-add sums in ascending source order, the
    order of a CPU index_add_ (bitwise equal)."""
    rng = np.random.RandomState(5)
    v = torch.from_numpy(rng.randn(500, *trailing).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 37, 500))
    want = torch.zeros((40,) + trailing).index_add_(0, idx, v)
    equal(segment_sum(v, idx, 40), want)
    equal(segment_sum(v[:0], idx[:0], 4), torch.zeros((4,) + trailing))


def _pnp_problem(seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.randn(80, 3) * np.array([1, 0.8, 0.5])
         + np.array([0, 0, 5.0])).astype(np.float32)
    T_gt = npy(jlie.se3_exp(jnp.asarray(
        [0.2, -0.1, 0.3, 0.04, -0.08, 0.1], jnp.float64))).astype(np.float32)
    K = (280.0, 280.0, 160.0, 160.0)
    Pc = X @ T_gt[:3, :3].T + T_gt[:3, 3]
    uv = np.stack([K[0] * Pc[:, 0] / Pc[:, 2] + K[2],
                   K[1] * Pc[:, 1] / Pc[:, 2] + K[3]], 1).astype(np.float32)
    out = rng.rand(len(X)) < 0.3
    uv[out] += (rng.randn(out.sum(), 2) * 40).astype(np.float32)
    valid = rng.rand(len(X)) < 0.95
    return X, uv, valid, K


def test_pnp_ransac_given_picks_matches():
    """Same picks: pose atol 1e-4 (float32), inlier mask and count equal;
    the port's own draw also finds the pose."""
    X, uv, valid, K = _pnp_problem()
    Tj, mj, nj = jpnp.pnp_ransac(jnp.asarray(X), jnp.asarray(uv),
                                 jnp.asarray(valid), K, KEY, inlier_px=8.0)
    picks = torch.from_numpy(jax_picks(valid, 256, 6, KEY))
    Tt, mt, nt = tpnp.pnp_ransac_from_picks(
        torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(valid),
        K, picks, inlier_px=8.0)
    close(Tt, Tj, rtol=0, atol=1e-4, what="T")
    equal(mt, mj, "inliers")
    assert int(nt) == int(nj)
    g = torch.Generator().manual_seed(0)
    T2, _, n2 = tpnp.pnp_ransac(torch.from_numpy(X), torch.from_numpy(uv),
                                torch.from_numpy(valid), K, g, inlier_px=8.0)
    assert int(n2) == int(nj)
    close(T2, Tj, rtol=0, atol=1e-4, what="T, own draw")


def test_dlt_pose_matches():
    """Minimal sets of 6 distinct exact correspondences (a set with a
    repeated point has no unique DLT solution in either package)."""
    X, _, _, K = _pnp_problem(1)
    T = npy(jlie.se3_exp(jnp.asarray([0.1, 0.2, -0.1, 0.05, 0.02, -0.07])))
    Pc = X @ T[:3, :3].T.astype(np.float32) + T[:3, 3].astype(np.float32)
    xn = (Pc[:, :2] / Pc[:, 2:3]).astype(np.float32)
    rng = np.random.RandomState(3)
    picks = np.stack([rng.choice(len(X), 6, replace=False)
                      for _ in range(16)])
    Tj = jax.vmap(lambda pk: jpnp._dlt_pose(jnp.asarray(X)[pk],
                                            jnp.asarray(xn)[pk]))(
        jnp.asarray(picks))
    Tt = tpnp._dlt_pose(torch.from_numpy(X)[picks], torch.from_numpy(xn)[picks])
    close(Tt, Tj, rtol=0, atol=1e-3, what="DLT poses")


def _sim3_problem(seed=0, n=100, outliers=0.35):
    rng = np.random.RandomState(seed)
    P = (rng.randn(n, 3) * np.array([1.0, 0.8, 0.5])
         + np.array([0, 0, 4.0])).astype(np.float32)
    S_gt = npy(jlie.sim3_exp(jnp.asarray(
        [0.2, 0.1, -0.3, 0.05, 0.1, -0.08, 0.1], jnp.float64))
        ).astype(np.float32)
    Q = (np.c_[P, np.ones(n)] @ S_gt.T)[:, :3].astype(np.float32)
    Qo = Q.copy()
    out = rng.rand(n) < outliers
    Qo[out] += (rng.randn(out.sum(), 3) * 2.0).astype(np.float32)
    return P, Q, Qo, S_gt


def test_umeyama_matches():
    P, Q, _, _ = _sim3_problem()
    w = np.random.RandomState(2).rand(len(P)).astype(np.float32)
    close(tsim.umeyama_sim3(torch.from_numpy(P), torch.from_numpy(Q),
                            torch.from_numpy(w)),
          jsim.umeyama_sim3(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(w)),
          rtol=0, atol=1e-4, what="umeyama")


def test_umeyama_ransac_given_picks_matches():
    P, _, Qo, _ = _sim3_problem()
    valid = np.ones(len(P), bool)
    valid[::17] = False
    Sj, mj, nj = jsim.umeyama_ransac(jnp.asarray(P), jnp.asarray(Qo),
                                     jnp.asarray(valid), KEY)
    picks = torch.from_numpy(jax_picks(valid, 256, 3, KEY))
    St, mt, nt = tsim.umeyama_ransac_from_picks(
        torch.from_numpy(P), torch.from_numpy(Qo), torch.from_numpy(valid),
        picks)
    close(St, Sj, rtol=0, atol=1e-4, what="S")
    equal(mt, mj, "inliers")
    assert int(nt) == int(nj)


def test_refine_sim3_matches():
    """Two refinement passes as LoopClosing runs them: S atol 1e-4, H
    rtol 1e-3, inlier masks equal."""
    P, Q, Qo, _ = _sim3_problem(3, 80, outliers=0.1)
    K = (300.0, 300.0, 160.0, 160.0)
    uv = np.stack([K[0] * Q[:, 0] / Q[:, 2] + K[2],
                   K[1] * Q[:, 1] / Q[:, 2] + K[3]], 1).astype(np.float32)
    S0 = npy(jlie.sim3_exp(jnp.asarray(
        [0.17, 0.02, -0.12, 0.02, 0.07, -0.03, 0.06], jnp.float64))
        ).astype(np.float32)
    m = np.ones(len(P), np.float32)
    m[-7:] = 0.0                                 # padding lanes
    rj = jsim.refine_sim3(jnp.asarray(S0), jnp.asarray(P), jnp.asarray(uv),
                          jnp.asarray(m), jnp.asarray(P), jnp.asarray(Qo),
                          jnp.asarray(m), K, iterations=10)
    rt = tsim.refine_sim3(torch.from_numpy(S0), torch.from_numpy(P),
                          torch.from_numpy(uv), torch.from_numpy(m),
                          torch.from_numpy(P), torch.from_numpy(Qo),
                          torch.from_numpy(m), K, iterations=10)
    close(rt[0], rj[0], rtol=0, atol=1e-4, what="S")
    close(rt[1], rj[1], rtol=1e-3, atol=1e-3 * float(np.abs(npy(rj[1])).max()),
          what="H")
    equal(rt[2], rj[2], "inl2d")
    equal(rt[3], rj[3], "inl3d")
    m2 = m * npy(rj[3]).astype(np.float32)
    rj2 = jsim.refine_sim3(rj[0], jnp.asarray(P), jnp.asarray(uv),
                           jnp.asarray(m2), jnp.asarray(P), jnp.asarray(Qo),
                           jnp.asarray(m2), K, iterations=10)
    rt2 = tsim.refine_sim3(rt[0], torch.from_numpy(P), torch.from_numpy(uv),
                           torch.from_numpy(m2), torch.from_numpy(P),
                           torch.from_numpy(Qo), torch.from_numpy(m2), K,
                           iterations=10)
    close(rt2[0], rj2[0], rtol=0, atol=1e-4, what="S, second pass")
    close(rt2[1], rj2[1], rtol=1e-3,
          atol=1e-3 * float(np.abs(npy(rj2[1])).max()), what="H, second pass")


def _circle_system(n=24, drift=(2e-3, -1e-3, 0.0, 0.0, 0.0, 1.5e-3),
                   sigma=0.003):
    from test_posegraph import _circle_gt, _drifted_odometry
    gt = _circle_gt(n)
    est = _drifted_odometry(gt, np.asarray(drift), sigma)
    S = np.stack(est)
    fixed = np.zeros(n, bool)
    fixed[-1] = True
    ei = np.r_[np.arange(1, n), 0].astype(np.int32)
    ej = np.r_[np.arange(0, n - 1), n - 1].astype(np.int32)
    Z = np.concatenate([np.stack([est[k] @ np.linalg.inv(est[k - 1])
                                  for k in range(1, n)]),
                        (gt[0] @ np.linalg.inv(gt[-1]))[None]])
    info = np.tile(np.eye(7), (n, 1, 1))
    info[-1] *= 3.0
    valid = np.ones(n, bool)
    valid[5] = False
    return gt, est, (S, fixed, ei, ej, Z, info, valid)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_solvers_match(solver):
    """float64, atol 1e-8 on every vertex."""
    _, _, args = _circle_system()
    if solver == "dense":
        Sj = jpg.optimize_pose_graph(*map(jnp.asarray, args), iterations=10)
        St = tpg.optimize_pose_graph(*map(torch.from_numpy, args),
                                     iterations=10)
    else:
        Sj = jpg.optimize_pose_graph_cg(*map(jnp.asarray, args),
                                        iterations=6, cg_iters=60)
        St = tpg.optimize_pose_graph_cg(*map(torch.from_numpy, args),
                                        iterations=6, cg_iters=60)
    assert St.dtype == torch.float64
    close(St, Sj, rtol=0, atol=1e-8, what=solver)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_solvers_match_float32(solver):
    """float32 inputs, which the JAX package's CLI solves (x64 off narrows
    run_pose_graph's arrays to float32): both packages keep the input's
    dtype, vertices within atol 1e-4 (the loop slice's float32 pose
    tolerance). The port's jacfwd once promoted the 0-dim scale of a
    single increment to float64 and raised on float32 input."""
    _, _, args = _circle_system()
    a32 = [a.astype(np.float32) if a.dtype == np.float64 else a
           for a in args]
    if solver == "dense":
        Sj = jpg.optimize_pose_graph(*map(jnp.asarray, a32), iterations=10)
        St = tpg.optimize_pose_graph(*map(torch.from_numpy, a32),
                                     iterations=10)
    else:
        Sj = jpg.optimize_pose_graph_cg(*map(jnp.asarray, a32),
                                        iterations=6, cg_iters=60)
        St = tpg.optimize_pose_graph_cg(*map(torch.from_numpy, a32),
                                        iterations=6, cg_iters=60)
    assert St.dtype == torch.float32 and Sj.dtype == jnp.float32
    close(St, Sj, rtol=0, atol=1e-4, what=solver)


def _drifted_map():
    """The drifted GlobalMap of tests/test_posegraph.py (JAX package)."""
    from ldso_tpu.slam_map import FrameShell, GlobalMap
    gt, est, _ = _circle_system(n=20, sigma=0.004)
    gm = GlobalMap()
    for k in range(len(gt)):
        gm.add_keyframe(FrameShell(id=k, kf_id=k, T_cw=est[k]))
    kfs = gm.get_all_kfs()
    for k in range(1, len(gt)):
        kfs[k].add_pose_rel(k - 1, est[k] @ np.linalg.inv(est[k - 1]))
    kfs[0].add_pose_rel(len(gt) - 1, gt[0] @ np.linalg.inv(gt[-1]),
                        is_loop=True)
    return gm


def test_run_pose_graph_drifted_map_matches():
    """run_pose_graph on the drifted GlobalMap of tests/test_posegraph.py
    (odometry edges from the drifted estimates, one loop edge from ground
    truth), carried into the port with utils/convert: S_cw float64 atol
    1e-8 and the same latest_optimized_kf_id."""
    gm = _drifted_map()
    gt_port = global_map_to_torch(gm)
    jpg.run_pose_graph(gm, iterations=10)
    tpg.run_pose_graph(gt_port, iterations=10, device="cpu",
                       dtype=torch.float64)
    assert gt_port.latest_optimized_kf_id == gm.latest_optimized_kf_id
    for k in gm.keyframes:
        close(gt_port.keyframes[k].S_cw, gm.keyframes[k].S_cw, rtol=0,
              atol=1e-8, what=f"kf {k}")


def test_run_pose_graph_float32_as_the_jax_cli():
    """run_pose_graph's default precision is the JAX package's as its CLI
    runs it: with x64 off, `jnp.asarray` narrows the host arrays, so the
    JAX solve and its S_cw are float32. The port's default matches, S_cw
    float32 within atol 1e-4 (the float32 pose tolerance)."""
    gm = _drifted_map()
    gt_port = global_map_to_torch(gm)
    with jax.enable_x64(False):
        jpg.run_pose_graph(gm, iterations=10)
    tpg.run_pose_graph(gt_port, iterations=10, device="cpu")
    for k in gm.keyframes:
        assert gm.keyframes[k].S_cw.dtype == np.float32
        assert gt_port.keyframes[k].S_cw.dtype == np.float32
        close(gt_port.keyframes[k].S_cw, gm.keyframes[k].S_cw, rtol=0,
              atol=1e-4, what=f"kf {k}")
