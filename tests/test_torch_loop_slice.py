"""The loop slice as a whole, port alone: the port's FullSystem with loop
closing on the 40-frame out-and-back of tests/test_full_system_loop.py
(256x192, loop_kf_gap=4, exposure ramp), rendered by the port, holding
everything that test holds: a loop closes, its edge is in the pose graph,
the pose graph stamped S_cw with scales in (0.5, 2), and after injected
drift the pose graph corrects the loop pairs and residuals without
blowing up the trajectory."""

import numpy as np
import pytest
import torch

import torch_port_utils  # noqa: F401  (one torch thread per worker)
from ldso_tpu_torch.config import Config
from ldso_tpu_torch.loop import posegraph
from ldso_tpu_torch.math import lie
from ldso_tpu_torch.synthetic import PlaneScene, default_calib
from ldso_tpu_torch.system.full_system import FullSystem

LOOP_KW = dict(max_points=1024, max_immature=1024,
               tracker_caps=(8192, 4096, 2048, 1024, 512, 256),
               desired_point_density=500, desired_immature_density=400,
               enable_loop_closing=True, loop_kf_gap=4,
               # mode=1 semantics: free affine, so the exposure ramp drives
               # keyframe 0 out of the window (tests/test_full_system_loop.py)
               affine_opt_mode_a=0.0, affine_opt_mode_b=0.0)
N_LOOP = 40


def out_and_back(n):
    """Drive right then return to the start, same heading throughout
    (tests/test_full_system_loop.py:14-24)."""
    xs = np.concatenate([np.linspace(0, 1.0, n // 2),
                         np.linspace(1.0, 0.0, n - n // 2)])
    poses = []
    for i, x in enumerate(xs):
        T_wc = np.eye(4)
        T_wc[:3, 3] = np.array([x, 0.03 * np.sin(0.3 * i), 0.0])
        poses.append(np.linalg.inv(T_wc))
    return poses


def exposure_gains(n):
    half = n // 2
    return np.exp(np.concatenate([np.linspace(0.0, -0.9, half),
                                  np.linspace(-0.9, 0.0, n - half)]))


def _log(S):
    return lie.sim3_log(torch.as_tensor(np.asarray(S, np.float64))).numpy()


def _exp(xi):
    return lie.sim3_exp(torch.as_tensor(np.asarray(xi, np.float64))).numpy()


@pytest.fixture(scope="module")
def run():
    calib = default_calib(256, 192)
    scene = PlaneScene(freq_hi=30.0, contrast=80.0, n_waves=32)
    poses = out_and_back(N_LOOP)
    gains = exposure_gains(N_LOOP)
    fs = FullSystem(calib, Config(**LOOP_KW))
    for i, T in enumerate(poses):
        img, _ = scene.render(calib, T)
        fs.add_active_frame(img.numpy() * float(gains[i]), i, 1.0, i * 0.05)
        assert not fs.is_lost and not fs.init_failed, f"failed at {i}"
    return fs, poses


def test_loop_closes_and_pgo_stamps(run):
    fs, _ = run
    assert fs.global_map.num_frames() >= 8
    lc = fs.loop_closing
    assert lc is not None and lc.vocab is not None, "vocabulary never trained"
    loops = [(kf.kf_id, oid) for kf in fs.global_map.get_all_kfs()
             for oid, (_, _, il) in kf.pose_rel.items() if il]
    assert lc.n_loops_closed >= 1, "no loop closed on revisit"
    assert loops, "loop edge missing from the pose graph"
    assert sorted(loops) == sorted(lc.loop_pairs)
    ids = {kf.kf_id: kf.id for kf in fs.global_map.get_all_kfs()}
    for a, b in loops:                       # return leg -> out leg
        assert ids[a] >= N_LOOP // 2 > ids[b], (a, b)
    assert fs.global_map.latest_optimized_kf_id >= 0
    for kf in fs.global_map.get_all_kfs():
        assert kf.S_cw is not None
        s = float(np.cbrt(np.linalg.det(kf.get_S_cw()[:3, :3])))
        assert 0.5 < s < 2.0
    assert fs.timer.count["kf.loop"] >= fs.global_map.num_frames() - 1


def test_pose_graph_corrects_injected_drift(run):
    """The drift-correction contract of tests/test_full_system_loop.py:
    inject monocular-style drift into the stored poses and odometry edges
    (loop edges stay as measured), run the pose graph, and require the
    loop pairs' relative poses and the loop-edge residuals to shrink while
    the ATE does not blow up."""
    fs, poses = run
    kfs = fs.global_map.get_all_kfs()
    gt = {kf.id: poses[kf.id] for kf in kfs}
    orig = [kf.T_cw.copy() for kf in kfs]
    D = _exp([4e-3, -3e-3, 2e-3, 1e-3, -5e-4, 8e-4, 3e-3])
    drifted = [orig[0].copy()]
    for k in range(1, len(kfs)):
        drifted.append(D @ orig[k] @ np.linalg.inv(orig[k - 1]) @ drifted[-1])
    index = {kf.kf_id: k for k, kf in enumerate(kfs)}
    for k, kf in enumerate(kfs):
        kf.T_cw = drifted[k]
        kf.S_cw = drifted[k].copy()
        for oid in list(kf.pose_rel.keys()):
            S_rel, info, il = kf.pose_rel[oid]
            if not il:
                kf.pose_rel[oid] = (
                    drifted[k] @ np.linalg.inv(drifted[index[oid]]), info, il)

    def ate(mats):
        est_c = np.stack([np.linalg.inv(T)[:3, 3] for T in mats])
        gt_c = np.stack([np.linalg.inv(gt[kf.id])[:3, 3] for kf in kfs])
        ec, gc = est_c - est_c.mean(0), gt_c - gt_c.mean(0)
        s = np.sqrt((gc ** 2).sum() / max((ec ** 2).sum(), 1e-12))
        U, _, Vt = np.linalg.svd(ec.T @ gc)
        R = (U @ Vt).T
        return float(np.sqrt(np.mean(np.sum((gc - s * (ec @ R.T)) ** 2, 1))))

    loop_edges = [(kf, fs.global_map.keyframes[o], Z) for kf in kfs
                  for o, (Z, _, il) in kf.pose_rel.items()
                  if il and o in fs.global_map.keyframes]
    assert loop_edges

    def loop_residual(pose):
        return max(np.linalg.norm(_log(np.linalg.inv(Z) @ pose(a)
                                       @ np.linalg.inv(pose(b))))
                   for a, b, Z in loop_edges)

    est_c0 = np.stack([np.linalg.inv(T)[:3, 3] for T in orig])
    gt_c0 = np.stack([np.linalg.inv(gt[kf.id])[:3, 3] for kf in kfs])
    ec0, gc0 = est_c0 - est_c0.mean(0), gt_c0 - gt_c0.mean(0)
    s_glob = float(np.sqrt((gc0 ** 2).sum() / max((ec0 ** 2).sum(), 1e-12)))

    def loop_pair_err_vs_gt(pose):
        r = 0.0
        for a, b, _ in loop_edges:
            rel = pose(a) @ np.linalg.inv(pose(b))
            rel[:3, 3] *= s_glob
            rel_gt = gt[a.id] @ np.linalg.inv(gt[b.id])
            r = max(r, float(np.linalg.norm(_log(np.linalg.inv(rel_gt)
                                                 @ rel))))
        return r

    ate_odo = ate(drifted)
    assert ate_odo > 0.01, "drift injection too small to be meaningful"
    res_odo = loop_residual(lambda kf: kf.T_cw)
    pair_odo = loop_pair_err_vs_gt(lambda kf: kf.T_cw)
    posegraph.run_pose_graph(fs.global_map)
    ate_loop = ate([kf.get_S_cw() for kf in kfs])
    pair_loop = loop_pair_err_vs_gt(lambda kf: kf.get_S_cw())
    assert pair_loop < 0.3 * pair_odo, (pair_loop, pair_odo)
    res_loop = loop_residual(lambda kf: kf.get_S_cw())
    assert res_loop < 0.25 * res_odo, (res_loop, res_odo)
    assert ate_loop < 1.5 * ate_odo, (ate_loop, ate_odo)
