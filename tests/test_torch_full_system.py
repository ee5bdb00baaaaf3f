"""The slice as a whole: the port's synchronous FullSystem against the JAX
FullSystem on the same frames (the reduced config of
tests/test_full_system.py: 256x192, 1024-point pools), plus the
keyframe helpers started from one JAX snapshot."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_utils import close, equal, npy, plane_frames, t32

from ldso_tpu.config import Config as JC
from ldso_tpu.system import full_system as jfs
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.system import full_system as tfs
from ldso_tpu_torch.utils import convert

KW = dict(max_points=1024, max_immature=1024,
          tracker_caps=(8192, 4096, 2048, 1024, 512, 256),
          desired_point_density=500, desired_immature_density=400,
          enable_loop_closing=False)
N = 48          # overflows the 7-keyframe window: frame + point marg run


def _centre(T):
    return np.linalg.inv(T)[:3, 3]


@pytest.fixture(scope="module")
def runs():
    calib, poses, imgs, _ = plane_frames(N + 1, 256, 192)
    fj = jfs.FullSystem(calib, JC(**KW))
    fp = tfs.FullSystem(calib, TC(**KW), device="cpu")
    for i in range(N):
        fj.add_active_frame(imgs[i], i, 1.0, i * 0.05)
        fp.add_active_frame(imgs[i], i, 1.0, i * 0.05)
        assert not (fj.is_lost or fp.is_lost or fj.init_failed or fp.init_failed)
    return calib, poses, imgs, fj, fp


def _kf_ids(fs, below=N):
    return [f.id for f in fs.all_frames if f.kf_id >= 0 and f.id < below]


@pytest.mark.parametrize("n", [20, N])
def test_same_keyframes_and_centres(runs, n):
    """Same keyframe ids; camera centres within 1 mm (the trajectory moves
    ~35 mm per frame; float32 rounding differences stay at the um level)."""
    calib, poses, imgs, fj, fp = runs
    assert _kf_ids(fp, n) == _kf_ids(fj, n)
    assert len(_kf_ids(fj, n)) >= 4
    for a, b in zip(fj.all_frames[:n], fp.all_frames[:n]):
        assert a.pose_valid == b.pose_valid
        if a.pose_valid:
            assert np.linalg.norm(_centre(a.T_cw) - _centre(b.T_cw)) < 1e-3, a.id


def test_window_overflow_and_map(runs):
    """Frame and point marginalization both ran, with the same window and
    nearly the same surviving point set; the port's own ATE is within the
    JAX package's 5 mm bound."""
    from test_full_system import sim_align_ate
    calib, poses, imgs, fj, fp = runs
    assert [f.id for f in fp.window_frames] == [f.id for f in fj.window_frames]
    assert len(fp.window_frames) <= KW.get("max_frames", 7)
    nj, nt = fj.ef.pt_valid_np.sum(), fp.ef.pt_valid_np.sum()
    assert abs(int(nj) - int(nt)) <= 0.03 * nj
    rj = sum(len(k.map_points) for k in fj.global_map.get_all_kfs())
    rt = sum(len(k.map_points) for k in fp.global_map.get_all_kfs())
    assert rt > 0 and abs(rt - rj) <= 0.05 * rj
    ids = [f.id for f in fp.all_frames if f.pose_valid]
    _, est = fp.trajectory()
    ate, _ = sim_align_ate(est, [poses[i] for i in ids])
    assert ate < 0.005


def test_keyframe_helpers_from_snapshot(runs):
    """Gate (occupancy splat + distance map + candidate gating), removal
    flags and the tracker-reference splat, from the JAX system's final
    window and arena: decisions exact, idepths within 1e-5 relative."""
    calib, poses, imgs, fj, fp = runs
    nf = len(fj.window_frames)
    newest = nf - 1
    F = fj.ef.F
    W_j = fj.ef.W
    W_t = convert.window_to_torch(W_j)
    arena_t = convert.arena_to_torch(fj.imm_arena)
    T = [fr.T_cw for fr in fj.window_frames]
    K1, Ki0 = calib.K(1), calib.Ki(0)
    KRKis = np.tile(np.eye(3), (F, 1, 1))
    Kts = np.zeros((F, 3))
    for i in range(nf):
        T_rel = T[newest] @ np.linalg.inv(T[i])
        KRKis[i] = K1 @ T_rel[:3, :3] @ Ki0
        Kts[i] = K1 @ T_rel[:3, 3]
    marg = np.asarray([False, True] + [False] * (nf - 2) + [True] * (F - nf))
    cfg_j, cfg_t = fj.cfg, fp.cfg
    w1, h1 = calib.w[1], calib.h[1]
    gj = np.asarray(jfs._gate_candidates_fused(
        W_j, jnp.int32(newest), fj.imm_arena, jnp.asarray(KRKis, jnp.float32),
        jnp.asarray(Kts, jnp.float32), jnp.float32(2.0), jnp.asarray(marg),
        cfg_j, w1, h1))
    to_opt, remove, idm = tfs._gate_candidates_fused(
        W_t, newest, arena_t, t32(KRKis), t32(Kts), 2.0, torch.from_numpy(marg),
        cfg_t, w1, h1)
    equal(to_opt, gj[:, 0] > 0.5, "to_opt")
    equal(remove, gj[:, 1] > 0.5, "remove")
    close(idm, gj[:, 2], 1e-6, 0, "idm")
    assert npy(to_opt).sum() + npy(remove).sum() > 0

    flags = np.zeros(F, bool)
    flags[0] = True
    host_flagged = flags[np.minimum(np.asarray(W_j.pt_host), F - 1)]
    dj, mj = jfs._flag_removal_device(W_j, jnp.asarray(flags),
                                      jnp.asarray(host_flagged),
                                      jnp.int32(newest), jnp.int32(newest - 1))
    dt, mt = tfs._flag_removal(W_t, torch.from_numpy(flags),
                               torch.from_numpy(host_flagged), newest, newest - 1)
    equal(dt, dj, "drop")
    equal(mt, mj, "marg")

    ref_j = jfs._make_tracker_ref_fused(
        W_j, jnp.int32(newest), fj.window_pyrs[newest].dI,
        jnp.float32(fj.window_frames[newest].exposure), calib,
        cfg_j.tracker_caps[:calib.levels])
    fp.ef.W = W_t
    fp.window_frames = list(fp.window_frames[:nf])
    fp.window_pyrs = [convert.pyramid_to_torch(p) for p in fj.window_pyrs]
    fp._update_tracker_ref()
    for lvl in range(calib.levels):
        equal(fp.tracker_ref.valid[lvl], ref_j.valid[lvl], f"ref valid {lvl}")
        close(fp.tracker_ref.points[lvl], ref_j.points[lvl], 1e-5, 1e-6,
              f"ref points {lvl}")


def test_motion_hypotheses_match():
    from ldso_tpu.math import lie_np
    a = lie_np.se3_exp(np.array([0.03, 0.01, -0.02, 0.01, 0.02, -0.01]))
    b = lie_np.se3_exp(np.array([0.02, 0.0, 0.01, 0.0, 0.01, 0.01]))
    hj = jfs._motion_hypotheses(a, b)
    ht = tfs._motion_hypotheses(a, b)
    assert len(ht) == len(hj) == 83
    for x, y in zip(ht, hj):
        equal(x, y)


def test_full_system_carried_between_frames(runs):
    """utils/convert.full_system_to_torch: a JAX FullSystem stopped after
    frame 15 becomes a port FullSystem in the same state (window, HM/bM,
    shells shared by the window, the map and the tracking reference,
    arena, counters), and both then step frames 16-21 alike: the same
    keyframe decisions, camera centres within 5 um (a few float32
    roundings of a 35 mm/frame trajectory)."""
    from ldso_tpu_torch.utils.convert import full_system_to_torch
    calib, poses, imgs, _, _ = runs
    fj = jfs.FullSystem(calib, JC(**KW))
    for i in range(16):
        fj.add_active_frame(imgs[i], i, 1.0, i * 0.05)
    fp = full_system_to_torch(fj, TC(**KW), "cpu")
    equal(fp.ef.W.res_exist, fj.ef.W.res_exist)
    equal(fp.ef.W.idepth, fj.ef.W.idepth)
    equal(fp.imm_arena.pool.idepth_max, fj.imm_arena.pool.idepth_max)
    equal(fp.ef.HM, fj.ef.HM)
    assert [f.id for f in fp.window_frames] == [f.id for f in fj.window_frames]
    assert fp.ef.window_shells is fp.window_frames
    assert all(any(w is a for a in fp.all_frames) for w in fp.window_frames)
    assert fp.tracker_ref_shell is fp.window_frames[-1]
    assert fp.global_map.keyframes[fp.window_frames[-1].kf_id] is \
        fp.window_frames[-1]
    for i in range(16, 22):
        sj = fj.add_active_frame(imgs[i], i, 1.0, i * 0.05)
        st = fp.add_active_frame(imgs[i], i, 1.0, i * 0.05)
        assert (sj.kf_id >= 0) == (st.kf_id >= 0), i
        assert np.linalg.norm(_centre(sj.T_cw) - _centre(st.T_cw)) < 5e-6, i
    assert [f.id for f in fp.window_frames] == [f.id for f in fj.window_frames]


def test_retry_sweep_matches(runs):
    """Force the retrack gate on both systems (an impossibly good last
    RMSE) and compare the rank-then-refine sweep's pose."""
    from ldso_tpu.slam_map import FrameShell as JShell
    from ldso_tpu_torch.slam_map import FrameShell as TShell
    calib, poses, imgs, fj, fp = runs
    # the previous test replaced fp's window state: take it from fj again
    fp.ef.W = convert.window_to_torch(fj.ef.W)
    fp.imm_arena = convert.arena_to_torch(fj.imm_arena)
    fp._publish_tracker_ref((convert.tracker_ref_to_torch(fj.tracker_ref),
                             fj.tracker_ref_shell, None))
    fp.all_frames = list(fj.all_frames)
    fp.window_frames = list(fj.window_frames)
    for fs in (fj, fp):
        fs.last_coarse_rmse = np.full(calib.levels, 1e-9)
    sj = JShell(id=N, timestamp=N * 0.05, exposure=1.0)
    st = TShell(id=N, timestamp=N * 0.05, exposure=1.0)
    fj.all_frames.append(sj)
    fp.all_frames.append(st)
    n0 = fp._n_retry_sweeps
    assert fj._track_new_coarse(sj, imgs[N], commit_trace=False,
                                neighbors=(fj.all_frames[-2], fj.all_frames[-3]))
    assert fp._track_new_coarse(st, t32(imgs[N]))
    assert fp._n_retry_sweeps == n0 + 1
    close(st.T_cw, sj.T_cw, 0, 1e-4, "swept pose")
