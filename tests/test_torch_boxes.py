"""BoxScene, the multi-depth occlusion scene, in the port: its render
against the JAX package's, the scene factory and trajectory helpers, the
port's VO on it, and the port and JAX FullSystems on it side by side."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_utils import close, equal, npy

from ldso_tpu import synthetic as jsyn
from ldso_tpu.math import lie as jlie
from ldso_tpu_torch import synthetic as tsyn


def _pose(xi):
    return np.linalg.inv(np.asarray(jlie.se3_exp(jnp.asarray(np.asarray(xi)))))


@pytest.mark.parametrize("lvl", [0, 1])
@pytest.mark.parametrize("xi", [[0.0] * 6, [0.4, -0.1, 0.2, 0.01, 0.05, -0.02]])
def test_box_render_matches(lvl, xi):
    """Image within 2e-3 of the 0..255 range and inverse depth within 1e-5
    relative wherever both renders hit the same surface; the nearest-hit
    test flips only at box edges that a ray grazes to float32 rounding
    (at most 0.2% of the pixels)."""
    calib = tsyn.default_calib(160, 120)
    T = _pose(xi)
    kw = dict(freq_hi=25.0, contrast=80.0, n_waves=32)
    ij, dj = jsyn.make_scene("boxes", **kw).render(
        calib, jnp.asarray(T, jnp.float32), lvl=lvl, exposure=1.1,
        aff_a=0.05, aff_b=2.0)
    it, dt = tsyn.make_scene("boxes", **kw).render(
        calib, T, lvl=lvl, exposure=1.1, aff_a=0.05, aff_b=2.0)
    ij, dj, it, dt = npy(ij), npy(dj), npy(it), npy(dt)
    same = np.abs(dt - dj) <= 1e-5 * np.abs(dj)
    assert same.mean() >= 0.998
    close(it[same], ij[same], rtol=0, atol=2e-3, what="image")
    assert it.dtype == dt.dtype == np.float32
    assert len(np.unique(np.round(1.0 / np.clip(dt, 1e-6, None), 2))) >= 4


def test_make_scene_and_trajectories():
    assert isinstance(tsyn.make_scene("boxes", freq_hi=25.0, contrast=80.0,
                                      n_waves=32, d=9.0), tsyn.BoxScene)
    assert isinstance(tsyn.make_scene("plane", d=2.0), tsyn.PlaneScene)
    with pytest.raises(ValueError):
        tsyn.make_scene("nope")
    assert tsyn.BoxScene()._boxes()[4].tolist() == \
        jsyn.BoxScene()._boxes()[4].tolist()
    close(tsyn.orbit_trajectory(9), jsyn.orbit_trajectory(9), 0, 1e-6,
          "orbit")
    calib = tsyn.default_calib(64, 48)
    poses = tsyn.orbit_trajectory(3)
    seq = tsyn.render_sequence(tsyn.BoxScene(), calib, poses,
                               exposures=np.array([1.0, 0.9, 1.2]))
    assert seq.shape == (3, 48, 64) and seq.dtype == np.float32
    equal(seq[1], tsyn.BoxScene().render(calib, poses[1], exposure=0.9)[0])


def _lateral_poses(n):
    """tests/test_synthetic_scenes.py:95-101's mostly-lateral path."""
    from ldso_tpu_torch.math import lie_np
    poses = []
    for i in range(n):
        t = np.array([0.03 * i, 0.010 * np.sin(0.2 * i), 0.002 * i])
        w = np.array([0.0, 0.0015 * i, 0.0004 * i])
        poses.append(np.linalg.inv(lie_np.se3_exp(np.concatenate([t, w]))))
    return poses


KW = dict(max_points=1024, max_immature=1024,
          tracker_caps=(8192, 4096, 2048, 1024, 512, 256),
          desired_point_density=500, desired_immature_density=400,
          enable_loop_closing=False)


def test_port_vo_on_boxes():
    """The port's VO on the boxes scene (the JAX package's
    test_vo_e2e_on_boxes, tests/test_synthetic_scenes.py:78, at 20 frames):
    tracked throughout, ATE under 2 cm, and a reconstruction that spans the
    box depths and the background."""
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.io.trajectory import ate_rmse
    from ldso_tpu_torch.system.full_system import FullSystem
    calib = tsyn.default_calib(256, 192)
    scene = tsyn.BoxScene(contrast=80.0, freq_hi=25.0)
    poses = _lateral_poses(20)
    fs = FullSystem(calib, Config(**KW), device="cpu")
    for i, T in enumerate(poses):
        img, _ = scene.render(calib, T)
        fs.add_active_frame(img.numpy(), i, 1.0, i * 0.05)
        assert not fs.is_lost and not fs.init_failed, i
    est = [f for f in fs.all_frames if f.pose_valid]
    assert len(est) >= 0.6 * len(poses)
    assert ate_rmse([f.T_cw for f in est], [poses[f.id] for f in est]) < 0.02
    W = fs.ef.W
    idep = W.idepth[W.pt_valid].numpy()
    idep = idep[idep > 1e-6]
    assert len(idep) > 100
    lo, hi = np.percentile(idep, 5), np.percentile(idep, 95)
    assert hi / lo > 1.5, (lo, hi)


@pytest.mark.slow
def test_same_keyframes_as_jax_on_boxes():
    """The port's and the JAX FullSystem on 30 boxes frames at the reduced
    size of test_torch_full_system.py pick the same keyframes, camera
    centres within 1 mm. Slow: two FullSystems on the CPU."""
    from ldso_tpu.config import Config as JC
    from ldso_tpu.system import full_system as jfs
    from ldso_tpu_torch.config import Config as TC
    from ldso_tpu_torch.system import full_system as tfs
    calib = tsyn.default_calib(256, 192)
    scene = jsyn.BoxScene(contrast=80.0, freq_hi=25.0)
    poses = _lateral_poses(30)
    fj = jfs.FullSystem(calib, JC(**KW))
    fp = tfs.FullSystem(calib, TC(**KW), device="cpu")
    for i, T in enumerate(poses):
        img = np.asarray(scene.render(calib, jnp.asarray(T, jnp.float32))[0])
        fj.add_active_frame(img, i, 1.0, i * 0.05)
        fp.add_active_frame(img, i, 1.0, i * 0.05)
        assert not (fj.is_lost or fp.is_lost)
    kj = [f.id for f in fj.all_frames if f.kf_id >= 0]
    kp = [f.id for f in fp.all_frames if f.kf_id >= 0]
    assert kp == kj and len(kj) >= 4
    for a, b in zip(fj.all_frames, fp.all_frames):
        assert a.pose_valid == b.pose_valid
        if a.pose_valid:
            ca, cb = np.linalg.inv(a.T_cw)[:3, 3], np.linalg.inv(b.T_cw)[:3, 3]
            assert np.linalg.norm(ca - cb) < 1e-3, a.id
