"""The port's LoopClosing against the JAX package's on the two-visit scene
of tests/test_loop.py, and the port's FullSystem over every Config the
JAX package accepts (the default one constructs; point selections 0 and 2
run against their JAX counterparts)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_utils import plane_frames

from ldso_tpu.config import Config as JC
from ldso_tpu.frontend import detector as jdet
from ldso_tpu.loop.loopclosing import LoopClosing as JLC
from ldso_tpu.math import lie as jlie
from ldso_tpu.ops.preprocess import make_pyramid as jpyr
from ldso_tpu.slam_map import FrameShell as JShell
from ldso_tpu.slam_map import GlobalMap as JMap
from ldso_tpu.synthetic import PlaneScene, default_calib
from ldso_tpu.system import full_system as jfs
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.frontend import detector as tdet
from ldso_tpu_torch.loop.loopclosing import LoopClosing as TLC
from ldso_tpu_torch.ops.preprocess import make_pyramid as tpyr
from ldso_tpu_torch.slam_map import FrameShell as TShell
from ldso_tpu_torch.slam_map import GlobalMap as TMap
from ldso_tpu_torch.system import full_system as tfs
from ldso_tpu_torch.utils import convert


def _sim3_err(A, B):
    return float(np.linalg.norm(np.asarray(jlie.sim3_log(jnp.asarray(
        np.linalg.inv(A) @ B)))))


@pytest.fixture(scope="module")
def two_visits():
    """The tour of tests/test_loop.py:160-215 (ten distinct views, then a
    revisit near view 0), rendered once by the JAX renderer; each package
    detects its own features on the same frames, with ground-truth idepths
    at the feature pixels."""
    calib = default_calib(320, 240)
    scene = PlaneScene(freq_hi=45.0, contrast=80.0, n_waves=40)
    views = [np.asarray(jlie.se3_exp(jnp.asarray(np.array(
        [0.8 * i, 0.15 * i, 0.0, 0.0, 0.04 * i, 0.0]))), np.float64)
        for i in range(10)]
    T_loop = np.asarray(jlie.se3_exp(jnp.asarray(
        [0.05, -0.02, 0.01, 0.004, -0.01, 0.003])), np.float64) @ views[0]
    frames = []
    for T in views + [T_loop]:
        img, idep = scene.render(calib, jnp.asarray(T, jnp.float32))
        frames.append((T, np.asarray(img, np.float32),
                       np.asarray(idep, np.float32)))
    return calib, views, T_loop, frames


def _shell(cls, kf_id, T, feats, idep, desc):
    valid = np.asarray(feats["valid"]) & np.asarray(feats["is_corner"])
    sel = np.nonzero(valid)[0]
    u = np.asarray(feats["u"])[sel]
    v = np.asarray(feats["v"])[sel]
    kf = cls(id=kf_id, kf_id=kf_id, T_cw=np.asarray(T, np.float64))
    kf.feat_uv = np.stack([u, v], 1)
    kf.feat_desc = desc[sel]
    kf.feat_angle = np.asarray(feats["angle"])[sel].astype(np.float32)
    kf.feat_idepth = idep[v.astype(int), u.astype(int)]
    return kf


def _jax_kf(calib, k, T, img, idep):
    pyr = jpyr(jnp.asarray(img), calib.levels)
    f = jdet.detect_corners(pyr.dI[0], pyr.abs_grad[0], 500)
    return _shell(JShell, k, T, f, idep, np.asarray(f["desc"]))


def _port_kf(calib, k, T, img, idep):
    pyr = tpyr(torch.from_numpy(img), calib.levels)
    f = {n: t.numpy() for n, t in tdet.detect_corners(
        pyr.dI[0], pyr.abs_grad[0], 500).items()}
    return _shell(TShell, k, T, f, idep, f["desc"].astype(np.uint32))


def test_two_visit_loop_matches_jax(two_visits):
    """Both packages, each driven from the same rendered keyframes, close
    the revisit against kf 0; the port's S_rel lies within
    |sim3_log(S_jax^-1 S_port)| < 1e-3 of JAX's, both within 0.02 of the
    ground truth. The port's features are the JAX package's: same pixels,
    and descriptors equal up to a bounded number of flipped bits (an
    orientation one float32 ulp off flips a test whose rotated offset sits
    on an integer; given JAX's angles the descriptors are exact,
    test_torch_loop_features.py)."""
    calib, views, T_loop, frames = two_visits
    S_gt = T_loop @ np.linalg.inv(views[0])
    out = {}
    for name, LC, Map, Cfg, make, kw in (
            ("jax", JLC, JMap, JC, _jax_kf, {}),
            ("port", TLC, TMap, TC, _port_kf, {"device": "cpu"})):
        gm = Map()
        lc = LC(calib, Cfg(loop_kf_gap=3), gm, **kw)
        kfs = []
        for k, (T, img, idep) in enumerate(frames):
            kf = make(calib, k, T, img, idep)
            gm.add_keyframe(kf)
            kfs.append(kf)
            closed = lc.insert_keyframe(kf, window_kf_ids=[k])
        assert closed, f"{name}: loop not closed on the revisit"
        loops = {o: S for o, (S, _, il) in kfs[-1].pose_rel.items() if il}
        assert list(loops) == [0], f"{name}: matched {list(loops)}"
        assert _sim3_err(S_gt, loops[0]) < 0.02
        out[name] = (kfs, loops[0], lc)
    flipped = feats = bits = 0
    for a, b in zip(out["jax"][0], out["port"][0]):
        np.testing.assert_array_equal(b.feat_uv, a.feat_uv)
        np.testing.assert_allclose(b.feat_angle, a.feat_angle, rtol=0,
                                   atol=1e-5)
        x = np.bitwise_xor(b.feat_desc, a.feat_desc)
        flipped += int(np.unpackbits(x.view(np.uint8)).sum())
        feats += int((x != 0).any(axis=1).sum())
        bits += x.size * 32
    # measured: 15 bits in 4 of ~2300 features over the 11 keyframes
    assert flipped <= 1e-3 * bits and feats <= 0.01 * bits / 256, \
        (flipped, feats)
    assert out["port"][2]._db_order == out["jax"][2]._db_order
    assert _sim3_err(out["jax"][1], out["port"][1]) < 1e-3


def test_loop_closing_from_jax_state(two_visits):
    """The port's LoopClosing started from the JAX package's state (its
    vocabulary and global map carried over by utils/convert) closes the
    same revisit with the same edge (within 1e-3)."""
    calib, views, T_loop, frames = two_visits
    gm = JMap()
    lc = JLC(calib, JC(loop_kf_gap=3), gm)
    for k, (T, img, idep) in enumerate(frames[:-1]):
        kf = _jax_kf(calib, k, T, img, idep)
        gm.add_keyframe(kf)
        lc.insert_keyframe(kf, window_kf_ids=[k])
    assert lc.vocab is not None
    tgm = convert.global_map_to_torch(gm)
    tlc = TLC(calib, TC(loop_kf_gap=3), tgm,
              vocab=convert.vocabulary_to_torch(lc.vocab), device="cpu")
    for kid in lc._db_order:
        tlc._add_to_db(tgm.keyframes[kid])
    assert tlc._db_order == lc._db_order
    kj = _jax_kf(calib, 10, *frames[-1])
    kt = convert.frame_shell_to_torch(kj)
    for g, kf, l in ((gm, kj, lc), (tgm, kt, tlc)):
        g.add_keyframe(kf)
        assert l.insert_keyframe(kf, window_kf_ids=[10])
    assert tlc.loop_pairs == lc.loop_pairs == [(10, 0)]
    assert _sim3_err(kj.pose_rel[0][0], kt.pose_rel[0][0]) < 1e-3


def test_default_config_constructs():
    """FullSystem(calib, Config()) builds with loop closing on."""
    from ldso_tpu_torch.synthetic import default_calib as tdc
    fs = tfs.FullSystem(tdc(64, 48), TC(), device="cpu")
    assert fs.loop_closing is not None and fs.loop_closing.vocab is None
    assert fs.cfg.point_selection == 1


KW = dict(max_points=1024, max_immature=1024,
          tracker_caps=(8192, 4096, 2048, 1024, 512, 256),
          desired_point_density=500, desired_immature_density=400,
          enable_loop_closing=False)
N_SEL = 14


@pytest.mark.parametrize("point_selection", [0, 2])
def test_point_selection_runs_like_jax(point_selection):
    """The DSO gradient selector (0) and random selection (2) through both
    FullSystems on the same frames: same keyframes, camera centres within
    1 mm, and the keyframes made after the bootstrap select the same
    number of candidates."""
    calib, poses, imgs, _ = plane_frames(N_SEL, 256, 192)
    kw = dict(KW, point_selection=point_selection)
    fj = jfs.FullSystem(calib, JC(**kw))
    fp = tfs.FullSystem(calib, TC(**kw), device="cpu")
    for i in range(N_SEL):
        fj.add_active_frame(imgs[i], i, 1.0, i * 0.05)
        fp.add_active_frame(imgs[i], i, 1.0, i * 0.05)
        assert not (fj.is_lost or fp.is_lost or fj.init_failed
                    or fp.init_failed)
    kj = [f.id for f in fj.all_frames if f.kf_id >= 0]
    kp = [f.id for f in fp.all_frames if f.kf_id >= 0]
    assert kp == kj and len(kp) >= 3
    for a, b in zip(fj.all_frames, fp.all_frames):
        assert a.pose_valid == b.pose_valid
        if a.pose_valid:
            ca, cb = np.linalg.inv(a.T_cw)[:3, 3], np.linalg.inv(b.T_cw)[:3, 3]
            assert np.linalg.norm(ca - cb) < 1e-3, a.id
    nj = int(np.asarray(fj.imm_arena.pool.valid).sum())
    nt = int(fp.imm_arena.pool.valid.sum())
    assert nt > 0 and abs(nt - nj) <= 0.03 * nj
