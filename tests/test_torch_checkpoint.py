"""The map checkpoint: io/ldso_binary (the reference's saveAll layout)
against the JAX package's in both directions, and FullSystem.save_all /
load_all after a short port run."""

import dataclasses

import numpy as np
import pytest

from torch_port_utils import equal

from ldso_tpu import slam_map as jmap
from ldso_tpu.io import ldso_binary as jbin
from ldso_tpu_torch import slam_map as tmap
from ldso_tpu_torch.io import ldso_binary as tbin


def _map(mod, seed=4):
    """Four keyframes with ORB records (some with depth), retired points
    (one of them the same as a feature) and Sim(3) edges."""
    rng = np.random.RandomState(seed)
    gm = mod.GlobalMap()
    for k in range(4):
        T = np.eye(4)
        T[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0] * np.sign(
            np.linalg.det(np.linalg.qr(rng.randn(3, 3))[0]))
        T[:3, 3] = rng.randn(3)
        sh = mod.FrameShell(id=5 * k + 1, kf_id=k, T_cw=T)
        n = 6 + k
        sh.feat_uv = (rng.rand(n, 2) * 100).astype(np.float32)
        sh.feat_desc = rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64) \
            .astype(np.uint32)
        sh.feat_angle = rng.rand(n).astype(np.float32)
        sh.feat_idepth = np.where(rng.rand(n) < 0.5, -1.0,
                                  rng.rand(n) + 0.1).astype(np.float32)
        for u, v, d in rng.rand(3, 3):
            sh.map_points.append(mod.MapPointRecord(k, float(u), float(v),
                                                    float(d) + 0.2))
        i = int(np.argmax(sh.feat_idepth))
        sh.map_points.append(mod.MapPointRecord(
            k, float(sh.feat_uv[i, 0]), float(sh.feat_uv[i, 1]),
            float(sh.feat_idepth[i])))
        if k:
            S = np.eye(4)
            S[:3, 3] = rng.randn(3)
            sh.add_pose_rel(k - 1, S * 1.1)
        gm.add_keyframe(sh)
    return gm


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_binary_map_crossloads(tmp_path, writer):
    """A map saved by one package loads in the other, and that package's
    re-save is byte-equal to the first file."""
    src, dst = (tbin, jbin) if writer == "port" else (jbin, tbin)
    first = tmp_path / "a.bin"
    src.save_ldso_binary(_map(tmap if writer == "port" else jmap), str(first))
    back = dst.load_ldso_binary(str(first))
    again = tmp_path / "b.bin"
    dst.save_ldso_binary(back, str(again))
    assert first.read_bytes() == again.read_bytes()
    kfs = back.get_all_kfs()
    assert [k.kf_id for k in kfs] == [0, 1, 2, 3]
    for a, b in zip(kfs, _map(jmap).get_all_kfs()):
        equal(a.T_cw, b.T_cw)
        assert a.id == b.id and sorted(a.pose_rel) == sorted(b.pose_rel)


@pytest.fixture(scope="module")
def port_run():
    """A short port run on the CPU (192x144, loop closing off)."""
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.examples import time_modes
    from ldso_tpu_torch.system.full_system import FullSystem
    calib, poses, images = time_modes.bench_frames(14, 192, 144, "cpu")
    cfg = dataclasses.replace(Config(), enable_loop_closing=False)
    fs = FullSystem(calib, cfg, device="cpu")
    for i, img in enumerate(images):
        fs.add_active_frame(img, i, 1.0, i * 0.05)
    fs.flush_active_points()
    assert fs.global_map.num_frames() >= 3
    return fs


@pytest.mark.parametrize("ext", [".bin", ".map", ".npz"])
def test_save_all_load_all_roundtrip(tmp_path, port_run, ext):
    """save_all then load_all into a fresh system: the keyframes, their
    T_cw (float64 in both formats) and the point cloud come back."""
    from ldso_tpu_torch.system.full_system import FullSystem
    fs = port_run
    path = str(tmp_path / ("map" + ext))
    fs.save_all(path)
    back = FullSystem(fs.calib, fs.cfg, device="cpu")
    back.load_all(path)
    a, b = fs.global_map.get_all_kfs(), back.global_map.get_all_kfs()
    assert [k.kf_id for k in a] == [k.kf_id for k in b]
    assert [k.id for k in a] == [k.id for k in b]
    for x, y in zip(a, b):
        equal(y.T_cw, x.T_cw)
    np.testing.assert_allclose(back.global_map.point_cloud(),
                               fs.global_map.point_cloud(), rtol=1e-6,
                               atol=1e-6)
    if ext == ".npz":
        # the richer snapshot keeps what the binary layout drops
        for x, y in zip(a, b):
            equal(y.get_S_cw(), x.get_S_cw())


def test_load_all_refills_the_database(tmp_path, port_run):
    """With loop closing on and a vocabulary, load_all puts every keyframe
    with ORB descriptors into the retrieval database, as the JAX package's
    load_all does (full_system.py:1741-1747)."""
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.loop.vocab import Vocabulary
    from ldso_tpu_torch.system.full_system import FullSystem
    gm = _map(tmap)
    path = str(tmp_path / "map.npz")
    gm.save(path)
    descs = np.concatenate([kf.feat_desc for kf in gm.get_all_kfs()])
    vocab = Vocabulary.train(descs, k=4, L=2, seed=7)
    fs = FullSystem(port_run.calib, Config(), vocab=vocab, device="cpu")
    assert fs.loop_closing is not None
    fs.load_all(path)
    lc = fs.loop_closing
    assert lc.global_map is fs.global_map
    assert lc._db_order == [0, 1, 2, 3]
    for kf in fs.global_map.get_all_kfs():
        assert kf.bow_vector is not None
