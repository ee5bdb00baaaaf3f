"""The pipelined modes: the port's tracking chain, keyframe split and
pipeline drivers against the JAX package's, on the reduced config of
tests/test_pipeline.py (192x144, 512-point pools)."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_utils import close, equal, npy, t32

from ldso_tpu.config import Config as JC
from ldso_tpu.math import lie
from ldso_tpu.system import full_system as jfs
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.system import full_system as tfs
from ldso_tpu_torch.system.pipeline import AsyncPipeline, DeterministicPipeline
from ldso_tpu_torch.utils import convert
from ldso_tpu_torch.utils.device import HostCopy

KW = dict(max_points=512, max_immature=512,
          tracker_caps=(4096, 2048, 1024, 512, 256, 128),
          desired_point_density=300, desired_immature_density=250,
          enable_loop_closing=False)
N = 18          # tests/test_pipeline.py's lookahead run
N_ASYNC = 20    # and its async run


@pytest.fixture(scope="module")
def frames():
    """uint8 frames of tests/test_pipeline.py's plane trajectory, rendered
    by the JAX package, and their poses."""
    from ldso_tpu.synthetic import PlaneScene, default_calib
    calib = default_calib(192, 144)
    scene = PlaneScene(freq_hi=25.0, contrast=80.0)
    poses, images = [], []
    for i in range(N_ASYNC):
        t = np.array([0.035 * i, 0.01 * np.sin(0.2 * i), 0.003 * i,
                      0.0, 0.0015 * i, 0.0])
        T = np.linalg.inv(np.asarray(lie.se3_exp(jnp.asarray(t))))
        poses.append(T)
        img, _ = scene.render(calib, jnp.asarray(T, jnp.float32))
        images.append(np.clip(np.round(np.asarray(img)), 0,
                              255).astype(np.uint8))
    return calib, poses, images


def _state(fs):
    """Everything a run decides, for bitwise comparison."""
    return ([f.id for f in fs.all_frames if f.kf_id >= 0],
            [(f.id, f.pose_valid, f.T_cw.tobytes(), f.aff.tobytes())
             for f in fs.all_frames],
            fs.ef.HM.tobytes(), fs.ef.pt_valid_np.tobytes())


def _ate(fs, poses):
    from ldso_tpu.io.trajectory import ate_rmse
    fr = [f for f in fs.all_frames if f.pose_valid]
    return ate_rmse([f.T_cw for f in fr], [poses[f.id] for f in fr])


def _run_port(calib, images, driver, n=N):
    fs = tfs.FullSystem(calib, TC(**KW), device="cpu")
    drv = driver(fs)
    for i in range(n):
        drv.add_active_frame(images[i], i, 1.0, i * 0.05)
        assert not fs.is_lost
    if drv is not fs:
        drv.block_until_mapping_is_finished()
    return fs, drv


# --------------------------------------------------------------- the chain
def _chain(T_slast, T_sprelast, aff, rmse):
    return (jfs.TrackChain(*(jnp.asarray(np.asarray(x, np.float32))
                             for x in (T_slast, T_sprelast, aff, rmse))),
            tfs.TrackChain(*(t32(x) for x in (T_slast, T_sprelast, aff, rmse))))


def test_chain_prep_matches():
    """The inputs of tests/test_pipeline.py:153-172; atol 1e-5."""
    rng = np.random.RandomState(3)
    T_ref, T_slast, T_sprelast = (np.asarray(lie.se3_exp(jnp.asarray(
        rng.randn(6) * 0.1))) for _ in range(3))
    cj, ct = _chain(T_slast, T_sprelast, [0.1, -0.2], np.full(6, 2.5))
    oj = jfs._chain_prep(cj, jnp.asarray(T_ref, jnp.float32))
    ot = tfs._chain_prep(ct, t32(T_ref))
    for a, b in zip(ot, oj):
        close(a, b, 0, 1e-5)
    tries = tfs._motion_hypotheses(T_slast @ np.linalg.inv(T_ref),
                                   T_sprelast @ np.linalg.inv(T_slast))
    close(ot[0], tries[0], 0, 1e-5, "hypothesis 0")


@pytest.mark.parametrize("ok", [True, False])
def test_chain_update_matches(ok):
    """The inputs of tests/test_pipeline.py:174-206, tracked and failed;
    atol 1e-5."""
    L = 6
    T_ref = np.asarray(lie.se3_exp(jnp.asarray([0.1, 0, 0, 0, 0, 0.02])))
    T = np.asarray(lie.se3_exp(jnp.asarray([0.02, 0, 0, 0, 0.01, 0])))
    T0 = np.asarray(lie.se3_exp(jnp.asarray([0.5, 0, 0, 0, 0, 0])))
    cj, ct = _chain(np.eye(4), np.eye(4), np.zeros(2), np.full(L, 3.0))
    packed = np.concatenate([T.reshape(-1), [0.3, -0.1],
                             [1.0 if ok else 0.0, 1.0], np.full(L, 1.5),
                             np.zeros(3)])
    oj = jfs._chain_update(cj, jnp.asarray(packed, jnp.float32),
                           jnp.asarray(T0, jnp.float32),
                           jnp.asarray(T_ref, jnp.float32))
    ot = tfs._chain_update(ct, t32(packed), t32(T0), t32(T_ref))
    for a, b in zip(ot, oj):
        close(a, b, 0, 1e-5)
    close(ot.T_slast, (T if ok else T0) @ T_ref, 0, 1e-5)


def test_chain_frame_step_matches(frames):
    """One 192x144 plane frame through the port's chain step and JAX's
    `_frame_step_chain`, from the same chain (its hypothesis 0 the pose
    below, by JAX's `_chain_prep` on the JAX side), the packed vectors
    compared whole at the port's tracker tolerances
    (tests/test_torch_tracker.py): pose 1e-4, affine 1e-3, flags exact,
    residuals and flow 1e-3 relative plus 1e-4."""
    from ldso_tpu.frontend import tracker as jtr
    from ldso_tpu.ops.preprocess import make_pyramid as jmp
    from ldso_tpu.synthetic import PlaneScene
    calib, poses, images = frames
    cfg = JC(**KW)
    L = calib.levels
    _, id0 = PlaneScene(freq_hi=25.0, contrast=80.0).render(
        calib, jnp.asarray(poses[0], jnp.float32))
    ref_j = jtr.make_tracker_ref_from_idepth(
        id0, jmp(jnp.asarray(images[0]), L), calib,
        cfg.tracker_caps[:L], stride=2)
    T0 = poses[2] @ np.linalg.inv(poses[0])
    T0 = np.asarray(lie.se3_exp(jnp.asarray([0.004, -0.002, 0.001, 0.0,
                                             0.001, 0.0]))) @ T0
    # a chain whose hypothesis 0 is T0 against the identity reference
    cj, ct = _chain(np.eye(4), np.linalg.inv(T0), np.zeros(2),
                    np.full(L, np.inf))
    T0j, aff0j, rmse_j = jfs._chain_prep(cj, jnp.eye(4, dtype=jnp.float32))
    _, pk_j = jfs._frame_step_chain(
        jnp.asarray(images[2]), ref_j, T0j, aff0j, jnp.float32(1.0), rmse_j,
        None, calib, cfg, L - 1)
    fs = tfs.FullSystem(calib, TC(**KW), device="cpu")
    pyr, pk_t, _ = fs._chain_step(
        torch.from_numpy(images[2]), convert.tracker_ref_to_torch(ref_j), ct,
        t32(np.r_[np.eye(4).ravel(), 1.0]))
    pk_j, pk_t = npy(pk_j), npy(pk_t)
    assert pk_t.shape == pk_j.shape == (23 + L,)
    atol = np.r_[np.full(16, 1e-4), np.full(2, 1e-3), 0, 0,
                 np.full(L + 3, 1e-4)]
    rtol = np.r_[np.zeros(20), np.full(L + 3, 1e-3)]
    assert np.isclose(pk_t, pk_j, rtol=rtol, atol=atol).all(), (pk_t, pk_j)
    assert pk_t[18] == 1.0 and pk_t[19] == 0.0
    close(pyr.dI[0], jmp(jnp.asarray(images[2]), L).dI[0], 0, 1e-5, "pyramid")


def test_host_copy_on_the_cpu():
    x = torch.arange(5.0)
    h = HostCopy(x)
    assert h.is_ready()
    equal(h.numpy(), np.arange(5.0))


# ------------------------------------------------------- the keyframe split
def test_keyframe_dispatch_then_finish_is_make_keyframe(frames):
    """Driving the hooks by hand (track, decide, make_keyframe_dispatch,
    ready(), finish()) gives bitwise the strict loop's run."""
    calib, poses, images = frames
    strict, _ = _run_port(calib, images, lambda fs: fs, n=N)
    fs = tfs.FullSystem(calib, TC(**KW), device="cpu")
    from ldso_tpu_torch.slam_map import FrameShell
    for i in range(N):
        if not fs.initialized:
            fs.add_active_frame(images[i], i, 1.0, i * 0.05)
            continue
        shell = FrameShell(id=i, timestamp=i * 0.05, exposure=1.0)
        fs.all_frames.append(shell)
        assert fs._track_new_coarse(shell, torch.from_numpy(images[i]))
        pyr = fs._frame_pyr
        if fs._keyframe_decision(shell):
            finish = fs.make_keyframe_dispatch(shell, pyr)
            assert fs.tracker_ref_shell is shell    # published at dispatch
            assert finish.ready()
            finish()
        else:
            fs.make_non_keyframe(shell, pyr)
    assert len(_state(fs)[0]) >= 3
    assert _state(fs) == _state(strict)


# ----------------------------------------------------------- the pipelines
@pytest.fixture(scope="module")
def lookahead_runs(frames):
    calib, poses, images = frames
    return [_run_port(calib, images, DeterministicPipeline) for _ in range(2)]


def test_lookahead_twice_bitwise(lookahead_runs):
    """DeterministicPipeline's contract: two runs, identical bits."""
    (a, _), (b, _) = lookahead_runs
    assert _state(a) == _state(b)


def test_lookahead_matches_jax(frames, lookahead_runs):
    """The port's DeterministicPipeline against the JAX one on 18 frames:
    same keyframe ids, camera centres within 1 mm (the bound of
    tests/test_torch_full_system.py). The JAX run takes about 50 s of CPU
    (its compiles), under the 60 s that would make this a `slow` test."""
    from ldso_tpu.system.pipeline import DeterministicPipeline as JDP
    calib, poses, images = frames
    fj = jfs.FullSystem(calib, JC(**KW))
    pj = JDP(fj, depth=3)
    for i in range(N):
        pj.add_active_frame(images[i], i, 1.0, i * 0.05)
    pj.block_until_mapping_is_finished()
    fp = lookahead_runs[0][0]
    kf = [f.id for f in fp.all_frames if f.kf_id >= 0]
    assert kf == [f.id for f in fj.all_frames if f.kf_id >= 0]
    assert len(kf) >= 3
    for a, b in zip(fj.all_frames, fp.all_frames):
        assert a.pose_valid == b.pose_valid
        if a.pose_valid:
            ca = np.linalg.inv(a.T_cw)[:3, 3]
            cb = np.linalg.inv(b.T_cw)[:3, 3]
            assert np.linalg.norm(ca - cb) < 1e-3, a.id


def test_lookahead_quality(frames, lookahead_runs):
    """The JAX package's bound for lookahead against the strict loop
    (tests/test_pipeline.py:148)."""
    calib, poses, images = frames
    fs = lookahead_runs[0][0]
    strict, _ = _run_port(calib, images, lambda f: f, n=N)
    ate, ate_sync = _ate(fs, poses), _ate(strict, poses)
    assert ate < max(0.01, 3.0 * ate_sync + 1e-4), (ate, ate_sync)


def test_async_linearized_is_strict(frames):
    """AsyncPipeline(linearize_operation=True) runs the strict loop: bitwise
    the same run."""
    calib, poses, images = frames
    strict, _ = _run_port(calib, images, lambda fs: fs, n=12)
    lin, drv = _run_port(calib, images,
                         lambda fs: AsyncPipeline(fs, linearize_operation=True),
                         n=12)
    assert drv.thread is None
    assert _state(lin) == _state(strict)


def test_async_threaded_quality(frames):
    """The threaded pipeline on 20 frames, with the interpreter switching
    threads every 10 us: not lost, >= 3 keyframes, every frame from the bootstrap on posed, ATE
    under the JAX package's 1 cm (tests/test_pipeline.py:86)."""
    calib, poses, images = frames
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        fs, drv = _run_port(calib, images, AsyncPipeline, n=N_ASYNC)
    finally:
        sys.setswitchinterval(old)
    assert not drv.thread.is_alive()
    assert fs.initialized and not fs.is_lost
    assert fs.global_map.num_frames() >= 3
    init = sorted(k.id for k in fs.global_map.get_all_kfs())[1]
    assert all(f.pose_valid for f in fs.all_frames[init:])
    assert not drv.unmapped and not drv.pending
    assert _ate(fs, poses) < 0.01


def test_async_mapping_failure_is_raised(frames):
    """An exception on the mapping thread reaches the caller."""
    calib, poses, images = frames
    fs = tfs.FullSystem(calib, TC(**KW), device="cpu")
    drv = AsyncPipeline(fs)
    boom = RuntimeError("mapping failed")

    def fail(*a, **k):
        raise boom
    i = 0
    while not fs.initialized:
        drv.add_active_frame(images[i], i, 1.0, i * 0.05)
        i += 1
    fs.make_keyframe = fs.make_non_keyframe = fail
    with pytest.raises(RuntimeError, match="mapping failed"):
        for i in range(i, N_ASYNC):
            drv.add_active_frame(images[i], i, 1.0, i * 0.05)
        drv.block_until_mapping_is_finished()
    drv.thread.join(timeout=60)
    assert not drv.thread.is_alive() and drv.exc is boom


def test_tracker_ref_pair_is_one_tuple(frames):
    """The tracking reference is one (ref, shell, event) tuple, swapped
    whole by a publish; the CPU records no event."""
    calib, poses, images = frames
    fs, _ = _run_port(calib, images, lambda f: f, n=10)
    ref, shell, event = fs._tracker_ref_pair
    assert ref is fs.tracker_ref and shell is fs.tracker_ref_shell
    assert shell is fs.window_frames[-1] and event is None
    fs.first_coarse_rmse = 3.0
    fs._publish_tracker_ref((None, fs.all_frames[0], None))
    assert (fs.tracker_ref, fs.tracker_ref_shell) == (None, fs.all_frames[0])
    assert fs.first_coarse_rmse == -1.0
