"""Tests that need a CUDA card: the port's hand-written kernels against
their plain PyTorch versions, and the main path on the card against the
same path on the CPU. They skip where there is no card.

This file imports neither jax nor ldso_tpu, so it also runs on a machine
without JAX, where tests/conftest.py (which imports jax) cannot load:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py
"""

import contextlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


# the main path's map, KITTI's (1241x376 input), 1280x1024 and 1920x1080
# inputs, a 1000x1000 map (above one block's shared memory as bytes), and
# widths that are not a multiple of 32
@pytest.mark.parametrize("shape", [(240, 320), (96, 128), (61, 97),
                                   (188, 620), (512, 640), (540, 960),
                                   (1000, 1000)])
def test_distance_kernel_matches_plain(cuda, shape):
    """Exact (atol 0) at every occupancy and sweep count."""
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.ops.distance_map import distance_transform_ref
    rng = np.random.RandomState(8)
    before = cuda_kernels.LAUNCHES["distance_transform"]
    for p in (0.0, 0.005, 0.02, 0.1, 1.0):
        occ = torch.from_numpy(rng.rand(*shape) < p).to(cuda)
        for max_k in (1, 2, 18, 40):
            got = cuda_kernels.distance_transform(occ, max_k)
            want = distance_transform_ref(occ, max_k)
            assert torch.equal(got, want), (shape, p, max_k)
        got8 = cuda_kernels.distance_transform(occ.to(torch.uint8), 18)
        assert torch.equal(got8, distance_transform_ref(occ, 18))
    assert cuda_kernels.LAUNCHES["distance_transform"] == before + 25


@pytest.mark.parametrize("band", [1, 2, 4, 8])
def test_distance_kernel_any_band_is_exact(cuda, band):
    """The band height changes only how the rows are split among blocks:
    a map of band x (SM count) rows is planned at that band."""
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.ops.distance_map import distance_transform_ref
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    H, W = band * n_sm, 97
    occ = torch.from_numpy(np.random.RandomState(9).rand(H, W) < 0.02)
    for max_k in (2, 18, 40):
        assert cuda_kernels.distance_plan(H, W, max_k, n_sm)[0] == band
        got = cuda_kernels.distance_transform(occ.to(cuda), max_k)
        assert torch.equal(got.cpu(), distance_transform_ref(occ, max_k))


def test_distance_kernel_refuses_what_it_cannot_take(cuda):
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.ops.distance_map import distance_transform_ref
    big = torch.zeros(1000, 1000, dtype=torch.bool, device=cuda)
    big[500, 500] = True
    assert torch.equal(cuda_kernels.distance_transform(big, 18),
                       distance_transform_ref(big, 18))
    with pytest.raises(ValueError, match="shared memory"):
        cuda_kernels.distance_transform(
            torch.zeros(8, 100000, dtype=torch.bool, device=cuda), 40)
    with pytest.raises(ValueError, match="non-empty"):
        cuda_kernels.distance_transform(
            torch.zeros(0, 8, dtype=torch.bool, device=cuda), 18)
    with pytest.raises(ValueError):
        cuda_kernels.distance_transform(
            torch.zeros(8, 8, dtype=torch.float32, device=cuda), 18)
    with pytest.raises(ValueError):
        cuda_kernels.distance_transform(
            torch.zeros(8, 8, dtype=torch.bool, device=cuda), 300)
    with pytest.raises(ValueError):
        cuda_kernels.distance_transform(
            torch.zeros(8, 16, dtype=torch.bool, device=cuda)[:, ::2], 18)


def test_full_system_defaults_to_the_card(cuda):
    """FullSystem(calib, cfg) with no device places its tensors on the
    card, and so does its loop closer."""
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.synthetic import default_calib
    from ldso_tpu_torch.system.full_system import FullSystem
    fs = FullSystem(default_calib(64, 48), Config())
    assert fs.device.type == "cuda"
    for t in (fs.ef.W.idepth, fs.imm_arena.pool.u, fs.dIs,
              fs.selector.random_pattern):
        assert t.device.type == "cuda"
    assert fs.loop_closing.device.type == "cuda"


def test_main_path_card_matches_cpu(cuda):
    """20 frames of the reduced 256x192 config on the card and on the CPU:
    same keyframes, camera centres within 1 mm."""
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.math import lie_np
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.synthetic import PlaneScene, default_calib
    from ldso_tpu_torch.system.full_system import FullSystem
    cfg = Config(max_points=1024, max_immature=1024,
                 tracker_caps=(8192, 4096, 2048, 1024, 512, 256),
                 desired_point_density=500, desired_immature_density=400,
                 enable_loop_closing=False)
    calib = default_calib(256, 192)
    scene = PlaneScene(freq_hi=25.0, contrast=80.0)
    imgs = []
    for i in range(20):
        t = np.array([0.035 * i, 0.012 * np.sin(0.2 * i), 0.004 * i])
        w = np.array([0.0, 0.002 * i, 0.0005 * i])
        T = np.linalg.inv(lie_np.se3_exp(np.concatenate([t, w])))
        imgs.append(scene.render(calib, T)[0].numpy())
    runs = {}
    for dev in ("cpu", "cuda"):
        fs = FullSystem(calib, cfg, device=dev)
        n0 = cuda_kernels.LAUNCHES["distance_transform"]
        for i, im in enumerate(imgs):
            fs.add_active_frame(im, i, 1.0, i * 0.05)
            assert not fs.is_lost and not fs.init_failed
        runs[dev] = (fs, cuda_kernels.LAUNCHES["distance_transform"] - n0)
    (fc, lc), (fg, lg) = runs["cpu"], runs["cuda"]
    assert lc == 0 and lg > 0
    kf = lambda fs: [f.id for f in fs.all_frames if f.kf_id >= 0]  # noqa: E731
    assert kf(fg) == kf(fc)
    for a, b in zip(fc.all_frames, fg.all_frames):
        if a.pose_valid:
            ca, cb = np.linalg.inv(a.T_cw)[:3, 3], np.linalg.inv(b.T_cw)[:3, 3]
            assert np.linalg.norm(ca - cb) < 1e-3


def test_segment_sum_card_matches_cpu_bitwise(cuda):
    """The deterministic scatter-add: the card sums each destination in
    ascending source order like the CPU, so the results are bitwise equal
    and equal across repeats."""
    from ldso_tpu_torch.ops.scatter import segment_sum
    g = torch.Generator().manual_seed(3)
    v = torch.randn(20000, 3, generator=g) * 100.0
    idx = torch.randint(0, 97, (20000,), generator=g)
    want = segment_sum(v, idx, 100)
    for _ in range(5):
        got = segment_sum(v.to(cuda), idx.to(cuda), 100)
        assert torch.equal(got.cpu(), want)


def test_loop_stack_card_matches_cpu(cuda):
    """ORB features, descriptor distances and the pose graph on the card
    against the same functions on the CPU: corners exact, at most a few
    flipped descriptor bits (cos/sin differ in the last ulp between the
    two), Hamming distances exact, pose graph within 1e-9 (float64)."""
    from ldso_tpu_torch.frontend import detector
    from ldso_tpu_torch.loop import posegraph
    from ldso_tpu_torch.math import lie
    from ldso_tpu_torch.ops.preprocess import make_pyramid
    from ldso_tpu_torch.synthetic import PlaneScene, default_calib
    calib = default_calib(640, 480)
    img, _ = PlaneScene(freq_hi=25.0, contrast=80.0, n_waves=32).render(
        calib, np.eye(4))
    img = torch.round(img)
    out = {}
    for dev in ("cpu", "cuda"):
        pyr = make_pyramid(img.to(dev), calib.levels)
        out[dev] = {k: t.cpu() for k, t in detector.detect_corners(
            pyr.dI[0], pyr.abs_grad[0], 2000).items()}
    a, b = out["cpu"], out["cuda"]
    for k in ("u", "v", "valid", "is_corner"):
        assert torch.equal(a[k], b[k]), k
    assert torch.allclose(a["angle"], b["angle"], rtol=0, atol=1e-5)
    x = detector.desc_to_numpy(a["desc"]) ^ detector.desc_to_numpy(b["desc"])
    assert np.unpackbits(x.view(np.uint8)).sum() <= 1e-3 * x.size * 32
    d = detector.hamming_matrix(a["desc"][:300].to(cuda),
                                a["desc"][:400].to(cuda)).cpu()
    assert torch.equal(d, detector.hamming_matrix(a["desc"][:300],
                                                  a["desc"][:400]))

    n = 40
    rng = np.random.RandomState(0)
    xi = torch.from_numpy(rng.randn(n, 7) * 0.05)
    S = lie.sim3_exp(xi)
    ei = torch.arange(1, n)
    ej = torch.arange(0, n - 1)
    Z = S[ei] @ lie.sim3_inv(S[ej]) @ lie.sim3_exp(
        torch.from_numpy(rng.randn(n - 1, 7) * 0.01))
    fixed = torch.zeros(n, dtype=torch.bool)
    fixed[-1] = True
    args = (S, fixed, ei, ej, Z, torch.eye(7, dtype=torch.float64).expand(
        n - 1, 7, 7).contiguous(), torch.ones(n - 1, dtype=torch.bool))
    want = posegraph.optimize_pose_graph(*args, iterations=5)
    got = posegraph.optimize_pose_graph(*[t.to(cuda) for t in args],
                                        iterations=5)
    assert torch.allclose(got.cpu(), want, rtol=0, atol=1e-9)


def test_cross_stream_handoff_matches_one_stream(cuda):
    """A pyramid made on one stream and read on another, with the hand-off
    of the pipelines (an event, and record_stream so that the producer's
    next allocations do not reuse its memory), equals the same pyramid made
    and read on one stream. The producer is kept busy (a sleeping kernel
    ahead of the pyramid) so that a missing wait or a reused block would
    show."""
    from ldso_tpu_torch.ops.preprocess import make_pyramid
    from ldso_tpu_torch.system.full_system import use_on_current_stream
    from ldso_tpu_torch.utils.device import record_event
    g = torch.Generator(cuda).manual_seed(0)
    img = torch.rand((480, 640), generator=g, device=cuda) * 255.0
    want = [t.clone() for t in make_pyramid(img, 6).dI]
    track, mapping = torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)
    track.wait_stream(torch.cuda.current_stream(cuda))
    for _ in range(5):
        with torch.cuda.stream(track):
            torch.cuda._sleep(20_000_000)
            pyr = make_pyramid(img, 6)
            ev = record_event(img.device)
        with torch.cuda.stream(mapping):
            use_on_current_stream(pyr, ev, img.device)
            got = [t * 1.0 for t in pyr.dI]
        del pyr
        with torch.cuda.stream(track):
            junk = [torch.full_like(t, -1.0) for t in want]  # noqa: F841
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _pipeline_frames(n):
    from ldso_tpu_torch.math import lie_np
    from ldso_tpu_torch.synthetic import PlaneScene, default_calib
    calib = default_calib(192, 144)
    scene = PlaneScene(freq_hi=25.0, contrast=80.0)
    poses, imgs = [], []
    for i in range(n):
        t = np.array([0.035 * i, 0.01 * np.sin(0.2 * i), 0.003 * i,
                      0.0, 0.0015 * i, 0.0])
        T = np.linalg.inv(lie_np.se3_exp(t))
        poses.append(T)
        imgs.append(torch.clamp(torch.round(scene.render(calib, T)[0]), 0,
                                255).to(torch.uint8).numpy())
    return calib, poses, imgs


def _pipeline_cfg():
    from ldso_tpu_torch.config import Config
    return Config(max_points=512, max_immature=512,
                  tracker_caps=(4096, 2048, 1024, 512, 256, 128),
                  desired_point_density=300, desired_immature_density=250,
                  enable_loop_closing=False)


def test_async_pipeline_on_the_card(cuda, monkeypatch):
    """20 frames through AsyncPipeline on the card: not lost, >= 3
    keyframes, ATE under 1 cm, and every distance-map kernel launched on
    the mapping thread's stream (each activation pass's replay, whose
    graph holds K1's one launch, on the stream it replays on)."""
    from ldso_tpu_torch.examples import time_modes
    from ldso_tpu_torch.system.full_system import FullSystem
    from ldso_tpu_torch.system.pipeline import AsyncPipeline
    calib, poses, imgs = _pipeline_frames(20)
    fs = FullSystem(calib, _pipeline_cfg())
    with time_modes.traced_k1() as k1:
        drv = AsyncPipeline(fs)
        for i, im in enumerate(imgs):
            drv.add_active_frame(im, i, 1.0, i * 0.05)
        drv.block_until_mapping_is_finished()
    streams = {s for _, s in k1}
    assert fs.initialized and not fs.is_lost
    kfs = fs.global_map.get_all_kfs()
    assert len(kfs) >= 3
    boot = sorted(k.id for k in kfs)[1]
    # bootstrap keyframes run on the caller's thread under the mapping
    # stream, the later ones on the mapping thread
    assert streams and streams == {drv.map_stream.cuda_stream}
    assert all(f.pose_valid for f in fs.all_frames[boot:])
    ate = _tracked_ate(fs, poses)
    assert ate < 0.01, ate


def _tracked_ate(fs, poses):
    from ldso_tpu_torch.io.trajectory import ate_rmse
    fr = [f for f in fs.all_frames if f.pose_valid]
    return ate_rmse([f.T_cw for f in fr], [poses[f.id] for f in fr])


def _late_card_frames(imgs, cuda):
    """Each frame as a tensor on the card that the caller's stream writes
    behind a sleeping kernel (~3 ms), over a zeroed block: a stream that
    reads it without waiting for the caller's sees zeros. Each frame drops
    the previous one, so the allocator may hand its block to the next
    frame's zeros unless the readers' streams were recorded on it."""
    for im in imgs:
        src = torch.from_numpy(im).to(cuda)
        img = torch.zeros_like(src)
        torch.cuda._sleep(5_000_000)
        img.copy_(src)
        yield img
        del img


def test_async_pipeline_takes_card_frames_from_the_callers_stream(cuda):
    """The CLI's async path: frames made on the card on the caller's stream
    (as ImageFolderReader.get_image makes them) cross to the tracking and
    mapping streams. 20 late frames through the threaded AsyncPipeline
    track as well as the host frames of test_async_pipeline_on_the_card:
    not lost, >= 3 keyframes, ATE under 1 cm."""
    from ldso_tpu_torch.system.full_system import FullSystem
    from ldso_tpu_torch.system.pipeline import AsyncPipeline
    calib, poses, imgs = _pipeline_frames(20)
    fs = FullSystem(calib, _pipeline_cfg())
    drv = AsyncPipeline(fs)
    for i, img in enumerate(_late_card_frames(imgs, cuda)):
        drv.add_active_frame(img, i, 1.0, i * 0.05)
    drv.block_until_mapping_is_finished()
    assert fs.initialized and not fs.is_lost
    assert len(fs.global_map.get_all_kfs()) >= 3
    ate = _tracked_ate(fs, poses)
    assert ate < 0.01, ate


def test_linearized_async_on_late_card_frames_matches_one_stream(cuda):
    """AsyncPipeline(linearize_operation=True) maps every frame on its
    mapping stream; fed the late card frames, it gives bitwise the poses
    and keyframes of the strict loop fed the same frames from the host on
    the caller's stream."""
    from ldso_tpu_torch.system.full_system import FullSystem
    from ldso_tpu_torch.system.pipeline import AsyncPipeline
    calib, _, imgs = _pipeline_frames(18)
    one = FullSystem(calib, _pipeline_cfg())
    for i, im in enumerate(imgs):
        one.add_active_frame(im, i, 1.0, i * 0.05)
    fs = FullSystem(calib, _pipeline_cfg())
    drv = AsyncPipeline(fs, linearize_operation=True)
    for i, img in enumerate(_late_card_frames(imgs, cuda)):
        drv.add_active_frame(img, i, 1.0, i * 0.05)
    drv.block_until_mapping_is_finished()
    want = [(f.id, f.kf_id, f.T_cw.tobytes()) for f in one.all_frames]
    got = [(f.id, f.kf_id, f.T_cw.tobytes()) for f in fs.all_frames]
    assert got == want
    assert sum(1 for _, k, _ in want if k >= 0) >= 3


def test_lookahead_twice_bitwise_on_the_card(cuda):
    """DeterministicPipeline's contract on the card: two runs of 18 frames
    give the same keyframes and bitwise the same poses."""
    from ldso_tpu_torch.system.full_system import FullSystem
    from ldso_tpu_torch.system.pipeline import DeterministicPipeline
    calib, poses, imgs = _pipeline_frames(18)
    runs = []
    for _ in range(2):
        fs = FullSystem(calib, _pipeline_cfg())
        drv = DeterministicPipeline(fs)
        for i, im in enumerate(imgs):
            drv.add_active_frame(im, i, 1.0, i * 0.05)
        drv.block_until_mapping_is_finished()
        assert not fs.is_lost
        runs.append([(f.id, f.kf_id, f.T_cw.tobytes()) for f in fs.all_frames])
    assert runs[0] == runs[1]
    assert sum(1 for _, k, _ in runs[0] if k >= 0) >= 3


def _same(a, b):
    """Bitwise equality of bool, 32-bit or 64-bit tensors (0-d ones too),
    NaN payloads included."""
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32))


def _tracked_system(n=12):
    """A card FullSystem over the first n pipeline frames, and the inputs
    of one more track against its tracking reference."""
    from ldso_tpu_torch.frontend import track_graph
    from ldso_tpu_torch.ops.preprocess import make_pyramid, upload_image
    from ldso_tpu_torch.system.full_system import FullSystem
    calib, poses, imgs = _pipeline_frames(n + 1)
    before = dict(track_graph.CAPTURES)
    fs = FullSystem(calib, _pipeline_cfg())
    built = track_graph.CAPTURES["count"]
    for i, im in enumerate(imgs[:n]):
        fs.add_active_frame(im, i, 1.0, i * 0.05)
    assert fs.initialized and not fs.is_lost
    # the constructor captured what the run needed, the run captured nothing
    assert built >= before["count"]
    assert track_graph.CAPTURES["count"] == built
    ref, shell = fs._current_tracker_ref()
    L = calib.levels
    f32 = dict(dtype=torch.float32, device=fs.device)
    # start from the last tracked frame's pose, as the strict loop's
    # identity-velocity guess would
    T0 = torch.as_tensor(fs.all_frames[-1].T_cw @ np.linalg.inv(shell.T_cw),
                         **f32)
    pyr = make_pyramid(upload_image(imgs[n], fs.device), L)
    args = (torch.zeros(2, **f32), torch.ones((), **f32),
            torch.full((L,), 1e9, **f32))
    return fs, imgs, ref, pyr, T0, args


def test_tracker_graph_equals_eager_on_the_card(cuda):
    """The captured tracker replays bitwise what the eager masked function
    computes, at batch 1 and at the retry path's batch."""
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.system.full_system import RETRY_K
    fs, _, ref, pyr, T0, args = _tracked_system()
    Tb = T0.expand(RETRY_K, 4, 4).clone()
    Tb[1:, 0, 3] += torch.linspace(-0.02, 0.02, RETRY_K - 1, device=cuda)
    L = fs.calib.levels
    for T in (T0[None], Tb):
        got = tracker.track_frame_hypotheses(ref, pyr, T, *args, fs.calib,
                                             fs.cfg, L - 1)
        want = tracker._track_batch(ref, pyr, T, *args, fs.calib, fs.cfg,
                                    L - 1)
        for g, w in zip(got, want):
            assert _same(g, w)
    assert bool(got[2][0])


def test_tracker_graph_shared_by_two_streams(cuda):
    """Two streams replay one graph at once, the first behind a sleeping
    kernel: each result equals its own eager track (the replay waits for
    the other stream's use of the graph's buffers)."""
    from ldso_tpu_torch.frontend import tracker
    fs, _, ref, pyr, T0, args = _tracked_system()
    L = fs.calib.levels
    T1 = T0.clone()
    T1[0, 3] += 0.01
    want = [tracker._track_batch(ref, pyr, T[None], *args, fs.calib, fs.cfg,
                                 L - 1) for T in (T0, T1)]
    a, b = torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)
    a.wait_stream(torch.cuda.current_stream(cuda))
    b.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(a):
        torch.cuda._sleep(50_000_000)
        got_a = tracker.track_frame(ref, pyr, T0, *args, fs.calib, fs.cfg,
                                    L - 1)
    with torch.cuda.stream(b):
        got_b = tracker.track_frame(ref, pyr, T1, *args, fs.calib, fs.cfg,
                                    L - 1)
    torch.cuda.synchronize()
    for got, w in ((got_a, want[0]), (got_b, want[1])):
        for g, x in zip(got, w):
            assert _same(g, x[0])


def test_dispatch_runs_ahead_of_the_card(cuda):
    """track_chain_dispatch behind ~50 ms of sleep on a tracking stream,
    under set_sync_debug_mode("error"): it returns before the sleep ends
    (its HostCopy not ready), and its packed result equals bitwise the
    dispatch of the same frame from the same chain without the sleep."""
    import time
    from ldso_tpu_torch.slam_map import FrameShell
    fs, imgs, *_ = _tracked_system()
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    k = len(imgs) - 1
    with torch.cuda.stream(stream):
        fs.chain_reset()
        chain = fs.track_chain
        want = fs.track_chain_dispatch(FrameShell(id=k), imgs[k])[1].numpy()
        fs.track_chain = chain
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        torch.cuda.set_sync_debug_mode("error")
        try:
            t = time.perf_counter()
            packed = fs.track_chain_dispatch(FrameShell(id=k), imgs[k])[1]
            ms = (time.perf_counter() - t) * 1e3
            ready = packed.is_ready()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert not ready, ms
    assert packed.numpy().tobytes() == want.tobytes()


def test_frame_step_graph_equals_eager_on_the_card(cuda):
    """A card FullSystem captures the frame step's and the chain step's
    graphs for uint8 and float32 frames when it is built (their families
    refuse to capture at a replay). The strict step's replay on the next frame is bitwise
    its eager program (K3 trips_per_track and K4 once in each), and so is
    the chain step's; a failed gate leaves the arena bitwise as it went
    in."""
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.system import full_system as fsm
    fs, imgs, ref, _, T0, _ = _tracked_system()
    shell = fs.all_frames[-1]
    L = fs.calib.levels
    trips = tracker.trips_per_track(fs.cfg, L, L - 1)
    img = fsm.frame_image(imgs[-1], fs.device)
    for last, flag in ((np.nan, 1.0), (1e-30, 0.0)):
        fs.last_coarse_rmse = np.full(L, last)
        up = fs._frame_upload(T0.cpu().numpy(), shell.aff, 1.0, True,
                              fs.tracker_ref_shell.T_cw)
        family, static, fn, inputs = fs._frame_step_call(img, ref,
                                                         fs.imm_arena, up)
        outs = {}
        for name, run in (("replay", lambda: family.replay(static, fn,
                                                            inputs)),
                          ("eager", lambda: fn(*inputs))):
            before = dict(cuda_kernels.LAUNCHES)
            outs[name] = run()
            assert cuda_kernels.LAUNCHES["tracker_trip"] == \
                before["tracker_trip"] + trips
            assert cuda_kernels.LAUNCHES["trace"] == before["trace"] + 1
            assert cuda_kernels.LAUNCHES["pyramid"] == before["pyramid"] + 1
        for g, e in zip(outs["replay"], outs["eager"]):
            assert _same(g, e)
        assert float(outs["replay"][-1][19]) == flag
        if not flag:
            for o, x in zip(outs["replay"][2 * L:-1],
                            fsm._arena_flat(fs.imm_arena)):
                assert _same(o, x)
    fs.chain_reset()
    family, static, fn, inputs = fs._chain_step_call(
        img, ref, fs.track_chain, fs._f32(np.r_[np.ravel(
            fs.tracker_ref_shell.T_cw), 1.0]))
    for g, e in zip(family.replay(static, fn, inputs), fn(*inputs)):
        assert _same(g, e)
    # a replay of a key with no graph raises: these were captured when
    # the system was built, one per frame dtype and step
    mine = (fs.cfg, tracker.graph_key(fs.cfg))
    for f in (fsm.FRAME_STEP_GRAPHS, fsm.CHAIN_STEP_GRAPHS):
        assert len([k for k in f.graphs if k[1][0] == fs.calib
                    and k[1][1] in mine]) == len(fsm.FRAME_DTYPES)


def test_frame_step_dispatch_runs_ahead_of_the_card(cuda):
    """FullSystem._frame_step_dispatch behind ~100 ms of sleep, under
    set_sync_debug_mode("error"): it returns before the sleep ends (its
    HostCopy not ready), one replay of the frame step's graph, and its
    packed row and arena equal bitwise a dispatch without the sleep."""
    import time
    from ldso_tpu_torch.system import full_system as fsm
    fs, imgs, ref, _, T0, _ = _tracked_system()
    args = (imgs[-1], ref, T0.cpu().numpy(), fs.all_frames[-1].aff, 1.0,
            fs.tracker_ref_shell.T_cw, True)
    arena0 = fs.imm_arena
    want = fs._frame_step_dispatch(*args)[1].numpy().copy()
    want_arena = fs.imm_arena
    fs.imm_arena = arena0
    replays = fsm.FRAME_STEP_GRAPHS.counts["replays"]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = time.perf_counter()
        packed = fs._frame_step_dispatch(*args)[1]
        ms = (time.perf_counter() - t) * 1e3
        ready = packed.is_ready()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not ready, ms
    assert fsm.FRAME_STEP_GRAPHS.counts["replays"] == replays + 1
    assert packed.numpy().tobytes() == want.tobytes()
    for a, b in zip(fsm._arena_flat(fs.imm_arena),
                    fsm._arena_flat(want_arena)):
        assert _same(a, b)


# ---------------------------------------------------------------------------
# K3, the tracker trip (csrc/tracker_trip.cu)
# ---------------------------------------------------------------------------

_TRIP_SCENE = {}


def _trip_scene():
    """A 640x480 scene (4 pyramid levels, as the main path's) on the card:
    the tracking reference from the rendered idepth, the frame rendered at
    a known motion, and that motion."""
    if not _TRIP_SCENE:
        from ldso_tpu_torch.config import Config
        from ldso_tpu_torch.frontend import tracker
        from ldso_tpu_torch.math import lie_np
        from ldso_tpu_torch.ops.preprocess import make_pyramid
        from ldso_tpu_torch.synthetic import PlaneScene, default_calib
        calib, cfg = default_calib(640, 480), Config()
        L = calib.levels
        scene = PlaneScene(freq_hi=25.0, contrast=80.0)
        img0, idep0 = scene.render(calib, np.eye(4), device="cuda")
        ref = tracker.make_tracker_ref_from_idepth(
            idep0, make_pyramid(img0, L), calib, cfg.tracker_caps[:L],
            stride=2)
        T_true = lie_np.se3_exp(np.array([0.02, -0.01, 0.005, 0.002, 0.004,
                                          -0.001]))
        img1, _ = scene.render(calib, T_true, device="cuda")
        _TRIP_SCENE.update(calib=calib, cfg=cfg, ref=ref,
                           pyr=make_pyramid(img1, L),
                           T=torch.as_tensor(T_true, dtype=torch.float32,
                                             device="cuda"))
    return _TRIP_SCENE


def _trip_batch(T0, B):
    T = T0.expand(B, 4, 4).clone()
    T[1:, :3, 3] += torch.linspace(-0.01, 0.01, 3 * (B - 1),
                                   device=T.device).reshape(B - 1, 3)
    aff = torch.tensor([[0.01, 0.5]], device=T.device).expand(B, 2)
    return T, aff


@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_trip_kernel_matches_plain(cuda, lvl):
    """K3 against tracker_trip_ref at this level, batch 1 and 8, on the
    scene and on the edge cases (every point out of bounds, most terms
    saturated, a NaN patch in the intensity or in all channels, where the
    plain version's H and b turn NaN and K3's must turn NaN alike), within
    torch_kernel_checks' tolerances (NaN against NaN agrees, NaN on one
    side fails); one launch each."""
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.ops import cuda_kernels
    import torch_kernel_checks as kc
    sc = _trip_scene()
    expo = torch.ones((), device=cuda)
    before = cuda_kernels.LAUNCHES["tracker_trip"]
    for case in kc.TRIP_CASES:
        for B in (1, 8):
            p, T, aff, cut = kc.trip_case(
                case, sc["pyr"], lvl, *_trip_batch(sc["T"], B), sc["cfg"])
            args = (sc["ref"], p, lvl, T, aff, expo, cut, sc["calib"],
                    sc["cfg"], lvl == 0)
            got = cuda_kernels.tracker_trip(*args)
            want = tracker.tracker_trip_ref(*args)
            err, share, same_n = kc.trip_err(got, want,
                                             kc.trip_allowance(*args))
            assert share <= 1.0 and same_n, (case, B, err, share)
            for g, w in zip(got, want):
                assert torch.equal(torch.isnan(g), torch.isnan(w)), case
            if not case.startswith("nan"):
                assert all(bool(torch.isfinite(x).all()) for x in got), case
            if case == "out_of_bounds":
                assert not bool(got[0][:, 1].any())
            elif case == "saturating":
                assert bool((got[0][:, 5] > 0.5).all())
    assert cuda_kernels.LAUNCHES["tracker_trip"] == before + 10


def test_trip_kernel_repeats_bitwise(cuda):
    """20 launches on the same inputs give the same bits: no float atomics,
    a reduction order fixed by the code."""
    from ldso_tpu_torch.ops import cuda_kernels
    sc = _trip_scene()
    T, aff = _trip_batch(sc["T"], 8)
    args = (sc["ref"], sc["pyr"], 0, T, aff, torch.ones((), device=cuda),
            torch.full((8,), 20.0, device=cuda), sc["calib"], sc["cfg"], True)
    first = [x.clone() for x in cuda_kernels.tracker_trip(*args)]
    for _ in range(19):
        for a, b in zip(first, cuda_kernels.tracker_trip(*args)):
            assert _same(a, b)


@pytest.mark.parametrize("mode", ["trip", "cutoff", "lm"])
def test_trip_kernel_under_vmap_is_one_launch(cuda, mode):
    """Each K3 operator under torch.func.vmap launches the kernel once with
    the vmapped axis as its sequence axis, and each sequence gets the bits
    of its own single launch."""
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.ops import cuda_kernels
    import torch_kernel_checks as kc
    sc = _trip_scene()
    ref, calib, cfg = sc["ref"], sc["calib"], sc["cfg"]
    S, lvl = 3, 1
    T, aff = _trip_batch(sc["T"], S)
    T, aff = T[:, None], aff[:, None].contiguous()       # (S, B=1, ...)
    expo = torch.ones((), device=cuda)
    cut = torch.full((1,), 20.0, device=cuda)
    dI = torch.stack([sc["pyr"].dI[lvl]] * S)
    dI[1] = dI[1] * 1.1
    params = cuda_kernels.trip_params(calib, lvl, cfg)
    states = []
    for s_ in range(S):
        st = kc.mode_state(tracker.tracker_trip_ref, ref, sc["pyr"], lvl,
                           T[s_], aff[s_], expo, cut, calib, cfg, False)
        states.append(st)
    stats, H, b, rep, run, lam, done = (torch.stack(x) for x in zip(*states))
    op = getattr(torch.ops.ldso_tpu_torch, cuda_kernels.TRIP_OPS[mode])

    def one(d, t, a, st, h, bb, sc_, fl):
        state = {"trip": (cut,), "cutoff": (st, h, bb, sc_, fl),
                 "lm": (st, h, bb, sc_, fl, cut)}[mode]
        return op(ref.points[lvl], ref.valid[lvl], d, t, a, ref.ref_aff,
                  ref.ref_exposure, expo, *state, params, False)
    scal = rep if mode == "cutoff" else lam
    flag = run if mode == "cutoff" else done
    seq = (dI, T, aff, stats, H, b, scal, flag)
    before = cuda_kernels.LAUNCHES["tracker_trip"]
    got = torch.func.vmap(one)(*seq)
    assert cuda_kernels.LAUNCHES["tracker_trip"] == before + 1
    for s_ in range(S):
        for g, w in zip(got, one(*(x[s_] for x in seq))):
            assert _same(g[s_], w)


@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_trip_modes_match_plain(cuda, lvl):
    """K3's cutoff and lm modes against their plain versions at this
    level, batch 1 and 8, on the scene and on the edge cases, from a state
    with live, done and not-run members (torch_kernel_checks.mode_errs:
    idle members bit for bit, the step within the solve's rounding, the
    trip at the kernel's new pose within the trip's tolerances, the accept
    and done decisions equal unless their margins are within rounding);
    one launch per call."""
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.ops import cuda_kernels
    import torch_kernel_checks as kc
    sc = _trip_scene()
    expo = torch.ones((), device=cuda)
    for case in kc.TRIP_CASES:
        for B in (1, 8):
            p, T, aff, cut = kc.trip_case(
                case, sc["pyr"], lvl, *_trip_batch(sc["T"], B), sc["cfg"])
            before = cuda_kernels.LAUNCHES["tracker_trip"]
            err, share, faults, _ = kc.mode_errs(
                cuda_kernels.cutoff_trip, cuda_kernels.lm_trip,
                tracker.tracker_trip_ref,
                sc["ref"], p, lvl, T, aff, expo, cut, sc["calib"], sc["cfg"],
                lvl == 0)
            # the cutoff call, the lm call and its candidate
            assert cuda_kernels.LAUNCHES["tracker_trip"] == before + 3
            assert not faults and share <= 1.0, (case, B, err, faults)


def test_trip_modes_repeat_bitwise(cuda):
    """20 launches of the cutoff and of the lm mode on the same inputs give
    the same bits, idle members included."""
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.ops import cuda_kernels
    import torch_kernel_checks as kc
    sc = _trip_scene()
    calib, cfg = sc["calib"], sc["cfg"]
    T, aff = _trip_batch(sc["T"], 8)
    expo = torch.ones((), device=cuda)
    cut = torch.full((8,), 20.0, device=cuda)
    stats, H, b, rep, run, lam, done = kc.mode_state(
        tracker.tracker_trip_ref, sc["ref"], sc["pyr"], 0, T, aff, expo, cut,
        calib, cfg, True)
    for call in (lambda: cuda_kernels.cutoff_trip(
            sc["ref"], sc["pyr"], 0, T, aff, expo, stats, H, b, rep, run,
            calib, cfg, True),
            lambda: cuda_kernels.lm_trip(
                sc["ref"], sc["pyr"], 0, T, aff, expo, stats, H, b, lam, done,
                cut, calib, cfg, True)):
        first = [x.clone() for x in call()]
        for _ in range(19):
            for a, b_ in zip(first, call()):
                assert _same(a, b_)


def test_batched_replay_runs_the_kernel(cuda):
    """parallel/replay's batched tracker (vmap in one CUDA graph) launches
    K3 once per trip for all S sequences, counted at each replay, and
    matches S single tracks within T 1e-4 (7c's tolerance)."""
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.ops.preprocess import FramePyramid
    from ldso_tpu_torch.parallel import replay
    sc = _trip_scene()
    ref, pyr, calib, cfg = sc["ref"], sc["pyr"], sc["calib"], sc["cfg"]
    S, L = 3, calib.levels
    f32 = dict(dtype=torch.float32, device=cuda)
    refs = replay._tree_map(
        lambda x: x[None].expand((S,) + tuple(x.shape)).contiguous(), ref)
    pyrs = [FramePyramid(dI=tuple(d * (1.0 + 0.05 * s) for d in pyr.dI),
                         abs_grad=()) for s in range(S)]
    pyr_b = FramePyramid(dI=tuple(torch.stack([p.dI[lv] for p in pyrs])
                                  for lv in range(L)), abs_grad=())
    T0 = torch.eye(4, **f32).expand(S, 4, 4).contiguous()
    aff0, expo = torch.zeros((S, 2), **f32), torch.ones(S, **f32)
    noab = torch.full((S, L), 1e9, **f32)
    step = replay.make_batched_tracker(calib, cfg, L - 1)
    step(refs, pyr_b, T0, aff0, expo, noab)              # capture
    cuda_kernels.reset_launch_counts()
    out = step(refs, pyr_b, T0, aff0, expo, noab)
    assert cuda_kernels.LAUNCHES["tracker_trip"] == tracker.trips_per_track(
        cfg, L, L - 1)
    for s in range(S):
        one = tracker.track_frame(ref, pyrs[s], T0[s], aff0[s], expo[s],
                                  noab[s], calib, cfg, L - 1)
        assert float(torch.max(torch.abs(out[0][s] - one[0]))) <= 1e-4
        assert bool(out[2][s] == one[2])


def test_trip_launches_count_through_graph_replays(cuda):
    """A replayed track counts K3's trips_per_track launches, though no
    Python runs at a replay; the eager function counts the same."""
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.ops import cuda_kernels
    sc = _trip_scene()
    calib, cfg = sc["calib"], sc["cfg"]
    L = calib.levels
    f32 = dict(dtype=torch.float32, device=cuda)
    args = (sc["ref"], sc["pyr"], sc["T"], torch.zeros(2, **f32),
            torch.ones((), **f32), torch.full((L,), 1e9, **f32), calib, cfg,
            L - 1)
    trips = tracker.trips_per_track(cfg, L, L - 1)
    tracker.track_frame(*args)                           # capture if new
    for run in (lambda: tracker.track_frame(*args),
                lambda: tracker._track_batch(args[0], args[1], args[2][None],
                                             *args[3:])):
        cuda_kernels.reset_launch_counts()
        run()
        assert cuda_kernels.LAUNCHES["tracker_trip"] == trips


# ---------------------------------------------------------------------------
# the windowed BA's device LM as one CUDA graph, and K12 (its projector)
# ---------------------------------------------------------------------------

def _kc():
    import os
    import sys
    tests = os.path.dirname(os.path.abspath(__file__))
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_kernel_checks
    return torch_kernel_checks


def _ba_inputs(cuda, nf, seed, F=8):
    """A BA window of nf frames in F slots on the card (the main path's F),
    with its prior and the newest frame as a device integer."""
    W, dIs, HM, bM, cfg, (w, h) = _kc().ba_window(
        nf, F, n_pts=64, seed=seed, device=cuda)
    return (W, dIs, HM, bM, torch.tensor(nf - 1, device=cuda)), cfg, w, h


def test_projector_kernel_matches_plain(cuda):
    """K12 against the plain projector (the SVD) on the windows of 1 to 8
    frames of the main path's 8 slots, an empty window and the planted
    bases (torch_kernel_checks.planted_bases), within
    torch_kernel_checks.projector_err's tolerance, the two planted at the
    gate reported so; against its own algorithm in float64 on the card
    (projector_emulated) within PROJ_EMU_ULPS float32 ulps, with the same
    sweeps and rotations; P symmetric bit for bit; one launch each; 20
    launches bitwise equal; a ragged n (not a multiple of 4) and k < 7."""
    from ldso_tpu_torch.backend import ba_device
    from ldso_tpu_torch.backend.window import empty_window
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kc()
    cfg = kc.ba_window(1, 8, device=cuda)[4]
    delta = cfg.solver_mode_delta
    cases = {f"window {nf}":
             ba_device.orth_basis(_ba_inputs(cuda, nf, nf)[0][0])
             for nf in range(1, 9)}
    cases["empty"] = ba_device.orth_basis(
        empty_window(8, 16, (100.0, 100.0, 80.0, 60.0), cfg, cuda))
    cases.update({name: torch.from_numpy(B).to(cuda)
                  for name, B in kc.planted_bases(delta).items()})
    rng = np.random.RandomState(5)
    cases["ragged n 37, k 5"] = torch.from_numpy(
        rng.randn(37, 5).astype(np.float32)).to(cuda)
    at_gate_cases = []
    for name, Nn in cases.items():
        before = cuda_kernels.LAUNCHES["ba_projector"]
        got = cuda_kernels.ba_projector(Nn, delta)
        assert cuda_kernels.LAUNCHES["ba_projector"] == before + 1
        want = ba_device.nullspace_projector_ref(Nn, delta)
        err, share, at_gate = kc.projector_err(got[None], want[None],
                                               Nn[None], delta)
        if at_gate:
            at_gate_cases.append(name)
        assert share <= 1.0, (name, err, share)
        emu, sweeps, rotations = kc.projector_emulated(Nn, delta)
        emu_err, emu_share = kc.projector_emu_err(got, emu)
        assert emu_share <= 1.0, (name, emu_err)
        work = cuda_kernels.projector_launch(Nn[None], delta)[1][0].tolist()
        assert work == [sweeps, rotations], (name, work)
        assert torch.equal(got, got.T)
    assert sorted(at_gate_cases) == ["gate_0.99", "gate_1.01"]
    Nn = cases["window 8"]
    first = cuda_kernels.ba_projector(Nn, delta)
    for _ in range(19):
        assert _same(cuda_kernels.ba_projector(Nn, delta), first)


@pytest.mark.parametrize("nf", [2, 3, 8])
def test_ba_graph_replay_equals_eager(cuda, nf):
    """The device LM replayed as one CUDA graph (energy_functional.
    replay_ba) against the eager optimize_device on the same window, bit
    for bit, at 20, 15 and 6 trips; every field it does not write is the
    caller's own tensor; one graph per key, K12 launched once per replay."""
    from ldso_tpu_torch.backend import ba_device, energy_functional as efm
    from ldso_tpu_torch.ops import cuda_kernels
    args, cfg, w, h = _ba_inputs(cuda, nf, 20 + nf)
    trips = efm.ba_trip_counts(6)[min(nf, 4) - 2]
    want = ba_device.optimize_device(*args, cfg, w, h, trips)
    efm.replay_ba(*args, cfg, w, h, trips)           # captured here if new
    before = (dict(efm.BA_GRAPHS.counts),
              cuda_kernels.LAUNCHES["ba_projector"])
    got = efm.replay_ba(*args, cfg, w, h, trips)
    torch.cuda.synchronize()
    assert efm.BA_GRAPHS.counts["count"] == before[0]["count"]
    assert efm.BA_GRAPHS.counts["replays"] == before[0]["replays"] + 1
    assert cuda_kernels.LAUNCHES["ba_projector"] == before[1] + 1
    for name, g, e in zip(ba_device.Window._fields, got[0], want[0]):
        assert _same(g, e), name
    assert _same(got[1], want[1])
    for g, x in zip(got[0], args[0]):
        assert g is x or g.data_ptr() != x.data_ptr()


def test_ba_replay_does_not_sync(cuda):
    """EnergyFunctional.optimize's device part (the prior's pinned uploads
    and the graph replay) under torch.cuda.set_sync_debug_mode("error"),
    behind 50 ms of queued sleep: it returns before the card has run it;
    the stats read afterwards equal an unslept replay's."""
    import time
    from ldso_tpu_torch.backend import energy_functional as efm
    from ldso_tpu_torch.ops.preprocess import to_device
    (W, dIs, HM, bM, newest), cfg, w, h = _ba_inputs(cuda, 8, 3)
    want = efm.replay_ba(W, dIs, HM, bM, newest, cfg, w, h, 6)[1]
    HMh, bMh = HM.cpu(), bM.cpu()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(50e-3 * 1.5e9))
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = time.perf_counter()
        got = efm.replay_ba(W, dIs, to_device(HMh, cuda), to_device(bMh, cuda),
                            to_device(torch.tensor(7), cuda), cfg, w, h, 6)[1]
        queued_s = time.perf_counter() - t
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert queued_s < 0.025, queued_s
    assert _same(got, want)


def test_ba_vmapped_graph_matches_single_replays(cuda):
    """torch.func.vmap of the device LM over S = 8 windows (2 to 8 frames
    of 8 slots, so other newest frames and other masked trips), captured
    as one CUDA graph, against 8 single replays, within torch_kernel_checks.
    ba_batch_err's tolerance (each member no farther from its window's
    float64 result than BA_F64_FACTOR times the farthest single replay),
    the residual bookkeeping equal, the planted faults (ba_batch_plants,
    the two reruns of a member too) refused; K12
    launched once for the 8."""
    from ldso_tpu_torch.backend import ba_device, energy_functional as efm
    from ldso_tpu_torch.backend.window import Window
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.utils.graphs import Programs
    kc = _kc()
    inputs = [_ba_inputs(cuda, nf, 40 + nf) for nf in (2, 3, 4, 5, 6, 7, 8, 8)]
    cfg, w, h = inputs[0][1:]
    stacked = tuple(torch.stack([a[0][0][i] for a in inputs])
                    for i in range(len(Window._fields))) + tuple(
        torch.stack([a[0][k] for a in inputs]) for k in (1, 2, 3, 4))

    def program(*xs):
        W, stats = torch.func.vmap(
            lambda W, d, H, b, n: ba_device.optimize_device(
                W, d, H, b, n, cfg, w, h, 6))(Window(*xs[:-4]), *xs[-4:])
        return tuple(W) + (stats,)
    graphs = Programs()
    graphs.replay(("vmap",), program, stacked)
    before = cuda_kernels.LAUNCHES["ba_projector"]
    out = graphs.replay(("vmap",), program, stacked)
    assert cuda_kernels.LAUNCHES["ba_projector"] == before + 1

    def single(W, *rest):
        return efm.replay_ba(W, *rest, cfg, w, h, 6)

    def plain(W, *rest):
        return ba_device.optimize_device(W, *rest, cfg, w, h, 6)
    batched = [(Window(*(x[s] for x in out[:-1])), out[-1][s])
               for s in range(len(inputs))]
    singles = [single(*a[0]) for a in inputs]
    reference = [kc.ba_f64(plain, *a[0]) for a in inputs]
    worst, tol, faults = kc.ba_batch_err(batched, singles, reference)
    assert not faults, (faults, worst, tol)
    plants = kc.ba_plant_readings(
        batched, singles, reference, calls=[a[0] for a in inputs],
        run=lambda *a: ba_device.optimize_device(*a[:5], cfg, w, h, a[5]),
        trips=6)
    for name, got in plants.items():
        assert got["faults"], (name, got)


# the counts of tests/test_torch_bench.py's CPU run
BENCH_SMALL = ["--warm", "9", "--sync-warm", "1", "--window", "1",
               "--pipe-warm", "1", "--pipe-window", "1", "--seqs", "2",
               "--unique-seqs", "1", "--seq-warm", "9", "--seq-window", "1",
               "--batch", "2", "--steps", "1", "--ba-batch", "2"]


def test_bench_gives_device_times_on_the_card(cuda):
    """The port's bench (examples/bench.py) on the card at the CPU test's
    small counts: exit code 0, the line last, and every device time
    present and positive."""
    import contextlib
    import io
    import json
    from ldso_tpu_torch.examples import bench
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(BENCH_SMALL)
    result = json.loads(out.getvalue().splitlines()[-1])
    assert rc == 0, result.get("error")
    assert result["device"]["type"] == "cuda" and result["device"]["name"]
    # the five programs of the bench's util, by name: the frame step, the
    # trace and the activation (named by their lanes), the device LM and
    # the batched-tracking leg's batched track (B = --batch 2)
    names = sorted(result["util"])
    assert len(names) == 5, names
    assert {"frame_step(track)", "ba_lm", "batched_track(2 seq)"} <= set(
        names), names
    assert [k.split("(")[0] for k in names if k.startswith(
        ("trace(", "activate("))] == ["activate", "trace"], names
    for name, rec in result["util"].items():
        assert rec["ms"] > 0 and rec["hbm_pct_min"] > 0, (name, rec)
    ba = result["batched_ba_2seq"]
    assert ba["ms"] > 0 and ba["agg_kf_per_sec"] > 0
    assert all(gb > 0 for gb in result["peak_memory_gb"].values())


# ---------------------------------------------------------------------------
# K4, the epipolar trace of the candidate arena (csrc/immature_trace.cu)
# ---------------------------------------------------------------------------

_TRACE_SCENE = {}
TRACE_CASES = [f"{v} {k}" for v in _kc().TRACE_VARIANTS
               for k in ("uninitialised", "narrowing")] + ["planted"]


def _trace_scene():
    """torch_kernel_checks.trace_scene at 640x480 on the card and its
    trace_cases."""
    if not _TRACE_SCENE:
        kc = _kc()
        scene = kc.trace_scene(640, 480, "cuda")
        _TRACE_SCENE.update(scene=scene, cases=kc.trace_cases(scene))
    return _TRACE_SCENE


@pytest.mark.parametrize("case", TRACE_CASES)
def test_trace_kernel_matches_plain(cuda, case):
    """K4 against trace_arena_ref on the card, in every search, on an
    uninitialised and a narrowing trace of the bench scene's 4,096 live
    lanes, and on the planted lanes (border, sticky OOB, skipped,
    badcondition, idepth_min < 0, steps at the cap, a former outlier, dead
    lanes between live ones, NaN pixels in the target): held by
    torch_kernel_checks.trace_err, one launch each, the fields the trace
    does not write shared."""
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kc()
    s = _trace_scene()
    arena, dI, KRKis, Kts, affs, cfg = s["cases"][case]
    calib = s["scene"]["calib"]
    before = cuda_kernels.LAUNCHES["trace"]
    got = cuda_kernels.trace_arena(arena, dI, KRKis, Kts, affs, calib, cfg)
    assert cuda_kernels.LAUNCHES["trace"] == before + 1
    want, parts = kc.plain_trace(arena, dI, KRKis, Kts, affs, calib, cfg)
    rep = kc.trace_err(want, got, parts, cfg)
    assert rep["ok"], (rep["faults"], rep["flips"])
    for f in got.pool._fields:
        if f not in cuda_kernels.TRACE_OUTPUTS:
            assert getattr(got.pool, f) is getattr(arena.pool, f)


# K4 at its limits: the step cap of 100 (immature.MAX_STEPS) and the most
# re-score steps (cuda_kernels.TRACE_MAX_REFINE) under both nearest searches
TRACE_LIMIT_CASES = [f"{v} {k}" for v in ("long search",
                                          "nearest packed refine 15",
                                          "nearest rotated refine 15")
                     for k in ("uninitialised", "narrowing")]


@pytest.mark.parametrize("case", TRACE_LIMIT_CASES)
def test_trace_kernel_is_bitwise_at_its_limits(cuda, case):
    """K4 at the step cap of 100 at 640x480 (a Config with max_pix_search
    0.09) and with 15 re-score steps after both nearest searches, on the
    bench scene's 4,096 lanes: one launch, every output bit for bit the
    plain version's (so trace_err holds with no flip); the uninitialised
    long search has lanes that score past step 64."""
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kc()
    s = _trace_scene()
    arena, dI, KRKis, Kts, affs, cfg = s["cases"][case]
    calib = s["scene"]["calib"]
    ints, _ = cuda_kernels.trace_params(calib, cfg)
    assert ints[2] == (100 if case.startswith("long") else 34)
    before = cuda_kernels.LAUNCHES["trace"]
    got = cuda_kernels.trace_arena(arena, dI, KRKis, Kts, affs, calib, cfg)
    assert cuda_kernels.LAUNCHES["trace"] == before + 1
    want, parts = kc.plain_trace(arena, dI, KRKis, Kts, affs, calib, cfg)
    for f in cuda_kernels.TRACE_OUTPUTS:
        a, b = getattr(got.pool, f), getattr(want.pool, f)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f
    rep = kc.trace_err(want, got, parts, cfg)
    assert rep["ok"] and not rep["flips"], (rep["faults"], rep["flips"])
    if case == "long search uninitialised":
        assert int((parts["do_search"] & (parts["n_steps"] > 64)).sum()) > 0


def test_trace_kernel_repeats_bitwise(cuda):
    """20 launches on the planted case give the same bits."""
    from ldso_tpu_torch.ops import cuda_kernels
    s = _trace_scene()
    arena, dI, KRKis, Kts, affs, cfg = s["cases"]["planted"]
    calib = s["scene"]["calib"]
    first = cuda_kernels.trace_arena(arena, dI, KRKis, Kts, affs, calib, cfg)
    for _ in range(19):
        again = cuda_kernels.trace_arena(arena, dI, KRKis, Kts, affs, calib,
                                         cfg)
        for f in cuda_kernels.TRACE_OUTPUTS:
            a, b = getattr(again.pool, f), getattr(first.pool, f)
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f


def test_trace_launches_count_through_graph_replays(cuda):
    """One launch per call of the wrapper, and one per replay of a graph
    that captured one (recording_launches): the captured launch gives the
    eager launch's bits."""
    from ldso_tpu_torch.ops import cuda_kernels
    s = _trace_scene()
    arena, dI, KRKis, Kts, affs, cfg = s["cases"]["packed uninitialised"]
    calib = s["scene"]["calib"]
    before = cuda_kernels.LAUNCHES["trace"]
    want = cuda_kernels.trace_arena(arena, dI, KRKis, Kts, affs, calib, cfg)
    assert cuda_kernels.LAUNCHES["trace"] == before + 1
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), cuda_kernels.recording_launches() as tally:
        with torch.cuda.graph(g, stream=side):
            got = cuda_kernels.trace_arena(arena, dI, KRKis, Kts, affs, calib,
                                           cfg)
    assert tally == {"trace": 1}
    assert cuda_kernels.LAUNCHES["trace"] == before + 1
    for _ in range(2):
        g.replay()
        cuda_kernels.add_launches(tally)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["trace"] == before + 3
    for f in cuda_kernels.TRACE_OUTPUTS:
        a, b = getattr(got.pool, f), getattr(want.pool, f)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f


def test_trace_arena_runs_ahead_of_the_card(cuda):
    """FullSystem._trace_transforms and _trace_arena behind ~50 ms of sleep,
    under set_sync_debug_mode("error"): no host read (the watermark and
    linalg.inv's check are gone), the call returns before the card has run
    the trace (an event after it is not done), and its results equal a
    run without the sleep bitwise."""
    import numpy as np
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.slam_map import FrameShell
    from ldso_tpu_torch.system.full_system import FullSystem
    kc = _kc()
    scene = _trace_scene()["scene"]
    fs = FullSystem(scene["calib"], scene["cfg"])
    for slot, k in enumerate(kc.TRACE_HOSTS):
        fs.window_frames.append(FrameShell(
            id=k, T_cw=scene["poses"][k], aff=np.array([0.02 * slot, 1.0]),
            exposure=1.0 + 0.1 * slot))
    target = kc.TRACE_TARGETS[0]
    pyr = scene["pyrs"][target]

    def run():
        fs.imm_arena = scene["arena"]
        transforms = fs._trace_transforms(
            fs._f32(scene["poses"][target]), fs._f32([0.01, -0.5]), 1.2)
        fs._trace_arena(pyr, *transforms)
        return list(transforms) + list(fs.imm_arena.pool)

    want = [t.clone() for t in run()]
    torch.cuda.synchronize()
    before = cuda_kernels.LAUNCHES["trace"]
    torch.cuda._sleep(100_000_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run()
        done = torch.cuda.Event()
        done.record()
        ready = done.query()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not ready
    assert cuda_kernels.LAUNCHES["trace"] == before + 1
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))


# ---------------------------------------------------------------------------
# K5, the keyframe's activation of the candidate arena
# (csrc/immature_activate.cu)
# ---------------------------------------------------------------------------

_ACT_SCENE = {}
ACT_CASES = [f"window {n}" for n in _kc().ACT_FRAMES] + ["planted"]
ACT_MAX_SLOTS = 32                     # cuda_kernels.ACTIVATE_MAX_SLOTS


def _act_scene():
    """torch_kernel_checks.activate_scene at 640x480 on the card, with the
    frames of K5's most slots, and its activate_cases."""
    if not _ACT_SCENE:
        kc = _kc()
        scene = kc.activate_scene(640, 480, "cuda", slots=ACT_MAX_SLOTS)
        _ACT_SCENE.update(scene=scene, cases=kc.activate_cases(scene))
    return _ACT_SCENE


@pytest.mark.parametrize("case", ACT_CASES)
def test_activate_kernel_matches_plain(cuda, case):
    """K5 against activate_arena_ref on the card, on the bench scene's
    4,096 lanes against windows of 2, 4 and 8 frames and on the planted
    lanes (border, masked targets, NaN pixels, Hdd under the gate, a first
    step that converges, an energy at the outlier limit, host == newest
    and out of range, dead lanes between live ones): held by
    torch_kernel_checks.activate_err, one launch each."""
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kc()
    s = _act_scene()
    inputs = s["cases"][case]
    calib = s["scene"]["calib"]
    before = cuda_kernels.LAUNCHES["activate"]
    got = cuda_kernels.activate_arena(*inputs[:13], calib, inputs[13])
    assert cuda_kernels.LAUNCHES["activate"] == before + 1
    want, parts = kc.plain_activate(inputs, calib)
    rep = kc.activate_err(want, got, parts, inputs[13])
    assert rep["ok"], (rep["faults"], rep["flips"])
    assert rep["optimised"] > 500


@pytest.mark.parametrize("F", range(1, ACT_MAX_SLOTS + 1),
                         ids=[f"F{F}" for F in range(1, ACT_MAX_SLOTS + 1)])
def test_activate_kernel_matches_plain_at_every_width(cuda, F):
    """K5 at every slot count it takes (it runs the slots in groups of 8)
    on the bench scene's 4,096 lanes against a window of F frames in F
    slots (torch_kernel_checks.activate_inputs): one launch, every output
    bit for bit the plain version's, so activate_err holds with no flip.
    tests/test_torch_activate_kernel.py::
    test_plain_activation_matches_jax_at_every_width holds the same cases'
    plain version against the JAX package at a small size."""
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kc()
    s = _act_scene()
    calib = s["scene"]["calib"]
    inputs = kc.activate_inputs(s["scene"], F, slots=F)
    before = cuda_kernels.LAUNCHES["activate"]
    got = cuda_kernels.activate_arena(*inputs[:13], calib, inputs[13])
    assert cuda_kernels.LAUNCHES["activate"] == before + 1
    want, parts = kc.plain_activate(inputs, calib)
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    rep = kc.activate_err(want, got, parts, inputs[13])
    assert rep["ok"] and not rep["flips"], (rep["faults"], rep["flips"])
    assert rep["optimised"] > (500 if F > 1 else -1)


def test_activate_kernel_repeats_bitwise(cuda):
    """20 launches on the planted case give the same bits."""
    from ldso_tpu_torch.ops import cuda_kernels
    s = _act_scene()
    inputs = s["cases"]["planted"]
    calib = s["scene"]["calib"]
    first = cuda_kernels.activate_arena(*inputs[:13], calib, inputs[13])
    for _ in range(19):
        again = cuda_kernels.activate_arena(*inputs[:13], calib, inputs[13])
        for a, b in zip(again, first):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b)


def test_activate_kernel_refuses_more_slots_than_a_warp(cuda):
    """F > ACTIVATE_MAX_SLOTS (four groups of 8 slots) raises; it is never
    handed to the plain version."""
    from ldso_tpu_torch.ops import cuda_kernels
    s = _act_scene()
    inputs = list(s["cases"]["window 2"])
    F = cuda_kernels.ACTIVATE_MAX_SLOTS + 1
    inputs[2] = torch.zeros((F, 3, 3), device="cuda")
    before = dict(cuda_kernels.LAUNCHES)
    with pytest.raises(ValueError, match="window slots"):
        cuda_kernels.activate_arena(*inputs[:13], s["scene"]["calib"],
                                    inputs[13])
    assert cuda_kernels.LAUNCHES == before


def test_activate_pass_runs_ahead_of_the_card(cuda):
    """FullSystem._activate_points behind ~50 ms of sleep, under
    set_sync_debug_mode("error"): no host read (no watermark, no boolean
    index, the tables up in one pinned copy), one K1 and one K5 launch,
    the call returns before the card has run the pass, its HostCopy is not
    ready, and its results equal a run without the sleep bitwise
    (chip_smoke._activation_dispatch)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    host_ms = chip_smoke._activation_dispatch(_kc(), _act_scene()["scene"])
    assert host_ms < 25.0


# ---------------------------------------------------------------------------
# K6 and K7: the windowed BA's linearization and accumulation
# (csrc/ba_linearize.cu, csrc/ba_accumulate.cu)
# ---------------------------------------------------------------------------

_BA_SCENE = {}
BA_LIN_CASES = ["window", "column", "planted", "planted column",
                "affine off"]
BA_ACC_CASES = [f"{tag} {name}" for tag in ("scene", "planted")
                for name in ("top mode 0", "top mode 1", "top mode 2",
                             "sc build", "sc marg")]


def _ba_scene():
    """torch_kernel_checks.ba_scene at the main path's shape on the card
    (8 frames in 8 slots, 2,048 points, 640x480), its K6 cases and its
    linearized windows (the scene's and the planted one)."""
    if not _BA_SCENE:
        kc = _kc()
        scene = kc.ba_scene(kc.BA_SLOTS, kc.BA_SLOTS, kc.BA_POINTS, 640, 480,
                            seed=3, device="cuda")
        cases = kc.lin_cases(scene)
        _BA_SCENE.update(scene=scene, cases=cases, windows={
            "scene": scene["W_lin"],
            "planted": kc.linearized(*cases["planted"][:3], 640, 480)})
    return _BA_SCENE


@pytest.mark.parametrize("case", BA_LIN_CASES)
def test_ba_linearize_kernel_matches_plain(cuda, case):
    """K6 against linearize_ref on the card: every field and the energy sum
    bitwise (torch_kernel_checks.lin_err), one launch."""
    from ldso_tpu_torch.backend import ba
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kc()
    W, dIs, cfg, tgt = _ba_scene()["cases"][case]
    before = cuda_kernels.LAUNCHES["ba_linearize"]
    got = cuda_kernels.ba_linearize(W, dIs, ba.make_precalc(W), cfg, 640,
                                    480, tgt)
    assert cuda_kernels.LAUNCHES["ba_linearize"] == before + 1
    rep = kc.lin_err(got, kc.plain_lin(W, dIs, cfg, 640, 480, tgt))
    assert rep["ok"], rep


@pytest.mark.parametrize("case", BA_ACC_CASES)
def test_ba_accumulate_kernel_matches_plain(cuda, case):
    """K7 against _accumulate_top_ref / _sc_sums_ref on the card, within
    torch_kernel_checks.acc_err (ACC_RTOL of each entry's magnitude sum,
    NaN where the plain version's is, counts exact), one launch; 20
    launches bitwise."""
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kc()
    tag, name = case.split(" ", 1)
    W = _ba_scene()["windows"][tag]
    part, args = kc.acc_cases(W)[name]
    before = cuda_kernels.LAUNCHES["ba_accumulate"]
    got = kc.kernel_acc(part, W, args)
    assert cuda_kernels.LAUNCHES["ba_accumulate"] == before + 1
    rep = kc.acc_err(got, kc.plain_acc(part, W, args),
                     kc.acc_scale(part, W, args))
    assert rep["ok"], rep
    for _ in range(20):
        again = kc.kernel_acc(part, W, args)
        assert all(_same(again[k], v) for k, v in got.items())


@pytest.mark.parametrize("case", BA_ACC_CASES)
def test_ba_accumulate_kernel_matches_its_emulation(cuda, case):
    """K7 against its own order of sums written out in plain PyTorch
    (torch_kernel_checks.acc_emulated, run on the card): every output
    bitwise, NaN where it is NaN."""
    kc = _kc()
    tag, name = case.split(" ", 1)
    W = _ba_scene()["windows"][tag]
    part, args = kc.acc_cases(W)[name]
    bad = kc.acc_emulated_err(kc.kernel_acc(part, W, args),
                              kc.acc_emulated(part, W, args))
    assert not bad, bad


# K7 at every slot count it takes (its Schur finisher's shared memory
# depends on F), 48 points a slot, and at 4,096 points (its point lists
# built in two rounds)
BA_ACC_SHAPES = [(F, 48 * F) for F in range(1, 33)] + [(8, 4096)]


@pytest.mark.parametrize("F,P", BA_ACC_SHAPES,
                         ids=[f"F{F}-P{P}" for F, P in BA_ACC_SHAPES])
def test_ba_accumulate_kernel_matches_its_emulation_at_every_width(cuda, F,
                                                                   P):
    """K7's five calls (top modes 0, 1 and 2, the Schur part's two) on a
    window of F frames in F slots (torch_kernel_checks.ba_scene at 96x64),
    one launch each, every output bitwise acc_emulated's."""
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kc()
    W = kc.ba_scene(F, F, P, 96, 64, seed=5, device="cuda")["W_lin"]
    for name, (part, args) in kc.acc_cases(W).items():
        before = cuda_kernels.LAUNCHES["ba_accumulate"]
        got = kc.kernel_acc(part, W, args)
        assert cuda_kernels.LAUNCHES["ba_accumulate"] == before + 1
        bad = kc.acc_emulated_err(got, kc.acc_emulated(part, W, args))
        assert not bad, (name, bad)


def test_ba_kernels_under_vmap_are_one_launch(cuda):
    """K6, K7's top part and its Schur part under torch.func.vmap over two
    windows: one launch each, each member bitwise its single launch on
    the same inputs."""
    from ldso_tpu_torch.backend import ba
    from ldso_tpu_torch.ops import cuda_kernels as ck
    s = _ba_scene()
    scene, planted = s["scene"], s["cases"]["planted"]
    cfg = scene["cfg"]
    stack = lambda xs: type(xs[0])(*(torch.stack(t) for t in zip(*xs)))  # noqa: E731
    Ws, ds = [scene["W"], planted[0]], [scene["dIs"], planted[1]]
    pcs = [ba.make_precalc(W) for W in Ws]
    before = dict(ck.LAUNCHES)
    got = torch.func.vmap(lambda W, d, pc: ck.ba_linearize(
        W, d, pc, cfg, 640, 480))(stack(Ws), torch.stack(ds), stack(pcs))
    assert ck.LAUNCHES["ba_linearize"] == before["ba_linearize"] + 1
    for i in range(2):
        one = ck.ba_linearize(Ws[i], ds[i], pcs[i], cfg, 640, 480)
        assert _kc().lin_err(({k: v[i] for k, v in got[0].items()},
                              got[1][i]), one)["ok"]
    Wl = [s["windows"]["scene"], s["windows"]["planted"]]
    pcl = [ba.make_precalc(W) for W in Wl]
    before = ck.LAUNCHES["ba_accumulate"]
    top = torch.func.vmap(lambda W, pc: ck.ba_accumulate_top(
        W, pc, 0, W.pt_valid))(stack(Wl), stack(pcl))
    sc = torch.func.vmap(lambda W, a, b, c: ck.ba_accumulate_sc(
        W, a, b, c, True, W.pt_valid))(stack(Wl), top[1], top[2], top[3])
    assert ck.LAUNCHES["ba_accumulate"] == before + 2
    for i in range(2):
        one = ck.ba_accumulate_top(Wl[i], pcl[i], 0, Wl[i].pt_valid)
        assert all(_same(a[i], b) for a, b in zip(top, one))
        one = ck.ba_accumulate_sc(Wl[i], top[1][i], top[2][i], top[3][i],
                                  True, Wl[i].pt_valid)
        assert all(_same(sc[k][i], v) for k, v in one.items())


@pytest.mark.parametrize("nf", [2, 8])
def test_ba_replay_launches_k6_and_k7(cuda, nf):
    """One device-LM replay launches K6 trips + 2 times and K7 3 x trips
    times (the first linearization, one of each per trip, the final one);
    its eager call, with every K6 and K7 call also run through the plain
    version, holds K6 bitwise and K7 within acc_err on each."""
    from ldso_tpu_torch.backend import ba_device, energy_functional as efm
    from ldso_tpu_torch.ops import cuda_kernels as ck
    kc = _kc()
    args, cfg, w, h = _ba_inputs(cuda, nf, seed=nf)
    trips = efm.ba_trip_counts(cfg.max_opt_iterations)[min(nf, 4) - 2]
    efm.replay_ba(*args, cfg, w, h, trips)
    ck.reset_launch_counts()
    efm.replay_ba(*args, cfg, w, h, trips)
    assert (ck.LAUNCHES["ba_linearize"], ck.LAUNCHES["ba_accumulate"]) == (
        trips + 2, 3 * trips)
    from ldso_tpu_torch.backend import ba
    lin, top = ck.ba_linearize, ck.ba_accumulate_top
    seen = []

    def lin_held(W, dIs, pc, cfg, w, h, tgt=None):
        got = lin(W, dIs, pc, cfg, w, h, tgt)
        seen.append(kc.lin_err(got, ba.linearize_ref(W, dIs, pc, cfg, w, h,
                                                     tgt))["ok"])
        return got

    def top_held(W, pc, mode, mask):
        got = top(W, pc, mode, mask)
        args = (pc, mode, mask)
        seen.append(kc.acc_err(dict(zip(ck.TOP_OUTPUTS, got)),
                               kc.plain_acc("top", W, args),
                               kc.acc_scale("top", W, args))["ok"])
        return got
    ck.ba_linearize, ck.ba_accumulate_top = lin_held, top_held
    try:
        ba_device.optimize_device(*args, cfg, w, h, trips)
    finally:
        ck.ba_linearize, ck.ba_accumulate_top = lin, top
    assert len(seen) == (trips + 2) + 2 * trips and all(seen)


def test_marg_graph_equals_eager(cuda):
    """The point marginalization's graph (energy_functional.replay_marg)
    against its eager program, bitwise; one K6 and two K7 launches per
    replay; its replay and pull queue behind a sleep without reading the
    host."""
    from ldso_tpu_torch.backend import energy_functional as efm
    from ldso_tpu_torch.ops import cuda_kernels as ck
    from ldso_tpu_torch.utils.device import HostCopy
    (W, dIs, HM, bM, newest), cfg, w, h = _ba_inputs(cuda, 5, seed=5)
    cand = W.pt_valid & (torch.arange(W.P, device=cuda) % 3 == 0)
    drop = W.pt_valid & (torch.arange(W.P, device=cuda) % 7 == 1) & ~cand
    args = (W, cand, drop, dIs, 50.0, 0.5, cfg, w, h)
    want = efm.marg_points_packed(*args)
    efm.replay_marg(*args)
    ck.reset_launch_counts()
    got = efm.replay_marg(*args)
    assert (ck.LAUNCHES["ba_linearize"], ck.LAUNCHES["ba_accumulate"]) == (
        1, 2)
    assert _same(got[1], want[1])
    assert all(_same(a, b) for a, b in zip(got[0], want[0]))
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = efm.replay_marg(*args)
        pull = HostCopy(out[1])
        assert not pull.is_ready()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.array_equal(pull.numpy(), want[1].cpu().numpy())


# ---------------------------------------------------------------------------
# the keyframe's dispatch: the post-BA flags, the tracker reference and the
# new candidates as captured programs (system/full_system)
# ---------------------------------------------------------------------------

def _kf_run(monkeypatch, watch=False, n=20):
    """A card FullSystem over n pipeline frames, with the last call of each
    keyframe program recorded (family -> (static, program, inputs)) and,
    with `watch`, each keyframe's dispatch from the activation through the
    new candidates under set_sync_debug_mode("error") behind ~50 ms of sleep
    (torch_kernel_checks.watched_keyframes): rows of (host ms,
    finish.ready() at return)."""
    from ldso_tpu_torch.system import full_system as fsm
    calib, poses, imgs = _pipeline_frames(n)
    fs = fsm.FullSystem(calib, _pipeline_cfg())
    fams = (fsm.ACTIVATE_GRAPHS, fsm.POST_BA_GRAPHS, fsm.TRACKER_REF_GRAPHS,
            fsm.NEW_TRACES_GRAPHS)
    counts = [f.counts["count"] for f in fams]
    seen = {}
    program = fsm._program

    def recorded(family, static, fn, inputs):
        # the keyframe's programs (the frame step goes through here too)
        if any(family is f for f in fams):
            seen[family] = (static, fn, tuple(inputs))
        return program(family, static, fn, inputs)
    monkeypatch.setattr(fsm, "_program", recorded)
    with (_kc().watched_keyframes(fs, 100_000_000) if watch
          else contextlib.nullcontext([])) as rows:
        for i, im in enumerate(imgs):
            fs.add_active_frame(im, i, 1.0, i * 0.05)
    assert fs.initialized and not fs.is_lost
    # captured when the system was built, none in the run
    assert [f.counts["count"] for f in fams] == counts
    return fs, seen, rows


def test_keyframe_programs_replay_equals_eager(cuda, monkeypatch):
    """Each of the keyframe's four programs (the activation pass, the
    post-BA flags, the tracker reference, the new candidates), on the
    run's last inputs: the graph's replay bitwise the eager program."""
    fs, seen, _ = _kf_run(monkeypatch)
    assert len(seen) == 4
    for family, (static, fn, inputs) in seen.items():
        want = fn(*inputs)
        got = family.replay(static, fn, inputs)
        assert len(got) == len(want)
        assert all(_same(g, w) for g, w in zip(got, want))


def test_keyframe_dispatch_runs_ahead_of_the_card(cuda, monkeypatch):
    """Every keyframe's dispatch from the activation through the new
    candidates queues behind ~50 ms of sleep under set_sync_debug_mode("error"),
    returns before the sleep ends (finish.ready() false), and the run's
    keyframes and poses are bitwise those of a run without the sleep."""
    fs, _, rows = _kf_run(monkeypatch, watch=True, n=24)
    ref, _, _ = _kf_run(monkeypatch, n=24)
    assert len(rows) >= 3 and not any(r[1] for r in rows), rows
    assert [f.kf_id for f in fs.all_frames] == [f.kf_id for f in ref.all_frames]
    for a, b in zip(fs.all_frames, ref.all_frames):
        assert np.array_equal(a.T_cw, b.T_cw), a.id


def test_activation_graphs_launch_k1_and_k5_once(cuda, monkeypatch):
    """A card FullSystem captures the activation's graph for every window
    size (1..F frames) when it is built; in a run each activation pass is
    one replay of one of them, which launches K1 and K5 once."""
    from ldso_tpu_torch.examples import time_modes
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.system import full_system as fsm
    fam = fsm.ACTIVATE_GRAPHS
    with time_modes.counted_activations() as acts:
        counts = dict(fam.counts)
        before = dict(cuda_kernels.LAUNCHES)
        fs, _, _ = _kf_run(monkeypatch)
        replays = fam.counts["replays"] - counts["replays"]
        captures = fam.counts["count"] - counts["count"]
    keys = {k for k in fam.graphs if k[1][1:3] == (fs.cfg, fs.calib)}
    assert {k[1][0] for k in keys} == set(range(1, fs.ef.F + 1))
    for k in keys:
        assert fam.graphs[k].launches == {"distance_transform": 1,
                                          "activate": 1}
    assert replays == acts["activations"] >= 2
    assert captures in (0, fs.ef.F)
    launched = {k: cuda_kernels.LAUNCHES[k] - before[k]
                for k in ("distance_transform", "activate")}
    # a graph captured when the system was built ran K1 and K5 once
    # before its capture
    assert launched == {"distance_transform": replays + captures,
                        "activate": replays + captures}


# ---------------------------------------------------------------------------
# the bootstrap as one captured program (frontend/initializer.INIT_GRAPHS)
# ---------------------------------------------------------------------------

def test_bootstrap_replay_is_bitwise_eager(cuda, monkeypatch):
    """A bootstrap on the card: the graph captured at the first frame
    (capture_frame_program) and no later; each frame's dispatch one
    replay, under set_sync_debug_mode("error") behind ~50 ms of sleep,
    returning before its pull is ready; each replay's outputs bitwise the
    eager masked program's on the same inputs; a key with no graph raises
    rather than capture mid-run."""
    from ldso_tpu_torch.frontend import initializer
    from ldso_tpu_torch.ops.preprocess import make_pyramid, upload_image
    from ldso_tpu_torch.utils.graphs import Programs
    calib, _, imgs = _pipeline_frames(8)
    cfg = _pipeline_cfg()
    fam = Programs(capture_on_replay=False)
    monkeypatch.setattr(initializer, "INIT_GRAPHS", fam)
    calls = []
    run = initializer._run

    def recorded(family, static, fn, inputs):
        out = run(family, static, fn, inputs)
        calls.append((fn, tuple(inputs), out))
        return out
    monkeypatch.setattr(initializer, "_run", recorded)
    pyrs = [make_pyramid(upload_image(im, cuda), calib.levels)
            for im in imgs]
    st = initializer.set_first(pyrs[0], calib, cfg)
    with pytest.raises(RuntimeError, match="no graph"):
        initializer.track_frame(st, pyrs[0], pyrs[1], calib, cfg)
    initializer.capture_frame_program(st, pyrs[0], calib, cfg)
    assert fam.counts["count"] == 1
    calls.clear()
    for k in range(1, len(imgs)):
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        torch.cuda.set_sync_debug_mode("error")
        try:
            pull = initializer.track_frame_dispatch(st, pyrs[0], pyrs[k],
                                                    calib, cfg)
            ready = pull.is_ready()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert not ready, k
        initializer.track_frame_finish(st, pull)
        assert len(st.trips) == calib.levels
    assert fam.counts["count"] == 1 and fam.counts["replays"] == len(calls)
    assert st.snapped
    for fn, inputs, out in calls:
        want = fn(*inputs)
        assert len(out) == len(want)
        assert all(_same(g, w) for g, w in zip(out, want))



def test_captured_graph_first_replay_runs_ahead(cuda):
    """A program's graph is uploaded at its capture: its first replay,
    queued behind ~60 ms of sleep, returns before the card has run it (a
    graph's first launch would otherwise upload it and hold the host
    until the card is idle), and gives the eager program's bits."""
    from ldso_tpu_torch.utils.graphs import Programs

    def program(x):
        y = x
        for _ in range(20):
            y = y * 1.0001 + 0.5
        return (y,)
    x = torch.randn(1 << 16, device=cuda)
    fam = Programs(capture_on_replay=False)
    fam.capture("toy", program, (x,))
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    (got,) = fam.replay("toy", program, (x,))
    after = torch.cuda.Event()
    after.record()
    ran_ahead = not after.query()
    torch.cuda.synchronize()
    assert ran_ahead
    assert _same(got, program(x)[0])


# K2: the frame's pyramid and the readers' rectification
# (csrc/preprocess.cu); the cases are torch_kernel_checks.pyramid_cases and
# rectify_cases
_PYR_CASES = ("uint8 640x480", "uint8 640x480 b_grad", "float32 steps",
              "float32 steps b_grad", "uint16", "uint8 97x61",
              "uint8 1241x376", "float32 620x188", "6 levels", "1 level",
              "uint8 37x23", "uint8 642x482", "float32 642x482 b_grad",
              "uint8 640x480 offset")
_RECT_CASES = ("uint8 G vignette", "uint8 G", "int32 G vignette",
               "uint8 raw", "float32 vignette", "float32",
               "uint8 G onto 597x437", "uint8 G maps offset")


@pytest.mark.parametrize("name", _PYR_CASES)
def test_pyramid_kernel_is_bitwise_plain(cuda, name):
    """K2's pyramid, one launch for every level, bitwise its plain version
    (make_pyramid_ref) on the card."""
    import torch_kernel_checks as kc
    from ldso_tpu_torch.ops import cuda_kernels, preprocess
    img, L, b = kc.pyramid_cases(cuda)[name]
    before = dict(cuda_kernels.LAUNCHES)
    got = preprocess.make_pyramid(img, L, b)
    assert cuda_kernels.LAUNCHES["pyramid"] == before["pyramid"] + 1
    assert kc.pyramid_bitwise(got, preprocess.make_pyramid_ref(img, L, b))


@pytest.mark.parametrize("name", _RECT_CASES)
def test_rectify_kernel_is_bitwise_plain(cuda, name):
    """K2's rectify, one launch, bitwise its plain version (rectify_ref)
    on the card; preprocess_frame is one rectify and one pyramid launch."""
    import torch_kernel_checks as kc
    from ldso_tpu_torch.ops import cuda_kernels, preprocess
    raw, G, vig, rx, ry = kc.rectify_cases(cuda)[name]
    before = dict(cuda_kernels.LAUNCHES)
    got = preprocess.rectify(raw, G, vig, rx, ry)
    assert cuda_kernels.LAUNCHES["rectify"] == before["rectify"] + 1
    assert kc.bits(got, preprocess.rectify_ref(raw, G, vig, rx, ry)).all()
    pyr = preprocess.preprocess_frame(raw, G, vig, rx, ry, None, 3)
    assert cuda_kernels.LAUNCHES["rectify"] == before["rectify"] + 2
    assert cuda_kernels.LAUNCHES["pyramid"] == before["pyramid"] + 1
    assert kc.pyramid_bitwise(pyr, preprocess.preprocess_frame_ref(
        raw, G, vig, rx, ry, None, 3))


@pytest.mark.parametrize("name", ("uint8 640x480 b_grad", "float32 steps",
                                  "uint8 97x61", "uint8 642x482",
                                  "uint8 37x23", "6 levels"))
def test_pyramid_kernel_plan_is_the_library_s(cuda, name):
    """The launch plan (cuda_kernels.pyramid_plan: tile, grid, threads,
    shared memory) is the library's at the case's shape and level count,
    and the launch, one, is bitwise the plain version."""
    import torch_kernel_checks as kc
    from ldso_tpu_torch.ops import cuda_kernels, preprocess
    img, L, b = kc.pyramid_cases(cuda)[name]
    plan = cuda_kernels.pyramid_plan(*img.shape, L)
    assert plan == cuda_kernels.library_pyramid_plan(*img.shape, L)
    before = cuda_kernels.LAUNCHES["pyramid"]
    got = cuda_kernels.pyramid(img, L, b)
    assert cuda_kernels.LAUNCHES["pyramid"] == before + 1
    assert kc.pyramid_bitwise(got, preprocess.make_pyramid_ref(img, L, b))


def test_pyramid_kernel_in_a_graph_and_refusals(cuda):
    """Captured into a CUDA graph the pyramid counts one launch a replay
    and gives its eager bits; a float64 frame is made float32 and takes
    one launch; the wrappers raise on what K2 does not take rather than
    run the plain version."""
    import torch_kernel_checks as kc
    from ldso_tpu_torch.ops import cuda_kernels, preprocess
    img, L, b = kc.pyramid_cases(cuda)["uint8 640x480 b_grad"]
    want = preprocess.make_pyramid(img, L, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), cuda_kernels.recording_launches() as tally:
        with torch.cuda.graph(g):
            got = preprocess.make_pyramid(img, L, b)
    torch.cuda.current_stream().wait_stream(side)
    assert tally == {"pyramid": 1}
    g.replay()
    torch.cuda.synchronize()
    assert kc.pyramid_bitwise(got, want)
    before = cuda_kernels.LAUNCHES["pyramid"]
    assert kc.pyramid_bitwise(preprocess.make_pyramid(img.double(), L),
                              preprocess.make_pyramid_ref(img.double(), L))
    assert cuda_kernels.LAUNCHES["pyramid"] == before + 1
    with pytest.raises(ValueError):
        preprocess.make_pyramid(img, cuda_kernels.PYRAMID_MAX_LEVELS + 1)
    with pytest.raises(ValueError):
        preprocess.make_pyramid(img, L, b[:128].contiguous())
    raw, G, vig, rx, ry = kc.rectify_cases(cuda)["uint8 G vignette"]
    with pytest.raises(ValueError):
        preprocess.rectify(raw.to(torch.int16), G, vig, rx, ry)
    with pytest.raises(ValueError):
        preprocess.rectify(raw, G, vig[:10], rx, ry)
