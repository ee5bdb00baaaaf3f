"""Tests that need a CUDA card: the port's hand-written kernels against
their plain PyTorch versions, and the main path on the card against the
same path on the CPU. They skip where there is no card.

This file imports neither jax nor ldso_tpu, so it also runs on a machine
without JAX, where tests/conftest.py (which imports jax) cannot load:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py
"""

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
    from ldso_tpu_torch.system.full_system import (record_event,
                                                   use_on_current_stream)
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
    the mapping thread's stream."""
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.system.full_system import FullSystem
    from ldso_tpu_torch.system.pipeline import AsyncPipeline
    calib, poses, imgs = _pipeline_frames(20)
    fs = FullSystem(calib, _pipeline_cfg())
    streams = []
    kernel = cuda_kernels.distance_transform

    def traced(occ, max_k=18):
        streams.append(torch.cuda.current_stream(occ.device).cuda_stream)
        return kernel(occ, max_k)
    monkeypatch.setattr(cuda_kernels, "distance_transform", traced)
    drv = AsyncPipeline(fs)
    for i, im in enumerate(imgs):
        drv.add_active_frame(im, i, 1.0, i * 0.05)
    drv.block_until_mapping_is_finished()
    assert fs.initialized and not fs.is_lost
    kfs = fs.global_map.get_all_kfs()
    assert len(kfs) >= 3
    boot = sorted(k.id for k in kfs)[1]
    # bootstrap keyframes run on the caller's thread under the mapping
    # stream, the later ones on the mapping thread
    assert streams and set(streams) == {drv.map_stream.cuda_stream}
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
    """Bitwise equality, NaN payloads included."""
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


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
