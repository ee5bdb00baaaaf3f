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


@pytest.mark.parametrize("shape", [(240, 320), (96, 128), (61, 97)])
def test_distance_kernel_matches_plain(cuda, shape):
    """Exact (atol 0) at every occupancy and both sweep counts."""
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.ops.distance_map import distance_transform_ref
    rng = np.random.RandomState(8)
    before = cuda_kernels.LAUNCHES["distance_transform"]
    for p in (0.0, 0.005, 0.02, 0.1, 1.0):
        occ = torch.from_numpy(rng.rand(*shape) < p).to(cuda)
        for max_k in (18, 40):
            got = cuda_kernels.distance_transform(occ, max_k)
            want = distance_transform_ref(occ, max_k)
            assert torch.equal(got, want), (shape, p, max_k)
        got8 = cuda_kernels.distance_transform(occ.to(torch.uint8), 18)
        assert torch.equal(got8, distance_transform_ref(occ, 18))
    assert cuda_kernels.LAUNCHES["distance_transform"] == before + 15


def test_distance_kernel_refuses_what_it_cannot_take(cuda):
    from ldso_tpu_torch.ops import cuda_kernels
    with pytest.raises(ValueError, match="shared"):
        cuda_kernels.distance_transform(
            torch.zeros(1000, 1000, dtype=torch.bool, device=cuda), 18)
    with pytest.raises(ValueError):
        cuda_kernels.distance_transform(
            torch.zeros(8, 8, dtype=torch.float32, device=cuda), 18)
    with pytest.raises(ValueError):
        cuda_kernels.distance_transform(
            torch.zeros(8, 8, dtype=torch.bool, device=cuda), 300)
    with pytest.raises(ValueError):
        cuda_kernels.distance_transform(
            torch.zeros(8, 16, dtype=torch.bool, device=cuda)[:, ::2], 18)


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
