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
