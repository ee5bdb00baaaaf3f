"""The port's math and image ops against their JAX counterparts: lie,
interp, affine, preprocess, the distance map (plain version and the CUDA
kernel's wrapper), the pixel selector and the corner detector."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_utils import close, equal, j32, npy, t32, tt

from ldso_tpu.math import lie as jlie
from ldso_tpu_torch.math import lie as tlie


# ---------------------------------------------------------------- math/lie
def _xis(seed):
    rng = np.random.RandomState(seed)
    xi = rng.randn(64, 6) * np.array([0.3] * 3 + [0.8] * 3)
    xi[:8, 3:] *= 1e-6                       # Taylor branch
    xi[8:12, 3:] = 0.0
    return xi


def test_lie_se3_exp_log_inv_adj():
    """float32 batched SE3 vs JAX; transcendental and 3x3 solve rounding
    differ at the 1e-6 level, so rtol 1e-5 / atol 1e-5."""
    xi = _xis(0)
    Tj = jlie.se3_exp(j32(xi))
    Tt = tlie.se3_exp(t32(xi))
    close(Tt, Tj, 1e-5, 1e-6, "se3_exp")
    close(tlie.se3_log(Tt), jlie.se3_log(j32(npy(Tt))), 1e-4, 1e-5, "se3_log")
    close(tlie.se3_inv(Tt), jlie.se3_inv(j32(npy(Tt))), 1e-5, 1e-6, "se3_inv")
    close(tlie.se3_adj(Tt), jlie.se3_adj(j32(npy(Tt))), 1e-5, 1e-6, "se3_adj")
    close(tlie.so3_exp(t32(xi[:, 3:])), jlie.so3_exp(j32(xi[:, 3:])),
          1e-5, 1e-6, "so3_exp")


def test_lie_so3_log_near_pi():
    rng = np.random.RandomState(1)
    axis = rng.randn(16, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    w = axis * (np.pi - np.linspace(0, 1e-5, 16))[:, None]
    Rj = jlie.so3_exp(j32(w))
    close(tlie.so3_log(t32(npy(Rj))), jlie.so3_log(Rj), 1e-4, 1e-4, "near pi")
    close(tlie.hat(t32(w)), jlie.hat(j32(w)), 0, 0, "hat")
    close(tlie.vee(tlie.hat(t32(w))), jlie.vee(jlie.hat(j32(w))), 0, 0, "vee")


# ---------------------------------------------------------------- ops/interp
def test_bilinear_nearest_in_bounds():
    """Same weight factorization and W-1.001 clamp: bit-equal on CPU."""
    from ldso_tpu.ops import interp as ji
    from ldso_tpu_torch.ops import interp as ti
    rng = np.random.RandomState(2)
    img = rng.rand(24, 32, 3).astype(np.float32) * 255
    x = rng.uniform(-3, 35, (50, 8)).astype(np.float32)
    y = rng.uniform(-3, 27, (50, 8)).astype(np.float32)
    x[0, 0] = 31.0
    y[0, 1] = 23.0                          # exactly on the far border
    close(ti.bilinear(t32(img), t32(x), t32(y)),
          ji.bilinear(j32(img), j32(x), j32(y)), 0, 0, "bilinear (H,W,3)")
    close(ti.bilinear(t32(img[..., 0]), t32(x), t32(y)),
          ji.bilinear(j32(img[..., 0]), j32(x), j32(y)), 0, 0, "bilinear (H,W)")
    close(ti.nearest(t32(img), t32(x), t32(y)),
          ji.nearest(j32(img), j32(x), j32(y)), 0, 0, "nearest")
    equal(ti.in_bounds(t32(x), t32(y), 32, 24),
          ji.in_bounds(j32(x), j32(y), 32, 24), "in_bounds")


def test_affine_from_to():
    from ldso_tpu.frontend import affine as ja
    from ldso_tpu_torch.frontend import affine as ta
    rng = np.random.RandomState(3)
    af = rng.randn(10, 2).astype(np.float32)
    at = rng.randn(10, 2).astype(np.float32)
    ef = np.array([1.0, 0.0, 2.0, 0.5, 1.0, 1.0, 3.0, 0.0, 1.0, 2.0], np.float32)
    et = np.array([1.0, 1.0, 0.0, 2.0, 1.5, 1.0, 3.0, 0.0, 0.7, 2.0], np.float32)
    close(ta.from_to(t32(ef), t32(et), t32(af), t32(at)),
          ja.from_to(j32(ef), j32(et), j32(af), j32(at)), 1e-6, 1e-6, "from_to")


# ---------------------------------------------------------------- preprocess
@pytest.mark.parametrize("kind", ["uint8", "float32", "uint16"])
@pytest.mark.parametrize("lut", [False, True])
def test_make_pyramid(kind, lut):
    """Box filter + central differences: integer inputs are exact, float
    ones agree to 1e-5 relative (summation order)."""
    from ldso_tpu.ops.preprocess import make_pyramid as jmp
    from ldso_tpu_torch.ops.preprocess import make_pyramid as tmp
    rng = np.random.RandomState(4)
    base = rng.rand(96, 128) * 255
    img = {"uint8": base.astype(np.uint8),
           "float32": base.astype(np.float32),
           "uint16": (base * 256).astype(np.uint16)}[kind]
    b = (np.linspace(0.5, 2.0, 256).astype(np.float32) if lut else None)
    pj = jmp(jnp.asarray(img), 4, None if b is None else j32(b))
    pt = tmp(tt(img), 4, None if b is None else t32(b))
    for lvl in range(4):
        close(pt.dI[lvl], pj.dI[lvl], 1e-5, 1e-4, f"dI {lvl}")
        close(pt.abs_grad[lvl], pj.abs_grad[lvl], 1e-5, 1e-3, f"ag {lvl}")
    from ldso_tpu_torch.utils import convert
    back = convert.pyramid_to_numpy(convert.pyramid_to_torch(pj))
    for lvl in range(4):
        equal(back["dI"][lvl], pj.dI[lvl], f"round trip dI {lvl}")
        equal(back["abs_grad"][lvl], pj.abs_grad[lvl], f"round trip ag {lvl}")


def test_preprocess_frame_luts_and_remap():
    from ldso_tpu.ops.preprocess import preprocess_frame as jpf
    from ldso_tpu_torch.ops.preprocess import preprocess_frame as tpf
    rng = np.random.RandomState(5)
    raw = (rng.rand(50, 70) * 255).astype(np.uint8)
    G = np.cumsum(rng.rand(256)).astype(np.float32)
    G = G / G[-1] * 255
    vig = (0.7 + 0.3 * rng.rand(50, 70)).astype(np.float32)
    rx = rng.uniform(-1, 70, (48, 64)).astype(np.float32)
    ry = rng.uniform(0, 49, (48, 64)).astype(np.float32)
    rx[rx < 0] = -1.0
    pj = jpf(jnp.asarray(raw), j32(G), j32(1.0 / vig), j32(rx), j32(ry), None, 3)
    pt = tpf(tt(raw), t32(G), t32(1.0 / vig), t32(rx), t32(ry), None, 3)
    for lvl in range(3):
        close(pt.dI[lvl], pj.dI[lvl], 1e-5, 1e-4, f"dI {lvl}")


# ---------------------------------------------------------------- distance map
@pytest.mark.parametrize("shape,p,max_k", [((64, 96), 0.01, 40),
                                           ((61, 97), 0.02, 18),
                                           ((32, 32), 0.0, 18),
                                           ((40, 56), 1.0, 40)])
def test_distance_transform_matches_xla_and_pallas(shape, p, max_k):
    """Exact (atol 0) against the XLA twin and the Pallas kernel in
    interpret mode, which is how tests/test_select.py runs it."""
    from ldso_tpu.ops.distance_map import distance_transform
    from ldso_tpu.ops.pallas_kernels import distance_transform_pallas
    from ldso_tpu_torch.ops.distance_map import distance_transform_ref
    rng = np.random.RandomState(6)
    occ = rng.rand(*shape) < p
    ref = distance_transform_ref(torch.from_numpy(occ), max_k)
    close(ref, distance_transform(jnp.asarray(occ), max_k), 0, 0, "xla")
    close(ref, distance_transform_pallas(jnp.asarray(occ), max_k,
                                         interpret=True), 0, 0, "pallas")


def test_distance_wrapper_cpu_path_is_plain_version():
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.ops.distance_map import distance_transform_ref
    occ = torch.from_numpy(np.random.RandomState(7).rand(30, 40) < 0.05)
    before = cuda_kernels.LAUNCHES["distance_transform"]
    equal(cuda_kernels.distance_transform(occ, 18),
          distance_transform_ref(occ, 18))
    # the counter counts kernel launches only
    assert cuda_kernels.LAUNCHES["distance_transform"] == before


# ---------------------------------------------------------------- ops/select
def _pyr(seed=9, w=256, h=192):
    from ldso_tpu.ops.preprocess import make_pyramid as jmp
    from ldso_tpu_torch.ops.preprocess import make_pyramid as tmp
    from ldso_tpu.synthetic import PlaneScene
    from ldso_tpu.synthetic import default_calib
    calib = default_calib(w, h)
    img, _ = PlaneScene(freq_hi=25.0, contrast=80.0, seed=seed).render(
        calib, jnp.eye(4, dtype=jnp.float32))
    img8 = np.clip(np.round(np.asarray(img)), 0, 255).astype(np.uint8)
    return (jmp(jnp.asarray(img8), calib.levels),
            tmp(tt(img8), calib.levels), calib)


def test_block_dir_bit_for_bit():
    from ldso_tpu.ops.select import _block_dir as jbd
    from ldso_tpu_torch.ops.select import _block_dir as tbd
    for bs, seed, salt in ((3, 3141592, 2), (6, 7, 3), (12, 3141592, 5)):
        equal(tbd(37, 53, bs, seed, salt, "cpu"), jbd(37, 53, bs, seed, salt))


def test_selector_maps_exact():
    """Threshold map, hierarchical selection, thinning and the density
    adaptation give the same status maps (atol 0)."""
    from ldso_tpu.config import Config as JC
    from ldso_tpu.ops import select as js
    from ldso_tpu_torch.config import Config as TC
    from ldso_tpu_torch.ops import select as ts
    pj, pt, calib = _pyr()
    close(ts.make_threshold_map(pt.abs_grad[0]),
          js.make_threshold_map(pj.abs_grad[0]), 0, 0, "threshold map")
    ths = ts.make_threshold_map(pt.abs_grad[0])
    for pot in (1, 3, 5):
        st, ct = ts.select(pt.dI[0], pt.abs_grad[0], pt.abs_grad[1],
                           pt.abs_grad[2], ths, pot, 2.0)
        sj, cj = js.select(pj.dI[0], pj.abs_grad[0], pj.abs_grad[1],
                           pj.abs_grad[2], j32(npy(ths)), pot, 2.0)
        equal(st, sj, f"select pot={pot}")
        equal(ct, cj)
    jsel = js.PixelSelector(calib.w[0], calib.h[0], JC())
    tsel = ts.PixelSelector(calib.w[0], calib.h[0], TC())
    equal(tsel.random_pattern, jsel.random_pattern)
    for density in (300.0, 800.0, 3000.0):
        sj, nj = jsel.make_maps(pj, density)
        st, nt = tsel.make_maps(pt, density)
        equal(st, sj, f"make_maps {density}")
        assert nt == nj and tsel.current_potential == jsel.current_potential
    quotia = np.float32(0.37)
    equal(ts._subsample(st, tsel.random_pattern, float(quotia)),
          js._subsample(sj, jsel.random_pattern, jnp.float32(quotia)))


def test_make_pixel_status_exact():
    from ldso_tpu.ops import select as js
    from ldso_tpu_torch.ops import select as ts
    pj, pt, _ = _pyr(seed=10)
    for lvl, dens in ((1, 400.0), (2, 150.0)):
        oj, nj, sj = js.make_pixel_status(pj.dI[lvl], dens)
        ot, nt, st = ts.make_pixel_status(pt.dI[lvl], dens)
        equal(ot, oj, f"level {lvl}")
        assert (nt, st) == (int(nj), sj)


# ---------------------------------------------------------------- detector
def test_detector_status_map_exact():
    """Shi-Tomasi map within 1e-5 relative; the status map exact, which
    pins lax.top_k's tie order and the masked (not dropped) scatter."""
    from ldso_tpu.frontend import detector as jd
    from ldso_tpu_torch.frontend import detector as td
    pj, pt, calib = _pyr(seed=11, w=160, h=120)
    close(td.shi_tomasi_map(pt.dI[0]), jd.shi_tomasi_map(pj.dI[0]),
          1e-5, 1e-3, "shi_tomasi")
    for n in (400, 1500):
        gp = td.detect_grid_params(calib.h[0], calib.w[0], n)
        assert gp == jd.detect_grid_params(calib.h[0], calib.w[0], n)
        equal(td.detect_status_map(pt.dI[0], pt.abs_grad[0], *gp),
              jd.detect_status_map(pj.dI[0], pj.abs_grad[0], *gp), f"n={n}")


def test_detector_ties_keep_lower_index():
    """A flat-gradient image makes every score tie: the port must keep
    the lower in-cell index like lax.top_k."""
    from ldso_tpu.frontend import detector as jd
    from ldso_tpu_torch.frontend import detector as td
    H, W = 96, 128
    dI = np.zeros((H, W, 3), np.float32)
    dI[..., 1] = 20.0
    ag = np.full((H, W), 400.0, np.float32)
    gp = td.detect_grid_params(H, W, 300)
    equal(td.detect_status_map(t32(dI), t32(ag), *gp),
          jd.detect_status_map(j32(dI), j32(ag), *gp))
