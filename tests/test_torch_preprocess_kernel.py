"""K2, the frame's pyramid and the readers' rectification
(ldso_tpu_torch/csrc/preprocess.cu), on the CPU: the wrappers' CPU path is
their plain version bit for bit, and the plain versions hold against the
JAX package's jitted program. The kernel itself against its plain version
is in tests/test_torch_cuda.py (`-k pyramid or rectify`) and chip_smoke.py's
phase 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_kernel_checks as kc
from ldso_tpu_torch.ops import cuda_kernels
from ldso_tpu_torch.ops import preprocess as tp

jax.config.update("jax_platforms", "cpu")

PYR_CASES = kc.pyramid_cases("cpu")
RECT_CASES = kc.rectify_cases("cpu")


def _j(t):
    return None if t is None else jnp.asarray(t.numpy())


@pytest.mark.parametrize("name", sorted(PYR_CASES))
def test_pyramid_wrapper_cpu_path_is_plain(name):
    """A CPU frame takes make_pyramid_ref, bit for bit, and counts no
    launch."""
    img, L, b = PYR_CASES[name]
    before = dict(cuda_kernels.LAUNCHES)
    got = tp.make_pyramid(img, L, b)
    assert kc.pyramid_bitwise(got, tp.make_pyramid_ref(img, L, b))
    assert [tuple(t.shape[:2]) for t in got.dI] == \
        cuda_kernels.pyramid_shapes(*img.shape, L)
    assert cuda_kernels.LAUNCHES == before


@pytest.mark.parametrize("name", sorted(RECT_CASES))
def test_rectify_wrapper_cpu_path_is_plain(name):
    """A CPU frame takes rectify_ref, bit for bit, and counts no launch;
    preprocess_frame is the rectification's pyramid."""
    raw, G, vig, rx, ry = RECT_CASES[name]
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.rectify(raw, G, vig, rx, ry)
    want = tp.rectify_ref(raw, G, vig, rx, ry)
    assert kc.bits(got, want).all()
    assert kc.pyramid_bitwise(tp.preprocess_frame(raw, G, vig, rx, ry, None,
                                                  3),
                              tp.make_pyramid_ref(want, 3))
    assert cuda_kernels.LAUNCHES == before


@pytest.mark.parametrize("b_grad", [False, True])
@pytest.mark.parametrize("kind", ["uint8", "uint16", "float32"])
def test_plain_pyramid_matches_jax(kind, b_grad):
    """The bench scene at 640x480, the main path's 4 levels: a uint8 or
    uint16 frame's pyramid is the JAX package's bit for bit (every level's
    mean is exact and absSquaredGrad rounds once, as XLA:CPU's contracted
    multiply-add); a float32 frame's within 1e-5 relative (the 2x2 mean's
    order of sums differs from XLA's), its level 0 exact."""
    img = {"uint8": PYR_CASES["uint8 640x480"][0],
           "uint16": PYR_CASES["uint16"][0],
           "float32": PYR_CASES["float32 steps"][0]}[kind]
    b = kc._b_grad_table() if b_grad else None
    pt = tp.make_pyramid_ref(img, kc.PYR_LEVELS, b)
    from ldso_tpu.ops.preprocess import make_pyramid as jmp
    pj = jmp(jnp.asarray(img.numpy()), kc.PYR_LEVELS, _j(b))
    for lvl in range(kc.PYR_LEVELS):
        for got, want in ((pt.dI[lvl], pj.dI[lvl]),
                          (pt.abs_grad[lvl], pj.abs_grad[lvl])):
            want = np.asarray(want)
            if kind != "float32" or lvl == 0:
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"level {lvl}")
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                           atol=1e-3, err_msg=f"level {lvl}")


@pytest.mark.parametrize("name", sorted(RECT_CASES))
def test_plain_preprocess_frame_matches_jax(name):
    """The response table with uint8 and int32 raw, the inverse vignette,
    invalid and edge-clamped remap coordinates, onto 600x440 (levels that
    end odd: 75x55 at level 3): within 1e-5 relative of the JAX package's
    jitted preprocess_frame (XLA:CPU contracts the remap's blend), the
    invalid pixels 0 in both."""
    from ldso_tpu.ops.preprocess import preprocess_frame as jpf
    raw, G, vig, rx, ry = RECT_CASES[name]
    pt = tp.preprocess_frame_ref(raw, G, vig, rx, ry, None, 4)
    pj = jpf(jnp.asarray(raw.numpy()), _j(G), _j(vig), _j(rx), _j(ry), None,
             4)
    invalid = (rx < 0).numpy()
    assert invalid.any() and (rx > 639).any() and (ry < 0).any()
    assert (pt.dI[0][..., 0].numpy()[invalid] == 0).all()
    for lvl in range(4):
        np.testing.assert_allclose(pt.dI[lvl].numpy(), np.asarray(pj.dI[lvl]),
                                   rtol=1e-5, atol=1e-3,
                                   err_msg=f"dI {lvl}")
        np.testing.assert_allclose(pt.abs_grad[lvl].numpy(),
                                   np.asarray(pj.abs_grad[lvl]), rtol=1e-4,
                                   atol=1e-2, err_msg=f"ag {lvl}")


def test_plain_mean_is_torch_cpu_mean():
    """The plain 2x2 mean, written out as (a00 + a01) + (a10 + a11) so that
    the card sums alike, is torch's mean on the CPU bit for bit, so float
    frames' pyramids on the CPU kept their bits."""
    img = PYR_CASES["float32 steps"][0]
    H, W = img.shape
    want = img.reshape(H // 2, 2, W // 2, 2).mean(dim=(1, 3))
    assert kc.bits(tp._downsample2(img), want).all()
    odd = PYR_CASES["float32 620x188"][0][:187, :619]
    want = odd[:186, :618].reshape(93, 2, 309, 2).mean(dim=(1, 3))
    assert kc.bits(tp._downsample2(odd), want).all()


def test_abs_grad_is_one_rounding():
    """absSquaredGrad is dx^2 + dy^2 rounded once (fma(dx, dx, dy * dy)),
    which two float32 roundings miss on some pixels of a float frame."""
    from ldso_tpu_torch.math.rounding import fma
    img = PYR_CASES["float32 steps"][0]
    pyr = tp.make_pyramid_ref(img, 1)
    dx, dy = pyr.dI[0][..., 1], pyr.dI[0][..., 2]
    assert kc.bits(pyr.abs_grad[0], fma(dx, dx, dy * dy)).all()
    assert not kc.bits(pyr.abs_grad[0], dx * dx + dy * dy).all()
    # the > 255 steps: the differences across the planted column and row
    # are zeroed, the ones along them are not
    assert (pyr.dI[0][110, [299, 301], 1] == 0).all()
    assert (pyr.dI[0][[199, 201], 60, 2] == 0).all()
    assert (pyr.dI[0][110, 300, 1] != 0) and (pyr.dI[0][200, 60, 2] != 0)


@pytest.mark.parametrize("levels", range(1, cuda_kernels.PYRAMID_MAX_LEVELS + 1))
def test_pyramid_plan(levels):
    """K2's launch plan: PYRAMID_TILE, whose sides 2^(L-1) divides at
    every level count (so every coarse level's tile is whole), one coarse
    block per tile over the frame (none for one level), then enough
    level-0 blocks for a quad of four pixels of every row a thread, and
    the shared memory of the coarse levels' regions (the tile and its
    2^(L-1) halo, halved per level, levels 1 .. L-1) as float32; a frame
    smaller than a tile takes one block of each kind."""
    halo = 1 << (levels - 1)
    plan = cuda_kernels.pyramid_plan(480, 640, levels)
    tx, ty = plan["tile"]
    assert (tx, ty) == cuda_kernels.PYRAMID_TILE
    assert tx % halo == 0 and ty % halo == 0
    coarse = (-(-640 // tx)) * (-(-480 // ty)) if levels > 1 else 0
    assert plan["coarse_blocks"] == coarse
    assert plan["threads"] == cuda_kernels.PYRAMID_THREADS
    assert plan["level0_blocks"] * plan["threads"] >= 480 * 160
    assert (plan["level0_blocks"] - 1) * plan["threads"] < 480 * 160
    assert plan["grid"] == coarse + plan["level0_blocks"]
    want = sum(((tx + 2 * halo) >> lvl) * ((ty + 2 * halo) >> lvl)
               for lvl in range(1, levels)) * 4
    assert plan["smem"] == want
    small = cuda_kernels.pyramid_plan(23, 37, levels)
    assert small["coarse_blocks"] == (1 if levels > 1 else 0)
    # 23 rows of 10 quads (the last one a single pixel wide)
    assert small["level0_blocks"] == 1


def test_pyramid_plan_at_the_main_path():
    """At 640x480 with 4 levels: 64x32 coarse tiles, 150 coarse blocks and
    300 level-0 blocks of 256 threads (76,800 quads), and 5,040 B of
    shared memory (40x24 + 20x12 + 10x6 floats); 6 levels take the same
    tile and 16,368 B (64x48 + 32x24 + 16x12 + 8x6 + 4x3 floats); one
    level no coarse block and no shared memory; 7 levels and 0 raise."""
    plan = cuda_kernels.pyramid_plan(480, 640, 4)
    assert plan == dict(tile=(64, 32), coarse_blocks=150, level0_blocks=300,
                        grid=450, threads=256, smem=5040)
    six = cuda_kernels.pyramid_plan(480, 640, 6)
    assert six["tile"] == (64, 32) and six["smem"] == 16368
    one = cuda_kernels.pyramid_plan(480, 640, 1)
    assert one["coarse_blocks"] == 0 and one["smem"] == 0
    for bad in (0, cuda_kernels.PYRAMID_MAX_LEVELS + 1):
        with pytest.raises(ValueError):
            cuda_kernels.pyramid_plan(480, 640, bad)
