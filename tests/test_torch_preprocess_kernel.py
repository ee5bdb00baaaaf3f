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
