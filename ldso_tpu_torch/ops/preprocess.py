"""Per-frame preprocessing: photometric correction, rectification, pyramid
and gradients.

Counterpart of ldso_tpu/ops/preprocess.py. Replaces the reference's
PhotometricUndistorter::processFrame (Undistort.cc:190-233), the bilinear
rectification remap (Undistort.cc:358-470) and FrameHessian::makeImages
(FrameHessian.cc:44-113). The output `FramePyramid` holds per level an
(H, W, 3) tensor of (intensity, dx, dy) plus the selector's gradient map.

`make_pyramid` and `preprocess_frame` go through K2's wrappers
(ops/cuda_kernels.pyramid and rectify, csrc/preprocess.cu): on the card
one launch builds every level of the pyramid and one rectifies a raw
frame; on the CPU their plain versions `make_pyramid_ref` and
`rectify_ref` (`preprocess_frame_ref`) run. absSquaredGrad is
fma(dx, dx, dy * dy), rounded once as the JAX package's jitted program
rounds it on the CPU, so a uint8 frame's pyramid is the JAX package's bit
for bit; a float frame's coarser levels differ from it by the order of
the 2x2 mean's sum.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ldso_tpu_torch.math.rounding import fma
from ldso_tpu_torch.ops import cuda_kernels


class FramePyramid(NamedTuple):
    """Per-level (H, W, 3) = (I, dx, dy), and (H, W) absSquaredGrad."""
    dI: Tuple[torch.Tensor, ...]
    abs_grad: Tuple[torch.Tensor, ...]

    @property
    def levels(self) -> int:
        return len(self.dI)

    def image(self, lvl: int = 0) -> torch.Tensor:
        return self.dI[lvl][..., 0]


def _grad_and_abs(I, b_grad_lut):
    """Central-difference gradients, zero at the borders and where |g| >
    255; absSquaredGrad optionally reweighted by the forward-response
    gradient (FrameHessian.cc:75-99)."""
    dx = 0.5 * (torch.roll(I, -1, dims=1) - torch.roll(I, 1, dims=1))
    dy = 0.5 * (torch.roll(I, -1, dims=0) - torch.roll(I, 1, dims=0))
    H, W = I.shape
    col = torch.arange(W, device=I.device)
    row = torch.arange(H, device=I.device)[:, None]
    edge = (col == 0) | (col == W - 1) | (row == 0) | (row == H - 1)
    zero = torch.zeros((), dtype=I.dtype, device=I.device)
    dx = torch.where(edge, zero, dx)
    dy = torch.where(edge, zero, dy)
    dx = torch.where(torch.abs(dx) > 255.0, zero, dx)
    dy = torch.where(torch.abs(dy) > 255.0, zero, dy)
    ag = fma(dx, dx, dy * dy)          # XLA:CPU contracts it
    if b_grad_lut is not None:
        c = torch.clamp(torch.round(I).long(), 5, 250)
        gw = b_grad_lut[c]
        ag = ag * (gw * gw)
    return dx, dy, ag


def _downsample2(I):
    """2x2 box filter (FrameHessian.cc:66-79): (a00 + a01) + (a10 + a11)
    times 0.25, the order of torch's mean on the CPU written out, so that
    the card sums alike. (The JAX package's jitted mean sums row by row at
    some levels and shapes and in this order at others.)"""
    H, W = I.shape
    q = I[:(H // 2) * 2, :(W // 2) * 2].reshape(H // 2, 2, W // 2, 2)
    return ((q[:, 0, :, 0] + q[:, 0, :, 1])
            + (q[:, 1, :, 0] + q[:, 1, :, 1])) * 0.25


def _make_pyramid_impl(img, levels: int, b_grad_lut=None) -> FramePyramid:
    dIs, ags = [], []
    I = img
    for lvl in range(levels):
        if lvl > 0:
            I = _downsample2(I)
        dx, dy, ag = _grad_and_abs(I, b_grad_lut)
        dIs.append(torch.stack([I, dx, dy], dim=-1))
        ags.append(ag)
    return FramePyramid(dI=tuple(dIs), abs_grad=tuple(ags))


def _to_intensity(img: torch.Tensor) -> torch.Tensor:
    """uint8 raw intensities, uint16 8.8 fixed point, or float (JAX
    counterpart: _to_intensity, preprocess.py:92-103)."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32)
    if img.dtype == torch.uint16:
        return img.to(torch.float32) * (1.0 / 256.0)
    return img.to(torch.float32)


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`. To the card it goes through pinned memory
    with non_blocking=True, so the caller does not wait for the copy (a
    pageable copy waits for the stream); the caching host allocator keeps
    the pinned buffer until the copy has run."""
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def upload_image(image, device) -> torch.Tensor:
    """Host -> device upload keeping uint8/uint16 compact (decoded on the
    device by _to_intensity); float images are cast to float32. A tensor
    input is moved to `device` as it is."""
    if isinstance(image, torch.Tensor):
        return to_device(image, device)
    image = np.asarray(image)
    if image.dtype not in (np.uint8, np.uint16):
        image = image.astype(np.float32)
    return to_device(torch.from_numpy(np.ascontiguousarray(image)), device)


def make_pyramid(img: torch.Tensor, levels: int, b_grad_lut=None) -> FramePyramid:
    """img: (H, W) rectified image (float, uint8 or uint16 8.8) on the
    target device (FrameHessian::makeImages equivalent): on the card one
    K2 launch (uint8, uint16 or float32 frames), on the CPU
    `make_pyramid_ref`."""
    return cuda_kernels.pyramid(img, levels, b_grad_lut)


def make_pyramid_ref(img: torch.Tensor, levels: int,
                     b_grad_lut=None) -> FramePyramid:
    """The plain version of K2's pyramid."""
    return _make_pyramid_impl(_to_intensity(img), levels, b_grad_lut)


def preprocess_frame(raw: torch.Tensor, G_lut: Optional[torch.Tensor],
                     vignette_inv: Optional[torch.Tensor],
                     remap_x: torch.Tensor, remap_y: torch.Tensor,
                     b_grad_lut: Optional[torch.Tensor],
                     levels: int) -> FramePyramid:
    """Response LUT, vignette, bilinear remap (invalid -> 0), pyramid: on
    the card K2's rectify then its pyramid, on the CPU
    `preprocess_frame_ref`."""
    return make_pyramid(rectify(raw, G_lut, vignette_inv, remap_x, remap_y),
                        levels, b_grad_lut)


def rectify(raw: torch.Tensor, G_lut: Optional[torch.Tensor],
            vignette_inv: Optional[torch.Tensor], remap_x: torch.Tensor,
            remap_y: torch.Tensor) -> torch.Tensor:
    """The raw frame rectified and photometrically corrected, (h, w)
    float32: on the card one K2 rectify launch, on the CPU `rectify_ref`."""
    return cuda_kernels.rectify(raw, G_lut, vignette_inv, remap_x, remap_y)


def preprocess_frame_ref(raw, G_lut, vignette_inv, remap_x, remap_y,
                         b_grad_lut, levels: int) -> FramePyramid:
    """The plain version of `preprocess_frame`."""
    return make_pyramid_ref(rectify_ref(raw, G_lut, vignette_inv, remap_x,
                                        remap_y), levels, b_grad_lut)


def rectify_ref(raw: torch.Tensor, G_lut: Optional[torch.Tensor],
                vignette_inv: Optional[torch.Tensor], remap_x: torch.Tensor,
                remap_y: torch.Tensor) -> torch.Tensor:
    """The plain version of K2's rectify: (h, w) float32 of the raw
    (h_org, w_org) frame through the response LUT (integer raw only), the
    inverse vignette and the bilinear remap, 0 where remap_x < 0."""
    if G_lut is not None and not torch.is_floating_point(raw):
        linear = G_lut[raw.long()]
    else:
        linear = raw.to(torch.float32)
    if vignette_inv is not None:
        linear = linear * vignette_inv

    h_org, w_org = linear.shape
    valid = remap_x >= 0
    xs = torch.clamp(remap_x, 0.0, w_org - 1.001)
    ys = torch.clamp(remap_y, 0.0, h_org - 1.001)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = xs - x0
    fy = ys - y0
    flat = linear.reshape(-1)
    idx = y0.long() * w_org + x0.long()
    v00 = flat[idx]
    v01 = flat[idx + 1]
    v10 = flat[idx + w_org]
    v11 = flat[idx + w_org + 1]
    fxy = fx * fy
    rect = (fxy * v11 + (fy - fxy) * v10 + (fx - fxy) * v01
            + (1.0 - fx - fy + fxy) * v00)
    return torch.where(valid, rect, torch.zeros_like(rect)).to(torch.float32)
