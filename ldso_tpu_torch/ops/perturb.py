"""Synthetic robustness perturbations: geometric noise + variable blur.

Counterpart of ldso_tpu/ops/perturb.py (the reference's benchmark knobs
benchmark_varNoise / benchmark_varBlurNoise / benchmark_noiseGridsize;
Undistort.cc:372-470, applyBlurNoise :480-540, Setting.cc:95-101): smooth
random warp fields and spatially varying separable Gaussian blur.

The JAX package draws its fields with jax.random, which torch cannot
reproduce, so the draw is split from the apply: `perturb_fields` draws
the uniform (g, g) control grids from a device torch.Generator seeded with
the frame index, and `warp_noise` / `blur_noise` / `benchmark_perturb`
apply given grids (the tests feed them the JAX package's draws).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as tnf

from ldso_tpu_torch.ops.interp import bilinear


class PerturbFields(NamedTuple):
    """Uniform [0, 1) control grids, (g, g) each, g = grid_size + 8."""
    warp_x: torch.Tensor
    warp_y: torch.Tensor
    blur_x: torch.Tensor
    blur_y: torch.Tensor


def perturb_fields(seed: int, grid_size: int, device) -> PerturbFields:
    """The four control grids of one frame, from a generator on `device`
    seeded with `seed` (the frame index: the reference draws from an
    unseeded rand() here, SURVEY §4 asks for determinism)."""
    g = grid_size + 8
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand((4, g, g), generator=gen, device=device)
    return PerturbFields(*u)


def _grid_coords(H: int, W: int, grid_size: int, device):
    xs = torch.arange(W, dtype=torch.float32, device=device)[None].expand(H, W)
    ys = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    return xs, ys, 4.0 + xs / W * grid_size, 4.0 + ys / H * grid_size


def warp_noise(img: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor,
               var_noise: float, grid_size: int = 3) -> torch.Tensor:
    """Displace the sampling coordinates by a smooth field of amplitude
    +-var_noise px, interpolated from the (g, g) uniform grids ux, uy."""
    H, W = img.shape
    nx = (ux - 0.5) * 2.0 * var_noise
    ny = (uy - 0.5) * 2.0 * var_noise
    xs, ys, gx, gy = _grid_coords(H, W, grid_size, img.device)
    dx = bilinear(nx, gx, gy)
    dy = bilinear(ny, gx, gy)
    return bilinear(img, torch.clamp(xs + dx, 0.01, W - 1.01),
                    torch.clamp(ys + dy, 0.01, H - 1.01))


def blur_noise(img: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor,
               var_blur: float, grid_size: int = 3,
               max_radius: int = 6) -> torch.Tensor:
    """Spatially varying separable Gaussian blur, sigma in [0, var_blur]
    interpolated from the (g, g) uniform grids (fixed-footprint kernels)."""
    H, W = img.shape
    _, _, gx, gy = _grid_coords(H, W, grid_size, img.device)
    sig_x = torch.clamp(bilinear(ux * var_blur, gx, gy), min=0.01)
    sig_y = torch.clamp(bilinear(uy * var_blur, gx, gy), min=0.01)
    r = max_radius

    def separable(im, sig, axis):
        num = torch.zeros_like(im)
        den = torch.zeros_like(im)
        padded = tnf.pad(im[None, None], (r, r, r, r), mode="replicate")[0, 0]
        for d in range(-r, r + 1):
            w = torch.exp(-0.5 * (d / sig) ** 2)
            if axis == 1:
                s = padded[r:r + H, r + d:r + d + W]
            else:
                s = padded[r + d:r + d + H, r:r + W]
            num = num + w * s
            den = den + w
        return num / den

    return separable(separable(img, sig_x, 1), sig_y, 0)


def benchmark_perturb(img: torch.Tensor, fields: PerturbFields,
                      var_noise: float = 0.0, var_blur: float = 0.0,
                      grid_size: int = 3) -> torch.Tensor:
    """The reference's perturbations in its order: warp noise first (it
    jitters the remap inside `undistort<T>`, Undistort.cc:372-470), then the
    variable blur (applyBlurNoise, :480-540); a knob <= 0 skips its stage
    (Setting.cc:95-101)."""
    if var_noise > 0.0:
        img = warp_noise(img, fields.warp_x, fields.warp_y, var_noise,
                         grid_size)
    if var_blur > 0.0:
        img = blur_noise(img, fields.blur_x, fields.blur_y, var_blur,
                         grid_size)
    return img
