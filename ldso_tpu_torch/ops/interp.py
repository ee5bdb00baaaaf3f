"""Bilinear and nearest interpolation gathers.

Counterpart of ldso_tpu/ops/interp.py: the reference's
getInterpolatedElement* family (include/internal/GlobalFuncs.h:55-230) as
batched flat-index gathers. Coordinates are (x, y) with x along width;
out-of-range coordinates are clamped, and callers mask validity themselves.

The JAX package's tap and pattern packing (`pack_taps`, `pack_pattern*`)
and its optimization-barrier fences are TPU gather workarounds with results
identical to the plain gathers below, so they have no counterpart here.
"""

from __future__ import annotations

import torch


def _floor_index(c, hi: float):
    """Clamp a coordinate like the reference and split it into its integer
    cell and the cell's float corner. A NaN coordinate indexes cell 0 and
    keeps its NaN weight, as XLA's saturating float->int conversion does."""
    c = torch.clamp(c, 0.0, hi)
    c0 = torch.floor(c)
    ci = torch.where(torch.isnan(c0), torch.zeros_like(c0), c0).long()
    return c, c0, ci


def bilinear(img, x, y):
    """img: (H, W) or (H, W, C); x, y: (...) float. Returns (...) or (..., C).

    Uses the weight factorization of getInterpolatedElement
    (GlobalFuncs.h:55-67) and the W-1.001 clamp that keeps the +1 taps in
    range."""
    H, W = img.shape[0], img.shape[1]
    x, x0, xi = _floor_index(x, W - 1.001)
    y, y0, yi = _floor_index(y, H - 1.001)
    dx = (x - x0).to(img.dtype)
    dy = (y - y0).to(img.dtype)
    flat = img.reshape((H * W,) + tuple(img.shape[2:]))
    idx = yi * W + xi
    v00 = flat[idx]
    v01 = flat[idx + 1]
    v10 = flat[idx + W]
    v11 = flat[idx + W + 1]
    if img.dim() == 3:
        dx = dx[..., None]
        dy = dy[..., None]
    dxdy = dx * dy
    return (dxdy * v11 + (dy - dxdy) * v10 + (dx - dxdy) * v01
            + (1.0 - dx - dy + dxdy) * v00)


def nearest(img, x, y):
    """Nearest-neighbour gather with clamping."""
    H, W = img.shape[0], img.shape[1]
    xr = torch.round(x)
    yr = torch.round(y)
    xi = torch.clamp(torch.where(torch.isnan(xr), torch.zeros_like(xr), xr),
                     0, W - 1).long()
    yi = torch.clamp(torch.where(torch.isnan(yr), torch.zeros_like(yr), yr),
                     0, H - 1).long()
    flat = img.reshape((H * W,) + tuple(img.shape[2:]))
    return flat[yi * W + xi]


def in_bounds(x, y, w: int, h: int, border: float = 2.0):
    """The reference's OOB guard (e.g. ResidualProjections.h:75-80)."""
    return (x > border) & (x < w - border - 1) & (y > border) & (y < h - border - 1)
