"""Corner-aware candidate selection (pure-VO path).

Counterpart of the pure-VO part of ldso_tpu/frontend/detector.py (reference
FeatureDetector, src/frontend/FeatureDetector.cc): the dense Shi-Tomasi
response and the per-grid-cell candidate picking of DetectCorners
(:33-95) as one (H, W) status map. The corner flags, orientations and ORB
descriptors only feed loop closing and come with it.
"""

from __future__ import annotations

import numpy as np
import torch

HALF_PATCH = 15


def shi_tomasi_map(dI: torch.Tensor, halfbox: int = 4) -> torch.Tensor:
    """Dense smaller-eigenvalue map (ShiTomasiScore, FeatureDetector.h:49-82)
    over box sums [x-hb, x+hb) x [y-hb, y+hb)."""
    gx = dI[..., 1]
    gy = dI[..., 2]
    xx, yy, xy = gx * gx, gy * gy, gx * gy
    H, W = gx.shape
    dev = dI.device
    hb = halfbox
    y0 = torch.clamp(torch.arange(H, device=dev) - hb, 0, H)
    y1 = torch.clamp(torch.arange(H, device=dev) + hb, 0, H)
    x0 = torch.clamp(torch.arange(W, device=dev) - hb, 0, W)
    x1 = torch.clamp(torch.arange(W, device=dev) + hb, 0, W)

    def box(a):
        ii = torch.cumsum(torch.cumsum(a, dim=0), dim=1)
        ii = torch.nn.functional.pad(ii, (1, 0, 1, 0))
        A = ii[y1][:, x1]
        B = ii[y0][:, x1]
        C = ii[y1][:, x0]
        D = ii[y0][:, x0]
        return A - B - C + D

    area = (2 * halfbox) ** 2
    dXX = box(xx) / (2.0 * area)
    dYY = box(yy) / (2.0 * area)
    dXY = box(xy) / (2.0 * area)
    tr = dXX + dYY
    det = dXX * dYY - dXY * dXY
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
    score = 0.5 * (tr - disc)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    ok = ((xs - halfbox >= 1) & (xs + halfbox < W - 1)
          & (ys - halfbox >= 1) & (ys + halfbox < H - 1))
    return torch.where(ok, score, torch.zeros_like(score))


def detect_status_map(dI: torch.Tensor, abs_grad: torch.Tensor,
                      gridsize: int, per_cell: int, skip: int) -> torch.Tensor:
    """DetectCorners' candidate selection (FeatureDetector.cc:33-95) as an
    (H, W) int32 status map. Per cell, the top `per_cell` Shi-Tomasi scores
    among pixels above max(0.5 * cell max gradient, 5); ties keep the lower
    index, as lax.top_k does."""
    H, W = abs_grad.shape
    dev = abs_grad.device
    st = shi_tomasi_map(dI)
    grid_x, grid_y = W // gridsize + 1, H // gridsize + 1
    gx0, gx1 = skip, grid_x - skip
    gy0, gy1 = skip, grid_y - skip
    Hc, Wc = gy1 - gy0, gx1 - gx0
    if Hc <= 0 or Wc <= 0:
        return torch.zeros((H, W), dtype=torch.int32, device=dev)
    y_lo, x_lo = gy0 * gridsize, gx0 * gridsize
    crop_a = abs_grad[y_lo:y_lo + Hc * gridsize, x_lo:x_lo + Wc * gridsize]
    crop_s = st[y_lo:y_lo + Hc * gridsize, x_lo:x_lo + Wc * gridsize]
    cells_a = crop_a.reshape(Hc, gridsize, Wc, gridsize).permute(0, 2, 1, 3)
    cells_s = crop_s.reshape(Hc, gridsize, Wc, gridsize).permute(0, 2, 1, 3)
    cell_max = torch.amax(cells_a, dim=(2, 3), keepdim=True)
    grad_th = torch.clamp(0.5 * cell_max, min=5.0)
    flat = torch.where(cells_a > grad_th, cells_s,
                       torch.full_like(cells_s, -1.0)).reshape(Hc, Wc, -1)
    k = min(per_cell, flat.shape[-1])
    # stable descending sort: equal scores keep ascending index order
    top_val, top_idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    top_val, top_idx = top_val[..., :k], top_idx[..., :k]
    yy = top_idx // gridsize
    xx = top_idx % gridsize
    cy = torch.arange(Hc, device=dev)[:, None, None]
    cx = torch.arange(Wc, device=dev)[None, :, None]
    u = (x_lo + cx * gridsize + xx).reshape(-1)
    v = (y_lo + cy * gridsize + yy).reshape(-1)
    ok = (top_val > 0).reshape(-1)
    out = torch.zeros(H * W, dtype=torch.int32, device=dev)
    out[(v * W + u)[ok]] = 1          # mask first: no out-of-range "drop"
    return out.reshape(H, W)


def detect_grid_params(H: int, W: int, n_features: int):
    """Static grid geometry (FeatureDetector.cc:38-46)."""
    gridsize = max(int(np.sqrt(W * H / n_features) + 0.5), 2)
    per_cell = int(float(n_features) / (W * H) * gridsize * gridsize) + 1
    skip = (HALF_PATCH * 2 // gridsize) + 1
    return gridsize, per_cell, skip
