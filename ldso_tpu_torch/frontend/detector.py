"""Corner-aware feature detection and ORB descriptors.

Counterpart of ldso_tpu/frontend/detector.py (reference FeatureDetector,
src/frontend/FeatureDetector.cc):
  * `shi_tomasi_map` + `detect_status_map`: the dense Shi-Tomasi response
    and the per-grid-cell candidate picking of DetectCorners (:33-95) as
    one (H, W) status map, for the pure-VO path;
  * `detect_corners`: the same picking on the host, the 1% corner gate and
    5 px radius NMS (the native library's `radius_nms`), then on the
    device `ic_angle` (IC_Angle orientation) and `compute_descriptors`
    (256-bit rotated BRIEF from the published ORB pattern, a copy of
    ldso_tpu/frontend/orb_pattern.npy);
  * `hamming_matrix` / `match_descriptors`: popcount distances and NN-ratio
    matching on the device.

Descriptors: (N, 8) 32-bit words, bit j of word w is pattern test 32w+j
(little-endian within each word, as the JAX package packs them). On the
device they are int64 tensors holding the 32-bit values, because torch's
uint32 has few ops and no popcount; `desc_to_numpy` gives the uint32 array
the native library and the FrameShell records take.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ldso_tpu_torch import native

HALF_PATCH = 15

_PATTERN = np.load(os.path.join(os.path.dirname(__file__), "orb_pattern.npy"))
assert _PATTERN.shape == (256, 4)


def _umax_table() -> np.ndarray:
    """Circular-patch row extents (ORB's umax, FeatureDetector.cc:8-28)."""
    umax = np.zeros(HALF_PATCH + 2, np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(HALF_PATCH * HALF_PATCH - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[:HALF_PATCH + 1]


UMAX = _umax_table()


def _fma(x, y, z):
    """x * y + z with one rounding to float32, as XLA:CPU contracts
    `x * y + z` of float32 operands into an FMA: the product of two
    float32 values is exact in float64."""
    return (x.double() * y.double() + z.double()).to(torch.float32)


_SCAN_BLOCK = 16


def _blocked_cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 cumsum in XLA:CPU's order (its reduce-window
    rewrite of cumsum): blocks of 16 summed one element after another,
    plus the exclusive prefix of the block totals, itself scanned the
    same way. Bit-identical to jnp.cumsum on the CPU, and the same on
    every device (torch.cumsum's order differs between CPU and CUDA)."""
    a = a.movedim(dim, 0)
    n, b = a.shape[0], _SCAN_BLOCK
    nb = -(-n // b)
    x = torch.cat([a, a.new_zeros((nb * b - n,) + a.shape[1:])])
    x = x.reshape((nb, b) + a.shape[1:])
    cols = [x[:, 0]]
    for j in range(1, b):
        cols.append(cols[-1] + x[:, j])
    inner = torch.stack(cols, dim=1)
    if nb > 1:
        inc = _blocked_cumsum(inner[:, -1], 0)
        carry = torch.cat([torch.zeros_like(inc[:1]), inc[:-1]])
        inner = torch.cat([inner[:1], inner[1:] + carry[1:, None]])
    return inner.reshape((nb * b,) + a.shape[1:])[:n].movedim(0, dim)


def shi_tomasi_map(dI: torch.Tensor, halfbox: int = 4) -> torch.Tensor:
    """Dense smaller-eigenvalue map (ShiTomasiScore, FeatureDetector.h:49-82)
    over box sums [x-hb, x+hb) x [y-hb, y+hb), rounded as the JAX package
    computes it on the CPU (blocked cumsum, contracted multiply-adds), so
    the corner ranking of detect_corners is the same."""
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
        ii = _blocked_cumsum(_blocked_cumsum(a, 0), 1)
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
    # XLA:CPU contracts both differences into FMAs
    det = _fma(dXX, dYY, -(dXY * dXY))
    disc = torch.sqrt(torch.clamp(_fma(tr, tr, -(4.0 * det)), min=0.0))
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


def detect_corners(dI: torch.Tensor, abs_grad: torch.Tensor, n_features: int,
                   max_feats: int = 2048):
    """Grid-based detection (DetectCorners, FeatureDetector.cc:33-126).

    Returns a dict of tensors on dI's device with capacity max_feats: u, v,
    score, is_corner, angle, desc ((N, 8) int64 words), valid. The cell
    picking and the NMS run on the host in the JAX package's exact numpy
    order; orientation and descriptors run on the device."""
    dev = dI.device
    H, W = abs_grad.shape
    gridsize, per_cell, skip = detect_grid_params(H, W, n_features)
    grid_x, grid_y = W // gridsize + 1, H // gridsize + 1
    st_np = shi_tomasi_map(dI).cpu().numpy()
    ag = abs_grad.cpu().numpy()

    gx0, gx1 = skip, grid_x - skip
    gy0, gy1 = skip, grid_y - skip
    Hc, Wc = gy1 - gy0, gx1 - gx0
    if Hc <= 0 or Wc <= 0:
        return _empty_feats(max_feats, dev)
    y_lo, x_lo = gy0 * gridsize, gx0 * gridsize
    crop_a = ag[y_lo:y_lo + Hc * gridsize, x_lo:x_lo + Wc * gridsize]
    crop_s = st_np[y_lo:y_lo + Hc * gridsize, x_lo:x_lo + Wc * gridsize]
    cells_a = crop_a.reshape(Hc, gridsize, Wc, gridsize).transpose(0, 2, 1, 3)
    cells_s = crop_s.reshape(Hc, gridsize, Wc, gridsize).transpose(0, 2, 1, 3)
    cell_max = cells_a.max(axis=(2, 3), keepdims=True)
    grad_th = np.maximum(0.5 * cell_max, 5.0)
    flat = np.where(cells_a > grad_th, cells_s, -1.0).reshape(Hc, Wc, -1)
    k = min(per_cell, flat.shape[-1])
    top_idx = np.argpartition(-flat, k - 1, axis=-1)[..., :k]
    top_val = np.take_along_axis(flat, top_idx, axis=-1)
    yy = top_idx // gridsize
    xx = top_idx % gridsize
    cy, cx = np.meshgrid(np.arange(Hc), np.arange(Wc), indexing="ij")
    u_all = (x_lo + cx[..., None] * gridsize + xx).reshape(-1)
    v_all = (y_lo + cy[..., None] * gridsize + yy).reshape(-1)
    s_all = top_val.reshape(-1)
    keep = s_all > 0
    us, vs, scores = u_all[keep], v_all[keep], s_all[keep]
    if len(us) == 0:
        return _empty_feats(max_feats, dev)

    # corners: > 1% of max score + 5 px NMS (FeatureDetector.cc:97-118)
    gate = scores > 0.01 * scores.max()
    keep = native.radius_nms(us[gate].astype(np.float32),
                             vs[gate].astype(np.float32),
                             scores[gate].astype(np.float32), 5.0)
    is_corner = np.zeros(len(us), bool)
    is_corner[np.nonzero(gate)[0][keep]] = True

    # cap to capacity, corners first
    order2 = np.argsort(~is_corner * 1 + 0.0 - scores / (scores.max() + 1e-9))
    sel = order2[:max_feats]
    us, vs, scores, is_corner = us[sel], vs[sel], scores[sel], is_corner[sel]

    n = len(us)
    pad = max_feats - n
    f32 = dict(dtype=torch.float32, device=dev)
    ut = torch.tensor(np.concatenate([us, np.zeros(pad)]).astype(np.float32),
                      **f32)
    vt = torch.tensor(np.concatenate([vs, np.zeros(pad)]).astype(np.float32),
                      **f32)
    valid = torch.arange(max_feats, device=dev) < n
    ct = torch.tensor(np.concatenate([is_corner, np.zeros(pad, bool)]),
                      device=dev)
    angle = ic_angle(dI, ut, vt)
    desc = compute_descriptors(dI, ut, vt, angle)
    score = torch.tensor(np.concatenate([scores, np.zeros(pad)])
                         .astype(np.float32), **f32)
    return dict(u=ut, v=vt, score=score, is_corner=ct & valid, angle=angle,
                desc=desc, valid=valid)


def _empty_feats(max_feats: int, device):
    z = torch.zeros(max_feats, dtype=torch.float32, device=device)
    f = torch.zeros(max_feats, dtype=torch.bool, device=device)
    return dict(u=z, v=z, score=z, is_corner=f, angle=z,
                desc=torch.zeros((max_feats, 8), dtype=torch.int64,
                                 device=device), valid=f)


def ic_angle(dI: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (IC_Angle, FeatureDetector.h:91-114)
    over the radius-15 circular patch, accumulated row pair by row pair in
    the JAX package's order."""
    H, W = dI.shape[:2]
    dev = dI.device
    flat = dI[..., 0].reshape(-1)
    ui = torch.clamp(u.to(torch.int64), HALF_PATCH + 1, W - HALF_PATCH - 2)
    vi = torch.clamp(v.to(torch.int64), HALF_PATCH + 1, H - HALF_PATCH - 2)

    def gather(yy, xx):
        return flat[yy * W + xx]

    du = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=dev)
    m10 = torch.sum(du[None, :].to(torch.float32)
                    * gather(vi[:, None], ui[:, None] + du[None, :]), dim=1)
    m01 = torch.zeros_like(m10)
    for vv in range(1, HALF_PATCH + 1):
        d = int(UMAX[vv])
        du2 = torch.arange(-d, d + 1, device=dev)
        plus = gather(vi[:, None] + vv, ui[:, None] + du2[None, :])
        minus = gather(vi[:, None] - vv, ui[:, None] + du2[None, :])
        m10 = m10 + torch.sum(du2[None, :].to(torch.float32) * (plus + minus),
                              dim=1)
        m01 = m01 + vv * torch.sum(plus - minus, dim=1)
    return torch.atan2(m01, m10)


def compute_descriptors(dI: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                        angle: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF (ComputeDescriptor, FeatureDetector.cc:131-189).
    Returns (N, 8) int64 words, bit j of word w = pattern test 32w+j."""
    H, W = dI.shape[:2]
    dev = dI.device
    img = dI[..., 0].reshape(-1)
    patt = torch.tensor(_PATTERN.astype(np.float32), device=dev)
    a = torch.cos(angle)
    b = torch.sin(angle)
    ui = torch.clamp(u.to(torch.int64), 16, W - 17)
    vi = torch.clamp(v.to(torch.int64), 16, H - 17)

    def rotated_val(px, py):
        # reference: offset = int(px*b + py*a)*step + int(px*a - py*b);
        # the int cast truncates toward zero, as astype(int32) does
        # XLA:CPU computes these as fma(px, b, py*a) and fma(px, a, -py*b)
        ry = _fma(px[None, :], b[:, None], py[None, :] * a[:, None])
        rx = _fma(px[None, :], a[:, None], -(py[None, :] * b[:, None]))
        idx = ((vi[:, None] + ry.to(torch.int32)) * W
               + (ui[:, None] + rx.to(torch.int32)))
        return img[idx]

    t0 = rotated_val(patt[:, 0], patt[:, 1])             # (N, 256)
    t1 = rotated_val(patt[:, 2], patt[:, 3])
    bits = (t0 < t1).to(torch.int64).reshape(-1, 8, 32)
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    return torch.sum(bits << shifts, dim=-1)


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """(N, 8) int64 words -> (N, 8) uint32 numpy."""
    return desc.cpu().numpy().astype(np.uint32)


def desc_to_torch(desc: np.ndarray, device="cpu") -> torch.Tensor:
    """(N, 8) uint32 numpy -> (N, 8) int64 words on `device`."""
    return torch.from_numpy(np.asarray(desc, np.uint32).astype(np.int64)).to(
        device)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 tensors holding 32-bit values (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) int32 Hamming distances (FeatureMatcher.cc:16-33)."""
    x = torch.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return torch.sum(_popcount32(x), dim=-1).to(torch.int32)


def match_descriptors(desc_a, valid_a, desc_b, valid_b,
                      nn_ratio: float = 0.9, th_low: int = 50):
    """Brute-force matching with the NN-ratio test (SearchByBoW semantics,
    FeatureMatcher.cc:66-124). Returns (match index into b or -1, best
    distance); argmin ties keep the lowest index, as jnp.argmin does."""
    d = hamming_matrix(desc_a, desc_b)
    big = torch.full((), 10 ** 6, dtype=torch.int32, device=d.device)
    d = torch.where(valid_b[None, :], d, big)
    d = torch.where(valid_a[:, None], d, big)
    best_d, best = torch.min(d, dim=1)
    # torch.min's index is not promised to be the first on ties: take the
    # first position that holds the minimum
    cols = torch.arange(d.shape[1], device=d.device)
    best = torch.min(torch.where(d == best_d[:, None], cols,
                                 torch.full_like(cols, d.shape[1])), dim=1)[0]
    d2 = d.clone()
    d2[torch.arange(d.shape[0], device=d.device), best] = big
    second_d = torch.min(d2, dim=1)[0]
    ok = (best_d < th_low) & (best_d.to(torch.float32)
                              < nn_ratio * second_d.to(torch.float32))
    return (torch.where(ok & valid_a, best, torch.full_like(best, -1)),
            best_d)
