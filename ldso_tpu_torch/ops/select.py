"""Candidate-pixel selection.

Counterpart of ldso_tpu/ops/select.py (reference
src/frontend/PixelSelector2.cc and include/frontend/PixelSelector2.h): the
reference's greedy pot / 2pot / 4pot block scan as masked block-argmax
reductions, the 32x32 gradient-histogram threshold map, deterministic
random thinning, and the gridMaxSelection used by the initializer.

The per-block selection direction comes from the JAX package's block hash
(`_block_dir`), ported bit for bit: it is a documented, deterministic
deviation from the reference's count-indexed random stream.
"""

from __future__ import annotations

import numpy as np
import torch

# the 16 candidate selection directions (PixelSelector2.cc:185-201)
DIRECTIONS = np.array([
    [0, 1.0000], [0.3827, 0.9239], [0.1951, 0.9808], [0.9239, 0.3827],
    [0.7071, 0.7071], [0.3827, -0.9239], [0.8315, 0.5556], [0.8315, -0.5556],
    [0.5556, -0.8315], [0.9808, 0.1951], [0.9239, -0.3827], [0.7071, -0.7071],
    [0.5556, 0.8315], [0.9808, -0.1951], [1.0000, 0.0000], [0.1951, -0.9808],
], dtype=np.float32)

MIN_USE_GRAD = 10.0  # minUseGrad_pixsel (PixelSelector2.h:61)


def _iota(H, W, device):
    return torch.meshgrid(torch.arange(H, device=device),
                          torch.arange(W, device=device), indexing="ij")


def make_threshold_map(abs_grad0: torch.Tensor, min_grad_cut: float = 0.5,
                       min_grad_add: float = 7.0) -> torch.Tensor:
    """Per-32x32-block smoothed squared gradient thresholds (makeHists,
    PixelSelector2.cc:36-109). Returns (h32, w32) float32."""
    H, W = abs_grad0.shape
    dev = abs_grad0.device
    h32, w32 = H // 32, W // 32
    g = torch.sqrt(torch.clamp(abs_grad0, min=0.0)).to(torch.int64)
    g = torch.clamp(g, 0, 48)
    ys, xs = _iota(H, W, dev)
    ok = (xs >= 1) & (xs <= W - 2) & (ys >= 1) & (ys <= H - 2)

    gc = g[: h32 * 32, : w32 * 32].reshape(h32, 32, w32, 32)
    okc = ok[: h32 * 32, : w32 * 32].reshape(h32, 32, w32, 32)
    blk = (torch.arange(h32, device=dev)[:, None, None, None] * w32
           + torch.arange(w32, device=dev)[None, None, :, None])
    key = (blk * 49 + gc)[okc]
    hist = torch.bincount(key, minlength=h32 * w32 * 49).reshape(
        h32, w32, 49).to(torch.float32)
    total = hist.sum(dim=-1)

    # computeHistQuantil (PixelSelector2.cc:27-34)
    th0 = torch.floor(total * min_grad_cut + 0.5)
    csum = torch.cumsum(hist, dim=-1)
    passed = csum > (th0[..., None] - 0.5)
    quant = torch.argmax(passed.to(torch.int32), dim=-1).to(torch.float32)
    quant = torch.where(passed.any(dim=-1), quant,
                        torch.full_like(quant, 90.0))
    ths = quant + min_grad_add

    # 3x3 edge-aware smoothing, then square (PixelSelector2.cc:67-109)
    padded = torch.nn.functional.pad(ths, (1, 1, 1, 1))
    cnt = torch.nn.functional.pad(torch.ones_like(ths), (1, 1, 1, 1))
    s = torch.zeros_like(ths)
    c = torch.zeros_like(ths)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = s + padded[1 + dy: 1 + dy + h32, 1 + dx: 1 + dx + w32]
            c = c + cnt[1 + dy: 1 + dy + h32, 1 + dx: 1 + dx + w32]
    sm = s / c
    return sm * sm


def _block_dir(H: int, W: int, bs: int, seed: int, salt: int, device):
    """Pseudo-random direction per (bs x bs) block, (H, W, 2)."""
    by = np.arange(H) // bs
    bx = np.arange(W) // bs
    hy, hx = np.meshgrid(by, bx, indexing="ij")
    idx = ((hx * 7919 + hy * 104729 + seed * 31 + salt * 1299709) % 16
           ).astype(np.int32)
    return torch.from_numpy(DIRECTIONS[idx]).to(device)


def _abs_dot2(grad, d):
    """|gx*dx + gy*dy| rounded like the JAX twin on XLA:CPU, which
    contracts the two-term sum into fma(gy, dy, gx*dx): the selection
    argmax then agrees at exact ties (e.g. a gradient orthogonal to the
    block direction, where the plain float32 sum is exactly 0)."""
    p0 = (grad[..., 0] * d[..., 0]).to(torch.float64)
    return torch.abs((grad[..., 1].to(torch.float64) * d[..., 1] + p0)
                     .to(torch.float32))


def _block_winner(score: torch.Tensor, bs: int) -> torch.Tensor:
    """Bool mask of the first argmax pixel per (bs x bs) block where the max
    is > 0. score: (H, W) with ineligible pixels <= 0."""
    H, W = score.shape
    Hp = -(-H // bs) * bs
    Wp = -(-W // bs) * bs
    s = torch.nn.functional.pad(score, (0, Wp - W, 0, Hp - H), value=-1.0)
    flat = s.reshape(Hp // bs, bs, Wp // bs, bs).permute(0, 2, 1, 3).reshape(
        Hp // bs, Wp // bs, bs * bs)
    best = torch.argmax(flat, dim=-1)
    mx = torch.amax(flat, dim=-1)
    win = torch.zeros_like(flat, dtype=torch.bool)
    win.scatter_(-1, best[..., None], (mx > 0.0)[..., None])
    win = win.reshape(Hp // bs, Wp // bs, bs, bs).permute(0, 2, 1, 3)
    return win.reshape(Hp, Wp)[:H, :W]


def _block_any(mask: torch.Tensor, bs: int) -> torch.Tensor:
    """Broadcast per-block ANY back to pixel resolution."""
    H, W = mask.shape
    Hp = -(-H // bs) * bs
    Wp = -(-W // bs) * bs
    m = torch.nn.functional.pad(mask, (0, Wp - W, 0, Hp - H))
    anyb = m.reshape(Hp // bs, bs, Wp // bs, bs).any(dim=3).any(dim=1)
    out = anyb.repeat_interleave(bs, dim=0).repeat_interleave(bs, dim=1)
    return out[:H, :W]


def select(dI0, ag0, ag1, ag2, ths_smoothed, pot: int, th_factor: float = 1.0,
           seed: int = 3141592, grad_downweight: float = 0.75):
    """Hierarchical candidate selection (PixelSelector2.cc:170-315).
    Returns (status (H,W) int32 in {0,1,2,4}, counts (3,) int32)."""
    H, W = ag0.shape
    dev = ag0.device
    ys, xs = _iota(H, W, dev)
    inb = (xs >= 4) & (xs < W - 5) & (ys >= 4) & (ys <= H - 4)

    th_block = ths_smoothed[torch.clamp(ys >> 5, 0, ths_smoothed.shape[0] - 1),
                            torch.clamp(xs >> 5, 0, ths_smoothed.shape[1] - 1)]
    dw1 = grad_downweight
    dw2 = dw1 * dw1
    th0 = th_block * th_factor
    th1 = th_block * dw1 * th_factor
    th2 = th_block * dw1 * dw2 * th_factor

    xf, yf = xs.to(torch.float32), ys.to(torch.float32)
    x1 = (xf * 0.5 + 0.25).to(torch.int64)
    y1 = (yf * 0.5 + 0.25).to(torch.int64)
    ag1up = ag1[torch.clamp(y1, 0, ag1.shape[0] - 1),
                torch.clamp(x1, 0, ag1.shape[1] - 1)]
    x2 = (xf * 0.25 + 0.125).to(torch.int64)
    y2 = (yf * 0.25 + 0.125).to(torch.int64)
    ag2up = ag2[torch.clamp(y2, 0, ag2.shape[0] - 1),
                torch.clamp(x2, 0, ag2.shape[1] - 1)]

    grad = dI0[..., 1:3]
    dir2 = _block_dir(H, W, pot, seed, 2, dev)
    dir3 = _block_dir(H, W, 2 * pot, seed, 3, dev)
    dir4 = _block_dir(H, W, 4 * pot, seed, 5, dev)

    pass0 = inb & (ag0 > th0)
    pass1 = inb & (ag1up > th1)
    pass2 = inb & (ag2up > th2)
    neg = torch.full((), -1.0, dtype=torch.float32, device=dev)

    score0 = torch.where(pass0, _abs_dot2(grad, dir2), neg)
    score1 = torch.where(pass1, _abs_dot2(grad, dir3), neg)
    score2 = torch.where(pass2, _abs_dot2(grad, dir4), neg)

    win1 = _block_winner(score0, pot)
    sup2 = _block_any(pass0, 2 * pot)
    win2 = _block_winner(torch.where(sup2, neg, score1), 2 * pot) & ~sup2
    sup3 = _block_any(pass0 | pass1, 4 * pot)
    win3 = _block_winner(torch.where(sup3, neg, score2), 4 * pot) & ~sup3

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    status = torch.where(win1, 1, torch.where(win2, 2, torch.where(
        win3, 4, zero))).to(torch.int32)
    counts = torch.stack([win1.sum(), win2.sum(), win3.sum()]).to(torch.int32)
    return status, counts


def _subsample(status, random_pattern, quotia: float):
    """Deterministic random thinning, mirroring the reference's
    count-indexed random stream (PixelSelector2.cc:149-163)."""
    flat = status.reshape(-1)
    selected = flat != 0
    rank = torch.cumsum(selected.to(torch.int64), 0) - 1
    char_th = int(np.float32(255.0) * np.float32(quotia))
    keep = random_pattern[torch.clamp(rank, 0, random_pattern.numel() - 1)] > char_th
    out = torch.where(selected & ~keep, torch.zeros_like(flat), flat)
    return out.reshape(status.shape)


class PixelSelector:
    """Host-side density adaptation around `select` (the reference's
    makeMaps recursion, PixelSelector2.cc:111-168), with the JAX package's
    two modes: synchronous for the first calls and on request, and
    adaptation on the previous call's count afterwards."""

    _SYNC_CALLS = 4

    def __init__(self, w: int, h: int, cfg, device):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        self.random_pattern = torch.from_numpy(
            rng.randint(0, 256, size=w * h).astype(np.int32)).to(device)
        self.current_potential = 3
        self._n_calls = 0
        self._pending = None

    def make_maps(self, pyr, density: float, recursions_left: int = 1,
                  th_factor: float = 2.0, sync: bool = False):
        """pyr: FramePyramid (levels 0..2). Returns (status, n)."""
        cfg = self.cfg
        self._n_calls += 1
        ths = make_threshold_map(pyr.abs_grad[0], cfg.min_grad_hist_cut,
                                 cfg.min_grad_hist_add)
        ag1 = pyr.abs_grad[1] if pyr.levels > 1 else pyr.abs_grad[0]
        ag2 = pyr.abs_grad[2] if pyr.levels > 2 else ag1
        status, counts = select(pyr.dI[0], pyr.abs_grad[0], ag1, ag2, ths,
                                self.current_potential, th_factor,
                                cfg.seed, cfg.grad_downweight_per_level)

        if sync or self._n_calls <= self._SYNC_CALLS or self._pending is None:
            num_have = float(counts.sum().item())
            pot_used = self.current_potential
        else:
            prev_counts, pot_used, _ = self._pending
            num_have = float(prev_counts.sum().item())
        self._pending = (counts, self.current_potential, density)

        quotia = density / max(num_have, 1.0)
        K = num_have * (pot_used + 1) ** 2
        ideal = max(int(np.sqrt(K / max(density, 1.0))) - 1, 1)

        if recursions_left > 0 and quotia > 1.25 and self.current_potential > 1:
            self.current_potential = min(ideal, self.current_potential - 1)
            if sync or self._n_calls <= self._SYNC_CALLS:
                return self.make_maps(pyr, density, recursions_left - 1,
                                      th_factor, sync)
        elif recursions_left > 0 and quotia < 0.25:
            self.current_potential = max(ideal, self.current_potential + 1)
            if sync or self._n_calls <= self._SYNC_CALLS:
                return self.make_maps(pyr, density, recursions_left - 1,
                                      th_factor, sync)
        else:
            self.current_potential = ideal

        if quotia < 0.95:
            status = _subsample(status, self.random_pattern, quotia)
            num_have = num_have * quotia
        return status, int(num_have)


# ---------------------------------------------------------------------------
# gridMaxSelection (initializer levels > 0; PixelSelector2.h:63-226)
# ---------------------------------------------------------------------------

def grid_max_selection(dI, pot: int, th_fac: float = 1.0):
    """Per pot-block argmax of |gx|, |gy|, |gx-gy|, |gx+gy| among pixels
    with squared gradient above threshold. Returns (bool map, count)."""
    H, W = dI.shape[:2]
    dev = dI.device
    gx = dI[..., 1]
    gy = dI[..., 2]
    sq = gx * gx + gy * gy
    TH = th_fac * MIN_USE_GRAD * 0.75
    ys, xs = _iota(H, W, dev)
    nbx = max((W - 1 - pot) // pot + 1, 0)
    nby = max((H - 1 - pot) // pot + 1, 0)
    region = (xs >= 1) & (xs < 1 + nbx * pot) & (ys >= 1) & (ys < 1 + nby * pot)
    ok = region & (sq > TH * TH)
    neg = torch.full((), -1.0, dtype=torch.float32, device=dev)

    out = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for score_raw in (torch.abs(gx), torch.abs(gy),
                      torch.abs(gx - gy), torch.abs(gx + gy)):
        score = torch.where(ok, score_raw, neg)
        win = _block_winner(score[1:1 + nby * pot, 1:1 + nbx * pot], pot)
        out[1:1 + nby * pot, 1:1 + nbx * pot] |= win
    return out, out.sum()


def make_pixel_status(dI, desired_density: float, recs_left: int = 5,
                      th_fac: float = 1.0, sparsity: int = 5):
    """Host density-adaptation loop (makePixelStatus,
    PixelSelector2.h:228-266). Returns (bool map, count, new_sparsity)."""
    out, n = grid_max_selection(dI, sparsity, th_fac)
    n = int(n.item())
    quotia = n / max(desired_density, 1.0)
    new_sparsity = max(int(sparsity * np.sqrt(quotia) + 0.7), 1)
    old_th = th_fac
    if new_sparsity == 1 and sparsity == 1:
        th_fac = 0.5
    if ((abs(new_sparsity - sparsity) < 1 and th_fac == old_th)
            or (quotia > 0.8 and 1.0 / max(quotia, 1e-9) > 0.8)
            or recs_left == 0):
        return out, n, new_sparsity
    return make_pixel_status(dI, desired_density, recs_left - 1, th_fac,
                             new_sparsity)
