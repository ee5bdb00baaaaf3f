"""Half-resolution chamfer distance map for activation spacing.

Counterpart of ldso_tpu/ops/distance_map.py, the rebuild of
CoarseDistanceMap::growDistBFS (src/frontend/CoarseTracker.cc:637-819):
`max_k - 1` min-plus relaxation sweeps, the 4-neighbourhood on every sweep
and the diagonals added on odd sweeps, with sources only at interior
pixels.

`distance_transform_ref` is the plain PyTorch version, written with
`torch.roll` shifts like the JAX function. It is the CPU path and the
oracle the hand-written CUDA kernel is held against; on a CUDA tensor the
main path calls the kernel through `ops.cuda_kernels.distance_transform`.
"""

from __future__ import annotations

import torch

BIG = 1000.0
MAX_K = 40  # growDistBFS iterations (CoarseTracker.cc:726)


def distance_transform_ref(occupied: torch.Tensor, max_k: int = MAX_K) -> torch.Tensor:
    """occupied: (H, W) bool. Returns the float32 chamfer distance: 0 at
    occupied cells, k where first reached at sweep k, 1000 where
    unreachable within max_k - 1 sweeps."""
    H, W = occupied.shape
    dev = occupied.device
    d = torch.where(occupied.to(torch.bool),
                    torch.zeros((), dtype=torch.float32, device=dev),
                    torch.full((), BIG, dtype=torch.float32, device=dev))
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]

    def from_shift(cand, d, dy, dx, kf):
        src = torch.roll(d, (dy, dx), dims=(0, 1))
        src_y = ys - dy
        src_x = xs - dx
        ok = (src_y >= 1) & (src_y <= H - 2) & (src_x >= 1) & (src_x <= W - 2)
        return torch.where(ok & (src < kf) & (cand > kf), kf, cand)

    for k in range(1, max_k):
        kf = torch.full((), float(k), dtype=torch.float32, device=dev)
        cand = d
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            cand = from_shift(cand, d, dy, dx, kf)
        if k % 2 == 1:
            for dy, dx in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
                cand = from_shift(cand, d, dy, dx, kf)
        d = cand
    return d
