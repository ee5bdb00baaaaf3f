"""Fixed-size index helpers that keep JAX's static-shape semantics.

`jnp.nonzero(mask, size=n, fill_value=f)` returns exactly n indices, padded
with f; torch.nonzero returns a data-dependent count and waits for the
device. `nonzero_padded` gives the JAX result without a host round-trip.
"""

from __future__ import annotations

import torch


def nonzero_padded(mask: torch.Tensor, size: int, fill_value: int = 0):
    """First `size` indices where the 1-D `mask` is true, in ascending
    order, padded with `fill_value` (jnp.nonzero(size=, fill_value=))."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    take = mask & (rank < size)
    out = torch.full((size + 1,), fill_value, dtype=torch.int64,
                     device=mask.device)
    dst = torch.where(take, rank, torch.full_like(rank, size))
    out.scatter_(0, dst, torch.arange(n, device=mask.device))
    # the overflow slot collects every dropped lane; cut it off
    return out[:size]
