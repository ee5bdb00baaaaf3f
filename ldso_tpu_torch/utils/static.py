"""Fixed-size helpers that keep JAX's static-shape semantics.

`jnp.nonzero(mask, size=n, fill_value=f)` returns exactly n indices, padded
with f; torch.nonzero returns a data-dependent count and waits for the
device. `nonzero_padded` gives the JAX result without a host round-trip.
`device_const` keeps the constant tensors of the captured programs (the
tracker, the windowed BA) on their device.
"""

from __future__ import annotations

import torch

_consts = {}


def device_const(values, device, dtype=torch.float32) -> torch.Tensor:
    """A constant tensor of the (nested) tuple `values` on `device`,
    uploaded at its first use and kept: a CUDA graph capture
    (utils/graphs.py) may not copy from the host, and the eager
    warm-up run before it makes every constant of the program first."""
    key = (values, str(device), dtype)
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


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
