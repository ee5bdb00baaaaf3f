"""Deterministic scatter-add.

`index_add_` on a CUDA tensor sums floats with atomics, so the order of
the additions (and with it the last bits of each sum) changes from run to
run. XLA's scatter sums in ascending source order on every run, and the
loop-closing gates (integer counts of matches and inliers) turn such
last-bit differences into different loop sets. `segment_sum` fixes the
order by construction on every device: a stable sort by destination,
then one sequential sum per destination in ascending source order. It
reads nothing back from the card (the segments' offsets come from a
search of the sorted destinations, where a `bincount` would read its
size), so a CUDA graph can capture it.
"""

from __future__ import annotations

import torch


def segment_sum(values: torch.Tensor, index: torch.Tensor,
                n: int) -> torch.Tensor:
    """out[k] = sum of values[i] over index[i] == k, added in ascending i
    starting from 0 (the order of XLA:CPU's scatter-add and of a CPU
    `index_add_`). values: (N, ...) float; index: (N,) int in [0, n).
    Returns (n, ...)."""
    index = index.to(torch.int64)
    dest, perm = torch.sort(index, stable=True)
    # offsets[k] = the number of sources with a destination below k
    offsets = torch.searchsorted(dest, torch.arange(n + 1,
                                                    device=index.device))
    rest = values.shape[1:]
    # 2-D data takes segment_reduce's one-thread-per-segment kernel, which
    # adds each segment's values one after another in order
    width = 1
    for d in rest:
        width *= d
    out = torch.segment_reduce(values[perm].reshape(values.shape[0], width),
                               "sum", offsets=offsets, axis=0, unsafe=True)
    return out.reshape((n,) + rest)
