"""Float32 multiply-adds rounded once, as XLA:CPU computes them.

XLA:CPU contracts `a * b + c` of float32 operands inside a fused program
into one fused multiply-add (one rounding where PyTorch's separate
operations round twice). Where the port must give the JAX package's bits
(the trace's search chain, the pyramid's absSquaredGrad), its plain
versions write those sums with `fma`, and the CUDA kernels that copy the
plain versions' bits use `__fmaf_rn` at the same places.
"""

from __future__ import annotations

import numpy as np
import torch


def fma(a, b, c) -> torch.Tensor:
    """a * b + c of float32 tensors (broadcast; a Python number stands for
    its float32 value), rounded once to float32.

    The product of two float32 values is exact in float64. The float64 sum
    is rounded to odd (its error, found exactly by Knuth's two-sum, forces
    the last bit to 1 when it is not 0), and a value rounded to odd with at
    least two more bits than float32 rounds to float32 as the exact sum
    would (Boldo and Melquiond): the result is correctly rounded on the CPU
    and on the card alike."""
    p = _f64(a) * _f64(b)
    cd = _f64(c)
    if not isinstance(cd, torch.Tensor):
        cd = torch.full_like(p, cd)
    p, cd = torch.broadcast_tensors(p, cd)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.contiguous().view(torch.int64)
    odd = (err != 0) & torch.isfinite(s) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where(odd, bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double()
    return float(np.float32(x))
