"""Float32 multiply-adds and elementary functions rounded once, as
XLA:CPU computes them.

XLA:CPU contracts `a * b + c` of float32 operands inside a fused program
into one fused multiply-add (one rounding where PyTorch's separate
operations round twice). Where the port must give the JAX package's bits
(the trace's search chain, the pyramid's absSquaredGrad), its plain
versions write those sums with `fma`, and the CUDA kernels that copy the
plain versions' bits use `__fmaf_rn` at the same places.

XLA:CPU's float32 cosine, sine and square root are the correctly rounded
values on the arguments the trackers take (its exponential too, on small
arguments); PyTorch's CPU ones are not on 0.6-8% of them (its AVX-512
float32 square root on 0.66% of |N(0, 1)| samples), and its cosine
rounds toward 1 more often than away. `rounded` takes such a function in
float64 and rounds once (ROADMAP 3a: the cosine's bias, through
(1 - cos) / theta^2 in the tracker's se3_exp, drifted the port's scale;
the tracker takes its step's exponential, its square roots and its
affine exponential so: lie.se3_exp_exact, affine.from_to(exact=True)).
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


def rounded(fn, x: torch.Tensor) -> torch.Tensor:
    """fn (torch.cos, sin, exp, sqrt) of a float32 tensor taken in float64
    and rounded once to float32, on the CPU and the card alike; another
    dtype takes fn as it is."""
    if x.dtype == torch.float32:
        return fn(x.double()).to(torch.float32)
    return fn(x)
