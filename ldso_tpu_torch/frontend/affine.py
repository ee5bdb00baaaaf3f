"""The DSO affine brightness-transfer model (a, b) with exposure folding.

Counterpart of ldso_tpu/frontend/affine.py (reference include/AffLight.h):
each frame maps global irradiance as I_frame = exp(a) * I_global + b, and
the transfer from frame F to frame T is
    rel_a = exp(a_T - a_F) * (t_T / t_F),   rel_b = b_T - rel_a * b_F.
"""

from __future__ import annotations

import torch

from ldso_tpu_torch.math.rounding import rounded


def from_to(exposure_f, exposure_t, aff_f, aff_t, exact: bool = False):
    """Relative (a, b) from frame F to frame T (AffLight.h:27-35).

    aff_f, aff_t: (..., 2) tensors [a, b]; exposures: tensors or floats.
    Zero exposures fall back to 1 (matching the reference). `exact`: the
    exponential rounded once, as XLA:CPU gives it (math/rounding.rounded;
    the tracker's)."""
    exposure_f = torch.as_tensor(exposure_f, dtype=torch.float32,
                                 device=aff_f.device)
    exposure_t = torch.as_tensor(exposure_t, dtype=torch.float32,
                                 device=aff_f.device)
    bad = (exposure_f == 0) | (exposure_t == 0)
    one = torch.ones_like(exposure_f)
    ef = torch.where(bad, one, exposure_f)
    et = torch.where(bad, one, exposure_t)
    d = aff_t[..., 0] - aff_f[..., 0]
    a = (rounded(torch.exp, d) if exact else torch.exp(d)) * et / ef
    b = aff_t[..., 1] - a * aff_f[..., 1]
    return torch.stack([a, b], dim=-1)
