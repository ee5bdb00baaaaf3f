"""Per-pyramid-level intrinsics (the reference's GlobalCalib, made functional).

The reference keeps mutable globals wG/hG/fxG/... per level
(src/internal/GlobalCalib.cc:20-75). Here the same quantities live in a
frozen, hashable dataclass so jitted programs can close over them as
static constants, while the *optimizable* intrinsics travel separately as a
length-4 device array (see backend CalibState).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ldso_tpu_torch.config import PYR_LEVELS


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Static rectified-camera geometry: sizes + intrinsics per level."""

    w: Tuple[int, ...]
    h: Tuple[int, ...]
    fx: Tuple[float, ...]
    fy: Tuple[float, ...]
    cx: Tuple[float, ...]
    cy: Tuple[float, ...]
    levels: int

    @staticmethod
    def create(w: int, h: int, fx: float, fy: float, cx: float, cy: float) -> "Calibration":
        """Mirror setGlobalCalib: halve until w*h <= 5000 or PYR_LEVELS
        (reference: GlobalCalib.cc:20-75)."""
        levels = 1
        wl, hl = w, h
        while wl % 2 == 0 and hl % 2 == 0 and wl * hl > 5000 and levels < PYR_LEVELS:
            wl //= 2
            hl //= 2
            levels += 1

        ws, hs = [w], [h]
        fxs, fys, cxs, cys = [float(fx)], [float(fy)], [float(cx)], [float(cy)]
        for lvl in range(1, levels):
            ws.append(w >> lvl)
            hs.append(h >> lvl)
            fxs.append(fxs[0] * 0.5 ** lvl)
            fys.append(fys[0] * 0.5 ** lvl)
            cxs.append((cxs[0] + 0.5) / (1 << lvl) - 0.5)
            cys.append((cys[0] + 0.5) / (1 << lvl) - 0.5)
        return Calibration(
            w=tuple(ws), h=tuple(hs), fx=tuple(fxs), fy=tuple(fys),
            cx=tuple(cxs), cy=tuple(cys), levels=levels,
        )

    def K(self, lvl: int = 0) -> np.ndarray:
        return np.array(
            [[self.fx[lvl], 0.0, self.cx[lvl]],
             [0.0, self.fy[lvl], self.cy[lvl]],
             [0.0, 0.0, 1.0]], dtype=np.float64)

    def Ki(self, lvl: int = 0) -> np.ndarray:
        return np.linalg.inv(self.K(lvl))

    def intrinsics_vec(self) -> np.ndarray:
        """Level-0 [fx, fy, cx, cy] — the CPARS optimizable in BA."""
        return np.array([self.fx[0], self.fy[0], self.cx[0], self.cy[0]], np.float64)

    def with_intrinsics(self, c) -> "Calibration":
        """Rebuild per-level intrinsics from an updated level-0 [fx fy cx cy]."""
        c = np.asarray(c, np.float64)
        return Calibration.create(self.w[0], self.h[0], c[0], c[1], c[2], c[3])
