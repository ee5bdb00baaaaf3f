"""Synthetic photometric scene with exact ground truth, rendered on the
port's device.

Counterpart of ldso_tpu/synthetic.py's PlaneScene and default_calib: a
band-limited procedural texture on a 3D plane, rendered through the
pinhole model the pipeline assumes, so the port can make frames without
JAX. The texture parameters come from the same numpy RandomState draw, so
both packages render the same scene.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ldso_tpu_torch.camera.calib import Calibration
from ldso_tpu_torch.math import lie


@dataclasses.dataclass(frozen=True)
class PlaneScene:
    """A textured plane n.X = d in world coordinates (camera-0 frame)."""

    n: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    d: float = 3.0
    n_waves: int = 24
    seed: int = 7
    contrast: float = 60.0
    base: float = 128.0
    freq_lo: float = 0.5
    freq_hi: float = 12.0

    def _texture_params(self, device):
        rng = np.random.RandomState(self.seed)
        freqs = rng.uniform(self.freq_lo, self.freq_hi, size=(self.n_waves, 2))
        phases = rng.uniform(0, 2 * np.pi, size=self.n_waves)
        amps = rng.uniform(0.3, 1.0, size=self.n_waves)
        amps = amps / amps.sum()
        f32 = dict(dtype=torch.float32, device=device)
        return (torch.tensor(freqs, **f32), torch.tensor(phases, **f32),
                torch.tensor(amps, **f32))

    def texture(self, u, v):
        """Procedural intensity at plane coordinates (u, v); range ~0..255."""
        freqs, phases, amps = self._texture_params(u.device)
        uf = u.reshape(-1)[None, :]
        vf = v.reshape(-1)[None, :]
        phase = (freqs[:, 0][:, None] * uf + freqs[:, 1][:, None] * vf
                 + phases[:, None])
        val = torch.sum(amps[:, None] * torch.sin(phase), dim=0)
        return (self.base + self.contrast * 2.0 * val).reshape(u.shape)

    def render(self, calib: Calibration, T_cw, lvl: int = 0,
               exposure: float = 1.0, aff_a: float = 0.0, aff_b: float = 0.0,
               device="cpu"):
        """Render the plane seen from camera pose T_cw (world->cam, 4x4).

        Returns (image (H,W) f32, idepth (H,W) f32) on `device`; affine
        (a, b) apply as I' = exp(a) * I + b."""
        w, h = calib.w[lvl], calib.h[lvl]
        fx, fy, cx, cy = calib.fx[lvl], calib.fy[lvl], calib.cx[lvl], calib.cy[lvl]
        f32 = dict(dtype=torch.float32, device=device)
        T_wc = lie.se3_inv(torch.as_tensor(np.asarray(T_cw), **f32))
        R = T_wc[:3, :3]
        o = T_wc[:3, 3]

        ys, xs = torch.meshgrid(torch.arange(h, **f32),
                                torch.arange(w, **f32), indexing="ij")
        rays_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy,
                                torch.ones_like(xs)], -1)
        rays_w = torch.einsum("ij,hwj->hwi", R, rays_cam)

        n = torch.tensor(self.n, **f32)
        denom = torch.einsum("hwi,i->hw", rays_w, n)
        denom = torch.where(torch.abs(denom) < 1e-9,
                            torch.full_like(denom, 1e-9), denom)
        t = (self.d - torch.dot(o, n)) / denom
        X = o[None, None, :] + t[..., None] * rays_w

        img = self.texture(X[..., 0], X[..., 1])
        img = float(np.exp(aff_a)) * img + aff_b
        img = torch.clamp(img * exposure, 0.0, 255.0)
        idepth = torch.where(t > 1e-6, 1.0 / torch.clamp(t, min=1e-6),
                             torch.zeros_like(t))
        return img.to(torch.float32), idepth.to(torch.float32)


def default_calib(w: int = 640, h: int = 480) -> Calibration:
    return Calibration.create(w, h, fx=0.55 * w, fy=0.55 * w,
                              cx=(w - 1) / 2.0, cy=(h - 1) / 2.0)
