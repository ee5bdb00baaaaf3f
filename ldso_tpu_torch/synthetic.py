"""Synthetic photometric scene with exact ground truth, rendered on the
port's device.

Counterpart of ldso_tpu/synthetic.py: PlaneScene (a band-limited
procedural texture on a 3D plane), BoxScene (textured rectangles at several
depths over a background plane: depth discontinuities and occlusion),
make_scene, default_calib, orbit_trajectory and render_sequence, rendered
through the pinhole model the pipeline assumes on the device the caller
names, so the port can make frames without JAX. The texture and box
parameters come from the same numpy RandomState draws, so both packages
render the same scenes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ldso_tpu_torch.camera.calib import Calibration
from ldso_tpu_torch.math import lie, lie_np


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


@dataclasses.dataclass(frozen=True)
class BoxScene:
    """Fronto-parallel textured rectangles at different depths over a
    background plane: depth discontinuities and viewpoint-dependent
    occlusion. Rendered by per-pixel nearest-hit ray casting against K+1
    z=const planes, so ground-truth poses and inverse depth stay exact and
    resampling-free like PlaneScene."""

    n_boxes: int = 7
    seed: int = 11
    z_bg: float = 4.5
    z_lo: float = 1.8
    z_hi: float = 3.2
    n_waves: int = 24
    contrast: float = 60.0
    base: float = 128.0
    freq_lo: float = 0.5
    freq_hi: float = 12.0

    def _boxes(self):
        rng = np.random.RandomState(self.seed)
        cx = rng.uniform(-1.6, 1.6, self.n_boxes)
        cy = rng.uniform(-1.2, 1.2, self.n_boxes)
        hx = rng.uniform(0.35, 0.9, self.n_boxes)
        hy = rng.uniform(0.3, 0.8, self.n_boxes)
        z = np.sort(rng.uniform(self.z_lo, self.z_hi, self.n_boxes))[::-1]
        return cx, cy, hx, hy, z.copy()

    def _face(self, k: int) -> PlaneScene:
        # a distinct texture per face (and for the background, k = -1)
        return PlaneScene(n_waves=self.n_waves, seed=self.seed + 31 * (k + 2),
                          contrast=self.contrast, base=self.base,
                          freq_lo=self.freq_lo, freq_hi=self.freq_hi)

    def render(self, calib: Calibration, T_cw, lvl: int = 0,
               exposure: float = 1.0, aff_a: float = 0.0, aff_b: float = 0.0,
               device="cpu"):
        """Same contract as PlaneScene.render: (image, idepth) on `device`,
        camera z-parameterized inverse depth."""
        w, h = calib.w[lvl], calib.h[lvl]
        fx, fy = calib.fx[lvl], calib.fy[lvl]
        cx0, cy0 = calib.cx[lvl], calib.cy[lvl]
        f32 = dict(dtype=torch.float32, device=device)
        T_wc = lie.se3_inv(torch.as_tensor(np.asarray(T_cw), **f32))
        R = T_wc[:3, :3]
        o = T_wc[:3, 3]

        ys, xs = torch.meshgrid(torch.arange(h, **f32),
                                torch.arange(w, **f32), indexing="ij")
        rays_cam = torch.stack([(xs - cx0) / fx, (ys - cy0) / fy,
                                torch.ones_like(xs)], -1)
        rays_w = torch.einsum("ij,hwj->hwi", R, rays_cam)
        rz = torch.where(torch.abs(rays_w[..., 2]) < 1e-9,
                         torch.full_like(rays_w[..., 2], 1e-9), rays_w[..., 2])

        def hit(z_plane):
            t = (z_plane - o[2]) / rz
            return t, o[None, None, :] + t[..., None] * rays_w

        t_best, X_bg = hit(self.z_bg)
        img = self._face(-1).texture(X_bg[..., 0], X_bg[..., 1])
        bx, by, hx, hy, bz = self._boxes()
        for k in range(self.n_boxes):
            t, X = hit(float(bz[k]))
            inside = ((torch.abs(X[..., 0] - float(bx[k])) < float(hx[k]))
                      & (torch.abs(X[..., 1] - float(by[k])) < float(hy[k]))
                      & (t > 0.1))
            closer = inside & (t < t_best)
            face = self._face(k).texture(X[..., 0], X[..., 1])
            img = torch.where(closer, face, img)
            t_best = torch.where(closer, t, t_best)

        img = float(np.exp(aff_a)) * img + aff_b
        img = torch.clamp(img * exposure, 0.0, 255.0)
        idepth = torch.where(t_best > 1e-6,
                             1.0 / torch.clamp(t_best, min=1e-6),
                             torch.zeros_like(t_best))
        return img.to(torch.float32), idepth.to(torch.float32)


def make_scene(name: str, **kw):
    """Scene-family factory: 'plane' (smooth single plane) or 'boxes'
    (multi-depth occluding rectangles)."""
    if name == "plane":
        return PlaneScene(**kw)
    if name == "boxes":
        allowed = {f.name for f in dataclasses.fields(BoxScene)}
        return BoxScene(**{k: v for k, v in kw.items() if k in allowed})
    raise ValueError(f"unknown scene family '{name}' (plane|boxes)")


def orbit_trajectory(n_frames: int, radius: float = 0.15,
                     fwd: float = 0.02, yaw: float = 0.003) -> np.ndarray:
    """Gentle sideways-orbit + forward camera path: (N, 4, 4) T_cw (f64)."""
    Ts = []
    for i in range(n_frames):
        t = np.array([radius * np.sin(0.15 * i),
                      0.5 * radius * (1 - np.cos(0.15 * i)), fwd * i])
        w = np.array([0.0, yaw * i, 0.0])
        Ts.append(np.linalg.inv(lie_np.se3_exp(np.concatenate([t, w]))))
    return np.stack(Ts)


def render_sequence(scene, calib: Calibration, poses_cw: np.ndarray,
                    exposures: Optional[np.ndarray] = None, device="cpu"):
    """Render a full sequence on `device`; returns (N, H, W) float32 numpy
    images."""
    if exposures is None:
        exposures = np.ones(len(poses_cw), np.float32)
    return np.stack([scene.render(calib, T, exposure=float(e),
                                  device=device)[0].cpu().numpy()
                     for T, e in zip(poses_cw, exposures)])


def default_calib(w: int = 640, h: int = 480) -> Calibration:
    return Calibration.create(w, h, fx=0.55 * w, fy=0.55 * w,
                              cx=(w - 1) / 2.0, cy=(h - 1) / 2.0)
