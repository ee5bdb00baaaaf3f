"""Geometric rectification + photometric calibration.

Host side (one-time setup, numpy):
  * calib-file parsing (5 camera models, "crop"/"none"/explicit-K output
    spec) and the iterative optimal-K "crop" search
    (reference: src/frontend/Undistort.cc:241-349, 557-666, 676-867).
  * photometric calibration loading: >=256-entry response G normalized to
    0..255, vignette image normalized by its max
    (reference: Undistort.cc:43-160).

Device side (per-frame, jitted; see ldso_tpu_torch.ops.preprocess for the fused
pipeline): gamma-LUT inversion, vignette division, bilinear remap.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ldso_tpu_torch.camera.models import CameraModel, distort_coordinates, parse_calib_line
from ldso_tpu_torch.camera.calib import Calibration


@dataclasses.dataclass
class PhotometricCalib:
    """Inverse response LUT + inverse vignette, ready for the device kernel.

    G maps raw intensity [0..GDepth-1] -> photometrically linear 0..255
    (this is what the reference calls Binv / "gamma"); `g_grad` is the
    gradient LUT of the *forward* response B used to reweight pixel-selector
    gradients (reference: FrameHessian.cc:93-98, CalibHessian.h:102-110).
    """

    G: np.ndarray                 # (GDepth,) float32, normalized 0..255
    vignette_inv: Optional[np.ndarray]  # (hOrg, wOrg) float32 or None
    valid: bool

    @staticmethod
    def load(pcalib_file: Optional[str], vignette_image: Optional[np.ndarray],
             w: int, h: int) -> "PhotometricCalib":
        """vignette_image: raw uint8/uint16 array (decoded by the caller)."""
        if not pcalib_file:
            return PhotometricCalib(_identity_G(), None, False)
        try:
            with open(pcalib_file) as f:
                first = f.readline()
            G = np.array([float(t) for t in first.split()], dtype=np.float64)
        except (OSError, ValueError):
            return PhotometricCalib(_identity_G(), None, False)
        if G.size < 256 or np.any(np.diff(G) <= 0):
            return PhotometricCalib(_identity_G(), None, False)
        G = 255.0 * (G - G[0]) / (G[-1] - G[0])

        vig_inv = None
        if vignette_image is not None:
            vig = np.asarray(vignette_image, np.float64)
            if vig.shape != (h, w):
                raise ValueError(f"vignette size {vig.shape} != image size {(h, w)}")
            vig = vig / vig.max()
            with np.errstate(divide="ignore"):
                vig_inv = (1.0 / vig).astype(np.float32)
        valid = vig_inv is not None
        return PhotometricCalib(G.astype(np.float32), vig_inv, valid)

    def inverse_response_B(self) -> np.ndarray:
        """256-entry forward response B with B[Ginv(i)] == i, used for the
        selector's gamma gradient weights (reference: FullSystem.cc:866-890)."""
        B = np.zeros(256, np.float32)
        Binv = self.G[:256].astype(np.float64)
        for i in range(255):
            s = np.searchsorted(Binv, i, side="right") - 1
            s = min(max(s, 0), 254)
            denom = Binv[s + 1] - Binv[s]
            B[i] = s + (i - Binv[s]) / denom if denom > 0 else s
        B[0] = 0.0
        B[255] = 255.0
        return B


def _identity_G(depth: int = 256) -> np.ndarray:
    return (255.0 * np.arange(depth) / (depth - 1)).astype(np.float32)


@dataclasses.dataclass
class Undistorter:
    """Rectification spec: original model -> ideal pinhole of size (w, h)."""

    model: CameraModel
    pars: np.ndarray              # original [fx fy cx cy (+dist params)]
    w_org: int
    h_org: int
    w: int
    h: int
    K: np.ndarray                 # rectified 3x3
    remap_x: np.ndarray           # (h, w) float32, -1 where invalid
    remap_y: np.ndarray
    passthrough: bool
    photometric: Optional[PhotometricCalib] = None

    @staticmethod
    def from_file(calib_file: str, pcalib_file: Optional[str] = None,
                  vignette_image: Optional[np.ndarray] = None) -> "Undistorter":
        with open(calib_file) as f:
            lines = [f.readline() for _ in range(4)]
        model, pars = parse_calib_line(lines[0])
        w_org, h_org = (int(t) for t in lines[1].split()[:2])
        out_spec = lines[2].strip()
        w, h = (int(t) for t in lines[3].split()[:2])
        u = Undistorter.create(model, pars, w_org, h_org, out_spec, w, h)
        if pcalib_file is not None or vignette_image is not None:
            u.photometric = PhotometricCalib.load(pcalib_file, vignette_image, w_org, h_org)
        return u

    @staticmethod
    def create(model: CameraModel, pars: np.ndarray, w_org: int, h_org: int,
               out_spec: str, w: int, h: int) -> "Undistorter":
        pars = np.asarray(pars, np.float64).copy()
        # "relative" calibration: rescale by image size, -0.5 sample-center
        # shift (reference: Undistort.cc:780-795).
        if pars[2] < 1 and pars[3] < 1:
            pars[0] *= w_org
            pars[1] *= h_org
            pars[2] = pars[2] * w_org - 0.5
            pars[3] = pars[3] * h_org - 0.5

        passthrough = False
        if out_spec == "crop":
            K = _make_optimal_K_crop(model, pars, w_org, h_org, w, h)
        elif out_spec == "none":
            if (w, h) != (w_org, h_org):
                raise ValueError("rectification 'none' requires matching sizes")
            K = np.eye(3)
            K[0, 0], K[1, 1], K[0, 2], K[1, 2] = pars[:4]
            passthrough = model == CameraModel.PINHOLE
        elif out_spec == "full":
            raise NotImplementedError("'full' is unimplemented in the reference too "
                                      "(Undistort.cc:672-674); use 'crop'")
        else:
            oc = np.array([float(t) for t in out_spec.split()], np.float64)
            K = np.eye(3)
            K[0, 0] = oc[0] * w
            K[1, 1] = oc[1] * h
            K[0, 2] = oc[2] * w - 0.5
            K[1, 2] = oc[3] * h - 0.5

        remap_x, remap_y = _build_remap(model, pars, K, w_org, h_org, w, h, passthrough)
        return Undistorter(model=model, pars=pars, w_org=w_org, h_org=h_org,
                           w=w, h=h, K=K, remap_x=remap_x, remap_y=remap_y,
                           passthrough=passthrough)

    def calibration(self) -> Calibration:
        return Calibration.create(self.w, self.h,
                                  self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2])


def _make_optimal_K_crop(model, pars, w_org, h_org, w, h) -> np.ndarray:
    """Largest axis-aligned normalized-coordinate box whose rectified border
    lands fully inside the raw image (reference: Undistort.cc:557-666)."""
    # 1. stretch the center lines for a coarse guess
    tg = (np.arange(100000, dtype=np.float64) - 50000.0) / 10000.0
    zeros = np.zeros_like(tg)
    dx, _ = distort_coordinates(model, pars, np.eye(3), tg, zeros, np)
    ok = (dx > 0) & (dx < w_org - 1)
    minX = tg[ok].min() if ok.any() else -1.0
    maxX = tg[ok].max() if ok.any() else 1.0
    _, dy = distort_coordinates(model, pars, np.eye(3), zeros, tg, np)
    ok = (dy > 0) & (dy < h_org - 1)
    minY = tg[ok].min() if ok.any() else -1.0
    maxY = tg[ok].max() if ok.any() else 1.0

    minX *= 1.01; maxX *= 1.01; minY *= 1.01; maxY *= 1.01

    # 2. shrink while any border pixel is invalid
    ys = np.arange(h, dtype=np.float64) / (h - 1.0)
    xs = np.arange(w, dtype=np.float64) / (w - 1.0)
    for it in range(501):
        # left/right borders
        by = minY + (maxY - minY) * ys
        lx, _ = distort_coordinates(model, pars, np.eye(3), np.full(h, minX), by, np)
        rx, _ = distort_coordinates(model, pars, np.eye(3), np.full(h, maxX), by, np)
        oob_left = np.any(~((lx > 0) & (lx < w_org - 1)))
        oob_right = np.any(~((rx > 0) & (rx < w_org - 1)))
        # top/bottom borders
        bx = minX + (maxX - minX) * xs
        _, ty = distort_coordinates(model, pars, np.eye(3), bx, np.full(w, minY), np)
        _, by2 = distort_coordinates(model, pars, np.eye(3), bx, np.full(w, maxY), np)
        oob_top = np.any(~((ty > 0) & (ty < h_org - 1)))
        oob_bottom = np.any(~((by2 > 0) & (by2 < h_org - 1)))

        if not (oob_left or oob_right or oob_top or oob_bottom):
            break
        if (oob_left or oob_right) and (oob_top or oob_bottom):
            if (maxX - minX) > (maxY - minY):
                oob_bottom = oob_top = False
            else:
                oob_left = oob_right = False
        if oob_left:
            minX *= 0.995
        if oob_right:
            maxX *= 0.995
        if oob_top:
            minY *= 0.995
        if oob_bottom:
            maxY *= 0.995
    else:
        raise RuntimeError("optimal-K crop search failed to converge")

    K = np.eye(3)
    K[0, 0] = (w - 1.0) / (maxX - minX)
    K[1, 1] = (h - 1.0) / (maxY - minY)
    K[0, 2] = -minX * K[0, 0]
    K[1, 2] = -minY * K[1, 1]
    return K


def _build_remap(model, pars, K, w_org, h_org, w, h, passthrough) -> tuple:
    """(h, w) maps rectified->raw pixel; -1 marks invalid
    (reference: Undistort.cc:833-860)."""
    if passthrough:
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32))
        return xx, yy
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    rx, ry = distort_coordinates(model, pars, K, xs, ys, np)
    # rounding resistance at exact borders
    rx = np.where(rx == 0, 0.001, rx)
    ry = np.where(ry == 0, 0.001, ry)
    rx = np.where(rx == w_org - 1, w_org - 1.001, rx)
    ry = np.where(ry == h_org - 1, h_org - 1.001, ry)
    valid = (rx > 0) & (ry > 0) & (rx < w_org - 1) & (ry < h_org - 1)
    rx = np.where(valid, rx, -1.0).astype(np.float32)
    ry = np.where(valid, ry, -1.0).astype(np.float32)
    return rx, ry
