"""The five geometric camera models of the reference, batched & array-generic.

`distort_coordinates(model, pars, K_new, x, y)` maps *rectified* pixel
coordinates (under the ideal pinhole K_new) to *raw distorted* pixel
coordinates under the original model parameters `pars` — the direction the
rectification remap needs (reference: src/frontend/Undistort.cc:888-1118,
one `distortCoordinates` per model).

Works with numpy (host-side remap construction, one-time) and jax.numpy
(if a device-side remap is ever needed) via the `xp` module argument.
"""

from __future__ import annotations

import enum

import numpy as np


class CameraModel(enum.Enum):
    PINHOLE = "pinhole"
    FOV = "fov"            # ATAN model (reference: Undistort.cc:888-919)
    RADTAN = "radtan"      # OpenCV k1 k2 p1 p2 (reference: Undistort.cc:934-975)
    EQUIDISTANT = "equidistant"  # (reference: Undistort.cc:990-1028)
    KANNALA_BRANDT = "kannalabrandt"  # (reference: Undistort.cc:1048-1086)


def _normalized(K_new, x, y):
    ix = (x - K_new[0, 2]) / K_new[0, 0]
    iy = (y - K_new[1, 2]) / K_new[1, 1]
    return ix, iy


def distort_coordinates(model: CameraModel, pars, K_new, x, y, xp=np):
    """Rectified pixel (x, y) -> raw distorted pixel, elementwise.

    pars: [fx fy cx cy (model params...)] of the ORIGINAL camera.
    K_new: 3x3 rectified pinhole intrinsics.
    """
    fx, fy, cx, cy = pars[0], pars[1], pars[2], pars[3]
    ix, iy = _normalized(K_new, x, y)

    if model == CameraModel.PINHOLE:
        return fx * ix + cx, fy * iy + cy

    if model == CameraModel.FOV:
        dist = pars[4]
        d2t = 2.0 * np.tan(dist / 2.0)
        r = xp.sqrt(ix * ix + iy * iy)
        safe_r = xp.where(r == 0, 1.0, r)
        fac = xp.where((r == 0) | (dist == 0), 1.0, xp.arctan(safe_r * d2t) / (dist * safe_r))
        return fx * fac * ix + cx, fy * fac * iy + cy

    if model == CameraModel.RADTAN:
        k1, k2, p1, p2 = pars[4], pars[5], pars[6], pars[7]
        mx2, my2, mxy = ix * ix, iy * iy, ix * iy
        rho2 = mx2 + my2
        rad = k1 * rho2 + k2 * rho2 * rho2
        x_d = ix + ix * rad + 2.0 * p1 * mxy + p2 * (rho2 + 2.0 * mx2)
        y_d = iy + iy * rad + 2.0 * p2 * mxy + p1 * (rho2 + 2.0 * my2)
        return fx * x_d + cx, fy * y_d + cy

    if model == CameraModel.EQUIDISTANT:
        k1, k2, k3, k4 = pars[4], pars[5], pars[6], pars[7]
        r = xp.sqrt(ix * ix + iy * iy)
        theta = xp.arctan(r)
        t2 = theta * theta
        thetad = theta * (1 + k1 * t2 + k2 * t2 * t2 + k3 * t2 * t2 * t2 + k4 * t2 * t2 * t2 * t2)
        scaling = xp.where(r > 1e-8, thetad / xp.where(r > 1e-8, r, 1.0), 1.0)
        return fx * ix * scaling + cx, fy * iy * scaling + cy

    if model == CameraModel.KANNALA_BRANDT:
        k0, k1, k2, k3 = pars[4], pars[5], pars[6], pars[7]
        rr = xp.sqrt(ix * ix + iy * iy)
        theta = xp.arctan2(rr, xp.ones_like(rr))
        t2 = theta * theta
        t3 = t2 * theta
        r = theta + k0 * t3 + k1 * t3 * t2 + k2 * t3 * t2 * t2 + k3 * t3 * t2 * t2 * t2
        small = rr < 1e-6
        scale = xp.where(small, 1.0, r / xp.where(small, 1.0, rr))
        return fx * ix * scale + cx, fy * iy * scale + cy

    raise ValueError(f"unknown camera model {model}")


def parse_calib_line(line: str):
    """Parse the first line of a DSO calib file into (model, params).

    Supports both the prefixed ("RadTan fx fy ...") and legacy bare-number
    formats (8 numbers => RadTan, 5 numbers with last==0 => Pinhole, else
    FOV), mirroring reference Undistort::getUndistorterForFile
    (Undistort.cc:241-349)."""
    tokens = line.strip().split()
    if not tokens:
        raise ValueError("empty calib line")
    name = tokens[0].lower()
    named = {
        "kannalabrandt": CameraModel.KANNALA_BRANDT,
        "radtan": CameraModel.RADTAN,
        "equidistant": CameraModel.EQUIDISTANT,
        "fov": CameraModel.FOV,
        "atan": CameraModel.FOV,
        "pinhole": CameraModel.PINHOLE,
    }
    if name in named:
        pars = np.array([float(t) for t in tokens[1:]], dtype=np.float64)
        return named[name], pars
    pars = np.array([float(t) for t in tokens], dtype=np.float64)
    if len(pars) == 8:
        return CameraModel.RADTAN, pars
    if len(pars) == 5:
        if pars[4] == 0:
            return CameraModel.PINHOLE, pars
        return CameraModel.FOV, pars
    raise ValueError(f"cannot interpret calib line: {line!r}")
