"""Feature matching for loop closing (FeatureMatcher + the projection
re-matching stage of LoopClosing::ComputeOptimizedPose).

Counterpart of ldso_tpu/loop/matcher.py. Host-side: matching runs only at
loop-candidate time on a few hundred features. SearchByBoW runs in the
native library's popcount matcher; the projection re-match is numpy with
a byte-table popcount (numpy's bitwise_count needs numpy >= 2).

Reference: src/frontend/FeatureMatcher.cc (SearchByBoW :66-124,
DescriptorDistance :16-33) and src/frontend/LoopClosing.cc:343-405
(search-by-projection with grid lookup + rotation check + idepth gate).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ldso_tpu_torch import native

TH_LOW = 50      # FeatureMatcher.h:62
TH_HIGH = 50     # LoopClosing.cc:275 (local TH_HIGH in ComputeOptimizedPose)
NN_RATIO = 0.75  # CorrectLoop's matcher(0.75, true), LoopClosing.cc:148

_POP8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


def hamming_matrix_np(da: np.ndarray, db: np.ndarray) -> np.ndarray:
    """(Na, 8) x (Nb, 8) uint32 -> (Na, Nb) int32 Hamming distances."""
    x = np.bitwise_xor(np.ascontiguousarray(da, np.uint32)[:, None, :],
                       np.ascontiguousarray(db, np.uint32)[None, :, :])
    return _POP8[x.view(np.uint8)].sum(axis=-1).astype(np.int32)


def search_by_bow(desc_a: np.ndarray, nodes_a: np.ndarray,
                  desc_b: np.ndarray, nodes_b: np.ndarray,
                  nn_ratio: float = NN_RATIO,
                  th_low: int = TH_LOW) -> np.ndarray:
    """SearchByBoW (FeatureMatcher.cc:66-124): match a-features to
    b-features only within the same vocabulary-tree node (the DBoW3
    FeatureVector bucket), best distance <= th_low and the NN-ratio test
    per bucket. Returns (Na,) int32 indices into b, -1 for no match."""
    return native.bow_bucketed_match(desc_a, nodes_a, desc_b, nodes_b,
                                     nn_ratio, th_low)[0]


def search_by_projection(P_ref: np.ndarray, desc_ref: np.ndarray,
                         angle_ref: np.ndarray, S_cr: np.ndarray,
                         uv_cur: np.ndarray, desc_cur: np.ndarray,
                         angle_cur: np.ndarray, idepth_cur: np.ndarray,
                         fxycxy: Tuple[float, float, float, float],
                         window_size: float = 5.0,
                         th_high: int = TH_HIGH) -> np.ndarray:
    """The re-matching stage of ComputeOptimizedPose
    (LoopClosing.cc:343-405): project each candidate-KF 3D point through
    the seed Sim3 into the current image, then search current-KF features
    within `window_size` px of the projection, requiring a compatible
    orientation (|angle diff| < 0.2, :367) and a current-frame idepth (the
    window idepth-map gate, :373-379); keep the best descriptor distance
    if <= th_high (argmin ties to the lowest index).

    Returns (M,) int32 indices into the current features, -1 for none."""
    fx, fy, cx, cy = fxycxy
    M = len(P_ref)
    if M == 0 or len(uv_cur) == 0:
        return np.full(M, -1, np.int32)
    Pc = P_ref @ S_cr[:3, :3].T + S_cr[:3, 3]
    z = Pc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = fx * Pc[:, 0] / z + cx
        v = fy * Pc[:, 1] / z + cy
    in_front = z > 1e-6
    du = np.abs(uv_cur[None, :, 0] - u[:, None])
    dv = np.abs(uv_cur[None, :, 1] - v[:, None])
    ok = (du <= window_size) & (dv <= window_size)
    ok &= np.abs(angle_cur[None, :] - angle_ref[:, None]) < 0.2
    ok &= (idepth_cur > 0)[None, :]
    ok &= in_front[:, None]
    dist = np.where(ok, hamming_matrix_np(desc_ref, desc_cur), 1 << 30)
    best = np.argmin(dist, axis=1)
    bestd = dist[np.arange(M), best]
    return np.where(bestd <= th_high, best, -1).astype(np.int32)
