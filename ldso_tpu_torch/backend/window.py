"""Sliding-window state as fixed-capacity tensors.

Counterpart of ldso_tpu/backend/window.py: one struct of tensors with
static capacities (F frame slots, P point slots, a dense (P, F) residual
lattice) in place of the reference's FrameHessian / PointHessian /
PointFrameResidual objects (SURVEY.md §2 C7-C12). The parameterization is
the reference's: frame state x (10,) unscaled, the physical increment is
S x; calib c (4,) unscaled; idepth physical.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ldso_tpu_torch.config import (SCALE_A, SCALE_B, SCALE_C, SCALE_F,
                                   SCALE_XI_ROT, SCALE_XI_TRANS)
from ldso_tpu_torch.math import lie
from ldso_tpu_torch.utils.static import device_const

RES_IN = 0
RES_OOB = 1
RES_OUTLIER = 2

FRAME_SCALE = np.array([SCALE_XI_TRANS] * 3 + [SCALE_XI_ROT] * 3
                       + [SCALE_A, SCALE_B], np.float32)
C_SCALE = np.array([SCALE_F, SCALE_F, SCALE_C, SCALE_C], np.float32)
STATE_SCALE = np.concatenate([FRAME_SCALE, [SCALE_A, SCALE_B]]).astype(np.float32)


class Window(NamedTuple):
    """All window state. F/P are static capacities."""
    frame_valid: torch.Tensor      # (F,) bool
    T_eval: torch.Tensor           # (F,4,4) worldToCam at the FEJ point
    state: torch.Tensor            # (F,10) unscaled [t(3) w(3) a b a' b']
    state_zero: torch.Tensor
    state_backup: torch.Tensor
    frame_step: torch.Tensor
    exposure: torch.Tensor         # (F,)
    prior: torch.Tensor            # (F,8)
    frame_energy_th: torch.Tensor  # (F,)
    c_value: torch.Tensor          # (4,) unscaled
    c_zero: torch.Tensor
    c_backup: torch.Tensor
    c_step: torch.Tensor
    c_prior: torch.Tensor
    pt_valid: torch.Tensor         # (P,) bool
    pt_host: torch.Tensor          # (P,) int64 frame slot
    pt_u: torch.Tensor
    pt_v: torch.Tensor
    pt_color: torch.Tensor         # (P,8)
    pt_weights: torch.Tensor       # (P,8)
    idepth: torch.Tensor
    idepth_zero: torch.Tensor
    idepth_backup: torch.Tensor
    pt_step: torch.Tensor
    pt_prior: torch.Tensor
    pt_energy_th: torch.Tensor
    pt_num_good_res: torch.Tensor  # (P,) int32
    pt_max_rel_baseline: torch.Tensor
    pt_idepth_hessian: torch.Tensor
    res_exist: torch.Tensor        # (P,F) bool
    res_active: torch.Tensor
    res_linearized: torch.Tensor
    res_state: torch.Tensor        # (P,F) int32
    res_energy: torch.Tensor
    res_new_state: torch.Tensor
    res_new_energy: torch.Tensor
    res_new_energy_wo: torch.Tensor
    res_toZero: torch.Tensor       # (P,F,8)
    Jpdxi: torch.Tensor            # (P,F,2,6)
    Jpdc: torch.Tensor             # (P,F,2,4)
    Jpdd: torch.Tensor             # (P,F,2)
    JIdx: torch.Tensor             # (P,F,2,8)
    JabF: torch.Tensor             # (P,F,2,8)
    resF: torch.Tensor             # (P,F,8)
    center_proj: torch.Tensor      # (P,F,3)

    @property
    def F(self) -> int:
        return self.frame_valid.shape[0]

    @property
    def P(self) -> int:
        return self.pt_valid.shape[0]


def empty_window(F: int, P: int, c_init, cfg, device) -> Window:
    """Fresh window with intrinsics c_init = physical [fx fy cx cy]."""
    f32 = dict(dtype=torch.float32, device=device)
    b = dict(dtype=torch.bool, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    z = torch.zeros
    c = torch.tensor(np.asarray(c_init, np.float32), **f32) / torch.tensor(
        C_SCALE, **f32)
    return Window(
        frame_valid=z(F, **b),
        T_eval=torch.eye(4, **f32).expand(F, 4, 4).clone(),
        state=z((F, 10), **f32), state_zero=z((F, 10), **f32),
        state_backup=z((F, 10), **f32), frame_step=z((F, 10), **f32),
        exposure=torch.ones(F, **f32), prior=z((F, 8), **f32),
        frame_energy_th=torch.full((F,), 12.0 * 12.0 * 8.0, **f32),
        c_value=c, c_zero=c.clone(), c_backup=c.clone(), c_step=z(4, **f32),
        c_prior=torch.full((4,), cfg.initial_calib_hessian, **f32),
        pt_valid=z(P, **b), pt_host=z(P, dtype=torch.int64, device=device),
        pt_u=z(P, **f32), pt_v=z(P, **f32),
        pt_color=z((P, 8), **f32), pt_weights=z((P, 8), **f32),
        idepth=z(P, **f32), idepth_zero=z(P, **f32), idepth_backup=z(P, **f32),
        pt_step=z(P, **f32), pt_prior=z(P, **f32), pt_energy_th=z(P, **f32),
        pt_num_good_res=z(P, **i32), pt_max_rel_baseline=z(P, **f32),
        pt_idepth_hessian=z(P, **f32),
        res_exist=z((P, F), **b), res_active=z((P, F), **b),
        res_linearized=z((P, F), **b),
        res_state=torch.full((P, F), RES_OUTLIER, **i32),
        res_energy=z((P, F), **f32),
        res_new_state=torch.full((P, F), RES_OUTLIER, **i32),
        res_new_energy=z((P, F), **f32), res_new_energy_wo=z((P, F), **f32),
        res_toZero=z((P, F, 8), **f32),
        Jpdxi=z((P, F, 2, 6), **f32), Jpdc=z((P, F, 2, 4), **f32),
        Jpdd=z((P, F, 2), **f32), JIdx=z((P, F, 2, 8), **f32),
        JabF=z((P, F, 2, 8), **f32), resF=z((P, F, 8), **f32),
        center_proj=z((P, F, 3), **f32),
    )


def scaled_state(state):
    """(..., 10) unscaled -> scaled (physical) parameters."""
    return state * device_const(tuple(STATE_SCALE.tolist()), state.device)


def c_scaled(c_value):
    return c_value * device_const(tuple(C_SCALE.tolist()), c_value.device)


def current_poses(W: Window):
    """(F,4,4) current worldToCam = exp(scaled_state[:6]) @ T_eval."""
    return lie.se3_exp(scaled_state(W.state)[:, :6]) @ W.T_eval


def aff_g2l(W: Window):
    """(F,2) current affine (a, b)."""
    return scaled_state(W.state)[:, 6:8]


def aff_g2l_zero(W: Window):
    return scaled_state(W.state_zero)[:, 6:8]
