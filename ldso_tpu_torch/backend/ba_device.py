"""The windowed-BA LM loop on the device.

Counterpart of ldso_tpu/backend/ba_device.py: the FullSystem::optimize
default path (setting_forceAceptStep == true, FIX_LAMBDA |
ORTHOGONALIZE_X_LATER; Setting.cc:23,77):

  reset -> linearize -> [solve -> step -> relinearize] x iters -> re-fix
  newest eval point -> final linearize -> commit + drop dead residuals

The <= 68x68 stitched solve runs in float32 with diagonal scaling, the
reference's +10 damping and one iterative-refinement pass; the nullspace
orthogonalization uses an SVD of the pose+scale nullspace basis. Both go
to torch.linalg. The loop reads one flag per iteration (its break test).
"""

from __future__ import annotations

import torch

from ldso_tpu_torch.config import (CPARS, Config, SCALE_A, SCALE_B,
                                   SCALE_XI_ROT, SCALE_XI_TRANS,
                                   SOLVER_FIX_LAMBDA, SOLVER_USE_GN)
from ldso_tpu_torch.backend import ba
from ldso_tpu_torch.backend.window import (RES_IN, RES_OOB, RES_OUTLIER,
                                           Window, aff_g2l_zero, current_poses)
from ldso_tpu_torch.math import lie


def _reset_oob_dev(W: Window) -> Window:
    """resetOOB for the active (non-linearized) residual set."""
    mask = ba._lin_mask(W)
    i32 = lambda c: torch.full((), c, dtype=torch.int32, device=mask.device)  # noqa: E731
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return W._replace(
        res_state=torch.where(mask, i32(RES_IN), W.res_state),
        res_new_state=torch.where(mask, i32(RES_OUTLIER), W.res_new_state),
        res_energy=torch.where(mask, zero, W.res_energy),
        res_new_energy=torch.where(mask, zero, W.res_new_energy),
    )


def _nullspaces_dev(W: Window):
    """(n, 9) nullspace basis (getNullspaces, FullSystem.cc:1711-1760);
    rows of invalid frames are zero."""
    F = W.F
    dev = W.state.device
    f32 = dict(dtype=torch.float32, device=dev)
    adj = lie.se3_adj(W.T_eval)
    aff0 = aff_g2l_zero(W)
    fv = W.frame_valid.to(torch.float32)
    inv_scale = torch.tensor([1.0 / SCALE_XI_TRANS] * 3
                             + [1.0 / SCALE_XI_ROT] * 3, **f32)
    cols = []
    for i in range(6):
        seg = adj[:, :, i] * inv_scale[None, :] * fv[:, None]
        cols.append(torch.cat([seg, torch.zeros((F, 2), **f32)], dim=1))
    affA = torch.zeros((F, 8), **f32)
    affA[:, 6] = 1.0 / SCALE_A
    cols.append(affA * fv[:, None])
    affB = torch.zeros((F, 8), **f32)
    affB[:, 7] = torch.exp(aff0[:, 0]) * W.exposure / SCALE_B
    cols.append(affB * fv[:, None])
    t_ev = W.T_eval[:, :3, 3] / SCALE_XI_TRANS * fv[:, None]
    cols.append(torch.cat([t_ev, torch.zeros((F, 5), **f32)], dim=1))
    N = torch.stack([torch.cat([torch.zeros(CPARS, **f32), c.reshape(-1)])
                     for c in cols], dim=1)
    return N


def _orthogonalize_dev(x, N, delta: float):
    """x -= N (N^T N)^+ N^T x (EnergyFunctional::orthogonalize)."""
    Nn = N / torch.clamp(torch.linalg.norm(N, dim=0, keepdim=True), min=1e-12)
    U, S, Vt = torch.linalg.svd(Nn, full_matrices=False)
    Sinv = torch.where(S > delta * torch.amax(S), 1.0 / torch.clamp(S, min=1e-20),
                       torch.zeros_like(S))
    Npi = (U * Sinv[None, :]) @ Vt
    NNpiT = Nn @ Npi.T
    NNpiTS = 0.5 * (NNpiT + NNpiT.T)
    return x - NNpiTS @ x


def _solve_dev(W: Window, HM, bM, lam: float, do_orth: bool, cfg: Config):
    """Stitched assembly + scaled f32 solve + resubstitution pieces."""
    HA, bA, HL, bL, Hsc, bsc, aux, delta, nresA = ba.build_system(W)
    bM_top = bM + HM @ delta
    HFinal = HL + HM + HA
    bFinal = bL + bM_top + bA - bsc
    HFinal.diagonal().mul_(1.0 + lam)
    HFinal = HFinal - Hsc * (1.0 / (1.0 + lam))

    # invalid frame slots: identity rows/cols so the solve stays regular
    fmask = torch.cat([torch.ones(CPARS, dtype=torch.float32, device=HA.device),
                       W.frame_valid.to(torch.float32).repeat_interleave(8)])
    HFinal = HFinal * fmask[:, None] * fmask[None, :]
    HFinal = HFinal + torch.diag((fmask <= 0).to(torch.float32))
    bFinal = bFinal * fmask

    SVecI = 1.0 / torch.sqrt(torch.abs(torch.diagonal(HFinal)) + 10.0)
    Hs = SVecI[:, None] * HFinal * SVecI[None, :]
    bs = SVecI * bFinal
    xs = torch.linalg.solve_ex(Hs, bs)[0]
    # one iterative-refinement pass recovers f64-grade accuracy in f32
    r = bs - Hs @ xs
    xs = xs + torch.linalg.solve_ex(Hs, r)[0]
    x = SVecI * xs

    if do_orth:
        # pose + scale columns only (EnergyFunctional.cc:687-689)
        N = _nullspaces_dev(W)[:, [0, 1, 2, 3, 4, 5, 8]]
        x = _orthogonalize_dev(x, N, cfg.solver_mode_delta)
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    return x, aux, nresA


def _commit(W: Window) -> Window:
    upd = ba._lin_mask(W) & (W.res_state != RES_OOB)
    active = upd & (W.res_new_state == RES_IN)
    return W._replace(
        res_active=torch.where(upd, active, W.res_active),
        res_state=torch.where(upd, W.res_new_state, W.res_state),
        res_energy=torch.where(upd, W.res_new_energy, W.res_energy),
    )


def refix_newest(W: Window, newest: int) -> Window:
    """Move the newest frame's evaluation point to its current pose,
    keeping (a, b) (FullSystem.cc:833-841)."""
    new_zero = torch.zeros(10, dtype=torch.float32, device=W.state.device)
    new_zero[6:8] = W.state[newest, 6:8]
    T_eval = W.T_eval.clone()
    T_eval[newest] = current_poses(W)[newest]
    state = W.state.clone()
    state[newest] = new_zero
    state_zero = W.state_zero.clone()
    state_zero[newest] = new_zero
    return W._replace(T_eval=T_eval, state=state, state_zero=state_zero)


def _finalize_linearization(W: Window) -> Window:
    """applyRes(true) + drop dead residuals + per-point stats (the
    fixLinearization path of linearizeAll, FullSystem.cc:1466-1543)."""
    mask = ba._lin_mask(W)
    W = _commit(W)
    pc = ba.make_precalc(W)
    KRKi = pc.KRKi[W.pt_host]
    Kt = pc.Kt[W.pt_host]
    p1 = torch.stack([W.pt_u, W.pt_v, torch.ones_like(W.pt_u)], -1)
    ptp_inf = torch.einsum("pfij,pj->pfi", KRKi, p1)
    ptp = ptp_inf + Kt * W.idepth[:, None, None]
    pi = ptp_inf[..., :2] / ptp_inf[..., 2:3]
    pp = ptp[..., :2] / ptp[..., 2:3]
    rel_bs = 0.01 * torch.linalg.norm(pi - pp, dim=-1)
    act_now = W.res_active & mask
    return W._replace(
        pt_max_rel_baseline=torch.maximum(
            W.pt_max_rel_baseline,
            torch.amax(torch.where(act_now, rel_bs, torch.zeros_like(rel_bs)),
                       dim=1)),
        pt_num_good_res=W.pt_num_good_res + torch.sum(act_now, dim=1).to(torch.int32),
        res_exist=W.res_exist & ~(mask & ~W.res_active),
    )


def optimize_device(W: Window, dIs, HM, bM, newest: int, cfg: Config,
                    img_w: int, img_h: int, max_iterations: int):
    """The default-mode LM loop. dIs: (F,H,W,3) window images; HM/bM: the
    marginalization prior padded to the full (4+8F) size, float32.

    Returns (W, stats) with stats = [final energy, nresA, rmse]."""
    lam0 = 1e-5 if (cfg.solver_mode & SOLVER_FIX_LAMBDA) else (
        0.0 if (cfg.solver_mode & SOLVER_USE_GN) else 1e-1)
    lam0 = float(torch.tensor(lam0, dtype=torch.float32))

    W = _reset_oob_dev(W)
    W, eP = ba.linearize_all(W, dIs, cfg, img_w, img_h)
    W = ba.set_new_frame_energy_th(W, newest, cfg)
    W = _commit(W)

    nresA = torch.ones((), dtype=torch.int64, device=eP.device)
    for it in range(max_iterations):
        W = ba.backup_state(W)
        x, aux, nresA = _solve_dev(W, HM, bM, lam0, it >= 2, cfg)
        W = ba.resubstitute(W, x, aux["HdiF"], aux["bdSum"], aux["Hcd"],
                            aux["JpJdF"])
        W = W._replace(pt_idepth_hessian=1.0 / torch.clamp(aux["HdiF"], min=1e-12))
        W, canbreak = ba.do_step(W, 1.0, 1.0, 1.0, 1.0, 1.0)
        W, eP = ba.linearize_all(W, dIs, cfg, img_w, img_h)
        W = ba.set_new_frame_energy_th(W, newest, cfg)
        W = _commit(W)      # force-accept path
        if bool(canbreak) and it + 1 >= cfg.min_opt_iterations:
            break

    W = refix_newest(W, newest)
    if cfg.ba_finalize_sliced:
        W, eP = ba.linearize_target(W, dIs, cfg, img_w, img_h, newest)
    else:
        W = _reset_oob_dev(W)
        W, eP = ba.linearize_all(W, dIs, cfg, img_w, img_h)
    W = ba.set_new_frame_energy_th(W, newest, cfg)
    W = _finalize_linearization(W)
    nres = nresA.to(torch.float32)
    rmse = torch.sqrt(eP / torch.clamp(8.0 * nres, min=1.0))
    return W, torch.stack([eP, nres, rmse])
