"""The windowed-BA LM loop as one device program.

Counterpart of ldso_tpu/backend/ba_device.py: the FullSystem::optimize
default path (setting_forceAceptStep == true, FIX_LAMBDA |
ORTHOGONALIZE_X_LATER; Setting.cc:23,77):

  reset -> linearize -> [solve -> step -> relinearize] x iters -> re-fix
  newest eval point -> final linearize -> commit + drop dead residuals

The <= 68x68 stitched solve runs in float32 with diagonal scaling, the
reference's +10 damping and one iterative-refinement pass
(torch.linalg.solve_ex). The nullspace orthogonalization projects out the
pose + scale nullspace, whose projector (`nullspace_projector`) does not
change during the LM trips: it is formed once per call, by an SVD on the
CPU and by a hand-written kernel on the card
(ops/cuda_kernels.ba_projector, csrc/ba_projector.cu), where the SVD reads
its convergence flag on the host.

As the JAX package's `lax.while_loop` on a device `done` flag, the loop
reads nothing on the host: it runs all `max_iterations` trips, and a trip
after `done` keeps the state it found (`torch.where` on the flag), so its
results are the early-exit loop's bit for bit. With `newest` a 0-d device
integer, one program serves every window fill. So `optimize_device` runs
under `torch.func.vmap` over S windows, and on the card
EnergyFunctional.optimize replays it as one CUDA graph per trip count
(backend/energy_functional.replay_ba).
"""

from __future__ import annotations

import numpy as np
import torch

from ldso_tpu_torch.config import (CPARS, Config, SCALE_A, SCALE_B,
                                   SCALE_XI_ROT, SCALE_XI_TRANS,
                                   SOLVER_FIX_LAMBDA, SOLVER_USE_GN)
from ldso_tpu_torch.backend import ba
from ldso_tpu_torch.backend.window import (RES_IN, RES_OOB, RES_OUTLIER,
                                           Window, aff_g2l_zero, current_poses)
from ldso_tpu_torch.math import lie
from ldso_tpu_torch.ops import cuda_kernels
from ldso_tpu_torch.utils.static import device_const

# the Config fields the device LM reads (its CUDA graphs are keyed on them)
CONFIG_FIELDS = ("solver_mode", "solver_mode_delta", "min_opt_iterations",
                 "ba_finalize_sliced", "outlier_th_sum_component",
                 "huber_th", "affine_opt_mode_a", "affine_opt_mode_b",
                 "frame_energy_th_n", "frame_energy_th_fac_median",
                 "frame_energy_th_const_weight", "overall_energy_th_weight")


def graph_key(cfg: Config) -> tuple:
    """The Config fields the device LM reads, as a CUDA graph key."""
    return tuple(getattr(cfg, f) for f in CONFIG_FIELDS)


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
    inv_scale = device_const((1.0 / SCALE_XI_TRANS,) * 3
                             + (1.0 / SCALE_XI_ROT,) * 3, dev)
    cols = []
    for i in range(6):
        seg = adj[:, :, i] * inv_scale[None, :] * fv[:, None]
        cols.append(torch.cat([seg, torch.zeros((F, 2), **f32)], dim=1))
    zeros = torch.zeros((F, 1), **f32)
    affA = torch.cat([torch.zeros((F, 6), **f32),
                      torch.full((F, 1), 1.0 / SCALE_A, **f32), zeros], 1)
    cols.append(affA * fv[:, None])
    affB = torch.cat([torch.zeros((F, 7), **f32),
                      (torch.exp(aff0[:, 0]) * W.exposure / SCALE_B)[:, None]],
                     1)
    cols.append(affB * fv[:, None])
    t_ev = W.T_eval[:, :3, 3] / SCALE_XI_TRANS * fv[:, None]
    cols.append(torch.cat([t_ev, torch.zeros((F, 5), **f32)], dim=1))
    N = torch.stack([torch.cat([torch.zeros(CPARS, **f32), c.reshape(-1)])
                     for c in cols], dim=1)
    return N


def nullspace_projector_ref(Nn, delta: float):
    """The symmetrised (n, n) projector N (N^T N)^+ N^T of the (n, k)
    column-normalised basis Nn, by its SVD: U_r U_r^T over the singular
    values S > delta max(S) (EnergyFunctional::orthogonalize). The plain
    version of K12 (ops/cuda_kernels.ba_projector); on the card the SVD
    reads its convergence flag on the host, so it cannot run in a graph."""
    U, S, Vt = torch.linalg.svd(Nn, full_matrices=False)
    Sinv = torch.where(S > delta * torch.amax(S), 1.0 / torch.clamp(S, min=1e-20),
                       torch.zeros_like(S))
    Npi = (U * Sinv[None, :]) @ Vt
    NNpiT = Nn @ Npi.T
    return 0.5 * (NNpiT + NNpiT.T)


def orth_basis(W: Window):
    """The pose + scale columns of the nullspace (EnergyFunctional.cc:
    687-689), each scaled to unit norm: (n, 7)."""
    N = _nullspaces_dev(W)
    N = torch.cat([N[:, :6], N[:, 8:9]], dim=1)
    return N / torch.clamp(torch.linalg.norm(N, dim=0, keepdim=True), min=1e-12)


def nullspace_projector(W: Window, cfg: Config):
    """The projector that x - P x removes the nullspace with
    (EnergyFunctional::orthogonalize). It reads T_eval, state_zero,
    exposure and frame_valid, which the LM trips do not write, so one per
    call serves every trip. CPU: the SVD; card: K12."""
    return cuda_kernels.ba_projector(orth_basis(W), cfg.solver_mode_delta)


def _solve_dev(W: Window, HM, bM, lam: float, proj, cfg: Config):
    """Stitched assembly + scaled f32 solve + resubstitution pieces; `proj`
    the nullspace projector, or None before ORTHOGONALIZE_X_LATER's
    iteration 2."""
    HA, bA, HL, bL, Hsc, bsc, aux, delta, nresA = ba.build_system(W)
    bM_top = bM + HM @ delta
    HFinal = HL + HM + HA
    bFinal = bL + bM_top + bA - bsc
    n = HFinal.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=HA.device)
    HFinal = torch.where(eye, HFinal * (1.0 + lam), HFinal)
    HFinal = HFinal - Hsc * (1.0 / (1.0 + lam))

    # invalid frame slots: identity rows/cols so the solve stays regular
    fmask = torch.cat([torch.ones(CPARS, dtype=torch.float32, device=HA.device),
                       W.frame_valid.to(torch.float32)[:, None].expand(
                           -1, 8).reshape(-1)])
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

    if proj is not None:
        x = x - proj @ x
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


def refix_newest(W: Window, newest) -> Window:
    """Move the newest frame's evaluation point (`newest` an int or a 0-d
    device integer) to its current pose, keeping (a, b)
    (FullSystem.cc:833-841)."""
    dev = W.state.device
    row = (torch.arange(W.F, device=dev) == newest)[:, None]
    ab = device_const(tuple(6 <= i < 8 for i in range(10)), dev, torch.bool)
    new_zero = torch.where(ab, W.state, torch.zeros_like(W.state))
    return W._replace(
        T_eval=torch.where(row[..., None], current_poses(W), W.T_eval),
        state=torch.where(row, new_zero, W.state),
        state_zero=torch.where(row, new_zero, W.state_zero))


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


def _trip(W: Window, dIs, HM, bM, newest, lam0: float, proj, cfg: Config,
          img_w: int, img_h: int):
    """One force-accepted LM iteration: (W, eP, nresA, canbreak)."""
    W = ba.backup_state(W)
    x, aux, nresA = _solve_dev(W, HM, bM, lam0, proj, cfg)
    W = ba.resubstitute(W, x, aux["HdiF"], aux["bdSum"], aux["Hcd"],
                        aux["JpJdF"])
    W = W._replace(pt_idepth_hessian=1.0 / torch.clamp(aux["HdiF"], min=1e-12))
    W, canbreak = ba.do_step(W, 1.0, 1.0, 1.0, 1.0, 1.0)
    W, eP = ba.linearize_all(W, dIs, cfg, img_w, img_h)
    W = ba.set_new_frame_energy_th(W, newest, cfg)
    return _commit(W), eP, nresA, canbreak


def lm_lambda(cfg: Config) -> float:
    """The LM's fixed damping, as float32 (FIX_LAMBDA 1e-5, else GN 0, else
    0.1)."""
    lam0 = 1e-5 if (cfg.solver_mode & SOLVER_FIX_LAMBDA) else (
        0.0 if (cfg.solver_mode & SOLVER_USE_GN) else 1e-1)
    return float(np.float32(lam0))


def optimize_device(W: Window, dIs, HM, bM, newest, cfg: Config,
                    img_w: int, img_h: int, max_iterations: int):
    """The default-mode LM loop as one device program. dIs: (F,H,W,3)
    window images; HM/bM: the marginalization prior padded to the full
    (4+8F) size, float32; newest: the newest frame's slot, an int or a 0-d
    device integer.

    Runs `max_iterations` trips; the break test (`canbreak` after at least
    min_opt_iterations trips) sets a device `done`, after which each trip's
    results are dropped by `torch.where`: the early-exit loop's results,
    with no host read. Returns (W, stats) with stats = [final energy,
    nresA, rmse]."""
    lam0 = lm_lambda(cfg)
    W = _reset_oob_dev(W)
    W, eP = ba.linearize_all(W, dIs, cfg, img_w, img_h)
    W = ba.set_new_frame_energy_th(W, newest, cfg)
    W = _commit(W)
    # ORTHOGONALIZE_X_LATER: from iteration 2 on
    proj = nullspace_projector(W, cfg) if max_iterations > 2 else None

    dev = eP.device
    nresA = torch.ones((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for it in range(max_iterations):
        Wn, eP_n, nresA_n, canbreak = _trip(
            W, dIs, HM, bM, newest, lam0, proj if it >= 2 else None, cfg,
            img_w, img_h)
        # after `done`, the state the trip found (fields it did not write
        # are the same tensors)
        W = Window(*(o if n is o else torch.where(done, o, n)
                     for o, n in zip(W, Wn)))
        eP = torch.where(done, eP, eP_n)
        nresA = torch.where(done, nresA, nresA_n)
        if it + 1 >= cfg.min_opt_iterations:
            done = done | canbreak

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
