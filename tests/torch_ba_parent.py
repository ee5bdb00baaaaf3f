"""The windowed BA's device LM as it ran before it became one device
program: the oracle that tests/test_torch_ba_device.py holds the masked
program to, bit for bit.

A frozen copy of the code it was, function for function, kept here so that
the test sees any change of arithmetic in the rewrites:
  * backend/ba_device.optimize_device: a Python loop that reads its break
    test on the host and stops; the nullspace projector formed by an SVD
    inside every trip from the third on; the newest frame a Python int;
  * every function of backend/ba.py, backend/window.py and math/lie.py that
    the program's rewrite (out of place, no host reads) touched, in its
    in-place form: `torch.linalg.inv`, the adjoint and stitch blocks and
    the diagonals written in place, `torch.tensor` constants, column and
    row writes at the newest frame.
The residual core and the energy sum are the current ones (backend/ba.
_residual_core, ordered_energy_sum): their arithmetic is K6's order, which
the rewrite did not touch, so the oracle and the program share it.
`early_exit_optimize` runs the loop with those functions put in place of
the current ones, so that the unchanged code between them (linearize_all,
build_system, the accumulations) calls the old versions too.
"""

from __future__ import annotations

import contextlib

import torch

from ldso_tpu_torch.backend import ba, window
from ldso_tpu_torch.backend.ba import (Precalc, _add_priors, _bilinear_frames,
                                       _host_onehot, _lin_mask, _sel)
from ldso_tpu_torch.backend.ba_device import (_commit,
                                              _finalize_linearization,
                                              _reset_oob_dev)
from ldso_tpu_torch.backend.window import (C_SCALE, FRAME_SCALE, RES_IN,
                                           RES_OOB, RES_OUTLIER, STATE_SCALE,
                                           Window, aff_g2l, aff_g2l_zero,
                                           current_poses)
from ldso_tpu_torch.config import (CPARS, PATTERN, SCALE_A, SCALE_B,
                                   SCALE_C, SCALE_F, SCALE_IDEPTH,
                                   SCALE_XI_ROT, SCALE_XI_TRANS,
                                   SOLVER_FIX_LAMBDA, SOLVER_USE_GN, Config)
from ldso_tpu_torch.frontend import affine
from ldso_tpu_torch.math import lie
from ldso_tpu_torch.math.lie import hat


# ---------------------------------------------------------------------------
# math/lie.py
# ---------------------------------------------------------------------------

def se3_adj(T):
    """Adjoint: (...,4,4) -> (...,6,6) for tangent order [v, w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    A = torch.zeros(T.shape[:-2] + (6, 6), dtype=T.dtype, device=T.device)
    A[..., :3, :3] = R
    A[..., :3, 3:] = hat(t) @ R
    A[..., 3:, 3:] = R
    return A


# ---------------------------------------------------------------------------
# backend/window.py
# ---------------------------------------------------------------------------

def scaled_state(state):
    """(..., 10) unscaled -> scaled (physical) parameters."""
    return state * torch.tensor(STATE_SCALE, device=state.device)


def c_scaled(c_value):
    return c_value * torch.tensor(C_SCALE, device=c_value.device)


# ---------------------------------------------------------------------------
# backend/ba.py
# ---------------------------------------------------------------------------

def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def make_precalc(W: Window) -> Precalc:
    """FrameFramePrecalc + setAdjointsF + setDeltaF."""
    F = W.F
    dev = W.state.device
    T_eval = W.T_eval
    T_cur = current_poses(W)
    Tinv_eval = lie.se3_inv(T_eval)
    Tinv_cur = lie.se3_inv(T_cur)
    rel0 = torch.einsum("tij,hjk->htik", T_eval, Tinv_eval)
    relc = torch.einsum("tij,hjk->htik", T_cur, Tinv_cur)
    R0 = rel0[..., :3, :3]
    t0 = rel0[..., :3, 3]
    Rc = relc[..., :3, :3]
    tc = relc[..., :3, 3]

    c = c_scaled(W.c_value)
    K = torch.eye(3, dtype=torch.float32, device=dev)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = c[0], c[1], c[2], c[3]
    Ki = torch.linalg.inv(K)
    KRKi = torch.einsum("ij,htjk,kl->htil", K, Rc, Ki)
    Kt = torch.einsum("ij,htj->hti", K, tc)

    aff_cur = aff_g2l(W)
    aff0 = aff_g2l_zero(W)
    expo = W.exposure
    aff_rel = affine.from_to(expo[:, None], expo[None, :],
                             aff_cur[:, None, :], aff_cur[None, :, :])
    b0 = aff0[:, 1]

    adj = lie.se3_adj(rel0.reshape(-1, 4, 4)).reshape(F, F, 6, 6)
    AH = torch.zeros((F, F, 8, 8), dtype=torch.float32, device=dev)
    AT = torch.zeros((F, F, 8, 8), dtype=torch.float32, device=dev)
    AH[..., :6, :6] = -adj.transpose(-1, -2)
    AT[..., :6, :6] = torch.eye(6, dtype=torch.float32, device=dev)
    aff0_rel = affine.from_to(expo[:, None], expo[None, :],
                              aff0[:, None, :], aff0[None, :, :])
    a0 = aff0_rel[..., 0]
    AT[..., 6, 6] = -a0
    AH[..., 6, 6] = a0
    AT[..., 7, 7] = -1.0
    AH[..., 7, 7] = a0
    rowscale = _f32(FRAME_SCALE, W.state)
    AH = AH * rowscale[None, None, :, None]
    AT = AT * rowscale[None, None, :, None]

    delta = (W.state - W.state_zero)[:, :8]
    adHTdelta = (torch.einsum("hj,htjk->htk", delta, AH)
                 + torch.einsum("tj,htjk->htk", delta, AT))
    return Precalc(R0=R0, t0=t0, KRKi=KRKi, Kt=Kt, aff=aff_rel, b0=b0,
                   adHost=AH, adTarget=AT, adHTdelta=adHTdelta,
                   c_delta=W.c_value - W.c_zero, fxycxy=c)


def linearize_target(W: Window, dIs, cfg: Config, img_w: int, img_h: int,
                     tgt: int):
    """`linearize_all` restricted to the residuals whose target is `tgt`,
    with the reference's sticky OOB (Residuals.cc:17-21). Returns (W',
    energy_sum over the full lattice)."""
    P = W.P
    pc = make_precalc(W)
    h = W.pt_host
    lin_mask = _lin_mask(W)[:, tgt]
    th = torch.maximum(W.frame_energy_th[h], W.frame_energy_th[tgt])
    out = ba._residual_core(
        W, pc, cfg, img_w, img_h, pc.R0[h, tgt], pc.t0[h, tgt],
        pc.KRKi[h, tgt], pc.Kt[h, tgt], pc.aff[h, tgt], pc.b0[h],
        lambda Ku, Kv: _bilinear_frames(dIs, torch.full_like(h, tgt)[:, None],
                                        Ku, Kv),
        W.pt_color, W.pt_weights, W.idepth_zero, W.idepth, th,
        W.res_state[:, tgt] == RES_OOB, W.res_energy[:, tgt])
    upd = {}
    for k, v in out.items():
        field = getattr(W, k).clone()
        field[:, tgt] = _sel(lin_mask, v, field[:, tgt])
        upd[k] = field
    W = W._replace(**upd)
    energy_sum = ba.ordered_energy_sum(torch.where(
        _lin_mask(W), W.res_new_energy, torch.zeros_like(W.res_new_energy)))
    return W, energy_sum


def set_new_frame_energy_th(W: Window, newest: int, cfg: Config) -> Window:
    """Quantile-based per-frame outlier threshold (FullSystem.cc:1762-1793)."""
    mask = _lin_mask(W) & (W.res_new_energy_wo >= 0)
    tsel = torch.arange(W.F, device=mask.device)[None, :] == newest
    mask = mask & tsel
    vals = torch.where(mask, W.res_new_energy_wo,
                       torch.full_like(W.res_new_energy_wo, float("inf"))).reshape(-1)
    n = torch.sum(mask)
    svals = torch.sort(vals).values
    nth = torch.clamp((cfg.frame_energy_th_n * n.to(torch.float32)).to(torch.int64),
                      0, vals.shape[0] - 1)
    default = torch.full((), 12.0 * 12.0 * 8.0, dtype=torch.float32,
                         device=mask.device)
    nth_el = torch.sqrt(torch.where(n > 0, svals[nth], default))
    th = nth_el * cfg.frame_energy_th_fac_median
    th = (26.0 * cfg.frame_energy_th_const_weight
          + th * (1.0 - cfg.frame_energy_th_const_weight))
    th = th * th * cfg.overall_energy_th_weight ** 2
    th = torch.where(n > 0, th, default)
    fet = W.frame_energy_th.clone()
    fet[newest] = th
    return W._replace(frame_energy_th=fet)


def _assemble(Hcc, colCf, Hff, bC, bF, F, dev):
    n = CPARS + 8 * F
    H = torch.zeros((n, n), dtype=torch.float32, device=dev)
    H[:CPARS, :CPARS] = Hcc
    H[CPARS:, CPARS:] = Hff
    H[CPARS:, :CPARS] = colCf
    H[:CPARS, CPARS:] = colCf.T
    return H, torch.cat([bC, bF.reshape(-1)])


def _stitch_top(acc, pc: Precalc, W: Window, use_prior: bool):
    """stitchDouble (AccumulatedTopHessian.cc:131-198), vectorized."""
    F = acc.shape[0]
    dev = acc.device
    AH, AT = pc.adHost, pc.adTarget
    G = acc[:, :, CPARS:CPARS + 8, CPARS:CPARS + 8]
    Gc = acc[:, :, CPARS:CPARS + 8, 0:CPARS]
    Gcc = acc[:, :, 0:CPARS, 0:CPARS]
    gb = acc[:, :, CPARS:CPARS + 8, CPARS + 8]
    cb = acc[:, :, 0:CPARS, CPARS + 8]

    Bhh = torch.einsum("htij,htjk,htlk->htil", AH, G, AH)
    Btt = torch.einsum("htij,htjk,htlk->htil", AT, G, AT)
    Bht = torch.einsum("htij,htjk,htlk->htil", AH, G, AT)
    col_h = torch.einsum("htij,htjc->htic", AH, Gc)
    col_t = torch.einsum("htij,htjc->htic", AT, Gc)
    b_h = torch.einsum("htij,htj->hti", AH, gb)
    b_t = torch.einsum("htij,htj->hti", AT, gb)

    hs = torch.arange(F, device=dev)
    grid = Bht.clone()
    grid[hs, hs] = grid[hs, hs] + torch.sum(Bhh, dim=1) + torch.sum(Btt, dim=0)
    gridT = grid.transpose(0, 1).transpose(2, 3)
    eye = torch.eye(F, dtype=torch.bool, device=dev)[:, :, None, None]
    sym = torch.where(eye, grid, grid + gridT)

    H, b = _assemble(
        torch.sum(Gcc, dim=(0, 1)),
        (torch.sum(col_h, dim=1) + torch.sum(col_t, dim=0)).reshape(8 * F, CPARS),
        sym.permute(0, 2, 1, 3).reshape(8 * F, 8 * F),
        torch.sum(cb, dim=(0, 1)),
        torch.sum(b_h, dim=1) + torch.sum(b_t, dim=0), F, dev)

    return _add_priors(H, b, W, pc) if use_prior else (H, b)


def _accumulate_sc(W: Window, pc: Precalc, Hdd_tot, bd_tot, Hcd_tot,
                   shift_prior: bool, pt_mask=None):
    """AccumulatedSCHessian accumulation + stitch (AccumulatedSCHessian.cc)."""
    P, F = W.P, W.F
    dev = W.state.device
    if pt_mask is None:
        pt_mask = W.pt_valid
    act = W.res_active & W.res_exist & W.frame_valid[None, :] & pt_mask[:, None]
    ngood = torch.sum(act, dim=1)
    has = (ngood > 0) & pt_mask
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    Hd = torch.clamp(Hdd_tot + W.pt_prior, min=1e-10)
    HdiF = torch.where(has, 1.0 / Hd, zero)
    bdSum = bd_tot + (W.pt_prior * (W.idepth - W.idepth_zero)
                      if shift_prior else 0.0)
    bdSum = torch.where(has, bdSum, zero)
    Hcd = torch.where(has[:, None], Hcd_tot, zero)

    JIdx2 = torch.einsum("pfik,pfjk->pfij", W.JIdx, W.JIdx)
    JI_JI_Jd = torch.einsum("pfij,pfj->pfi", JIdx2, W.Jpdd)
    JabJIdx = torch.einsum("pfik,pfjk->pfij", W.JabF, W.JIdx)
    JpJd6 = (W.Jpdxi[:, :, 0, :] * JI_JI_Jd[..., 0:1]
             + W.Jpdxi[:, :, 1, :] * JI_JI_Jd[..., 1:2])
    JpJd2 = torch.einsum("pfij,pfj->pfi", JabJIdx, W.Jpdd)
    JpJdF = torch.cat([JpJd6, JpJd2], dim=-1) * act[..., None]      # (P,F,8)

    hostoh = _host_onehot(W) * has[:, None]
    Hcc_sc = torch.einsum("p,pi,pj->ij", HdiF, Hcd, Hcd)
    bc_sc = torch.einsum("p,pi,p->i", HdiF, Hcd, bdSum)
    accE = torch.einsum("ph,p,pti,pc->htic", hostoh, HdiF, JpJdF, Hcd)
    accEB = torch.einsum("ph,p,pti->hti", hostoh, HdiF * bdSum, JpJdF)
    # accD[h, t1, i, t2, j] = sum_p oh[p,h] HdiF[p] JpJdF[p,t1,i] JpJdF[p,t2,j],
    # as one (F*F*8, P) x (P, F*8) product
    left = (hostoh * HdiF[:, None])[:, :, None, None] * JpJdF[:, None]
    accD = (left.reshape(P, -1).T @ JpJdF.reshape(P, -1)).reshape(F, F, 8, F, 8)
    accD = accD.permute(0, 1, 3, 2, 4)                              # (h,t1,t2,8,8)

    AH, AT = pc.adHost, pc.adTarget
    colH = torch.einsum("htij,htjc->htic", AH, accE)
    colT = torch.einsum("htij,htjc->htic", AT, accE)
    colC = torch.sum(colH, dim=1) + torch.sum(colT, dim=0)
    bH = torch.einsum("htij,htj->hti", AH, accEB)
    bT = torch.einsum("htij,htj->hti", AT, accEB)
    bF = torch.sum(bH, dim=1) + torch.sum(bT, dim=0)

    # frame-frame blocks (AccumulatedSCHessian.cc:91-108)
    D_AHAH = torch.einsum("hjab,hjkbc,hkdc->hjkad", AH, accD, AH)
    D_ATAT = torch.einsum("hjab,hjkbc,hkdc->hjkad", AT, accD, AT)
    D_ATAH = torch.einsum("hjab,hjkbc,hkdc->hjkad", AT, accD, AH)
    D_AHAT = torch.einsum("hjab,hjkbc,hkdc->hjkad", AH, accD, AT)

    hs = torch.arange(F, device=dev)
    grid = (torch.sum(D_ATAT, dim=0) + torch.sum(D_ATAH, dim=2).permute(1, 0, 2, 3)
            + torch.sum(D_AHAT, dim=1))
    grid[hs, hs] = grid[hs, hs] + torch.sum(D_AHAH, dim=(1, 2))

    H, b = _assemble(Hcc_sc, colC.reshape(8 * F, CPARS),
                     grid.permute(0, 2, 1, 3).reshape(8 * F, 8 * F),
                     bc_sc, bF, F, dev)
    aux = dict(HdiF=HdiF, bdSum=bdSum, Hcd=Hcd, JpJdF=JpJdF, ngood=ngood)
    return H, b, aux


def resubstitute(W: Window, x, aux_HdiF, aux_bdSum, aux_Hcd,
                 aux_JpJdF) -> Window:
    """Per-point idepth steps (EnergyFunctional::resubstituteF, :491-547)
    plus the frame/calib steps."""
    pc = make_precalc(W)
    F = W.F
    xc = x[:CPARS]
    xf = x[CPARS:].reshape(F, 8)
    xAd = (torch.einsum("hj,htjk->htk", xf, pc.adHost)
           + torch.einsum("tj,htjk->htk", xf, pc.adTarget))
    act = W.res_active & W.res_exist & W.frame_valid[None, :] & W.pt_valid[:, None]
    b = aux_bdSum - aux_Hcd @ xc
    b = b - torch.sum(torch.einsum("pfk,pfk->pf", xAd[W.pt_host], aux_JpJdF)
                      * act, dim=1)
    step = -b * aux_HdiF
    ngood = torch.sum(act, dim=1)
    step = torch.where((ngood > 0) & torch.isfinite(step), step,
                       torch.zeros_like(step))
    f_step = torch.zeros_like(W.frame_step)
    f_step[:, :8] = -xf
    return W._replace(pt_step=step, c_step=(-xc).to(torch.float32),
                      frame_step=f_step)


def do_step(W: Window, stepfac_c, stepfac_t, stepfac_r, stepfac_a, stepfac_d):
    """Returns (new W, canbreak) with canbreak a 0-d bool tensor."""
    dev = W.state.device
    pstep = torch.tensor([stepfac_t] * 3 + [stepfac_r] * 3 + [stepfac_a] * 4,
                         dtype=torch.float32, device=dev)
    new_state = W.state_backup + pstep * W.frame_step
    new_c = W.c_backup + stepfac_c * W.c_step
    act = W.pt_valid
    new_id = torch.where(act, W.idepth_backup + stepfac_d * W.pt_step, W.idepth)

    fvb = W.frame_valid
    fv = fvb[:, None].to(torch.float32)
    nf = torch.clamp(torch.sum(fvb), min=1)
    sumA = torch.sum(fv[:, 0] * W.frame_step[:, 6] ** 2) / nf
    sumB = torch.sum(fv[:, 0] * W.frame_step[:, 7] ** 2) / nf
    sumT = torch.sum(fv * W.frame_step[:, 0:3] ** 2) / nf
    sumR = torch.sum(fv * W.frame_step[:, 3:6] ** 2) / nf
    nid = torch.clamp(torch.sum(act), min=1)
    sumNID = torch.sum(act * torch.abs(W.idepth_backup)) / nid

    W = W._replace(state=torch.where(fvb[:, None], new_state, W.state),
                   c_value=new_c, idepth=new_id,
                   idepth_zero=torch.where(act, new_id, W.idepth_zero))
    th = 0.00005 * 1.2  # setting_thOptIterations = 1.2
    canbreak = ((torch.sqrt(sumA) < 0.0005 * 1.2) & (torch.sqrt(sumB) < th)
                & (torch.sqrt(sumR) < th) & (torch.sqrt(sumT) * sumNID < th))
    return W, canbreak


# ---------------------------------------------------------------------------
# backend/ba_device.py
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------

# the functions the old loop's unchanged callers reach through their modules
_OLD = ((lie, ("se3_adj",)), (window, ("scaled_state", "c_scaled")),
        (ba, ("make_precalc", "linearize_target",
              "set_new_frame_energy_th", "_stitch_top", "_accumulate_sc",
              "resubstitute", "do_step")))


@contextlib.contextmanager
def old_code(trips):
    """The old functions in place of the current ones (and ba.do_step
    counting the trips into trips[0]) while inside."""
    saved = [(mod, name, getattr(mod, name)) for mod, names in _OLD
             for name in names]
    here = globals()

    def counted(*a):
        trips[0] += 1
        return here["do_step"](*a)
    try:
        for mod, name, _ in saved:
            setattr(mod, name, here[name])
        ba.do_step = counted
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def early_exit_optimize(W, dIs, HM, bM, newest: int, cfg, img_w: int,
                        img_h: int, max_iterations: int):
    """The old device LM on (W, dIs, HM, bM) with the newest frame a Python
    int. Returns (W, stats, LM trips run)."""
    trips = [0]
    with old_code(trips):
        W, stats = optimize_device(W, dIs, HM, bM, newest, cfg, img_w, img_h,
                                   max_iterations)
    return W, stats, trips[0]
