"""Window bookkeeping, the BA driver and the float64 marginalization prior.

Counterpart of ldso_tpu/backend/energy_functional.py (reference
EnergyFunctional.cc plus the optimization driver of FullSystem.cc:725-864):
  * the marginalization prior HM/bM stays numpy float64 on the host (the
    reference keeps its stitched algebra in double);
  * frame slots: active frames always occupy slots [0, nf);
  * the default BA (`ba_device_lm=True`, force-accept, no momentum) runs
    through backend/ba_device.optimize_device; every other configuration
    runs the host-orchestrated LM `_optimize_host`: the accept/reject
    loop, each solve assembled on the device and solved in float64 numpy
    (`solve_system`, with every SOLVER_* branch), the momentum modes and
    the nullspace orthogonalizations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ldso_tpu_torch.config import (
    CPARS, Config, SCALE_A, SCALE_B, SCALE_XI_ROT, SCALE_XI_TRANS,
    SOLVER_FIX_LAMBDA, SOLVER_MOMENTUM, SOLVER_ORTHOGONALIZE_FULL,
    SOLVER_ORTHOGONALIZE_POINTMARG, SOLVER_ORTHOGONALIZE_SYSTEM,
    SOLVER_ORTHOGONALIZE_X, SOLVER_ORTHOGONALIZE_X_LATER,
    SOLVER_REMOVE_POSEPRIOR, SOLVER_STEPMOMENTUM, SOLVER_SVD, SOLVER_SVD_CUT7,
    SOLVER_USE_GN)
from ldso_tpu_torch.backend import ba, ba_device
from ldso_tpu_torch.backend.ba_device import (_finalize_linearization,
                                              _reset_oob_dev as _reset_oob,
                                              refix_newest)
from ldso_tpu_torch.backend.window import (RES_IN, RES_OUTLIER, Window,
                                           aff_g2l_zero, empty_window)
from ldso_tpu_torch.math import lie


def _set_at(t, i, v):
    t = t.clone()
    t[i] = v
    return t


def _insert_frame_dev(W: Window, i: int, T_cw, st, prior, exposure: float,
                      inherit_th: bool) -> Window:
    """All frame-insertion mutations."""
    dev = W.state.device
    f32 = dict(dtype=torch.float32, device=dev)
    th = (W.frame_energy_th[max(i - 1, 0)] if inherit_th and i > 0
          else torch.tensor(12.0 * 12.0 * 8.0, **f32))
    st = torch.as_tensor(st, **f32)
    return W._replace(
        frame_valid=_set_at(W.frame_valid, i, True),
        T_eval=_set_at(W.T_eval, i, torch.as_tensor(T_cw, **f32)),
        state=_set_at(W.state, i, st),
        state_zero=_set_at(W.state_zero, i, st),
        exposure=_set_at(W.exposure, i, float(exposure)),
        prior=_set_at(W.prior, i, torch.as_tensor(prior, **f32)),
        frame_energy_th=_set_at(W.frame_energy_th, i, th),
    )


def _add_residuals_dev(W: Window, i: int) -> Window:
    mask = W.pt_valid & (W.pt_host != i)

    def col(t, v):
        t = t.clone()
        t[:, i] = v
        return t

    return W._replace(
        res_exist=col(W.res_exist, mask),
        res_active=col(W.res_active, False),
        res_linearized=col(W.res_linearized, False),
        res_state=col(W.res_state, torch.where(
            mask, torch.full_like(W.res_state[:, i], RES_IN), W.res_state[:, i])),
        res_energy=col(W.res_energy, 0.0),
    )


def insert_points_dev(W: Window, slot, valid, host, u, v, idepth, prior,
                      energy_th, color, weights) -> Window:
    """Point insertion into `slot` where `valid` (every argument a tensor on
    the window's device; invalid or out-of-range slots are dropped before
    the scatter)."""
    P, F = W.P, W.F
    keep = valid & (slot >= 0) & (slot < P)
    sl = slot[keep]
    hk = host[keep].to(torch.int64)
    rows = W.frame_valid[None, :] & (
        hk[:, None] != torch.arange(F, device=hk.device)[None, :])

    def put(t, val):
        t = t.clone()
        t[sl] = val if not torch.is_tensor(val) else val.to(t.dtype)
        return t

    return W._replace(
        pt_valid=put(W.pt_valid, True),
        pt_host=put(W.pt_host, hk),
        pt_u=put(W.pt_u, u[keep]), pt_v=put(W.pt_v, v[keep]),
        pt_color=put(W.pt_color, color[keep]),
        pt_weights=put(W.pt_weights, weights[keep]),
        idepth=put(W.idepth, idepth[keep]),
        idepth_zero=put(W.idepth_zero, idepth[keep]),
        pt_prior=put(W.pt_prior, prior[keep]),
        pt_energy_th=put(W.pt_energy_th, energy_th[keep]),
        pt_num_good_res=put(W.pt_num_good_res, 0),
        pt_max_rel_baseline=put(W.pt_max_rel_baseline, 0.0),
        pt_idepth_hessian=put(W.pt_idepth_hessian, 0.0),
        res_exist=put(W.res_exist, rows),
        res_active=put(W.res_active, False),
        res_linearized=put(W.res_linearized, False),
        res_state=put(W.res_state, RES_IN),
        res_energy=put(W.res_energy, 0.0),
    )


def _drop_points_dev(W: Window, pt_mask) -> Window:
    return W._replace(
        pt_valid=W.pt_valid & ~pt_mask,
        res_exist=W.res_exist & ~pt_mask[:, None],
        res_active=W.res_active & ~pt_mask[:, None],
    )


def _boost_prior_dev(W: Window, pt_mask, fac: float) -> Window:
    return W._replace(pt_prior=torch.where(pt_mask, W.pt_prior * fac, W.pt_prior))


def _shift_frame_out(W: Window, idx: int) -> Window:
    """Remove frame slot idx; shift higher slots down by one."""
    F = W.F
    dev = W.state.device
    perm = torch.tensor(list(range(idx)) + list(range(idx + 1, F)) + [idx],
                        device=dev)
    last = F - 1
    f0 = lambda a: a[perm]          # noqa: E731
    f1 = lambda a: a[:, perm]       # noqa: E731

    def f1_clear(a):
        a = a[:, perm].clone()
        a[:, last] = False
        return a

    fv = W.frame_valid[perm].clone()
    fv[last] = False
    return W._replace(
        frame_valid=fv, T_eval=f0(W.T_eval),
        state=f0(W.state), state_zero=f0(W.state_zero),
        state_backup=f0(W.state_backup), frame_step=f0(W.frame_step),
        exposure=f0(W.exposure), prior=f0(W.prior),
        frame_energy_th=f0(W.frame_energy_th),
        pt_host=torch.where(W.pt_host > idx, W.pt_host - 1, W.pt_host),
        res_exist=f1_clear(W.res_exist),
        res_active=f1_clear(W.res_active),
        res_linearized=f1_clear(W.res_linearized),
        res_state=f1(W.res_state), res_energy=f1(W.res_energy),
        res_new_state=f1(W.res_new_state),
        res_new_energy=f1(W.res_new_energy),
        res_new_energy_wo=f1(W.res_new_energy_wo),
        res_toZero=f1(W.res_toZero),
        Jpdxi=f1(W.Jpdxi), Jpdc=f1(W.Jpdc), Jpdd=f1(W.Jpdd),
        JIdx=f1(W.JIdx), JabF=f1(W.JabF), resF=f1(W.resF),
        center_proj=f1(W.center_proj),
    )


def _marg_frame_mutations(W: Window, pre_drop, idx: int) -> Window:
    """Drop pre_drop points, drop the residual column, compact slots."""
    W = _drop_points_dev(W, pre_drop)
    col = torch.zeros(W.F, dtype=torch.bool, device=pre_drop.device)
    col[idx] = True
    W = W._replace(res_exist=W.res_exist & ~col[None, :],
                   res_active=W.res_active & ~col[None, :])
    return _shift_frame_out(W, idx)


def _marg_points_fused(W: Window, marg_cand, drop_in, dIs, min_idepth_h: float,
                       fac: float, cfg: Config, img_w: int, img_h: int):
    """End-of-keyframe point retirement: relinearize + FEJ-fix the
    marginalization candidates (FullSystem.cc:497-529), gate them on the
    idepth Hessian (flagPointsForRemoval, :1228-1263), accumulate + Schur
    the survivors onto the marginalization system (marginalizePointsF,
    EnergyFunctional.cc:165-222) and drop survivors and rejects.
    Returns (W', H, b, nres, rec (P,4), really, drop)."""
    relmask = W.res_exist & marg_cand[:, None]
    W = W._replace(
        res_linearized=W.res_linearized & ~relmask,
        res_state=torch.where(relmask, torch.full_like(W.res_state, RES_IN),
                              W.res_state),
        res_new_state=torch.where(relmask, torch.full_like(W.res_state, RES_OUTLIER),
                                  W.res_new_state),
    )
    W, _ = ba.linearize_all(W, dIs, cfg, img_w, img_h)
    W = ba.apply_res(W)
    W = ba.fix_linearization(W, marg_cand)
    rec = torch.stack([W.pt_u, W.pt_v, W.idepth, W.pt_idepth_hessian], dim=1)
    good_h = W.pt_idepth_hessian > min_idepth_h
    really = marg_cand & good_h
    drop = drop_in | (marg_cand & ~good_h)
    Wb = _boost_prior_dev(W, really, fac)
    H, b, nres = ba.accumulate_marg(Wb, really)
    return _drop_points_dev(Wb, really | drop), H, b, nres, rec, really, drop


class EnergyFunctional:
    """Owns the Window plus the host-side float64 marginalization prior.
    Host mirrors of pt_valid / pt_host keep device reads off the control
    path."""

    def __init__(self, cfg: Config, calib, F: Optional[int] = None,
                 P: Optional[int] = None, *, device):
        self.cfg = cfg
        self.calib = calib
        self.device = torch.device(device)
        self.F = F if F is not None else cfg.max_frames + 1
        self.P = P if P is not None else cfg.max_points
        self.W = empty_window(self.F, self.P, calib.intrinsics_vec(), cfg,
                              self.device)
        self.n_frames = 0
        self.HM = np.zeros((CPARS, CPARS), np.float64)
        self.bM = np.zeros(CPARS, np.float64)
        self.res_in_a = 0
        self.res_in_m = 0
        self.window_shells = []        # set by FullSystem (same list object)
        self.is_lost = False
        self.pt_valid_np = np.zeros(self.P, bool)
        self.pt_host_np = np.zeros(self.P, np.int64)

    def _grow_prior(self):
        n_old = self.HM.shape[0]
        HM = np.zeros((n_old + 8, n_old + 8), np.float64)
        HM[:n_old, :n_old] = self.HM
        bM = np.zeros(n_old + 8, np.float64)
        bM[:n_old] = self.bM
        self.HM, self.bM = HM, bM

    def _frame_prior(self, is_first: bool):
        cfg = self.cfg
        prior = np.zeros(8, np.float32)
        if is_first:
            prior[0:3] = cfg.initial_trans_prior
            prior[3:6] = cfg.initial_rot_prior
            if cfg.solver_mode & SOLVER_REMOVE_POSEPRIOR:
                prior[0:6] = 0.0
            prior[6] = cfg.initial_aff_a_prior
            prior[7] = cfg.initial_aff_b_prior
        else:
            prior[6] = (cfg.initial_aff_a_prior if cfg.affine_opt_mode_a < 0
                        else cfg.affine_opt_mode_a)
            prior[7] = (cfg.initial_aff_b_prior if cfg.affine_opt_mode_b < 0
                        else cfg.affine_opt_mode_b)
        return prior

    @staticmethod
    def _aff_state(aff):
        st = np.zeros(10, np.float32)
        st[6] = aff[0] / SCALE_A
        st[7] = aff[1] / SCALE_B
        return st

    # ------------------------------------------------------------------ frames
    def insert_frame(self, T_cw, exposure: float, aff, is_first: bool) -> int:
        """Append a frame at slot nf (insertFrame, EnergyFunctional.cc:32-62)."""
        i = self.n_frames
        assert i < self.F, "window capacity exceeded"
        self.W = _insert_frame_dev(self.W, i, T_cw, self._aff_state(aff),
                                   self._frame_prior(is_first), exposure,
                                   not is_first)
        self.n_frames += 1
        self._grow_prior()
        return i

    def insert_keyframe(self, T_cw, exposure, aff, dIs, dI0):
        """insert_frame + residual slots to the new frame + window image
        update. Returns (idx, new dIs)."""
        i = self.n_frames
        assert i < self.F, "window capacity exceeded"
        self.W = _insert_frame_dev(self.W, i, T_cw, self._aff_state(aff),
                                   self._frame_prior(False), exposure, True)
        self.W = _add_residuals_dev(self.W, i)
        self.n_frames += 1
        self._grow_prior()
        return i, _set_at(dIs, i, dI0)

    def marginalize_frame(self, idx: int, pre_drop=None, prior_delta=None):
        """Schur-marginalize frame slot idx onto HM/bM in float64 and compact
        the slots (EnergyFunctional::marginalizeFrame, :72-151).
        prior_delta: host (prior(8), state_delta(8)) of the frame."""
        nf = self.n_frames
        odim = nf * 8 + CPARS
        ndim = odim - 8
        HM, bM = self.HM.copy(), self.bM.copy()
        if idx != nf - 1:
            io = idx * 8 + CPARS
            order = (list(range(0, io)) + list(range(io + 8, odim))
                     + list(range(io, io + 8)))
            HM = HM[np.ix_(order, order)]
            bM = bM[order]
        if prior_delta is None:
            prior_delta = (self.W.prior[idx].cpu().numpy(),
                           self.W.state[idx, :8].cpu().numpy())
        prior = np.asarray(prior_delta[0], np.float64)
        delta_prior = np.asarray(prior_delta[1], np.float64)
        HM[ndim:, ndim:][np.diag_indices(8)] += prior
        bM[ndim:] += prior * delta_prior

        SVec = np.sqrt(np.abs(np.diag(HM)) + 10.0)
        SVecI = 1.0 / SVec
        HMs = SVecI[:, None] * HM * SVecI[None, :]
        bMs = SVecI * bM
        hpi = np.linalg.pinv(HMs[ndim:, ndim:])
        bli = HMs[ndim:, :ndim].T @ hpi
        HMs_new = HMs[:ndim, :ndim] - bli @ HMs[ndim:, :ndim]
        bMs_new = bMs[:ndim] - bli @ bMs[ndim:]
        HM_new = SVec[:ndim, None] * HMs_new * SVec[None, :ndim]
        self.HM = 0.5 * (HM_new + HM_new.T)
        self.bM = SVec[:ndim] * bMs_new

        if pre_drop is None:
            pre_drop = torch.zeros(self.P, dtype=torch.bool, device=self.device)
        self.W = _marg_frame_mutations(self.W, pre_drop, idx)
        self.n_frames -= 1
        self.pt_host_np = np.where(self.pt_host_np > idx,
                                   self.pt_host_np - 1, self.pt_host_np)

    # ------------------------------------------------------------------ points
    def insert_points(self, host_idx, u, v, color, weights, idepth,
                      energy_th, has_depth_prior=False) -> np.ndarray:
        """Place new active points into free slots (host arrays). Returns
        the slot indices used."""
        free = np.nonzero(~self.pt_valid_np)[0]
        k = min(len(free), len(u))
        host = np.array(np.broadcast_to(np.asarray(host_idx, np.int64), (len(u),))[:k])
        prior = self.cfg.idepth_fix_prior if has_depth_prior else 0.0
        if self.cfg.solver_mode & SOLVER_REMOVE_POSEPRIOR:
            prior = 0.0
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)[:k],  # noqa: E731
                                        device=dev)
        self.W = insert_points_dev(
            self.W, torch.as_tensor(free[:k], device=dev),
            torch.ones(k, dtype=torch.bool, device=dev),
            torch.as_tensor(host, device=dev), f32(u), f32(v), f32(idepth),
            torch.full((k,), prior, dtype=torch.float32, device=dev),
            f32(energy_th), f32(color), f32(weights))
        self.pt_valid_np[free[:k]] = True
        self.pt_host_np[free[:k]] = host
        return free[:k]

    def marginalize_points(self, pt_mask):
        """Flagged points: boost their prior, accumulate and Schur them onto
        HM/bM, then remove them (marginalizePointsF, :165-222). pt_mask:
        (P,) bool tensor on the window's device."""
        mask_np = pt_mask.cpu().numpy()
        if not mask_np.any():
            return
        Wb = _boost_prior_dev(self.W, pt_mask,
                              float(np.float32(self.cfg.idepth_fix_prior_marg_fac)))
        H, b, nres = ba.accumulate_marg(Wb, pt_mask)
        self.W = _drop_points_dev(Wb, pt_mask)
        self._absorb_points(H, b, nres)
        self.pt_valid_np &= ~mask_np

    def _has_first_frame(self) -> bool:
        """The pose-prior-carrying first keyframe is still in the window."""
        return any(getattr(f, "kf_id", -1) == 0 for f in self.window_shells)

    def _absorb_points(self, H, b, nres):
        """Add a marginalized point system (device H, b) to HM/bM with the
        orthogonalizations of EnergyFunctional.cc:205-212."""
        cfg = self.cfg
        n = CPARS + 8 * self.n_frames
        H = H.cpu().numpy().astype(np.float64)
        b = b.cpu().numpy().astype(np.float64)
        if (cfg.solver_mode & SOLVER_ORTHOGONALIZE_POINTMARG
                and not self._has_first_frame()):
            self.HM, self.bM = self._orthogonalize_system(self.HM, self.bM)
        self.HM += cfg.marg_weight_fac * H[:n, :n]
        self.bM += cfg.marg_weight_fac * b[:n]
        if cfg.solver_mode & SOLVER_ORTHOGONALIZE_FULL:
            self.HM, self.bM = self._orthogonalize_system(self.HM, self.bM)
        self.res_in_m += int(nres)

    def marginalize_and_drop(self, marg_cand, drop, dIs, img_w: int,
                             img_h: int):
        """Point retirement (see _marg_points_fused): absorbs the survivors'
        Schur system into HM/bM and updates the host mirrors. Returns (rec
        (P,4) [u,v,idepth,idepth_H], really_marg, dropped) as host arrays."""
        return self.marginalize_and_drop_consume(
            self.marginalize_and_drop_dispatch(marg_cand, drop, dIs, img_w,
                                               img_h))

    def marginalize_and_drop_dispatch(self, marg_cand, drop, dIs, img_w: int,
                                      img_h: int):
        """The device half: updates the window and returns the device
        results that marginalize_and_drop_consume reads."""
        cfg = self.cfg
        self.W, *out = _marg_points_fused(
            self.W, marg_cand, drop, dIs, float(np.float32(cfg.min_idepth_h_marg)),
            float(np.float32(cfg.idepth_fix_prior_marg_fac)), cfg, img_w, img_h)
        return out

    def marginalize_and_drop_consume(self, out):
        """The host half: the float64 prior update and the host mirrors."""
        H, b, nres, rec, really, dropped = out
        really = really.cpu().numpy()
        dropped = dropped.cpu().numpy()
        rec = rec.cpu().numpy().astype(np.float64)
        if really.any():
            self._absorb_points(H, b, nres)
        self.pt_valid_np &= ~(really | dropped)
        return rec, really, dropped

    # ------------------------------------------------------------------ solving
    def _nullspaces(self) -> np.ndarray:
        """Columns: 6 pose + 2 affine + 1 scale global null directions
        (getNullspaces, FullSystem.cc:1711-1760)."""
        nf = self.n_frames
        n = CPARS + 8 * nf
        W = self.W
        adj = lie.se3_adj(W.T_eval[:nf]).cpu().numpy().astype(np.float64)
        T_eval = W.T_eval[:nf].cpu().numpy().astype(np.float64)
        aff0 = aff_g2l_zero(W)[:nf].cpu().numpy()
        expo = W.exposure[:nf].cpu().numpy()
        N = np.zeros((n, 9))
        for f in range(nf):
            o = CPARS + 8 * f
            N[o:o + 3, :6] = adj[f][0:3] / SCALE_XI_TRANS
            N[o + 3:o + 6, :6] = adj[f][3:6] / SCALE_XI_ROT
            N[o + 6, 6] = 1.0 / SCALE_A
            N[o + 7, 7] = np.exp(aff0[f, 0]) * expo[f] / SCALE_B
            N[o:o + 3, 8] = T_eval[f][:3, 3] / SCALE_XI_TRANS
        return N

    @staticmethod
    def _orthogonalize(vec: np.ndarray, N: np.ndarray,
                       delta: float = 1e-5) -> np.ndarray:
        """x -= N (N^T N)^+ N^T x via SVD (EnergyFunctional.cc:685-717)."""
        Nn = N / np.maximum(np.linalg.norm(N, axis=0, keepdims=True), 1e-12)
        U, S, Vt = np.linalg.svd(Nn, full_matrices=False)
        Sinv = np.where(S > delta * S.max(), 1.0 / S, 0.0)
        Npi = U * Sinv[None, :] @ Vt
        NNpiT = Nn @ Npi.T
        return vec - 0.5 * (NNpiT + NNpiT.T) @ vec

    def _orth_nullspaces(self) -> np.ndarray:
        """The pose (6) and scale (1) columns, the set the reference's
        orthogonalize() uses (EnergyFunctional.cc:687-689)."""
        return self._nullspaces()[:, [0, 1, 2, 3, 4, 5, 8]]

    def _orthogonalize_system(self, H: np.ndarray, b: np.ndarray):
        """b -= Q b; H -= Q H Q with Q = N (N^T N)^+ N^T
        (EnergyFunctional::orthogonalize with a system argument)."""
        N = self._orth_nullspaces()
        Nn = N / np.maximum(np.linalg.norm(N, axis=0, keepdims=True), 1e-12)
        U, S, Vt = np.linalg.svd(Nn, full_matrices=False)
        Sinv = np.where(S > self.cfg.solver_mode_delta * S.max(),
                        1.0 / np.maximum(S, 1e-20), 0.0)
        Q = Nn @ (U * Sinv[None, :] @ Vt).T
        Q = 0.5 * (Q + Q.T)
        return H - Q @ H @ Q, b - Q @ b

    def solve_system(self, iteration: int, lam: float):
        """solveSystemF (EnergyFunctional.cc:240-351): the system assembled
        on the device, solved in float64 on the host, the step
        resubstituted on the device."""
        cfg = self.cfg
        if cfg.solver_mode & SOLVER_USE_GN:
            lam = 0.0
        if cfg.solver_mode & SOLVER_FIX_LAMBDA:
            lam = 1e-5
        HA, bA, HL, bL, Hsc, bsc, aux, delta, nresA = ba.build_system(self.W)
        n = CPARS + 8 * self.n_frames
        f64 = lambda t: t.cpu().numpy().astype(np.float64)  # noqa: E731
        HA, HL, Hsc = (f64(t)[:n, :n] for t in (HA, HL, Hsc))
        bA, bL, bsc, delta = (f64(t)[:n] for t in (bA, bL, bsc, delta))
        self.res_in_a = int(nresA)

        bM_top = self.bM + self.HM @ delta
        didx = np.diag_indices(n)
        if cfg.solver_mode & SOLVER_ORTHOGONALIZE_SYSTEM:
            # orthogonalize the active system before adding the prior
            # (EnergyFunctional.cc:262-281), unless frame 0 is in the window
            HT = HL + HA - Hsc
            bT = bL + bA - bsc
            if not self._has_first_frame():
                HT, bT = self._orthogonalize_system(HT, bT)
            HFinal = HT + self.HM
            bFinal = bT + bM_top
            HFinal[didx] *= (1.0 + lam)
        else:
            HFinal = HL + self.HM + HA
            bFinal = bL + bM_top + bA - bsc
            HFinal[didx] *= (1.0 + lam)
            HFinal = HFinal - Hsc * (1.0 / (1.0 + lam))

        if cfg.solver_mode & SOLVER_SVD:
            # scaled SVD solve with singular-value gating (:296-324)
            SVecI = 1.0 / np.sqrt(np.abs(np.diag(HFinal)) + 1e-12)
            Hs = SVecI[:, None] * HFinal * SVecI[None, :]
            U, S, Vt = np.linalg.svd(Hs)
            Ub = U.T @ (SVecI * bFinal)
            max_sv = S.max() if len(S) else 1.0
            for i in range(len(Ub)):
                if S[i] < cfg.solver_mode_delta * max_sv:
                    Ub[i] = 0.0
                if (cfg.solver_mode & SOLVER_SVD_CUT7) and i >= len(Ub) - 7:
                    Ub[i] = 0.0
                else:
                    Ub[i] /= max(S[i], 1e-20)
            x = SVecI * (Vt.T @ Ub)
        else:
            SVecI = 1.0 / np.sqrt(np.abs(np.diag(HFinal)) + 10.0)
            Hs = SVecI[:, None] * HFinal * SVecI[None, :]
            x = SVecI * np.linalg.solve(Hs, SVecI * bFinal)

        if (cfg.solver_mode & SOLVER_ORTHOGONALIZE_X) or (
                iteration >= 2 and cfg.solver_mode & SOLVER_ORTHOGONALIZE_X_LATER):
            x = self._orthogonalize(x, self._orth_nullspaces(),
                                    cfg.solver_mode_delta)

        xf = np.zeros(CPARS + 8 * self.F, np.float32)
        xf[:n] = x
        self.W = ba.resubstitute(self.W, torch.from_numpy(xf).to(self.device),
                                 aux["HdiF"], aux["bdSum"], aux["Hcd"],
                                 aux["JpJdF"])
        self.W = self.W._replace(
            pt_idepth_hessian=1.0 / torch.clamp(aux["HdiF"], min=1e-12))
        self.last_x = x
        return x

    def calc_M_energy(self) -> float:
        if self.cfg.force_accept_step:
            return 0.0
        n = CPARS + 8 * self.n_frames
        d = ba.stitched_delta(self.W).cpu().numpy().astype(np.float64)[:n]
        return float(d @ (2.0 * self.bM + self.HM @ d))

    def calc_L_energy(self) -> float:
        if self.cfg.force_accept_step:
            return 0.0
        return float(ba.calc_L_energy(self.W))

    # ------------------------------------------------------------------ optimize
    def optimize(self, dIs, max_iterations: int, img_w: int, img_h: int) -> float:
        """The windowed BA (FullSystem::optimize, :725-864). Returns the final
        RMSE; sets self.is_lost on divergence. The default mode
        (ba_device_lm, force-accept, no momentum) runs on the device
        (backend/ba_device.py); every other mode runs `_optimize_host`."""
        cfg = self.cfg
        nf = self.n_frames
        if nf < 2:
            return 0.0
        if nf < 3:
            max_iterations = 20
        elif nf < 4:
            max_iterations = 15
        momentum = bool(cfg.solver_mode & SOLVER_MOMENTUM)
        if not (cfg.ba_device_lm and cfg.force_accept_step and not momentum):
            return self._optimize_host(dIs, max_iterations, img_w, img_h,
                                       nf - 1, momentum)
        n_full = CPARS + 8 * self.F
        n = CPARS + 8 * nf
        HMp = np.zeros((n_full, n_full), np.float32)
        bMp = np.zeros(n_full, np.float32)
        HMp[:n, :n] = self.HM
        bMp[:n] = self.bM
        self.W, stats = ba_device.optimize_device(
            self.W, dIs, torch.from_numpy(HMp).to(self.device),
            torch.from_numpy(bMp).to(self.device), nf - 1, cfg, img_w, img_h,
            max_iterations)
        stats = stats.cpu().numpy()
        self.res_in_a = int(stats[1])
        if not np.isfinite(stats[0]):
            self.is_lost = True
        return float(stats[2])

    def _linearize(self, dIs, img_w, img_h, newest) -> float:
        """linearizeAll without fixing (FullSystem.cc:1442-1543): returns
        the energy, read on the host."""
        self.W, eP = ba.linearize_all(self.W, dIs, self.cfg, img_w, img_h)
        self.W = ba.set_new_frame_energy_th(self.W, newest, self.cfg)
        return float(eP)

    def _optimize_host(self, dIs, max_iterations, img_w, img_h, newest,
                       momentum):
        """The reference's LM (FullSystem::optimize): accept a step when
        energy + L + M drops (always under force_accept_step), damping x0.25
        after an accepted step and x1e2 after a rejected one. The host
        reads three scalars per iteration."""
        cfg = self.cfg
        self.W = _reset_oob(self.W)
        last_energy = self._linearize(dIs, img_w, img_h, newest)
        lastL = self.calc_L_energy()
        lastM = self.calc_M_energy()
        self.W = ba.apply_res(self.W)

        lam = 1e-1
        stepsize = 1.0
        prev_x = None
        for iteration in range(max_iterations):
            self.W = ba.backup_state(self.W)
            if momentum:
                # backupState(iteration != 0) (FullSystem.cc:1627-1650): the
                # previous raw step is what the blended update mixes in
                if iteration != 0:
                    prev_fstep, prev_pstep = self.W.frame_step, self.W.pt_step
                else:
                    prev_fstep = torch.zeros_like(self.W.frame_step)
                    prev_pstep = torch.zeros_like(self.W.pt_step)
            self.solve_system(iteration, lam)
            # step-direction momentum (FullSystem.cc:781-793): grow the
            # step when successive increments align, shrink when they oppose
            if (cfg.solver_mode & SOLVER_STEPMOMENTUM) and prev_x is not None:
                inc = ((1e-20 + prev_x @ self.last_x)
                       / (1e-20 + np.linalg.norm(prev_x)
                          * np.linalg.norm(self.last_x)))
                if np.isfinite(inc):
                    if inc < 0 and stepsize > 1:
                        stepsize = 1.0
                    new_ss = np.exp(inc * 1.4)
                    stepsize = float(np.clip(
                        np.sqrt(np.sqrt(new_ss * stepsize ** 3)), 0.25, 2.0))
            prev_x = self.last_x
            if momentum:
                self.W, canbreak = ba.do_step_momentum(self.W, prev_fstep,
                                                       prev_pstep)
            else:
                self.W, canbreak = ba.do_step(self.W, stepsize, stepsize,
                                              stepsize, stepsize, stepsize)
            canbreak = bool(canbreak)

            new_energy = self._linearize(dIs, img_w, img_h, newest)
            newL = self.calc_L_energy()
            newM = self.calc_M_energy()
            if cfg.force_accept_step or (new_energy + newL + newM
                                         < last_energy + lastL + lastM):
                self.W = ba.apply_res(self.W)
                last_energy, lastL, lastM = new_energy, newL, newM
                lam *= 0.25
            else:
                self.W = ba.load_backup(self.W)
                last_energy = self._linearize(dIs, img_w, img_h, newest)
                lastL = self.calc_L_energy()
                lastM = self.calc_M_energy()
                lam *= 1e2

            if canbreak and iteration >= cfg.min_opt_iterations:
                break

        self.W = _reset_oob(refix_newest(self.W, newest))
        last_energy = self._linearize(dIs, img_w, img_h, newest)
        self.W = _finalize_linearization(self.W)
        if not np.isfinite(last_energy):
            self.is_lost = True
        return float(np.sqrt(last_energy / max(8 * self.res_in_a, 1)))
