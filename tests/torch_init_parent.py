"""The bootstrap's LM as it ran before it became one device program: the
oracle that tests/test_torch_initializer.py holds the masked program to,
bit for bit, and that chip_smoke.py counts the live trips of.

A frozen copy of frontend/initializer's code as it was, function for
function, kept here so that the test sees any change of arithmetic in the
rewrite:
  * `_level_opt`: a Python loop that reads its accept, snap and stop tests
    on the host once per trip and stops; `lam` a numpy float32, the
    damping a Python float;
  * `_calc_ec`, `_opt_reg`, `_propagate_down`, `_propagate_up` with
    `snapped` a Python bool and its branches in Python;
  * `_do_step` dividing by a Python float;
  * `track_frame`, which resets T's translation and the levels on the
    device from the host's snap flag, and reads T and aff at the end.
The residual and Schur pieces (`_calc_res_gs`), `_apply_step`,
`_reset_points` and the neighbour gather are the current ones: the rewrite
changed only where their constants come from, not their arithmetic.
`_level_opt` and `track_frame` take a `trips` list that gets each level's
trip count (the copy's one addition). It imports torch and numpy only.
"""

from __future__ import annotations

import numpy as np
import torch

from ldso_tpu_torch.camera.calib import Calibration
from ldso_tpu_torch.config import (Config, SCALE_A, SCALE_B, SCALE_XI_ROT,
                                   SCALE_XI_TRANS)
from ldso_tpu_torch.frontend.initializer import (
    ALPHA_K, COUPLING_WEIGHT, MAX_ITERATIONS, REG_WEIGHT, InitializerState,
    InitLevel, _apply_step, _calc_res_gs, _nb_gather, _reset_points)
from ldso_tpu_torch.math import lie
from ldso_tpu_torch.ops.preprocess import FramePyramid
from ldso_tpu_torch.ops.scatter import segment_sum


def _calc_ec(L: InitLevel, snapped: bool):
    """Coupling energy (calcEC, CoarseInitializer.cc:412-428)."""
    if not snapped:
        return torch.zeros(2, dtype=torch.float32, device=L.u.device)
    g = L.is_good_new & L.valid
    zero = torch.zeros((), dtype=torch.float32, device=L.u.device)
    r_old = torch.where(g, (L.idepth - L.iR) ** 2, zero)
    r_new = torch.where(g, (L.idepth_new - L.iR) ** 2, zero)
    return torch.stack([COUPLING_WEIGHT * torch.sum(r_old),
                        COUPLING_WEIGHT * torch.sum(r_new)])


def _opt_reg(L: InitLevel, snapped: bool) -> InitLevel:
    """Pull iR toward the neighbourhood median (optReg, :430-459)."""
    if not snapped:
        return L._replace(iR=torch.ones_like(L.iR))
    nb_ok, nb_iR = _nb_gather(L)
    vals = torch.where(nb_ok, nb_iR, torch.full_like(nb_iR, float("inf")))
    vals = torch.sort(vals, dim=-1).values
    nnn = torch.sum(nb_ok, dim=-1)
    med = torch.gather(vals, 1, torch.clamp(nnn[:, None] // 2, min=0))[:, 0]
    use = (nnn > 2) & L.is_good & L.valid
    return L._replace(iR=torch.where(
        use, (1.0 - REG_WEIGHT) * L.idepth + REG_WEIGHT * med, L.iR))


def _do_step(L: InitLevel, inc, one_plus_lam: float) -> InitLevel:
    """Per-point idepth resubstitution (doStep, :645-671)."""
    b = L.jb[:, 8] + L.jb[:, :8] @ inc
    step = -b * L.jb[:, 9] / one_plus_lam
    max_step = torch.clamp(0.25 * L.max_step, max=1e10)
    step = torch.minimum(torch.maximum(step, -max_step), max_step)
    new_id = torch.clamp(L.idepth + step, 1e-3, 50.0)
    new_id = torch.where(L.is_good & L.valid, new_id, L.idepth_new)
    return L._replace(idepth_new=new_id)


def _level_opt(L: InitLevel, dI_ref, dI_new, T, aff, snapped: bool,
               lvl: int, calib: Calibration, cfg: Config,
               fix_affine: bool = True, trips=None):
    """The per-level LM loop of trackFrame (CoarseInitializer.cc:74-165);
    appends its trip count to `trips` when given."""
    wl, hl = calib.w[lvl], calib.h[lvl]
    dev = T.device
    scale = torch.tensor([SCALE_XI_ROT] * 3 + [SCALE_XI_TRANS] * 3
                         + [SCALE_A, SCALE_B], dtype=torch.float32, device=dev)
    norm_fac = float(np.float32(0.01 / (wl * hl)))

    H, b, Hsc, bsc, res, upd = _calc_res_gs(L, dI_ref, dI_new, T, aff, lvl,
                                            calib, cfg)
    L = _apply_step(L._replace(**upd))

    one = np.float32(1.0)

    def solve(H, b, Hsc, bsc, lam):
        damp = float(one / (one + lam))     # float32 arithmetic, as in JAX
        Hl = H + torch.diag(torch.diagonal(H)) * float(lam)
        Hl = Hl - Hsc * damp
        bl = b - bsc * damp
        Hl = (scale[:, None] * Hl * scale[None, :]) * norm_fac
        bl = (scale * bl) * norm_fac
        n = 6 if fix_affine else 8
        eye = torch.eye(n, dtype=Hl.dtype, device=dev) * 1e-12
        x = torch.linalg.solve_ex(Hl[:n, :n] + eye, bl[:n])[0]
        inc = torch.zeros(8, dtype=Hl.dtype, device=dev)
        inc[:n] = -(scale[:n] * x)
        return torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))

    snapped_in = snapped          # calcEC reads the level's entry state
    lam = np.float32(0.1)
    fails = 0
    it = 0
    while True:
        inc = solve(H, b, Hsc, bsc, lam)
        T_new = lie.se3_exp(inc[:6]) @ T
        aff_new = aff + inc[6:8]
        Ld = _do_step(L, inc, float(one + lam))
        Hn, bn, Hscn, bscn, res_new, updn = _calc_res_gs(
            Ld, dI_ref, dI_new, T_new, aff_new, lvl, calib, cfg)
        Ld = Ld._replace(**updn)
        reg = _calc_ec(Ld, snapped_in)
        e_new = res_new[0] + res_new[1] + reg[1]
        e_old = res[0] + res[1] + reg[0]
        npts = torch.sum(Ld.valid.to(torch.float32))
        flags = torch.stack([e_old > e_new,
                             res_new[1] >= ALPHA_K * npts - 1e-3,
                             torch.linalg.norm(inc) <= 1e-4]).cpu().tolist()
        accept, snap_hit, small = flags
        if accept:
            snapped = snapped or snap_hit
            L = _opt_reg(_apply_step(Ld), snapped)
            T, aff, H, b, Hsc, bsc, res = T_new, aff_new, Hn, bn, Hscn, bscn, res_new
            lam = max(lam * np.float32(0.5), np.float32(1e-4))
            fails = 0
        else:
            lam = min(lam * np.float32(4.0), np.float32(1e4))
            fails += 1
        it += 1
        if small or it > MAX_ITERATIONS[lvl] or fails >= 2:
            break
    if trips is not None:
        trips.append(it)
    return L, T, aff, snapped, res


def _propagate_down(Lc: InitLevel, Lf: InitLevel, snapped: bool):
    """Parent (coarse, Lc) -> child (fine, Lf) idepth blending
    (propagateDown, :519-544)."""
    par = torch.clamp(Lf.parent, min=0)
    p_good = (Lc.is_good & Lc.valid)[par] & (Lf.parent >= 0)
    p_lh = Lc.last_hessian[par]
    p_iR = Lc.iR[par]
    usable = p_good & (p_lh >= 0.1)

    revive = usable & (~Lf.is_good) & Lf.valid
    blend_num = Lf.iR * Lf.last_hessian * 2.0 + p_iR * p_lh
    blend_den = Lf.last_hessian * 2.0 + p_lh
    blended = blend_num / torch.clamp(blend_den, min=1e-12)
    update = usable & Lf.is_good & Lf.valid

    new_iR = torch.where(revive, p_iR, torch.where(update, blended, Lf.iR))
    new_id = torch.where(revive | update, new_iR, Lf.idepth)
    Lf = Lf._replace(
        iR=new_iR, idepth=new_id, idepth_new=new_id,
        is_good=Lf.is_good | revive,
        last_hessian=torch.where(revive, torch.zeros_like(Lf.last_hessian),
                                 Lf.last_hessian))
    return _opt_reg(Lf, snapped)


def _propagate_up(Lf: InitLevel, Lc: InitLevel, snapped: bool):
    """Child (fine) -> parent (coarse) weighted mean (propagateUp,
    :462-517); the sums run in child order on every device, as XLA's
    scatter-add does (ops/scatter.py)."""
    good = Lf.is_good & Lf.valid & (Lf.parent >= 0)
    par = torch.clamp(Lf.parent, min=0)
    w = torch.where(good, Lf.last_hessian, torch.zeros_like(Lf.last_hessian))
    n = Lc.iR.shape[0]
    num = segment_sum(w * Lf.iR, par, n)
    den = segment_sum(w, par, n)
    has = den > 0
    mean = num / torch.clamp(den, min=1e-12)
    Lc = Lc._replace(
        iR=torch.where(has, mean, Lc.iR),
        idepth=torch.where(has, mean, Lc.idepth),
        idepth_new=torch.where(has, mean, Lc.idepth_new),
        is_good=Lc.is_good | (has & Lc.valid))
    return _opt_reg(Lc, snapped)


def track_frame(state: InitializerState, pyr_first: FramePyramid,
                pyr_new: FramePyramid, calib: Calibration, cfg: Config,
                first_exposure: float = 1.0, new_exposure: float = 1.0,
                trips=None):
    """One initializer step on a new frame. Mutates `state`; returns True
    once snapped for > 5 frames (reference trackFrame, :40-177). `trips`,
    when given, gets each level's LM trip count, coarsest first."""
    dev = pyr_new.dI[0].device
    levels = list(state.levels)
    T = torch.tensor(state.T, dtype=torch.float32, device=dev)
    if not state.snapped:
        T[:3, 3] = 0.0
        for i, L in enumerate(levels):
            levels[i] = L._replace(iR=torch.ones_like(L.iR),
                                   idepth_new=torch.ones_like(L.idepth_new),
                                   last_hessian=torch.zeros_like(L.last_hessian))
    aff = torch.tensor(state.aff, dtype=torch.float32, device=dev)
    if first_exposure > 0 and new_exposure > 0:
        aff = torch.tensor([np.log(new_exposure / first_exposure), 0.0],
                           dtype=torch.float32, device=dev)
    snapped = bool(state.snapped)

    top = calib.levels - 1
    for lvl in range(top, -1, -1):
        if lvl < top:
            levels[lvl] = _propagate_down(levels[lvl + 1], levels[lvl], snapped)
        levels[lvl] = _reset_points(levels[lvl], is_top=(lvl == top))
        levels[lvl], T, aff, snapped, _ = _level_opt(
            levels[lvl], pyr_first.dI[lvl], pyr_new.dI[lvl], T, aff, snapped,
            lvl, calib, cfg, fix_affine=True, trips=trips)

    for lvl in range(0, top):
        levels[lvl + 1] = _propagate_up(levels[lvl], levels[lvl + 1], snapped)

    state.levels = tuple(levels)
    state.T = T.cpu().numpy().astype(np.float64)
    state.aff = aff.cpu().numpy().astype(np.float64)
    state.snapped = snapped
    state.frame_id += 1
    if not state.snapped:
        state.snapped_at = 0
    if state.snapped and state.snapped_at == 0:
        state.snapped_at = state.frame_id
    return state.snapped and state.frame_id > state.snapped_at + 5
