"""Monocular bootstrap: joint (pose, affine, per-point idepth) optimization.

Counterpart of ldso_tpu/frontend/initializer.py (reference
CoarseInitializer, src/frontend/CoarseInitializer.cc):
  * `set_first` (:547-619): candidate points at 5 densities across the
    pyramid, a brute-force 10-NN graph and the coarser-level parent.
  * `track_frame` (:40-177): per level, coarse-to-fine LM over the 8-dof
    (pose, a, b) with each point's idepth eliminated by a per-point Schur
    complement (calcResAndGS :181-405, doStep :645-671).
  * idepth regularization toward the neighbourhood median (optReg
    :430-459), pyramid propagation up/down (:462-547) and the
    translation-alpha snapping (:339-361).
The level LM is a Python loop with the reference's accept/reject and quit
rules; the host reads one flag per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ldso_tpu_torch.config import (Config, PATTERN, SCALE_A, SCALE_B,
                                   SCALE_XI_ROT, SCALE_XI_TRANS)
from ldso_tpu_torch.camera.calib import Calibration
from ldso_tpu_torch.math import lie
from ldso_tpu_torch.ops import select as select_ops
from ldso_tpu_torch.ops.interp import bilinear
from ldso_tpu_torch.ops.preprocess import FramePyramid
from ldso_tpu_torch.ops.scatter import segment_sum

ALPHA_K = 2.5 * 2.5
ALPHA_W = 150.0 * 150.0
REG_WEIGHT = 0.8
COUPLING_WEIGHT = 1.0
MAX_ITERATIONS = (5, 5, 10, 30, 50, 50)
NN_K = 10
NN_DIST_FACTOR = 0.05


class InitLevel(NamedTuple):
    """Fixed-capacity point pool for one pyramid level."""
    u: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    idepth: torch.Tensor
    idepth_new: torch.Tensor
    iR: torch.Tensor
    energy: torch.Tensor       # (cap, 2)
    energy_new: torch.Tensor
    is_good: torch.Tensor
    is_good_new: torch.Tensor
    last_hessian: torch.Tensor
    last_hessian_new: torch.Tensor
    max_step: torch.Tensor
    jb: torch.Tensor           # (cap, 10)
    neighbours: torch.Tensor   # (cap, NN_K) int64, -1 = none
    parent: torch.Tensor       # (cap,) int64, -1 at top
    outlier_th: torch.Tensor


@dataclasses.dataclass
class InitializerState:
    levels: Tuple[InitLevel, ...]
    T: np.ndarray                 # thisToNext (4,4) f64
    aff: np.ndarray               # (2,)
    snapped: bool = False
    frame_id: int = 0
    snapped_at: int = 0


# ---------------------------------------------------------------------------
# setFirst
# ---------------------------------------------------------------------------

def _knn(u, v, valid, k: int, qu=None, qv=None, chunk=1024):
    """Brute-force k-NN: (Nq, k) indices into (u, v) and distances.
    Invalid points sit at 1e30; ties keep the lower index (lax.top_k)."""
    if qu is None:
        qu, qv = u, v
    pts = torch.stack([u, v], dim=-1)
    qpts = torch.stack([qu, qv], dim=-1)
    big = torch.full((), 1e30, dtype=torch.float32, device=u.device)
    idxs, dists = [], []
    for s in range(0, qpts.shape[0], chunk):
        q = qpts[s:s + chunk]
        diff = q[:, None, :] - pts[None, :, :]
        # dx^2 + dy^2 rounded like XLA:CPU's fma(dy, dy, dx*dx), so exact
        # distance ties order the neighbours the same way
        d = (diff[..., 1].double() ** 2
             + (diff[..., 0] ** 2).double()).to(torch.float32)
        d = torch.where(valid[None, :], d, big)
        dv, di = torch.sort(d, dim=-1, stable=True)
        idxs.append(di[:, :k])
        dists.append(dv[:, :k])
    return torch.cat(idxs), torch.cat(dists)


def _make_nn_level(u, v, valid, k: int):
    idx, dist = _knn(u, v, valid, k)
    return torch.where(valid[:, None], idx, torch.full_like(idx, -1)), dist


def _make_parent(u, v, valid, pu, pv, pvalid):
    idx, _ = _knn(pu, pv, pvalid, 1, u * 0.5 - 0.25, v * 0.5 - 0.25)
    return torch.where(valid, idx[:, 0], torch.full_like(idx[:, 0], -1))


def _round_cap(n: int) -> int:
    return max(256, int(2 ** np.ceil(np.log2(max(n, 1)))))


def set_first(pyr: FramePyramid, calib: Calibration, cfg: Config,
              selector: Optional[select_ops.PixelSelector] = None) -> InitializerState:
    """Select candidate points on the first frame and build the NN graph
    (reference setFirst, CoarseInitializer.cc:547-619)."""
    dev = pyr.dI[0].device
    densities = [0.03, 0.05, 0.15, 0.5, 1.0, 1.0]
    w0h0 = calib.w[0] * calib.h[0]
    if selector is None:
        selector = select_ops.PixelSelector(calib.w[0], calib.h[0], cfg, dev)
    f32 = dict(dtype=torch.float32, device=dev)

    levels = []
    pad = 2 + 1
    for lvl in range(calib.levels):
        wl, hl = calib.w[lvl], calib.h[lvl]
        if lvl == 0:
            selector.current_potential = 3
            status, _ = selector.make_maps(pyr, densities[0] * w0h0,
                                           th_factor=2.0)
            mask = status.cpu().numpy() != 0
        else:
            bmap, _, _ = select_ops.make_pixel_status(
                pyr.dI[lvl], densities[lvl] * w0h0)
            mask = bmap.cpu().numpy()
        ys, xs = np.mgrid[0:hl, 0:wl]
        inb = (xs >= pad) & (xs < wl - pad - 1) & (ys >= pad) & (ys < hl - pad - 1)
        py, px = np.nonzero(mask & inb)
        n = len(px)
        cap = _round_cap(n)

        def padf(a, fill=0.0):
            return torch.tensor(np.concatenate(
                [a.astype(np.float32), np.full(cap - n, fill, np.float32)]),
                **f32)

        u = padf(px + 0.1)
        v = padf(py + 0.1)
        valid = torch.arange(cap, device=dev) < n
        ones = torch.ones(cap, **f32)
        levels.append(InitLevel(
            u=u, v=v, valid=valid,
            idepth=ones, idepth_new=ones, iR=ones,
            energy=torch.zeros((cap, 2), **f32),
            energy_new=torch.zeros((cap, 2), **f32),
            is_good=valid, is_good_new=valid,
            last_hessian=torch.zeros(cap, **f32),
            last_hessian_new=torch.zeros(cap, **f32),
            max_step=torch.full((cap,), 1e10, **f32),
            jb=torch.zeros((cap, 10), **f32),
            neighbours=torch.full((cap, NN_K), -1, dtype=torch.int64,
                                  device=dev),
            parent=torch.full((cap,), -1, dtype=torch.int64, device=dev),
            outlier_th=torch.full((cap,), 8.0 * cfg.outlier_th, **f32),
        ))

    # NN graph + parents (reference makeNN, CoarseInitializer.cc:717-783)
    for lvl in range(calib.levels):
        L = levels[lvl]
        nb, _ = _make_nn_level(L.u, L.v, L.valid, NN_K)
        if lvl < calib.levels - 1:
            Lp = levels[lvl + 1]
            parent = _make_parent(L.u, L.v, L.valid, Lp.u, Lp.v, Lp.valid)
        else:
            parent = torch.full((L.u.shape[0],), -1, dtype=torch.int64,
                                device=dev)
        levels[lvl] = L._replace(neighbours=nb, parent=parent)
    return InitializerState(levels=tuple(levels), T=np.eye(4), aff=np.zeros(2))


# ---------------------------------------------------------------------------
# per-level residual/Jacobian/Schur (calcResAndGS)
# ---------------------------------------------------------------------------

def _calc_res_gs(L: InitLevel, dI_ref, dI_new, T, aff_rel, lvl,
                 calib: Calibration, cfg: Config):
    """Returns (H(8,8), b(8,), Hsc, bsc, res(3,), point updates dict)."""
    wl, hl = calib.w[lvl], calib.h[lvl]
    fx, fy = calib.fx[lvl], calib.fy[lvl]
    cx, cy = calib.cx[lvl], calib.cy[lvl]
    dev = T.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    Ki = torch.tensor(calib.Ki(lvl), dtype=torch.float32, device=dev)
    R = T[:3, :3]
    t = T[:3, 3]
    RKi = R @ Ki
    a_rel = torch.exp(aff_rel[0])
    b_rel = aff_rel[1]

    patt = torch.tensor(PATTERN, dtype=torch.float32, device=dev)
    uP = L.u[:, None] + patt[None, :, 0]
    vP = L.v[:, None] + patt[None, :, 1]
    idep = L.idepth_new[:, None]

    p = torch.stack([uP, vP, torch.ones_like(uP)], dim=-1)          # (N,8,3)
    pt = torch.einsum("ij,npj->npi", RKi, p) + t[None, None, :] * idep[..., None]
    u = pt[..., 0] / pt[..., 2]
    v = pt[..., 1] / pt[..., 2]
    Ku = fx * u + cx
    Kv = fy * v + cy
    new_idepth = idep / pt[..., 2]

    inb = (Ku > 1) & (Kv > 1) & (Ku < wl - 2) & (Kv < hl - 2) & (new_idepth > 0)

    hit = bilinear(dI_new, Ku, Kv)                                  # (N,8,3)
    ref_c = bilinear(dI_ref[..., 0], uP, vP)                        # (N,8)
    finite = torch.isfinite(hit[..., 0]) & torch.isfinite(ref_c)
    ok_pix = inb & finite
    point_ok = L.is_good & L.valid & torch.all(ok_pix, dim=-1)

    residual = hit[..., 0] - a_rel * ref_c - b_rel
    abs_r = torch.abs(residual)
    hw_e = torch.where(abs_r < cfg.huber_th, torch.ones_like(abs_r),
                       cfg.huber_th / torch.clamp(abs_r, min=1e-12))
    energy = torch.sum(hw_e * residual * residual * (2.0 - hw_e), dim=-1)

    good_new = point_ok & (energy <= L.outlier_th * 20.0)

    hw = torch.where(hw_e < 1.0, torch.sqrt(hw_e), hw_e)
    dxdd = (t[0] - t[2] * u) / pt[..., 2]
    dydd = (t[1] - t[2] * v) / pt[..., 2]
    dxI = hw * hit[..., 1] * fx
    dyI = hw * hit[..., 2] * fy
    dp = torch.stack([
        new_idepth * dxI,
        new_idepth * dyI,
        -new_idepth * (u * dxI + v * dyI),
        -u * v * dxI - (1.0 + v * v) * dyI,
        (1.0 + u * u) * dxI + u * v * dyI,
        -v * dxI + u * dyI,
        -hw * a_rel * ref_c,
        -hw,
    ], dim=-1)                                                      # (N,8,8)
    dd = dxI * dxdd + dyI * dydd
    r = hw * residual

    step_norm = torch.sqrt((dxdd * fx) ** 2 + (dydd * fy) ** 2)
    max_step = torch.amin(torch.where(ok_pix, 1.0 / torch.clamp(step_norm, min=1e-12),
                                      torch.full_like(step_norm, 1e10)), dim=-1)
    max_step = torch.where(good_new, max_step, torch.full_like(max_step, 1e10))

    gmask = good_new[:, None].to(torch.float32)
    rows = torch.cat([dp, r[..., None]], dim=-1) * gmask[..., None]
    rows = rows.reshape(-1, 9)
    H9 = rows.T @ rows
    H = H9[:8, :8]
    b = H9[:8, 8]

    jb = torch.cat([
        torch.sum(dp * dd[..., None], dim=1),
        torch.sum(r * dd, dim=1, keepdim=True),
        torch.sum(dd * dd, dim=1, keepdim=True),
    ], dim=-1)
    jb = torch.where(good_new[:, None], jb, zero)

    npts = torch.sum(L.valid.to(torch.float32))
    e_photo = torch.sum(torch.where(good_new, energy,
                                    torch.where(L.valid, L.energy[:, 0], zero)))
    e_alpha_term = torch.where(good_new, (L.idepth_new - 1.0) ** 2,
                               torch.where(L.valid, L.energy[:, 1], zero))
    E_total = e_photo + torch.sum(e_alpha_term)
    num_in_E = torch.sum((good_new | L.valid).to(torch.float32))

    alpha_energy_raw = ALPHA_W * torch.sum(t * t) * npts
    capped = alpha_energy_raw > ALPHA_K * npts
    alpha_energy = torch.where(capped, ALPHA_K * npts, alpha_energy_raw)
    alpha_opt = torch.where(capped, zero, zero + ALPHA_W)

    free = alpha_opt == 0.0
    jb8 = jb[:, 8] + alpha_opt * (L.idepth_new - 1.0)
    jb9 = jb[:, 9] + alpha_opt
    jb8 = jb8 + torch.where(free, COUPLING_WEIGHT * (L.idepth_new - L.iR), zero)
    jb9 = jb9 + torch.where(free, zero + COUPLING_WEIGHT, zero)
    jb9 = 1.0 / (1.0 + jb9)
    jb = torch.cat([jb[:, :8], jb8[:, None], jb9[:, None]], dim=1)
    jb = torch.where(good_new[:, None], jb, zero)

    w_sc = jb[:, 9] * good_new.to(torch.float32)
    Jsc = jb[:, :8]
    Hsc = (Jsc * w_sc[:, None]).T @ Jsc
    bsc = (Jsc * w_sc[:, None]).T @ jb[:, 8]

    diag_add = alpha_opt * npts
    H = H + torch.diag(torch.cat([diag_add.expand(3),
                                  torch.zeros(5, dtype=H.dtype, device=dev)]))
    tlog = lie.se3_log(T)[:3]
    b = torch.cat([b[:3] + tlog * alpha_opt * npts, b[3:]])

    updates = dict(
        is_good_new=good_new,
        energy_new=torch.stack([torch.where(good_new, energy, L.energy[:, 0]),
                                torch.where(good_new, (L.idepth_new - 1.0) ** 2,
                                            L.energy[:, 1])], dim=-1),
        last_hessian_new=torch.where(good_new, torch.sum(dd * dd, dim=1), zero),
        max_step=max_step,
        jb=jb,
    )
    res = torch.stack([E_total, alpha_energy, num_in_E])
    return H, b, Hsc, bsc, res, updates


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


def _nb_gather(L: InitLevel):
    nb = L.neighbours
    nbc = torch.clamp(nb, min=0)
    nb_ok = (nb >= 0) & (L.is_good & L.valid)[nbc]
    return nb_ok, L.iR[nbc]


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


def _reset_points(L: InitLevel, is_top: bool) -> InitLevel:
    """resetPoints (:621-643): zero energies; at the top level revive bad
    points from the mean of good neighbours."""
    L = L._replace(energy=torch.zeros_like(L.energy), idepth_new=L.idepth)
    if not is_top:
        return L
    nb_ok, nb_iR = _nb_gather(L)
    s = torch.sum(torch.where(nb_ok, nb_iR, torch.zeros_like(nb_iR)), dim=-1)
    n = torch.sum(nb_ok, dim=-1)
    revive = (~L.is_good) & L.valid & (n > 0)
    mean = s / torch.clamp(n, min=1)
    return L._replace(
        is_good=L.is_good | revive,
        iR=torch.where(revive, mean, L.iR),
        idepth=torch.where(revive, mean, L.idepth),
        idepth_new=torch.where(revive, mean, L.idepth_new),
    )


def _do_step(L: InitLevel, inc, one_plus_lam: float) -> InitLevel:
    """Per-point idepth resubstitution (doStep, :645-671)."""
    b = L.jb[:, 8] + L.jb[:, :8] @ inc
    step = -b * L.jb[:, 9] / one_plus_lam
    max_step = torch.clamp(0.25 * L.max_step, max=1e10)
    step = torch.minimum(torch.maximum(step, -max_step), max_step)
    new_id = torch.clamp(L.idepth + step, 1e-3, 50.0)
    new_id = torch.where(L.is_good & L.valid, new_id, L.idepth_new)
    return L._replace(idepth_new=new_id)


def _apply_step(L: InitLevel) -> InitLevel:
    """Commit (applyStep, :673-687)."""
    good = L.is_good & L.valid
    return L._replace(
        idepth=torch.where(good, L.idepth_new, L.iR),
        idepth_new=torch.where(good, L.idepth_new, L.iR),
        energy=torch.where(good[:, None], L.energy_new, L.energy),
        is_good=torch.where(L.valid, L.is_good_new, L.is_good),
        last_hessian=torch.where(good, L.last_hessian_new, L.last_hessian),
    )


def _level_opt(L: InitLevel, dI_ref, dI_new, T, aff, snapped: bool,
               lvl: int, calib: Calibration, cfg: Config,
               fix_affine: bool = True):
    """The per-level LM loop of trackFrame (CoarseInitializer.cc:74-165)."""
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
    return L, T, aff, snapped, res


# ---------------------------------------------------------------------------
# pyramid propagation
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------

def track_frame(state: InitializerState, pyr_first: FramePyramid,
                pyr_new: FramePyramid, calib: Calibration, cfg: Config,
                first_exposure: float = 1.0, new_exposure: float = 1.0):
    """One initializer step on a new frame. Mutates `state`; returns True
    once snapped for > 5 frames (reference trackFrame, :40-177)."""
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
            lvl, calib, cfg, fix_affine=True)

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
