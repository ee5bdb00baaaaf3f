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
Each level's LM runs its `MAX_ITERATIONS[lvl] + 1` trips in full, masked
by a device `quit` flag with the reference's accept/reject and quit rules
(the JAX package's `lax.while_loop`): a trip after the quit leaves the
whole state as it was. So a bootstrap frame (every level's LM, then the
propagation up) reads nothing back from the card. On the card it is one
CUDA graph per (calibration, Config, level capacities) in the family
INIT_GRAPHS, captured when the first frame is set (`capture_frame_program`)
and replayed once per later frame, with T, the affine and the snap flag in
one pinned upload and one packed HostCopy home (`track_frame_dispatch`,
`track_frame_finish`). On the CPU the same program runs eagerly.
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
from ldso_tpu_torch.ops.preprocess import FramePyramid, to_device
from ldso_tpu_torch.ops.scatter import segment_sum
from ldso_tpu_torch.utils.device import HostCopy
from ldso_tpu_torch.utils.graphs import Programs
from ldso_tpu_torch.utils.static import device_const

ALPHA_K = 2.5 * 2.5
ALPHA_W = 150.0 * 150.0
REG_WEIGHT = 0.8
COUPLING_WEIGHT = 1.0
MAX_ITERATIONS = (5, 5, 10, 30, 50, 50)
NN_K = 10
NN_DIST_FACTOR = 0.05
# the LM's step scales (trackFrame's SCALE_XI_ROT ... SCALE_B)
LM_SCALE = (SCALE_XI_ROT,) * 3 + (SCALE_XI_TRANS,) * 3 + (SCALE_A, SCALE_B)

# the bootstrap frame's captured programs (utils/graphs.Programs): a CUDA
# graph per (calibration, Config, level capacities), captured when the
# first frame is set
INIT_GRAPHS = Programs(capture_on_replay=False)


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
    # the last frame's LM trips per level, coarsest first
    trips: Tuple[int, ...] = ()


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


def _rows(a) -> tuple:
    """A 2-D array as a tuple of row tuples (a device_const key)."""
    return tuple(map(tuple, np.asarray(a).tolist()))


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
    Ki = device_const(_rows(calib.Ki(lvl)), dev)
    R = T[:3, :3]
    t = T[:3, 3]
    RKi = R @ Ki
    a_rel = torch.exp(aff_rel[0])
    b_rel = aff_rel[1]

    patt = device_const(_rows(PATTERN), dev)
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


def _calc_ec(L: InitLevel, snapped):
    """Coupling energy (calcEC, CoarseInitializer.cc:412-428); snapped a
    0-d bool tensor (zero energies when it is false)."""
    g = L.is_good_new & L.valid
    zero = torch.zeros((), dtype=torch.float32, device=L.u.device)
    r_old = torch.where(g, (L.idepth - L.iR) ** 2, zero)
    r_new = torch.where(g, (L.idepth_new - L.iR) ** 2, zero)
    E = torch.stack([COUPLING_WEIGHT * torch.sum(r_old),
                     COUPLING_WEIGHT * torch.sum(r_new)])
    return torch.where(snapped, E, torch.zeros_like(E))


def _nb_gather(L: InitLevel):
    nb = L.neighbours
    nbc = torch.clamp(nb, min=0)
    nb_ok = (nb >= 0) & (L.is_good & L.valid)[nbc]
    return nb_ok, L.iR[nbc]


def _opt_reg(L: InitLevel, snapped) -> InitLevel:
    """Pull iR toward the neighbourhood median (optReg, :430-459); snapped
    a 0-d bool tensor (iR all ones when it is false)."""
    nb_ok, nb_iR = _nb_gather(L)
    vals = torch.where(nb_ok, nb_iR, torch.full_like(nb_iR, float("inf")))
    vals = torch.sort(vals, dim=-1).values
    nnn = torch.sum(nb_ok, dim=-1)
    med = torch.gather(vals, 1, torch.clamp(nnn[:, None] // 2, min=0))[:, 0]
    use = (nnn > 2) & L.is_good & L.valid
    iR = torch.where(use, (1.0 - REG_WEIGHT) * L.idepth + REG_WEIGHT * med,
                     L.iR)
    return L._replace(iR=torch.where(snapped, iR, torch.ones_like(iR)))


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


def _do_step(L: InitLevel, inc, one_plus_lam) -> InitLevel:
    """Per-point idepth resubstitution (doStep, :645-671); one_plus_lam a
    0-d tensor, which the card divides by as XLA does (a Python float it
    would multiply by its reciprocal)."""
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


def _pick(keep, new, old):
    """torch.where(keep, new, old) over every field of two InitLevels (a
    field both share is kept as it is)."""
    return InitLevel(*(n if n is o else torch.where(keep, n, o)
                       for n, o in zip(new, old)))


def _level_opt(L: InitLevel, dI_ref, dI_new, T, aff, snapped,
               lvl: int, calib: Calibration, cfg: Config,
               fix_affine: bool = True):
    """The per-level LM loop of trackFrame (CoarseInitializer.cc:74-165) as
    the JAX package's while_loop: MAX_ITERATIONS[lvl] + 1 trips in full,
    each masked by the device flag `quit` (a trip after it leaves L, T,
    aff, the systems, res, lam, fails, the trip count and snapped as they
    were). snapped a 0-d bool tensor. Reads nothing back from the card.
    Returns (L, T, aff, snapped, res, trips): trips a 0-d int32 tensor,
    the live trips the early-exit loop would run."""
    wl, hl = calib.w[lvl], calib.h[lvl]
    dev = T.device
    scale = device_const(LM_SCALE, dev)
    norm_fac = float(np.float32(0.01 / (wl * hl)))
    n = 6 if fix_affine else 8
    eye = device_const(tuple(tuple(1e-12 if i == j else 0.0
                                   for j in range(n)) for i in range(n)), dev)

    H, b, Hsc, bsc, res, upd = _calc_res_gs(L, dI_ref, dI_new, T, aff, lvl,
                                            calib, cfg)
    L = _apply_step(L._replace(**upd))

    def solve(H, b, Hsc, bsc, lam, damp):
        Hl = H + torch.diag(torch.diagonal(H)) * lam
        Hl = Hl - Hsc * damp
        bl = b - bsc * damp
        Hl = (scale[:, None] * Hl * scale[None, :]) * norm_fac
        bl = (scale * bl) * norm_fac
        x = torch.linalg.solve_ex(Hl[:n, :n] + eye, bl[:n])[0]
        inc = -(scale[:n] * x)
        if n < 8:
            inc = torch.cat([inc, torch.zeros(8 - n, dtype=inc.dtype,
                                              device=dev)])
        return torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))

    snapped_in = snapped          # calcEC reads the level's entry state
    lam = device_const(0.1, dev)
    lam_min, lam_max = device_const(1e-4, dev), device_const(1e4, dev)
    zero = device_const(0, dev, torch.int32)
    fails = it = zero
    quit = device_const(False, dev, torch.bool)
    for _ in range(MAX_ITERATIONS[lvl] + 1):
        live = ~quit
        one_plus_lam = 1.0 + lam
        inc = solve(H, b, Hsc, bsc, lam, torch.reciprocal(one_plus_lam))
        T_new = lie.se3_exp(inc[:6]) @ T
        aff_new = aff + inc[6:8]
        Ld = _do_step(L, inc, one_plus_lam)
        Hn, bn, Hscn, bscn, res_new, updn = _calc_res_gs(
            Ld, dI_ref, dI_new, T_new, aff_new, lvl, calib, cfg)
        Ld = Ld._replace(**updn)
        reg = _calc_ec(Ld, snapped_in)
        e_new = res_new[0] + res_new[1] + reg[1]
        e_old = res[0] + res[1] + reg[0]
        npts = torch.sum(Ld.valid.to(torch.float32))
        accept = e_old > e_new
        snap_hit = res_new[1] >= ALPHA_K * npts - 1e-3
        small = torch.linalg.norm(inc) <= 1e-4
        acc = live & accept
        rej = live & ~accept
        snapped_acc = snapped | snap_hit
        L = _pick(acc, _opt_reg(_apply_step(Ld), snapped_acc), L)
        T = torch.where(acc, T_new, T)
        aff = torch.where(acc, aff_new, aff)
        H, b, Hsc, bsc, res = (torch.where(acc, x, y) for x, y in zip(
            (Hn, bn, Hscn, bscn, res_new), (H, b, Hsc, bsc, res)))
        snapped = torch.where(acc, snapped_acc, snapped)
        lam = torch.where(acc, torch.maximum(lam * 0.5, lam_min),
                          torch.where(rej, torch.minimum(lam * 4.0, lam_max),
                                      lam))
        fails = torch.where(acc, zero, torch.where(rej, fails + 1, fails))
        it = torch.where(live, it + 1, it)
        quit = quit | (live & (small | (it > MAX_ITERATIONS[lvl])
                               | (fails >= 2)))
    return L, T, aff, snapped, res, it


# ---------------------------------------------------------------------------
# pyramid propagation
# ---------------------------------------------------------------------------

def _propagate_down(Lc: InitLevel, Lf: InitLevel, snapped):
    """Parent (coarse, Lc) -> child (fine, Lf) idepth blending
    (propagateDown, :519-544); snapped a 0-d bool tensor."""
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


def _propagate_up(Lf: InitLevel, Lc: InitLevel, snapped):
    """Child (fine) -> parent (coarse) weighted mean (propagateUp,
    :462-517); the sums run in child order on every device, as XLA's
    scatter-add does (ops/scatter.py). snapped a 0-d bool tensor."""
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
# one bootstrap frame as one program
# ---------------------------------------------------------------------------

def bootstrap_frame(levels, dI_ref, dI_new, up, calib: Calibration,
                    cfg: Config):
    """trackFrame (:40-177) on the device: from an un-snapped state the
    levels restart from unit idepth, then every level's LM from the
    coarsest down (propagated down to and reset first), then the
    propagation up. levels: the state's InitLevels; dI_ref, dI_new the two
    frames' pyramid levels; up the float32 upload [T (16), aff (2),
    snapped]. Reads nothing back. Returns (levels', packed): packed the
    float32 row [T (16), aff (2), snapped, each level's LM trips, coarsest
    first]."""
    snapped = up[18] > 0.5
    T = up[:16].reshape(4, 4)
    aff = up[16:18]
    levels = [L._replace(
        iR=torch.where(snapped, L.iR, torch.ones_like(L.iR)),
        idepth_new=torch.where(snapped, L.idepth_new,
                               torch.ones_like(L.idepth_new)),
        last_hessian=torch.where(snapped, L.last_hessian,
                                 torch.zeros_like(L.last_hessian)))
        for L in levels]
    top = calib.levels - 1
    trips = []
    for lvl in range(top, -1, -1):
        if lvl < top:
            levels[lvl] = _propagate_down(levels[lvl + 1], levels[lvl],
                                          snapped)
        levels[lvl] = _reset_points(levels[lvl], is_top=(lvl == top))
        levels[lvl], T, aff, snapped, _, it = _level_opt(
            levels[lvl], dI_ref[lvl], dI_new[lvl], T, aff, snapped, lvl,
            calib, cfg, fix_affine=True)
        trips.append(it)

    for lvl in range(0, top):
        levels[lvl + 1] = _propagate_up(levels[lvl], levels[lvl + 1],
                                        snapped)
    packed = torch.cat([T.reshape(-1), aff, snapped.to(torch.float32)[None],
                        torch.stack(trips).to(torch.float32)])
    return levels, packed


def _flat(levels) -> tuple:
    return tuple(t for L in levels for t in L)


def _levels_of(xs, n: int) -> tuple:
    k = len(InitLevel._fields)
    return tuple(InitLevel(*xs[i * k:(i + 1) * k]) for i in range(n))


def _frame_program(calib: Calibration, cfg: Config):
    """bootstrap_frame over (the levels' fields..., dI_ref's levels,
    dI_new's levels, the upload): the levels' fields and the packed row."""
    nl = calib.levels

    def program(*xs):
        k = nl * len(InitLevel._fields)
        levels, packed = bootstrap_frame(
            _levels_of(xs[:k], nl), xs[k:k + nl], xs[k + nl:k + 2 * nl],
            xs[-1], calib, cfg)
        return _flat(levels) + (packed,)
    return program


def _frame_call(state: InitializerState, dI_ref, dI_new, up,
                calib: Calibration, cfg: Config):
    """The bootstrap frame's (family, static, program, inputs), keyed on
    the calibration, the Config and the levels' capacities."""
    caps = tuple(L.u.shape[0] for L in state.levels)
    return (INIT_GRAPHS, (calib, cfg, caps), _frame_program(calib, cfg),
            _flat(state.levels) + tuple(dI_ref) + tuple(dI_new) + (up,))


def _run(family: Programs, static, fn, inputs):
    """fn(*inputs) as the replay of its graph on the card (captured before,
    by capture_frame_program: a key with no graph raises), eagerly on the
    CPU."""
    if inputs[0].device.type == "cuda":
        return family.replay(static, fn, tuple(inputs))
    return tuple(fn(*inputs))


def capture_frame_program(state: InitializerState, pyr: FramePyramid,
                          calib: Calibration, cfg: Config):
    """Capture the bootstrap frame's graph for `state`'s level capacities
    (set_first's, known at the first frame) on the first frame's pyramid,
    so that no later frame captures. On the card only; a capture that
    fails raises."""
    if pyr.dI[0].device.type != "cuda":
        return
    up = torch.zeros(19, dtype=torch.float32, device=pyr.dI[0].device)
    family, static, fn, inputs = _frame_call(state, pyr.dI, pyr.dI, up,
                                             calib, cfg)
    family.capture(static, fn, inputs)


# ---------------------------------------------------------------------------
# the host side: one upload, one replay, one pull a frame
# ---------------------------------------------------------------------------

def track_frame_dispatch(state: InitializerState, pyr_first: FramePyramid,
                         pyr_new: FramePyramid, calib: Calibration,
                         cfg: Config, first_exposure: float = 1.0,
                         new_exposure: float = 1.0) -> HostCopy:
    """Queue one initializer step on a new frame (bootstrap_frame, on the
    card one graph replay) and return its packed row on its way home:
    T, aff and the snap flag go up in one pinned upload (the un-snapped
    reset of T's translation made in numpy first), and nothing is read
    back. Sets state.levels; track_frame_finish reads the rest."""
    dev = pyr_new.dI[0].device
    T = np.array(state.T, np.float64)
    if not state.snapped:
        T[:3, 3] = 0.0
    aff = np.asarray(state.aff, np.float64)
    if first_exposure > 0 and new_exposure > 0:
        aff = np.array([np.log(new_exposure / first_exposure), 0.0])
    row = np.concatenate([T.ravel(), aff, [float(state.snapped)]])
    up = to_device(torch.from_numpy(row.astype(np.float32)), dev)
    out = _run(*_frame_call(state, pyr_first.dI, pyr_new.dI, up, calib, cfg))
    state.levels = _levels_of(out[:-1], calib.levels)
    return HostCopy(out[-1])


def track_frame_finish(state: InitializerState, pull: HostCopy) -> bool:
    """Apply a dispatched step's packed row (its one read of the card):
    T, aff, the snap flag and the trip counts. Returns True once snapped
    for > 5 frames."""
    pk = pull.numpy().astype(np.float64)
    state.T = pk[:16].reshape(4, 4)
    state.aff = pk[16:18]
    state.snapped = bool(pk[18] > 0.5)
    state.trips = tuple(int(x) for x in pk[19:])
    state.frame_id += 1
    if not state.snapped:
        state.snapped_at = 0
    if state.snapped and state.snapped_at == 0:
        state.snapped_at = state.frame_id
    return state.snapped and state.frame_id > state.snapped_at + 5


def track_frame(state: InitializerState, pyr_first: FramePyramid,
                pyr_new: FramePyramid, calib: Calibration, cfg: Config,
                first_exposure: float = 1.0, new_exposure: float = 1.0):
    """One initializer step on a new frame. Mutates `state`; returns True
    once snapped for > 5 frames (reference trackFrame, :40-177): one
    program and one read of the card, as the JAX package's one
    device_get."""
    return track_frame_finish(state, track_frame_dispatch(
        state, pyr_first, pyr_new, calib, cfg, first_exposure,
        new_exposure))
