"""Immature points: batched epipolar trace + depth-only activation GN.

Counterpart of ldso_tpu/frontend/immature.py (reference
src/internal/ImmaturePoint.cc):
  * `make_pool` <- the ImmaturePoint constructor (:14-38).
  * `trace`     <- traceOn (:47-310): project the idepth interval, discrete
    SSD search over the epipolar steps, <= 3 GN steps along the line, then
    the new interval and status.
  * `linearize_depth_residual` / `activate` <- linearizeResidual
    (:312-381) + FullSystem::optimizeImmaturePoint (FullSystem.cc:892-1010).
  * the flat candidate arena: every host keyframe's candidates in one (N,)
    pool plus a per-candidate host slot.

The trace's discrete search has the JAX package's three samplings, chosen
by `trace_packed` and `trace_search_nearest`:
  * packed (the default): the UNROTATED integer pattern sampled
    bilinearly, every tap of a step sharing the step's fractional part and
    each tap row/column clamped to the image (`_search_samples`);
  * not packed: the reference's search, bilinear over the rotated pattern
    (ImmaturePoint.cc:182-205);
  * nearest: one tap per pattern pixel, over the unrotated integer pattern
    when packed (`_nearest_samples`) or the rotated one when not, followed
    by a bilinear re-score of the +-`trace_refine_steps` neighbourhood.
The packing that implemented the packed samplings on the TPU is not
ported; the functions it computes are.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ldso_tpu_torch.config import Config, PATTERN
from ldso_tpu_torch.camera.calib import Calibration
from ldso_tpu_torch.ops.interp import bilinear, nearest
from ldso_tpu_torch.utils.static import nonzero_padded

IPS_GOOD = 0
IPS_OOB = 1
IPS_OUTLIER = 2
IPS_SKIPPED = 3
IPS_BADCONDITION = 4
IPS_UNINITIALIZED = 5

MAX_STEPS = 100

RES_IN = 0
RES_OOB = 1
RES_OUTLIER = 2


def _steps_cap(W: int, H: int, cfg) -> int:
    """Static bound on the epipolar step count (ImmaturePoint.cc:101-157)."""
    return min(MAX_STEPS, int(2.0 + (W + H) * cfg.max_pix_search
                              / cfg.trace_stepsize) + 2)


class ImmaturePool(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    color: torch.Tensor         # (cap, 8)
    weights: torch.Tensor       # (cap, 8)
    gradH: torch.Tensor         # (cap, 2, 2)
    idepth_min: torch.Tensor
    idepth_max: torch.Tensor    # +inf when uninitialized
    quality: torch.Tensor
    energy_th: torch.Tensor
    status: torch.Tensor        # (cap,) int32 IPS_*
    last_u: torch.Tensor
    last_v: torch.Tensor
    last_interval: torch.Tensor
    my_type: torch.Tensor       # (cap,) int32 selector status (1/2/4)


def _patt(device):
    return torch.tensor(PATTERN, dtype=torch.float32, device=device)


def make_pool(status_map, dI0, cap: int, cfg: Config) -> ImmaturePool:
    """Pool from a selection status map ((H,W) int, 0 = unselected)."""
    H, W = status_map.shape
    dev = status_map.device
    flat = status_map.reshape(-1)
    sel = flat != 0
    idx = nonzero_padded(sel, cap, 0)
    got = torch.arange(cap, device=dev) < sel.sum()
    u = (idx % W).to(torch.float32)
    v = (idx // W).to(torch.float32)
    my_type = flat[idx]

    patt = _patt(dev)
    ptc = bilinear(dI0, u[:, None] + patt[None, :, 0],
                   v[:, None] + patt[None, :, 1])                 # (cap,8,3)
    color = ptc[..., 0]
    g = ptc[..., 1:3]
    gradH = torch.einsum("npi,npj->nij", g, g)
    gsq = torch.sum(g * g, dim=-1)
    weights = torch.sqrt(cfg.outlier_th_sum_component
                         / (cfg.outlier_th_sum_component + gsq))
    valid = got & torch.all(torch.isfinite(color), dim=-1)

    energy_th = (8.0 * cfg.outlier_th
                 * cfg.overall_energy_th_weight * cfg.overall_energy_th_weight)
    f32 = dict(dtype=torch.float32, device=dev)
    return ImmaturePool(
        u=u, v=v, valid=valid, color=color, weights=weights, gradH=gradH,
        idepth_min=torch.zeros(cap, **f32),
        idepth_max=torch.full((cap,), float("inf"), **f32),
        quality=torch.full((cap,), 10000.0, **f32),
        energy_th=torch.full((cap,), energy_th, **f32),
        status=torch.full((cap,), IPS_UNINITIALIZED, dtype=torch.int32,
                          device=dev),
        last_u=torch.full((cap,), -1.0, **f32),
        last_v=torch.full((cap,), -1.0, **f32),
        last_interval=torch.zeros(cap, **f32),
        my_type=my_type.to(torch.int32),
    )


def _search_samples(img, x, y, patt_int):
    """Bilinear samples of the integer pattern around each (x, y), every tap
    with the fractional part of (x, y) and its row/column clamped to the
    image: the function the JAX package computes with
    `bilinear_packed_pattern(pack_pattern_bilinear(img, PATTERN), ...)`.
    img (H, W); x, y (...); patt_int (P, 2) int64. Returns (..., P)."""
    H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]
    xi = torch.where(torch.isnan(x0), torch.zeros_like(x0), x0).long()
    yi = torch.where(torch.isnan(y0), torch.zeros_like(y0), y0).long()
    cx = torch.clamp(xi[..., None] + patt_int[:, 0], 0, W - 1)
    cy = torch.clamp(yi[..., None] + patt_int[:, 1], 0, H - 1)
    cx1 = torch.clamp(cx + 1, max=W - 1)
    cy1 = torch.clamp(cy + 1, max=H - 1)
    flat = img.reshape(-1)
    v00 = flat[cy * W + cx]
    v01 = flat[cy * W + cx1]
    v10 = flat[cy1 * W + cx]
    v11 = flat[cy1 * W + cx1]
    dxdy = dx * dy
    return (dxdy * v11 + (dy - dxdy) * v10 + (dx - dxdy) * v01
            + (1.0 - dx - dy + dxdy) * v00)


def _nearest_samples(img, x, y, patt_int):
    """img[round(y) + pat_y, round(x) + pat_x] for the integer pattern, the
    rounded centre clamped to the image and then each tap clamped to it:
    what the JAX package computes with `nearest_packed_pattern(
    pack_pattern(img, PATTERN), ...)`. Rounds half to even, as jnp.round.
    img (H, W); x, y (...); patt_int (P, 2) int64. Returns (..., P)."""
    H, W = img.shape
    xr = torch.round(x)
    yr = torch.round(y)
    xi = torch.clamp(torch.where(torch.isnan(xr), torch.zeros_like(xr), xr),
                     0, W - 1).long()
    yi = torch.clamp(torch.where(torch.isnan(yr), torch.zeros_like(yr), yr),
                     0, H - 1).long()
    cx = torch.clamp(xi[..., None] + patt_int[:, 0], 0, W - 1)
    cy = torch.clamp(yi[..., None] + patt_int[:, 1], 0, H - 1)
    return img.reshape(-1)[cy * W + cx]


def _huber_w(ar, cfg):
    return torch.where(ar < cfg.huber_th, torch.ones_like(ar),
                       cfg.huber_th / torch.clamp(ar, min=1e-12))


def trace(pool: ImmaturePool, dI_target, KRKi, Kt, aff, calib: Calibration,
          cfg: Config) -> ImmaturePool:
    """Batched traceOn (ImmaturePoint.cc:47-310) against one new frame.

    KRKi (3,3) or (N,3,3) = K R_target<-host K^-1; Kt (3,) or (N,3); aff
    (2,) or (N,2) host->target brightness transfer."""
    W, H = calib.w[0], calib.h[0]
    dev = pool.u.device
    max_pix_search = (W + H) * cfg.max_pix_search
    patt = _patt(dev)
    N = pool.u.shape[0]
    if KRKi.dim() == 2:
        KRKi = KRKi.expand(N, 3, 3)
        Kt = Kt.expand(N, 3)
        aff = aff.expand(N, 2)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    sticky_oob = pool.status == IPS_OOB
    active = pool.valid & ~sticky_oob

    pr = torch.einsum("nij,nj->ni", KRKi,
                      torch.stack([pool.u, pool.v, torch.ones_like(pool.u)], -1))
    ptp_min = pr + Kt * pool.idepth_min[:, None]
    u_min = ptp_min[:, 0] / ptp_min[:, 2]
    v_min = ptp_min[:, 1] / ptp_min[:, 2]
    inb_min = (u_min > 4) & (v_min > 4) & (u_min < W - 5) & (v_min < H - 5)

    finite_max = torch.isfinite(pool.idepth_max)
    id_max = torch.where(finite_max, pool.idepth_max,
                         torch.full_like(pool.idepth_max, 0.01))
    ptp_max = pr + Kt * id_max[:, None]
    u_max0 = ptp_max[:, 0] / ptp_max[:, 2]
    v_max0 = ptp_max[:, 1] / ptp_max[:, 2]

    dist_f = torch.sqrt((u_min - u_max0) ** 2 + (v_min - v_max0) ** 2)
    dnorm = 1.0 / torch.clamp(dist_f, min=1e-12)
    u_max_inf = u_min + max_pix_search * (u_max0 - u_min) * dnorm
    v_max_inf = v_min + max_pix_search * (v_max0 - v_min) * dnorm
    u_max = torch.where(finite_max, u_max0, u_max_inf)
    v_max = torch.where(finite_max, v_max0, v_max_inf)
    dist = torch.where(finite_max, dist_f,
                       torch.full_like(dist_f, max_pix_search))
    inb_max = (u_max > 4) & (v_max > 4) & (u_max < W - 5) & (v_max < H - 5)

    oob = ~inb_min | ~inb_max
    skipped = finite_max & (dist < cfg.trace_slack_interval) & ~oob
    scale_ok = (pool.idepth_min < 0) | ((ptp_min[:, 2] > 0.75)
                                        & (ptp_min[:, 2] < 1.5))
    oob = oob | (~scale_ok)

    # error bound from gradH (:133-146)
    dx0 = cfg.trace_stepsize * (u_max - u_min)
    dy0 = cfg.trace_stepsize * (v_max - v_min)
    gH = pool.gradH
    a = (dx0 * (gH[:, 0, 0] * dx0 + gH[:, 0, 1] * dy0)
         + dy0 * (gH[:, 1, 0] * dx0 + gH[:, 1, 1] * dy0))
    b_q = (dy0 * (gH[:, 0, 0] * dy0 - gH[:, 0, 1] * dx0)
           - dx0 * (gH[:, 1, 0] * dy0 - gH[:, 1, 1] * dx0))
    error_px = 0.2 + 0.2 * (a + b_q) / torch.clamp(a, min=1e-12)
    badcond = ((error_px * cfg.trace_min_improvement_factor > dist)
               & finite_max & ~oob & ~skipped)
    error_px = torch.clamp(error_px, max=10.0)

    dxn = dx0 / torch.clamp(dist, min=1e-12)
    dyn = dy0 / torch.clamp(dist, min=1e-12)
    clipped = dist > max_pix_search
    u_max = torch.where(clipped, u_min + max_pix_search * dxn, u_max)
    v_max = torch.where(clipped, v_min + max_pix_search * dyn, v_max)
    dist = torch.clamp(dist, max=max_pix_search)
    n_cap = _steps_cap(W, H, cfg)
    n_steps = torch.clamp((1.9999 + dist / cfg.trace_stepsize).to(torch.int32),
                          max=n_cap - 1)
    bad_dir = ~torch.isfinite(dxn) | ~torch.isfinite(dyn)
    oob = oob | bad_dir

    do_search = active & ~oob & ~skipped & ~badcond

    Rp = KRKi[:, :2, :2]
    rot_patt = torch.einsum("pk,njk->npj", patt, Rp)                # (N,8,2)

    rand_shift = u_min * 1000.0 - torch.floor(u_min * 1000.0)
    ptx0 = u_min - rand_shift * dxn
    pty0 = v_min - rand_shift * dyn

    steps = torch.arange(n_cap, dtype=torch.float32, device=dev)
    sx = ptx0[:, None] + steps[None, :] * dxn[:, None]              # (N,S)
    sy = pty0[:, None] + steps[None, :] * dyn[:, None]
    img0 = dI_target[..., 0]
    patt_int = torch.tensor(PATTERN, dtype=torch.int64, device=dev)
    if cfg.trace_search_nearest:
        hit = (_nearest_samples(img0, sx, sy, patt_int) if cfg.trace_packed
               else nearest(img0, sx[:, :, None] + rot_patt[:, None, :, 0],
                            sy[:, :, None] + rot_patt[:, None, :, 1]))
    elif cfg.trace_packed:
        # the default: the unrotated integer pattern around each step
        hit = _search_samples(img0, sx, sy, patt_int)
    else:
        hit = bilinear(img0, sx[:, :, None] + rot_patt[:, None, :, 0],
                       sy[:, :, None] + rot_patt[:, None, :, 1])    # (N,S,8)

    def pattern_energy(h):
        """Huber SSD of each step's pattern samples h (N, S, 8)."""
        res = h - (aff[:, None, None, 0] * pool.color[:, None, :]
                   + aff[:, None, None, 1])
        hw = _huber_w(torch.abs(res), cfg)
        e_pix = torch.where(torch.isfinite(h), hw * res * res * (2.0 - hw),
                            torch.full_like(res, 1e5))
        return torch.sum(e_pix, dim=-1)

    energies = pattern_energy(hit)                                  # (N,S)
    step_live = steps[None, :] < n_steps[:, None].to(torch.float32)
    energies = torch.where(step_live, energies,
                           torch.full_like(energies, 1e10))

    best_idx = torch.argmin(energies, dim=-1)      # first minimum, as jnp
    best_energy = torch.amin(energies, dim=-1)
    best_u = ptx0 + best_idx.to(torch.float32) * dxn
    best_v = pty0 + best_idx.to(torch.float32) * dyn

    # second-best outside +-2 steps -> quality (:213-220)
    far = torch.abs(steps[None, :] - best_idx[:, None].to(torch.float32)) > 2.0
    second = torch.amin(torch.where(far, energies,
                                    torch.full_like(energies, 1e10)), dim=-1)
    new_q = second / torch.clamp(best_energy, min=1e-12)
    quality = torch.where((new_q < pool.quality) | (n_steps > 10), new_q,
                          pool.quality)

    # nearest search: re-score the +-K steps around its argmin with the
    # reference's bilinear energy (rotated pattern), which recovers the
    # bilinear argmin the rounded taps can miss by a step or two
    if cfg.trace_search_nearest and cfg.trace_refine_steps > 0:
        K = cfg.trace_refine_steps
        offs = torch.arange(-K, K + 1, dtype=torch.float32, device=dev)
        cand = best_idx[:, None].to(torch.float32) + offs[None, :]
        cand_live = (cand >= 0) & (cand < n_steps[:, None].to(torch.float32))
        cu = ptx0[:, None] + cand * dxn[:, None]
        cv = pty0[:, None] + cand * dyn[:, None]
        re_sum = pattern_energy(bilinear(
            img0, cu[:, :, None] + rot_patt[:, None, :, 0],
            cv[:, :, None] + rot_patt[:, None, :, 1]))
        re_sum = torch.where(cand_live, re_sum, torch.full_like(re_sum, 1e10))
        j = torch.argmin(re_sum, dim=-1)
        best_energy = torch.amin(re_sum, dim=-1)
        best_u = torch.gather(cu, 1, j[:, None])[:, 0]
        best_v = torch.gather(cv, 1, j[:, None])[:, 0]

    # GN refinement along the line (:223-275)
    def gn_energy_Hb(bu, bv):
        hc = bilinear(dI_target, bu[:, None] + rot_patt[:, :, 0],
                      bv[:, None] + rot_patt[:, :, 1])               # (N,8,3)
        finite = torch.isfinite(hc[..., 0])
        r = hc[..., 0] - (aff[:, None, 0] * pool.color + aff[:, None, 1])
        d = dxn[:, None] * hc[..., 1] + dyn[:, None] * hc[..., 2]
        hw = _huber_w(torch.abs(r), cfg)
        e = torch.where(finite, pool.weights ** 2 * hw * r * r * (2.0 - hw),
                        torch.full_like(r, 1e5))
        Hc = 1.0 + torch.sum(torch.where(finite, hw * d * d, zero), -1)
        bc = torch.sum(torch.where(finite, hw * r * d, zero), -1)
        return torch.sum(e, -1), Hc, bc

    if cfg.trace_gn_iterations > 0:
        bu, bv = best_u, best_v
        ubak, vbak = best_u, best_v
        be = torch.full_like(best_energy, 1e5)
        stepback = torch.zeros_like(best_u)
        done = torch.zeros_like(do_search)
        for _ in range(cfg.trace_gn_iterations):
            e, Hc, bc = gn_energy_Hb(bu, bv)
            worse = e > be
            sb_half = stepback * 0.5
            bu_back = ubak + sb_half * dxn
            bv_back = vbak + sb_half * dyn
            step = torch.clamp(-bc / Hc, -0.5, 0.5)
            step = torch.where(torch.isfinite(step), step, zero)
            bu_fwd = bu + step * dxn
            bv_fwd = bv + step * dyn
            upd = ~done
            keep = upd & ~worse
            n_bu = torch.where(upd, torch.where(worse, bu_back, bu_fwd), bu)
            n_bv = torch.where(upd, torch.where(worse, bv_back, bv_fwd), bv)
            ubak = torch.where(keep, bu, ubak)
            vbak = torch.where(keep, bv, vbak)
            stepback = torch.where(upd, torch.where(worse, sb_half, step),
                                   stepback)
            be = torch.where(keep, e, be)
            done = done | (torch.abs(torch.where(worse, sb_half, step))
                           < cfg.trace_gn_threshold)
            bu, bv = n_bu, n_bv
        best_u, best_v, best_energy = bu, bv, be

    # energy-based outlier (:278-287)
    is_outlier = ~(best_energy < pool.energy_th * cfg.trace_extra_slack_on_th)
    was_outlier = pool.status == IPS_OUTLIER
    outlier_to_oob = is_outlier & was_outlier

    # new idepth interval (:290-303)
    use_x = dxn * dxn > dyn * dyn
    px_lo = torch.where(use_x, best_u - error_px * dxn, best_v - error_px * dyn)
    px_hi = torch.where(use_x, best_u + error_px * dxn, best_v + error_px * dyn)
    pr_a = torch.where(use_x, pr[:, 0], pr[:, 1])
    kt_a = torch.where(use_x, Kt[:, 0], Kt[:, 1])
    id_lo = (pr[:, 2] * px_lo - pr_a) / (kt_a - Kt[:, 2] * px_lo)
    id_hi = (pr[:, 2] * px_hi - pr_a) / (kt_a - Kt[:, 2] * px_hi)
    new_min = torch.minimum(id_lo, id_hi)
    new_max = torch.maximum(id_lo, id_hi)
    interval_bad = (~torch.isfinite(new_min)) | (~torch.isfinite(new_max)) \
        | (new_max < 0)

    good = do_search & ~is_outlier & ~interval_bad

    i32 = lambda c: torch.full((), c, dtype=torch.int32, device=dev)  # noqa: E731
    status = pool.status
    status = torch.where(active & oob, i32(IPS_OOB), status)
    status = torch.where(active & ~oob & skipped, i32(IPS_SKIPPED), status)
    status = torch.where(active & badcond, i32(IPS_BADCONDITION), status)
    status = torch.where(do_search & (is_outlier | interval_bad),
                         torch.where(outlier_to_oob, i32(IPS_OOB),
                                     i32(IPS_OUTLIER)), status)
    status = torch.where(good, i32(IPS_GOOD), status)

    mid_u = (u_max + u_min) * 0.5
    mid_v = (v_max + v_min) * 0.5
    sb = active & (skipped | badcond)
    last_u = torch.where(good, best_u, torch.where(sb, mid_u, pool.last_u))
    last_v = torch.where(good, best_v, torch.where(sb, mid_v, pool.last_v))
    lost = active & (oob | (do_search & (is_outlier | interval_bad)))
    neg1 = torch.full((), -1.0, dtype=torch.float32, device=dev)
    last_u = torch.where(lost, neg1, last_u)
    last_v = torch.where(lost, neg1, last_v)
    last_int = torch.where(good, 2.0 * error_px,
                           torch.where(sb, dist, torch.where(
                               active, zero, pool.last_interval)))

    return pool._replace(
        idepth_min=torch.where(good, new_min, pool.idepth_min),
        idepth_max=torch.where(good, new_max, pool.idepth_max),
        quality=torch.where(do_search, quality, pool.quality),
        status=status, last_u=last_u, last_v=last_v, last_interval=last_int,
    )


# ---------------------------------------------------------------------------
# flat candidate arena: ONE pool with a per-candidate host index
# ---------------------------------------------------------------------------

class ImmatureArena(NamedTuple):
    pool: ImmaturePool       # flat (N,) fields
    host: torch.Tensor       # (N,) int32 window slot of each candidate; -1 dead


def empty_arena(N: int, cfg: Config, device) -> ImmatureArena:
    f32 = dict(dtype=torch.float32, device=device)
    z = lambda *sh: torch.zeros((N,) + sh, **f32)  # noqa: E731
    pool = ImmaturePool(
        u=z(), v=z(), valid=torch.zeros(N, dtype=torch.bool, device=device),
        color=z(8), weights=z(8), gradH=z(2, 2),
        idepth_min=z(), idepth_max=torch.full((N,), float("inf"), **f32),
        quality=z(), energy_th=z(),
        status=torch.full((N,), IPS_UNINITIALIZED, dtype=torch.int32,
                          device=device),
        last_u=z(), last_v=z(), last_interval=z(),
        my_type=torch.zeros(N, dtype=torch.int32, device=device))
    return ImmatureArena(pool=pool,
                         host=torch.full((N,), -1, dtype=torch.int32,
                                         device=device))


def arena_add(arena: ImmatureArena, new_pool: ImmaturePool, host_idx: int):
    """Move a freshly selected pool into free arena slots: the k-th valid
    candidate goes to the k-th free slot, overflow is dropped."""
    N = arena.host.shape[0]
    cap = new_pool.u.shape[0]
    free = nonzero_padded(~arena.pool.valid, cap, N)
    rank = torch.cumsum(new_pool.valid.to(torch.int64), 0) - 1
    slot = torch.where(new_pool.valid, free[torch.clamp(rank, 0, cap - 1)],
                       torch.full_like(rank, N))
    keep = slot < N          # drop out-of-range slots before the scatter
    dst = slot[keep]

    def put(d, s):
        d = d.clone()
        d[dst] = s[keep].to(d.dtype)
        return d

    pool = ImmaturePool(*[put(d, s) for d, s in zip(arena.pool, new_pool)])
    host = arena.host.clone()
    host[dst] = int(host_idx)
    return ImmatureArena(pool=pool, host=host)


def arena_add_from_status(arena: ImmatureArena, status_map, dI0, host_idx,
                          cap: int, cfg: Config):
    """make_pool + arena_add (the per-keyframe candidate creation)."""
    return arena_add(arena, make_pool(status_map, dI0, cap, cfg), host_idx)


def trace_arena(arena: ImmatureArena, dI_target, KRKis, Kts, affs,
                calib: Calibration, cfg: Config) -> ImmatureArena:
    """traceNewCoarse over the arena with per-candidate host->new
    transforms gathered from the (F, ...) tables."""
    h = torch.clamp(arena.host, 0, KRKis.shape[0] - 1).long()
    pool = arena.pool._replace(valid=arena.pool.valid & (arena.host >= 0))
    traced = trace(pool, dI_target, KRKis[h], Kts[h], affs[h], calib, cfg)
    return arena._replace(pool=traced._replace(valid=arena.pool.valid))


def trace_arena_prefix(arena: ImmatureArena, dI_target, KRKis, Kts, affs,
                       calib: Calibration, cfg: Config, n: int) -> ImmatureArena:
    """trace_arena restricted to the first `n` lanes: live candidates form
    a contiguous prefix after `arena_compact`, and lanes past it are dead,
    which `trace` leaves untouched."""
    if n >= arena.host.shape[0]:
        return trace_arena(arena, dI_target, KRKis, Kts, affs, calib, cfg)
    pre = ImmatureArena(pool=ImmaturePool(*[x[:n] for x in arena.pool]),
                        host=arena.host[:n])
    traced = trace_arena(pre, dI_target, KRKis, Kts, affs, calib, cfg)
    return ImmatureArena(
        pool=ImmaturePool(*[torch.cat([t, f[n:]]) for f, t
                            in zip(arena.pool, traced.pool)]),
        host=arena.host)


def arena_watermark(arena: ImmatureArena) -> int:
    """Index of the last live lane + 1 (one host read)."""
    live = arena.pool.valid & (arena.host >= 0)
    lanes = torch.arange(1, live.shape[0] + 1, device=live.device)
    return int(torch.amax(torch.where(live, lanes, torch.zeros_like(lanes))).item())


def arena_compact(arena: ImmatureArena) -> ImmatureArena:
    """Stable-partition live candidates into a contiguous prefix."""
    live = arena.pool.valid & (arena.host >= 0)
    order = torch.argsort((~live).to(torch.int32), stable=True)
    pool = ImmaturePool(*[x[order] for x in arena.pool])
    host = arena.host[order]
    live_p = pool.valid & (host >= 0)
    return ImmatureArena(pool=pool._replace(valid=live_p),
                         host=torch.where(live_p, host, torch.full_like(host, -1)))


def arena_counts(arena: ImmatureArena, F: int):
    """(F,) live-candidate counts per host slot."""
    live = (arena.pool.valid & (arena.host >= 0)).to(torch.int64)
    h = torch.clamp(arena.host, 0, F - 1).long()
    return torch.zeros(F, dtype=torch.int64, device=h.device).index_add_(
        0, h, live)


def arena_counts_and_watermark(arena: ImmatureArena, F: int):
    """(F+1,) = per-host live counts ++ [watermark]."""
    live = arena.pool.valid & (arena.host >= 0)
    lanes = torch.arange(1, live.shape[0] + 1, device=live.device)
    wm = torch.amax(torch.where(live, lanes, torch.zeros_like(lanes)))
    return torch.cat([arena_counts(arena, F), wm[None]])


def arena_marg_shift(arena: ImmatureArena, idx: int) -> ImmatureArena:
    """Host slot idx leaves the window: kill its candidates, renumber."""
    valid = arena.pool.valid & (arena.host != idx)
    host = torch.where(arena.host > idx, arena.host - 1, arena.host)
    return ImmatureArena(pool=arena.pool._replace(valid=valid), host=host)


def arena_mask(arena: ImmatureArena, remove) -> ImmatureArena:
    return arena._replace(
        pool=arena.pool._replace(valid=arena.pool.valid & ~remove))


def activate_arena(arena: ImmatureArena, idepth0, cand_valid, Rs_all, ts_all,
                   affs_all, target_masks, dIs, calib: Calibration,
                   cfg: Config):
    """Flat activation against all window frames with per-candidate precalc
    gathered from the (F, T, ...) tables. Returns (N, 3) = [new idepth, ok,
    n_good]."""
    h = torch.clamp(arena.host, 0, Rs_all.shape[0] - 1).long()
    p = arena.pool
    new_id, ok, n_good, _ = activate(
        p.u, p.v, p.color, p.weights, p.energy_th, idepth0,
        cand_valid & (arena.host >= 0),
        Rs_all[h], ts_all[h], affs_all[h], target_masks[h], dIs, calib, cfg)
    return torch.stack([new_id, ok.to(torch.float32),
                        n_good.to(torch.float32)], dim=-1)


# ---------------------------------------------------------------------------
# activation (depth-only GN over all window frames)
# ---------------------------------------------------------------------------

def linearize_depth_residual(u, v, color, weights, energy_th, idepth,
                             R, t, affLL, dI_target, calib: Calibration,
                             cfg: Config, outlier_slack):
    """One (point x target) depth-only residual (linearizeResidual,
    ImmaturePoint.cc:312-381). R/t/affLL shared ((3,3)/(3,)/(2,)) or
    per-candidate. Returns (energy, Hdd, bd, state)."""
    fx, fy = calib.fx[0], calib.fy[0]
    cx, cy = calib.cx[0], calib.cy[0]
    W, H = calib.w[0], calib.h[0]
    dev = u.device
    patt = _patt(dev)
    N = u.shape[0]
    if R.dim() == 2:
        R = R.expand(N, 3, 3)
        t = t.expand(N, 3)
        affLL = affLL.expand(N, 2)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    KliP = torch.stack([
        (u[:, None] + patt[None, :, 0] - cx) / fx,
        (v[:, None] + patt[None, :, 1] - cy) / fy,
        torch.ones((N, 8), dtype=torch.float32, device=dev)], dim=-1)
    ptp = (torch.einsum("nij,npj->npi", R, KliP)
           + t[:, None, :] * idepth[:, None, None])
    drescale = 1.0 / ptp[..., 2]
    uu = ptp[..., 0] * drescale
    vv = ptp[..., 1] * drescale
    Ku = uu * fx + cx
    Kv = vv * fy + cy
    inb = (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < W - 3) & (Kv < H - 3)

    hit = bilinear(dI_target, Ku, Kv)
    pix_ok = inb & torch.isfinite(hit[..., 0])
    oob = ~torch.all(pix_ok, dim=-1)

    r = hit[..., 0] - (affLL[:, None, 0] * color + affLL[:, None, 1])
    hw = _huber_w(torch.abs(r), cfg)
    w2 = weights * weights
    energy = torch.sum(torch.where(pix_ok, w2 * hw * r * r * (2.0 - hw), zero), -1)

    dxI = hit[..., 1] * fx
    dyI = hit[..., 2] * fy
    d_id = (dxI * drescale * (t[:, 0:1] - t[:, 2:3] * uu)
            + dyI * drescale * (t[:, 1:2] - t[:, 2:3] * vv))
    hww = hw * w2
    Hdd = torch.sum(torch.where(pix_ok, hww * d_id * d_id, zero), -1)
    bd = torch.sum(torch.where(pix_ok, hww * r * d_id, zero), -1)

    lim = energy_th * outlier_slack
    over = energy > lim
    energy = torch.where(over, lim, energy)
    i32 = lambda c: torch.full((), c, dtype=torch.int32, device=dev)  # noqa: E731
    state = torch.where(oob, i32(RES_OOB),
                        torch.where(over, i32(RES_OUTLIER), i32(RES_IN)))
    Hdd = torch.where(oob, zero, Hdd)
    bd = torch.where(oob, zero, bd)
    return energy, Hdd, bd, state


def activate(u, v, color, weights, energy_th, idepth0, cand_valid,
             Rs, ts, affs, target_mask, dIs, calib: Calibration, cfg: Config):
    """Batched optimizeImmaturePoint (FullSystem.cc:892-1010): depth-only
    LM for every candidate against every window frame. Rs (T,3,3) / ts
    (T,3) / affs (T,2) / target_mask (T,) or per-candidate (N,T,...); dIs
    (T,H,W,3). Returns (idepth, ok, n_good_res, state (N,T))."""
    N = u.shape[0]
    dev = u.device
    if Rs.dim() == 3:
        Rs = Rs.expand((N,) + Rs.shape)
        ts = ts.expand((N,) + ts.shape)
        affs = affs.expand((N,) + affs.shape)
        target_mask = target_mask.expand((N,) + target_mask.shape)
    T = Rs.shape[1]
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def all_targets(idepth, slack):
        es, Hs, bs, sts = 0.0, 0.0, 0.0, []
        for k in range(T):
            e, Hdd, bd, st = linearize_depth_residual(
                u, v, color, weights, energy_th, idepth,
                Rs[:, k], ts[:, k], affs[:, k], dIs[k], calib, cfg, slack)
            live = target_mask[:, k]
            es = es + torch.where(live, e, zero)
            Hs = Hs + torch.where(live, Hdd, zero)
            bs = bs + torch.where(live, bd, zero)
            sts.append(torch.where(live, st, torch.full_like(st, RES_OOB)))
        return es, Hs, bs, torch.stack(sts, dim=-1)

    idepth = idepth0
    e, Hc, bc, st = all_targets(idepth, 1000.0)
    lam = torch.full_like(idepth, 0.1)
    done = torch.zeros_like(cand_valid)
    for _ in range(cfg.gn_its_on_point_activation):
        step = (1.0 / (Hc * (1.0 + lam) + 1e-12)) * bc
        new_id = idepth - step
        e2, H2, b2, st2 = all_targets(new_id, 1.0)
        accept = e2 < e
        upd = ~done
        take = accept & upd
        converged = torch.abs(step) < 1e-4 * torch.abs(idepth)
        idepth = torch.where(take, new_id, idepth)
        e = torch.where(take, e2, e)
        Hc = torch.where(take, H2, Hc)
        bc = torch.where(take, b2, bc)
        st = torch.where(take[:, None], st2, st)
        lam = torch.where(upd, torch.where(accept, lam * 0.5, lam * 5.0), lam)
        done = done | converged
    n_good = torch.sum((st == RES_IN) & target_mask, dim=-1)
    ok = (cand_valid & torch.isfinite(e) & torch.isfinite(idepth)
          & (Hc >= cfg.min_idepth_h_act))
    return idepth, ok, n_good, st
