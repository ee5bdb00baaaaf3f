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

`trace` is the plain PyTorch version of K4 (csrc/immature_trace.cu). It
rounds as the JAX package's jitted trace does on the CPU: XLA:CPU
contracts a multiply into the add that consumes it (the projection
K R K^-1 (u, v, 1), the interval's ends and error bound, each step's
position, the bilinear blend, the residual's affine model, the GN's
gradient and steps), which the plain version writes with
math/rounding.fma (one rounding, alike on the CPU and the card), sums
the 8 taps left to right (`_tap_sum`) and divides the Huber threshold by
|r| (`_huber_div`); K4 computes the same function in the same order.
`trace_arena` goes through the wrapper `ops.cuda_kernels.trace_arena` (K4
on the card, one launch over the whole arena); `trace_arena_ref` is its
plain version.

`activate_arena_ref` is the plain version of K5 (csrc/immature_activate.cu),
the keyframe's activation of every lane of the arena: the gate
(`gate_candidates`) and the depth-only LM (`activate`'s), written out in
K5's order; FullSystem reaches it through `ops.cuda_kernels.activate_arena`.
The activation's LM residual rounds as the JAX package's jitted activation
does on the CPU (read off its outputs, `tests/tools/trace_rounding.py
--activation`): the pattern rays times the focal lengths' float32
reciprocals (`_focal_reciprocal`), XLA's contractions of the projection
rows, the pixel, the blend (`_bilinear`), the residual's affine model and
the depth derivative (`fma`), the 8 taps in `_sum8`'s tree and the Huber
weight as a multiply by |r|'s reciprocal (`_huber_w`). The gate keeps its
written-out order. So the two tap sums (`_tap_sum` the trace's, `_sum8`
the activation's and the BA's) and the two Huber weights (`_huber_div`
the trace's, `_huber_w` the activation's) are each one function in the
two roundings the JAX package's jitted programs have, and K4 and K5 copy
their own.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ldso_tpu_torch.config import Config, PATTERN
from ldso_tpu_torch.camera.calib import Calibration
from ldso_tpu_torch.math.rounding import fma
from ldso_tpu_torch.ops.interp import _floor_index, bilinear, nearest
from ldso_tpu_torch.ops import cuda_kernels
from ldso_tpu_torch.utils.static import device_const, nonzero_padded

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


_PATTERN = tuple(tuple(int(c) for c in p) for p in PATTERN)


def _patt(device, dtype=torch.float32):
    return device_const(_PATTERN, device, dtype)


def _sum8(x):
    """The sum over the last axis (8 pattern taps) in the tree
    ((x0 + x1) + (x2 + x3)) + ((x4 + x5) + (x6 + x7)): the activation's
    (K5's; the order in which the JAX package's jitted activation gives
    its bits) and the BA residual's (K6's). The trace sums left to right
    (`_tap_sum`)."""
    x = x[..., 0::2] + x[..., 1::2]
    x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0] + x[..., 1]


def _first_min(e):
    """(index, value) of the first minimum over the last axis, as
    jnp.argmin: the lowest index on a tie, a NaN before any number."""
    return torch.argmin(e, dim=-1), torch.amin(e, dim=-1)


def make_pool(status_map, dI0, cap: int, cfg: Config) -> ImmaturePool:
    """Pool from a selection status map ((H,W) int, 0 = unselected). Reads
    nothing back from the card."""
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
    return _blend(dx, dy, v00, v01, v10, v11)


def _blend(dx, dy, v00, v01, v10, v11):
    """The bilinear weights of GlobalFuncs.h:55-67 applied as the JAX
    package's jitted trace applies them: XLA:CPU contracts each of the last
    three products into the sum before it (`fma`)."""
    dxdy = dx * dy
    s = fma(dxdy, v11, (dy - dxdy) * v10)
    s = fma(dx - dxdy, v01, s)
    return fma(1.0 - dx - dy + dxdy, v00, s)


def _bilinear(img, x, y):
    """interp.bilinear with the trace's `_blend`: the rotated search, the
    re-score and the GN's samples, as the jitted trace samples them."""
    H, W = img.shape[0], img.shape[1]
    x, x0, xi = _floor_index(x, W - 1.001)
    y, y0, yi = _floor_index(y, H - 1.001)
    dx = x - x0
    dy = y - y0
    flat = img.reshape((H * W,) + tuple(img.shape[2:]))
    idx = yi * W + xi
    if img.dim() == 3:
        dx = dx[..., None]
        dy = dy[..., None]
    return _blend(dx, dy, flat[idx], flat[idx + 1], flat[idx + W],
                  flat[idx + W + 1])


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


def _tap_sum(x):
    """The trace's sum over the last axis (8 pattern taps), left to right,
    as the JAX package's jitted `jnp.sum` adds them on the CPU."""
    s = x[..., 0]
    for p in range(1, x.shape[-1]):
        s = s + x[..., p]
    return s


def _huber_div(ar, cfg):
    """The trace's Huber weight: huber_th / |r| as one division, as the
    JAX package's jitted trace divides (`_huber_w` multiplies by the
    reciprocal, as the activation does)."""
    th = torch.full((), cfg.huber_th, dtype=ar.dtype, device=ar.device)
    return torch.where(ar < cfg.huber_th, torch.ones_like(ar),
                       th / torch.clamp(ar, min=1e-12))


def _huber_w(ar, cfg):
    """The activation's Huber weight (K5's): huber_th times |r|'s
    reciprocal, as torch computes a Python scalar over a tensor and as the
    JAX package's jitted activation gives its bits. The trace divides
    (`_huber_div`)."""
    return torch.where(ar < cfg.huber_th, torch.ones_like(ar),
                       cfg.huber_th / torch.clamp(ar, min=1e-12))


def trace(pool: ImmaturePool, dI_target, KRKi, Kt, aff, calib: Calibration,
          cfg: Config, parts: Optional[dict] = None) -> ImmaturePool:
    """Batched traceOn (ImmaturePoint.cc:47-310) against one new frame: the
    plain version of K4.

    KRKi (3,3) or (N,3,3) = K R_target<-host K^-1; Kt (3,) or (N,3); aff
    (2,) or (N,2) host->target brightness transfer. `parts`, when given,
    gets the intermediate values that tests/torch_kernel_checks.trace_err
    reads the plain version's ties from."""
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

    # K R K^-1 (u, v, 1), each row fma(k1, v, k0 u) + k2
    pr = fma(KRKi[:, :, 1], pool.v[:, None],
             KRKi[:, :, 0] * pool.u[:, None]) + KRKi[:, :, 2]
    ptp_min = fma(Kt, pool.idepth_min[:, None], pr)
    u_min = ptp_min[:, 0] / ptp_min[:, 2]
    v_min = ptp_min[:, 1] / ptp_min[:, 2]
    inb_min = (u_min > 4) & (v_min > 4) & (u_min < W - 5) & (v_min < H - 5)

    finite_max = torch.isfinite(pool.idepth_max)
    id_max = torch.where(finite_max, pool.idepth_max,
                         torch.full_like(pool.idepth_max, 0.01))
    ptp_max = fma(Kt, id_max[:, None], pr)
    u_max0 = ptp_max[:, 0] / ptp_max[:, 2]
    v_max0 = ptp_max[:, 1] / ptp_max[:, 2]

    du = u_min - u_max0
    dv = v_min - v_max0
    dist_f = torch.sqrt(fma(du, du, dv * dv))
    dnorm = 1.0 / torch.clamp(dist_f, min=1e-12)
    u_max_inf = fma(max_pix_search * (u_max0 - u_min), dnorm, u_min)
    v_max_inf = fma(max_pix_search * (v_max0 - v_min), dnorm, v_min)
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
    g00, g01 = pool.gradH[:, 0, 0], pool.gradH[:, 0, 1]
    g10, g11 = pool.gradH[:, 1, 0], pool.gradH[:, 1, 1]
    a = fma(dx0, fma(g01, dy0, g00 * dx0), dy0 * fma(g10, dx0, g11 * dy0))
    b_q = fma(dy0, fma(g00, dy0, -(g01 * dx0)),
              -(dx0 * fma(g10, dy0, -(g11 * dx0))))
    error_px = 0.2 + 0.2 * (a + b_q) / torch.clamp(a, min=1e-12)
    badcond = ((error_px * cfg.trace_min_improvement_factor > dist)
               & finite_max & ~oob & ~skipped)
    error_px = torch.clamp(error_px, max=10.0)

    dxn = dx0 / torch.clamp(dist, min=1e-12)
    dyn = dy0 / torch.clamp(dist, min=1e-12)
    clipped = dist > max_pix_search
    u_max = torch.where(clipped, fma(max_pix_search, dxn, u_min), u_max)
    v_max = torch.where(clipped, fma(max_pix_search, dyn, v_min), v_max)
    dist = torch.clamp(dist, max=max_pix_search)
    n_cap = _steps_cap(W, H, cfg)
    steps_f = 1.9999 + dist / cfg.trace_stepsize
    n_steps = torch.clamp(steps_f.to(torch.int32), max=n_cap - 1)
    bad_dir = ~torch.isfinite(dxn) | ~torch.isfinite(dyn)
    oob = oob | bad_dir

    do_search = active & ~oob & ~skipped & ~badcond

    # the pattern rotated by K R K^-1's 2x2 block, (px r0 + py r1) per row
    Rp = KRKi[:, :2, :2]
    rot_patt = (patt[None, :, None, 0] * Rp[:, None, :, 0]
                + patt[None, :, None, 1] * Rp[:, None, :, 1])    # (N,8,2)

    rand_shift = u_min * 1000.0 - torch.floor(u_min * 1000.0)
    ptx0 = fma(-rand_shift, dxn, u_min)
    pty0 = fma(-rand_shift, dyn, v_min)

    steps = torch.arange(n_cap, dtype=torch.float32, device=dev)
    sx = fma(steps[None, :], dxn[:, None], ptx0[:, None])           # (N,S)
    sy = fma(steps[None, :], dyn[:, None], pty0[:, None])
    img0 = dI_target[..., 0]
    patt_int = _patt(dev, torch.int64)
    if cfg.trace_search_nearest:
        hit = (_nearest_samples(img0, sx, sy, patt_int) if cfg.trace_packed
               else nearest(img0, sx[:, :, None] + rot_patt[:, None, :, 0],
                            sy[:, :, None] + rot_patt[:, None, :, 1]))
    elif cfg.trace_packed:
        # the default: the unrotated integer pattern around each step
        hit = _search_samples(img0, sx, sy, patt_int)
    else:
        hit = _bilinear(img0, sx[:, :, None] + rot_patt[:, None, :, 0],
                        sy[:, :, None] + rot_patt[:, None, :, 1])   # (N,S,8)

    def pattern_energy(h):
        """Huber SSD of each step's pattern samples h (N, S, 8)."""
        res = h - fma(aff[:, None, None, 0], pool.color[:, None, :],
                      aff[:, None, None, 1])
        hw = _huber_div(torch.abs(res), cfg)
        e_pix = torch.where(torch.isfinite(h), hw * res * res * (2.0 - hw),
                            torch.full_like(res, 1e5))
        return _tap_sum(e_pix)

    energies = pattern_energy(hit)                                  # (N,S)
    step_live = steps[None, :] < n_steps[:, None].to(torch.float32)
    energies = torch.where(step_live, energies,
                           torch.full_like(energies, 1e10))

    best_idx, best_energy = _first_min(energies)
    best_u = fma(best_idx.to(torch.float32), dxn, ptx0)
    best_v = fma(best_idx.to(torch.float32), dyn, pty0)

    # second-best outside +-2 steps -> quality (:213-220)
    far = torch.abs(steps[None, :] - best_idx[:, None].to(torch.float32)) > 2.0
    second = torch.amin(torch.where(far, energies,
                                    torch.full_like(energies, 1e10)), dim=-1)
    new_q = second / torch.clamp(best_energy, min=1e-12)
    quality = torch.where((new_q < pool.quality) | (n_steps > 10), new_q,
                          pool.quality)
    if parts is not None:
        parts.update(active=active, do_search=do_search, steps_f=steps_f,
                     n_steps=n_steps, energies=energies, best_idx=best_idx,
                     dxn=dxn, dyn=dyn, ptx0=ptx0, pty0=pty0,
                     rot_patt=rot_patt, u_min=u_min)

    # nearest search: re-score the +-K steps around its argmin with the
    # reference's bilinear energy (rotated pattern), which recovers the
    # bilinear argmin the rounded taps can miss by a step or two
    if cfg.trace_search_nearest and cfg.trace_refine_steps > 0:
        K = cfg.trace_refine_steps
        offs = torch.arange(-K, K + 1, dtype=torch.float32, device=dev)
        cand = best_idx[:, None].to(torch.float32) + offs[None, :]
        cand_live = (cand >= 0) & (cand < n_steps[:, None].to(torch.float32))
        cu = fma(cand, dxn[:, None], ptx0[:, None])
        cv = fma(cand, dyn[:, None], pty0[:, None])
        re_sum = pattern_energy(_bilinear(
            img0, cu[:, :, None] + rot_patt[:, None, :, 0],
            cv[:, :, None] + rot_patt[:, None, :, 1]))
        re_sum = torch.where(cand_live, re_sum, torch.full_like(re_sum, 1e10))
        j, best_energy = _first_min(re_sum)
        best_u = torch.gather(cu, 1, j[:, None])[:, 0]
        best_v = torch.gather(cv, 1, j[:, None])[:, 0]
        if parts is not None:
            parts.update(re_sum=re_sum, re_idx=j)

    # GN refinement along the line (:223-275)
    def gn_energy_Hb(bu, bv):
        hc = _bilinear(dI_target, bu[:, None] + rot_patt[:, :, 0],
                       bv[:, None] + rot_patt[:, :, 1])              # (N,8,3)
        finite = torch.isfinite(hc[..., 0])
        r = hc[..., 0] - fma(aff[:, None, 0], pool.color, aff[:, None, 1])
        d = fma(dxn[:, None], hc[..., 1], dyn[:, None] * hc[..., 2])
        hw = _huber_div(torch.abs(r), cfg)
        e = torch.where(finite, pool.weights ** 2 * hw * r * r * (2.0 - hw),
                        torch.full_like(r, 1e5))
        Hc = 1.0 + _tap_sum(torch.where(finite, hw * d * d, zero))
        b_terms = torch.where(finite, hw * r * d, zero)
        if parts is not None:
            parts.setdefault("gn_b_abs", []).append(
                _tap_sum(torch.abs(b_terms)))
        return _tap_sum(e), Hc, _tap_sum(b_terms)

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
            bu_back = fma(sb_half, dxn, ubak)
            bv_back = fma(sb_half, dyn, vbak)
            step = torch.clamp(-bc / Hc, -0.5, 0.5)
            step = torch.where(torch.isfinite(step), step, zero)
            bu_fwd = fma(step, dxn, bu)
            bv_fwd = fma(step, dyn, bv)
            upd = ~done
            keep = upd & ~worse
            if parts is not None:
                parts.setdefault("gn", []).append(dict(
                    upd=upd, e=e, be=be, Hc=Hc, bu=bu, bv=bv,
                    moved=torch.where(worse, sb_half, step)))
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
    outlier_th = pool.energy_th * cfg.trace_extra_slack_on_th
    is_outlier = ~(best_energy < outlier_th)
    was_outlier = pool.status == IPS_OUTLIER
    outlier_to_oob = is_outlier & was_outlier

    # new idepth interval (:290-303)
    use_x = dxn * dxn > dyn * dyn
    px_lo = torch.where(use_x, fma(-error_px, dxn, best_u),
                        fma(-error_px, dyn, best_v))
    px_hi = torch.where(use_x, fma(error_px, dxn, best_u),
                        fma(error_px, dyn, best_v))
    pr_a = torch.where(use_x, pr[:, 0], pr[:, 1])
    kt_a = torch.where(use_x, Kt[:, 0], Kt[:, 1])
    id_lo = fma(pr[:, 2], px_lo, -pr_a) / fma(-Kt[:, 2], px_lo, kt_a)
    id_hi = fma(pr[:, 2], px_hi, -pr_a) / fma(-Kt[:, 2], px_hi, kt_a)
    new_min = torch.minimum(id_lo, id_hi)
    new_max = torch.maximum(id_lo, id_hi)
    interval_bad = (~torch.isfinite(new_min)) | (~torch.isfinite(new_max)) \
        | (new_max < 0)
    if parts is not None:
        parts.update(best_energy=best_energy, outlier_th=outlier_th,
                     bounds=[(fma(pr[:, 2], px, -pr_a),
                              fma(-Kt[:, 2], px, kt_a),
                              pr[:, 2] * px, Kt[:, 2] * px, pr_a, kt_a)
                             for px in (px_lo, px_hi)])

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


def arena_add(arena: ImmatureArena, new_pool: ImmaturePool, host_idx):
    """Move a freshly selected pool into free arena slots: the k-th valid
    candidate goes to the k-th free slot, overflow is dropped. host_idx:
    the host's window slot, an int or a 0-d integer tensor on the arena's
    device. Reads nothing back from the card: the dropped candidates write
    a spare lane past the arena that is then cut."""
    N = arena.host.shape[0]
    cap = new_pool.u.shape[0]
    dev = arena.host.device
    free = nonzero_padded(~arena.pool.valid, cap, N)
    rank = torch.cumsum(new_pool.valid.to(torch.int64), 0) - 1
    slot = torch.where(new_pool.valid, free[torch.clamp(rank, 0, cap - 1)],
                       torch.full_like(rank, N))
    hosts = torch.zeros(cap, dtype=torch.int32, device=dev) + host_idx

    def put(d, s):
        d = torch.cat([d, d[:1]])
        d.index_copy_(0, slot, s.to(d.dtype))
        return d[:N]

    pool = ImmaturePool(*[put(d, s) for d, s in zip(arena.pool, new_pool)])
    return ImmatureArena(pool=pool, host=put(arena.host, hosts))


def arena_add_from_status(arena: ImmatureArena, status_map, dI0, host_idx,
                          cap: int, cfg: Config):
    """make_pool + arena_add (the per-keyframe candidate creation); reads
    nothing back from the card."""
    return arena_add(arena, make_pool(status_map, dI0, cap, cfg), host_idx)


def trace_arena_ref(arena: ImmatureArena, dI_target, KRKis, Kts, affs,
                    calib: Calibration, cfg: Config,
                    parts: Optional[dict] = None) -> ImmatureArena:
    """traceNewCoarse over the arena with per-candidate host->new
    transforms gathered from the (F, ...) tables: the plain version of K4
    (`parts` as `trace`'s)."""
    h = torch.clamp(arena.host, 0, KRKis.shape[0] - 1).long()
    pool = arena.pool._replace(valid=arena.pool.valid & (arena.host >= 0))
    traced = trace(pool, dI_target, KRKis[h], Kts[h], affs[h], calib, cfg,
                   parts)
    return arena._replace(pool=traced._replace(valid=arena.pool.valid))


def trace_arena(arena: ImmatureArena, dI_target, KRKis, Kts, affs,
                calib: Calibration, cfg: Config) -> ImmatureArena:
    """trace_arena_ref's function through its wrapper: on the card one K4
    launch over every lane (dead lanes pass through untouched), on the CPU
    the plain version."""
    return cuda_kernels.trace_arena(arena, dI_target, KRKis, Kts, affs,
                                    calib, cfg)


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
    """Stable-partition live candidates into a contiguous prefix (a stable
    argsort, so live lanes keep their order); reads nothing back from the
    card."""
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




# ---------------------------------------------------------------------------
# activation: the gate, then a depth-only LM over all window frames. The
# plain version of K5 (csrc/immature_activate.cu), written out in K5's
# order of operations (the gate's projection as (r0 u + r1 v) + r2 + t
# idm; the LM residual's rays times the focal lengths' float32
# reciprocals, its rows fma(r1, y, r0 x) + r2 + t idepth, its pixel,
# blend, affine model and depth derivative contracted as XLA:CPU does;
# every 8-tap sum in `_sum8`'s tree, the targets summed in slot order, a
# Python scalar over a tensor as its reciprocal times the scalar)
# ---------------------------------------------------------------------------

def _focal_reciprocal(calib: Calibration, dev):
    """(1 / fx, 1 / fy) rounded to float32, as 0-d tensors on `dev`: the
    JAX package's jitted activation multiplies by them where it divides
    by the focal length (XLA turns a division by a constant into a
    multiply by its reciprocal)."""
    import numpy as np
    one = np.float32(1.0)
    return device_const((float(one / np.float32(calib.fx[0])),
                         float(one / np.float32(calib.fy[0]))), dev)


def gate_candidates(pool: ImmaturePool, KRKi, Kt, dist_map, min_act_dist,
                    marg_flag, cfg: Config, parts: Optional[dict] = None):
    """Activation gating of candidates (activatePointsMT candidate loop,
    FullSystem.cc:1089-1160) against the newest keyframe at pyramid level
    1: KRKi (N, 3, 3) and Kt (N, 3) from each candidate's host, dist_map
    (h1, w1) the distance map of the window's points there, marg_flag (N,)
    its host's marginalization flag, min_act_dist a float or a 0-d tensor.
    Returns (to_opt, remove, idm). `parts`, when given, gets what
    tests/torch_kernel_checks.activate_ties reads."""
    h1, w1 = dist_map.shape
    st = pool.status
    valid = pool.valid
    id_max = pool.idepth_max
    finite_max = torch.isfinite(id_max)
    drop = valid & (~finite_max | (st == IPS_OUTLIER))
    can = (valid & ~drop
           & ((st == IPS_GOOD) | (st == IPS_SKIPPED)
              | (st == IPS_BADCONDITION) | (st == IPS_OOB))
           & (pool.last_interval < 8.0)
           & (pool.quality > cfg.min_trace_quality)
           & (id_max + pool.idepth_min > 0))
    kill = valid & ~drop & ~can & (marg_flag | (st == IPS_OOB))

    idm = 0.5 * (torch.where(finite_max, id_max, torch.zeros_like(id_max))
                 + pool.idepth_min)
    # K R K^-1 (u, v, 1) + K t idm, each row (k0 u + k1 v) + k2 + kt idm
    p = ((KRKi[:, :, 0] * pool.u[:, None] + KRKi[:, :, 1] * pool.v[:, None]
          + KRKi[:, :, 2]) + Kt * idm[:, None])
    z_ok = p[:, 2] > 1e-6
    zs = torch.where(z_ok, p[:, 2], torch.ones_like(p[:, 2]))
    uu = p[:, 0] / zs
    vv = p[:, 1] / zs
    ui = torch.clamp((uu + 0.5).to(torch.int64), 0, w1 - 1)
    vi = torch.clamp((vv + 0.5).to(torch.int64), 0, h1 - 1)
    inb = z_ok & (ui > 0) & (vi > 0) & (ui < w1) & (vi < h1)
    kill = kill | (can & ~inb)
    reached = can
    can = can & inb
    dist = dist_map[vi, ui] + (uu - torch.floor(uu))
    dist_th = min_act_dist * pool.my_type.to(torch.float32)
    to_opt = can & (dist >= dist_th)
    if parts is not None:
        parts.update(reached=reached, gate=can, dist=dist, dist_th=dist_th,
                     pixel=(uu + 0.5, vv + 0.5))
    return to_opt, drop | kill, idm


def linearize_depth_residual(u, v, color, weights, energy_th, idepth,
                             R, t, affLL, dI_target, calib: Calibration,
                             cfg: Config, outlier_slack,
                             parts: Optional[dict] = None):
    """One (point x target) depth-only residual (linearizeResidual,
    ImmaturePoint.cc:312-381). R/t/affLL shared ((3,3)/(3,)/(2,)) or
    per-candidate. Returns (energy, Hdd, bd, state); `parts`, when given,
    gets the energy before the outlier clamp, its limit and the in-bounds
    mask."""
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
    rfx, rfy = _focal_reciprocal(calib, dev)
    x = (u[:, None] + patt[None, :, 0] - cx) * rfx
    y = (v[:, None] + patt[None, :, 1] - cy) * rfy

    def row(i):
        return ((fma(R[:, i, 1:2], y, R[:, i, 0:1] * x) + R[:, i, 2:3])
                + t[:, i:i + 1] * idepth[:, None])
    p0, p1, p2 = row(0), row(1), row(2)
    drescale = p2.reciprocal()
    uu = p0 * drescale
    vv = p1 * drescale
    Ku = fma(uu, fx, cx)
    Kv = fma(vv, fy, cy)
    inb = (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < W - 3) & (Kv < H - 3)

    hit = _bilinear(dI_target, Ku, Kv)
    pix_ok = inb & torch.isfinite(hit[..., 0])
    oob = ~torch.all(pix_ok, dim=-1)

    r = hit[..., 0] - fma(affLL[:, None, 0], color, affLL[:, None, 1])
    hw = _huber_w(torch.abs(r), cfg)
    w2 = weights * weights
    energy = _sum8(torch.where(pix_ok, w2 * hw * r * r * (2.0 - hw), zero))

    dxI = hit[..., 1] * fx
    dyI = hit[..., 2] * fy
    d_id = fma(dxI * drescale, fma(-t[:, 2:3], uu, t[:, 0:1]),
               dyI * drescale * fma(-t[:, 2:3], vv, t[:, 1:2]))
    hww = hw * w2
    Hdd = _sum8(torch.where(pix_ok, hww * d_id * d_id, zero))
    bd = _sum8(torch.where(pix_ok, hww * r * d_id, zero))

    lim = energy_th * outlier_slack
    over = energy > lim
    if parts is not None:
        parts.update(energy=energy, lim=lim, inb=~oob, taps=(Ku, Kv))
    energy = torch.where(over, lim, energy)
    i32 = lambda c: torch.full((), c, dtype=torch.int32, device=dev)  # noqa: E731
    state = torch.where(oob, i32(RES_OOB),
                        torch.where(over, i32(RES_OUTLIER), i32(RES_IN)))
    Hdd = torch.where(oob, zero, Hdd)
    bd = torch.where(oob, zero, bd)
    return energy, Hdd, bd, state


def _depth_lm(u, v, color, weights, energy_th, idepth0, cand_valid, target,
              n_targets: int, dIs, calib: Calibration, cfg: Config,
              parts: Optional[dict] = None):
    """The depth-only LM of `activate`: target(k) gives target k's (R
    (N,3,3), t (N,3), aff (N,2), live (N,) bool). The targets' sums are
    taken in slot order 0..T-1 from 0.0."""
    dev = u.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tables = [target(k) for k in range(n_targets)]
    target_mask = torch.stack([tb[3] for tb in tables], dim=-1)

    def all_targets(idepth, slack):
        es, Hs, bs, sts = 0.0, 0.0, 0.0, []
        for k, (R, t, aff, live) in enumerate(tables):
            got = {} if parts is not None else None
            e, Hdd, bd, st = linearize_depth_residual(
                u, v, color, weights, energy_th, idepth, R, t, aff, dIs[k],
                calib, cfg, slack, got)
            if got is not None:
                parts.setdefault("outlier", []).append(
                    (got["energy"], got["lim"], live & got["inb"]))
                parts.setdefault("taps", []).append((k, live, *got["taps"]))
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
        if parts is not None:
            parts.setdefault("lm", []).append(dict(
                e2=e2, e=e, step=step, idepth=idepth, upd=upd))
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
    if parts is not None:
        parts["Hc"] = Hc
    return idepth, ok, n_good, st


def activate(u, v, color, weights, energy_th, idepth0, cand_valid,
             Rs, ts, affs, target_mask, dIs, calib: Calibration, cfg: Config):
    """Batched optimizeImmaturePoint (FullSystem.cc:892-1010): depth-only
    LM for every candidate against every window frame. Rs (T,3,3) / ts
    (T,3) / affs (T,2) / target_mask (T,) or per-candidate (N,T,...); dIs
    (T,H,W,3). Returns (idepth, ok, n_good_res, state (N,T))."""
    N = u.shape[0]
    if Rs.dim() == 3:
        Rs = Rs.expand((N,) + Rs.shape)
        ts = ts.expand((N,) + ts.shape)
        affs = affs.expand((N,) + affs.shape)
        target_mask = target_mask.expand((N,) + target_mask.shape)
    return _depth_lm(
        u, v, color, weights, energy_th, idepth0, cand_valid,
        lambda k: (Rs[:, k], ts[:, k], affs[:, k], target_mask[:, k]),
        Rs.shape[1], dIs, calib, cfg)


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


def activate_arena_ref(arena: ImmatureArena, dist_map, KRKis, Kts, Rs, ts,
                       affs, masks, dIs, min_act_dist, marg_flags, newest,
                       nf, calib: Calibration, cfg: Config,
                       parts: Optional[dict] = None):
    """The plain version of K5, the keyframe's activation of every lane of
    the arena (`_activate_fused`'s per-lane function in the JAX package):
    the gate against the newest keyframe (`gate_candidates`, with the
    host's KRKis (F,3,3), Kts (F,3), marg_flags (F,) and the distance map
    (h1, w1) at pyramid level 1), the `sane` and `remove` masks, then for
    the lanes to optimise the depth-only LM against every window slot with
    the lane's tables read from the (F, F, ...) arrays Rs, ts, affs, masks
    by its host. newest and nf are the window's newest slot and frame
    count (ints); min_act_dist a float or a 0-d tensor.

    Returns per lane (to_opt, remove, idepth, ok, n_good): to_opt and
    remove the gate's masks (remove before `| to_opt`), idepth the LM's
    result where to_opt and the gate's starting depth elsewhere, ok and
    n_good (int32) the LM's where to_opt, else False and 0. A dead lane
    (not valid or host < 0) is neither optimised nor removed. `parts`,
    when given, gets what tests/torch_kernel_checks.activate_ties reads."""
    F = KRKis.shape[0]
    p = arena.pool
    hostc = arena.host
    h = torch.clamp(hostc, 0, F - 1).long()
    live = p.valid & (hostc >= 0)
    to_opt, remove, idm = gate_candidates(
        p._replace(valid=live), KRKis[h], Kts[h], dist_map, min_act_dist,
        marg_flags[h], cfg, parts)
    to_opt = to_opt & (hostc >= 0) & (hostc < nf) & (hostc != newest)
    remove = remove & (hostc >= 0) & (hostc < nf)
    new_id, ok, n_good, _ = _depth_lm(
        p.u, p.v, p.color, p.weights, p.energy_th, idm, to_opt,
        lambda k: (Rs[h, k], ts[h, k], affs[h, k], masks[h, k]),
        dIs.shape[0], dIs, calib, cfg, parts)
    if parts is not None:
        parts.update(live=live, to_opt=to_opt)
    return (to_opt, remove, torch.where(to_opt, new_id, idm), ok,
            torch.where(to_opt, n_good, torch.zeros_like(n_good)).to(
                torch.int32))
