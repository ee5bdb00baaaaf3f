"""Sliding-window photometric bundle adjustment: linearization,
accumulation, Schur complement and stepping.

Counterpart of ldso_tpu/backend/ba.py (SURVEY.md §2 C12-C17):
  * `linearize_all`  <- PointFrameResidual::linearize (Residuals.cc:13-214)
    with first-estimate Jacobians, over the whole (P, F) residual lattice.
  * `build_system`   <- AccumulatedTopHessianSSE (modes 0/1) +
    AccumulatedSCHessianSSE + the adjoint stitch: per-(host, target) 13x13
    blocks, stitched into the (4+8F)^2 system.
  * `resubstitute`   <- EnergyFunctional::resubstituteF (:491-547).
  * `fix_linearization` / `accumulate_marg`: point marginalization pieces.

Parameter vector x: [c(4), frame0(8), ..., frame{F-1}(8)] in UNSCALED
units. The window's level-0 images are an (F, H, W, 3) stack; the JAX
package's tap-packed (F, H, W, 12) layout gives the same samples.

Everything here is written out of place and reads nothing back from the
device (constants from `device_const`; the newest frame may be a 0-d
device integer), so the device LM (backend/ba_device.py) runs under
`torch.func.vmap` and inside a CUDA graph.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ldso_tpu_torch.config import CPARS, Config, PATTERN, SCALE_C, SCALE_F, SCALE_IDEPTH
from ldso_tpu_torch.backend.window import (FRAME_SCALE, RES_IN, RES_OOB,
                                           RES_OUTLIER, Window, aff_g2l,
                                           aff_g2l_zero, c_scaled,
                                           current_poses)
from ldso_tpu_torch.frontend import affine
from ldso_tpu_torch.frontend.immature import _sum8
from ldso_tpu_torch.math import lie
from ldso_tpu_torch.ops import cuda_kernels
from ldso_tpu_torch.utils.static import device_const


class Precalc(NamedTuple):
    R0: torch.Tensor         # (F,F,3,3) FEJ relative rotation (h -> t)
    t0: torch.Tensor         # (F,F,3)
    KRKi: torch.Tensor       # (F,F,3,3) current K R K^-1
    Kt: torch.Tensor         # (F,F,3)
    aff: torch.Tensor        # (F,F,2) current relative (a, b)
    b0: torch.Tensor         # (F,) host aff_zero b
    adHost: torch.Tensor     # (F,F,8,8) indexed [h, t]
    adTarget: torch.Tensor
    adHTdelta: torch.Tensor  # (F,F,8)
    c_delta: torch.Tensor    # (4,)
    fxycxy: torch.Tensor     # (4,) current physical intrinsics


def _eye8_masks(device):
    """(8, 8) bool masks of the diagonal entries 6 and 7, and the (8, 8)
    float eye of the pose block (zero below and right of it)."""
    d6 = tuple(tuple(i == j == 6 for j in range(8)) for i in range(8))
    d7 = tuple(tuple(i == j == 7 for j in range(8)) for i in range(8))
    e6 = tuple(tuple(float(i == j and i < 6) for j in range(8))
               for i in range(8))
    return (device_const(d6, device, torch.bool),
            device_const(d7, device, torch.bool), device_const(e6, device))


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
    zero, one = torch.zeros_like(c[0]), torch.ones_like(c[0])
    K = torch.stack([c[0], zero, c[2], zero, c[1], c[3], zero, zero,
                     one]).reshape(3, 3)
    # inv_ex: inv's bits without its check of `info` on the host
    Ki = torch.linalg.inv_ex(K)[0]
    KRKi = torch.einsum("ij,htjk,kl->htil", K, Rc, Ki)
    Kt = torch.einsum("ij,htj->hti", K, tc)

    aff_cur = aff_g2l(W)
    aff0 = aff_g2l_zero(W)
    expo = W.exposure
    aff_rel = affine.from_to(expo[:, None], expo[None, :],
                             aff_cur[:, None, :], aff_cur[None, :, :])
    b0 = aff0[:, 1]

    adj = lie.se3_adj(rel0.reshape(-1, 4, 4)).reshape(F, F, 6, 6)
    aff0_rel = affine.from_to(expo[:, None], expo[None, :],
                              aff0[:, None, :], aff0[None, :, :])
    a0 = aff0_rel[..., 0][..., None, None]
    d6, d7, eye6 = _eye8_masks(dev)
    # AH: -adj^T in the pose block, a0 at (6, 6) and (7, 7); AT: the eye
    # in the pose block, -a0 at (6, 6), -1 at (7, 7); zeros elsewhere
    AH = torch.where(d6 | d7, a0, torch.nn.functional.pad(
        -adj.transpose(-1, -2), (0, 2, 0, 2)))
    AT = torch.where(d6, -a0, torch.where(d7, -1.0, eye6))
    rowscale = device_const(tuple(FRAME_SCALE.tolist()), dev)
    AH = AH * rowscale[None, None, :, None]
    AT = AT * rowscale[None, None, :, None]

    delta = (W.state - W.state_zero)[:, :8]
    adHTdelta = (torch.einsum("hj,htjk->htk", delta, AH)
                 + torch.einsum("tj,htjk->htk", delta, AT))
    return Precalc(R0=R0, t0=t0, KRKi=KRKi, Kt=Kt, aff=aff_rel, b0=b0,
                   adHost=AH, adTarget=AT, adHTdelta=adHTdelta,
                   c_delta=W.c_value - W.c_zero, fxycxy=c)


def _bilinear_frames(dIs, fidx, x, y):
    """Bilinear gather from stacked per-frame images dIs (F,H,W,C) with a
    per-element frame index fidx broadcastable to x/y."""
    F, H, Wd, C = dIs.shape
    x = torch.clamp(x, 0.0, Wd - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]
    xi = torch.where(torch.isnan(x0), torch.zeros_like(x0), x0).long()
    yi = torch.where(torch.isnan(y0), torch.zeros_like(y0), y0).long()
    base = fidx * (H * Wd) + yi * Wd + xi
    flat = dIs.reshape(-1, C)
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + Wd]
    v11 = flat[base + Wd + 1]
    dxdy = dx * dy
    return (dxdy * v11 + (dy - dxdy) * v10 + (dx - dxdy) * v01
            + (1.0 - dx - dy + dxdy) * v00)


def _lin_mask(W: Window):
    return (W.res_exist & W.pt_valid[:, None] & ~W.res_linearized
            & W.frame_valid[None, :])


def _row3(M, i, x, y):
    """Row i of a 3x3 M (..., 3, 3) times (x, y, 1), in K6's order:
    (m0 x + m1 y) + m2."""
    return (M[..., i, 0] * x + M[..., i, 1] * y) + M[..., i, 2]


# K6's block of residuals and its warp: the energy sum's fixed order
# (`ordered_energy_sum`)
LIN_BLOCK = 256
_WARP = 32


def _halve(x):
    """A warp's shuffle tree over the last axis (a power of two): lane i
    adds lane i + n/2, and so on down to one."""
    while x.shape[-1] > 1:
        n = x.shape[-1] // 2
        x = x[..., :n] + x[..., n:]
    return x[..., 0]


def ordered_energy_sum(e):
    """The sum of a (P, F) lattice of energies in K6's order: the lattice
    flattened point-major in blocks of LIN_BLOCK residuals, each warp's 32
    by the shuffle tree, a block's 8 warp sums by the same tree (padded
    with zeros to 32); then the block sums, lane l adding blocks l, l + 32,
    ... in order from 0.0, and the 32 lanes by the tree. Zeros pad the
    lattice to whole blocks and the blocks to whole warps."""
    x = e.reshape(-1)
    n = x.shape[0]
    nb = -(-n // LIN_BLOCK)
    x = torch.nn.functional.pad(x, (0, nb * LIN_BLOCK - n))
    warps = _halve(x.reshape(nb, LIN_BLOCK // _WARP, _WARP))
    blocks = _halve(torch.nn.functional.pad(
        warps, (0, _WARP - LIN_BLOCK // _WARP)))
    nc = -(-nb // _WARP)
    blocks = torch.nn.functional.pad(blocks, (0, nc * _WARP - nb))
    acc = torch.zeros_like(blocks[:_WARP])
    for c in range(nc):
        acc = acc + blocks[c * _WARP:(c + 1) * _WARP]
    return _halve(acc)


def _residual_core(W: Window, pc: Precalc, cfg: Config, img_w, img_h,
                   R0, t0, KRKi, Kt, affLL, b0, hit_fn, color, weights,
                   idepth_zero, idepth, th, prev_oob, prev_energy):
    """Shared body of linearize_all / linearize_target over any leading
    shape S of residuals: returns the Jacobian pieces and new states.
    Every operation is elementwise and written out in K6's order
    (csrc/ba_linearize.cu): the rows of a 3x3 product as `_row3`, then
    + t idepth; a Python scalar over a tensor as its reciprocal times the
    scalar; the focal lengths as 0-d tensor divisors; the 8-tap sums as
    `_sum8`."""
    fx, fy, cx, cy = pc.fxycxy[0], pc.fxycxy[1], pc.fxycxy[2], pc.fxycxy[3]
    wM3 = img_w - 3.0
    hM3 = img_h - 3.0
    u_pt, v_pt = W.pt_u, W.pt_v
    shp = R0.shape[:-2]
    ext = (slice(None),) + (None,) * (len(shp) - 1)

    x0 = ((u_pt - cx) / fx)[ext]
    y0 = ((v_pt - cy) / fy)[ext]
    iz = idepth_zero[ext]
    p0 = _row3(R0, 0, x0, y0) + t0[..., 0] * iz
    p1 = _row3(R0, 1, x0, y0) + t0[..., 1] * iz
    p2 = _row3(R0, 2, x0, y0) + t0[..., 2] * iz
    drescale = p2.reciprocal()
    new_idepth = iz * drescale
    u = p0 * drescale
    v = p1 * drescale
    Ku_c = u * fx + cx
    Kv_c = v * fy + cy
    center_ok = ((drescale > 0) & (Ku_c > 1.1) & (Kv_c > 1.1)
                 & (Ku_c < wM3) & (Kv_c < hM3))

    d_d_x = drescale * (t0[..., 0] - t0[..., 2] * u) * SCALE_IDEPTH * fx
    d_d_y = drescale * (t0[..., 1] - t0[..., 2] * v) * SCALE_IDEPTH * fy

    dCx2 = drescale * (R0[..., 2, 0] * u - R0[..., 0, 0])
    dCx3 = fx * drescale * (R0[..., 2, 1] * u - R0[..., 0, 1]) / fy
    dCx0 = (x0 * dCx2 + u) * SCALE_F
    dCx1 = (y0 * dCx3) * SCALE_F
    dCx2 = (dCx2 + 1.0) * SCALE_C
    dCx3 = dCx3 * SCALE_C
    dCy2 = fy * drescale * (R0[..., 2, 0] * v - R0[..., 1, 0]) / fx
    dCy3 = drescale * (R0[..., 2, 1] * v - R0[..., 1, 1])
    dCy0 = (x0 * dCy2) * SCALE_F
    dCy1 = (y0 * dCy3 + v) * SCALE_F
    dCy2 = dCy2 * SCALE_C
    dCy3 = (dCy3 + 1.0) * SCALE_C
    Jpdc = torch.stack([torch.stack([dCx0, dCx1, dCx2, dCx3], -1),
                        torch.stack([dCy0, dCy1, dCy2, dCy3], -1)], dim=-2)

    zero = torch.zeros_like(u)
    Jxi_x = torch.stack([new_idepth * fx, zero, -new_idepth * u * fx,
                         -u * v * fx, (u * u + 1.0) * fx, -v * fx], -1)
    Jxi_y = torch.stack([zero, new_idepth * fy, -new_idepth * v * fy,
                         -(v * v + 1.0) * fy, u * v * fy, u * fy], -1)
    Jpdxi = torch.stack([Jxi_x, Jxi_y], dim=-2)
    Jpdd = torch.stack([d_d_x, d_d_y], dim=-1)
    center_proj = torch.stack([Ku_c, Kv_c, new_idepth], -1)

    # pattern projections at the CURRENT state (Residuals.cc:126-188)
    patt = device_const(tuple(map(tuple, PATTERN.tolist())), u.device)
    uP = u_pt[ext][..., None] + patt[:, 0]
    vP = v_pt[ext][..., None] + patt[:, 1]
    Kb = KRKi[..., None, :, :]
    idp = idepth[ext][..., None]
    q0 = _row3(Kb, 0, uP, vP) + Kt[..., None, 0] * idp
    q1 = _row3(Kb, 1, uP, vP) + Kt[..., None, 1] * idp
    q2 = _row3(Kb, 2, uP, vP) + Kt[..., None, 2] * idp
    Ku = q0 / q2
    Kv = q1 / q2
    patt_ok = (Ku > 1.1) & (Kv > 1.1) & (Ku < wM3) & (Kv < hM3)

    hit = hit_fn(Ku, Kv)                                             # (S,8,3)
    h0, h1, h2 = hit[..., 0], hit[..., 1], hit[..., 2]
    finite = torch.isfinite(h0)
    oob = prev_oob | ~center_ok | ~torch.all(patt_ok & finite, dim=-1)

    resid = h0 - (affLL[..., 0:1] * color + affLL[..., 1:2])
    drdA = color - b0[..., None]
    gsq = h1 * h1 + h2 * h2
    c = cfg.outlier_th_sum_component
    wg = torch.sqrt((gsq + c).reciprocal() * c)
    wgt = 0.5 * (wg + weights)
    ar = torch.abs(resid)
    hw_e = torch.where(ar < cfg.huber_th, torch.ones_like(ar),
                       torch.clamp(ar, min=1e-12).reciprocal() * cfg.huber_th)
    energy = _sum8(wgt * wgt * hw_e * resid * resid * (2.0 - hw_e))

    hw = torch.where(hw_e < 1.0, torch.sqrt(hw_e), hw_e) * wgt
    JIdx = torch.stack([h1 * hw, h2 * hw], dim=-2)
    Jab0 = drdA * hw
    Jab1 = hw
    if cfg.affine_opt_mode_a < 0:
        Jab0 = torch.zeros_like(Jab0)
    if cfg.affine_opt_mode_b < 0:
        Jab1 = torch.zeros_like(Jab1)
    JabF = torch.stack([Jab0, Jab1], dim=-2)
    resF = resid * hw
    wJI2 = _sum8(hw * hw * gsq)

    is_outlier = (energy > th) | (wJI2 < 2.0)
    new_energy = torch.where(is_outlier, th, energy)
    i32 = lambda c: torch.full((), c, dtype=torch.int32, device=u.device)  # noqa: E731
    new_state = torch.where(oob, i32(RES_OOB),
                            torch.where(is_outlier, i32(RES_OUTLIER), i32(RES_IN)))
    # OOB keeps the previous energy (Residuals.cc:17-21,58-60)
    new_energy = torch.where(oob, prev_energy, new_energy)
    new_energy_wo = torch.where(oob, torch.full_like(energy, -1.0), energy)
    return dict(Jpdxi=Jpdxi, Jpdc=Jpdc, Jpdd=Jpdd, JIdx=JIdx, JabF=JabF,
                resF=resF, center_proj=center_proj, res_new_state=new_state,
                res_new_energy=new_energy, res_new_energy_wo=new_energy_wo)


def _sel(mask, a, b):
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())),
                       a, b)


def linearize_ref(W: Window, dIs, pc: Precalc, cfg: Config, img_w: int,
                  img_h: int, tgt=None):
    """K6's plain version (ops/cuda_kernels.ba_linearize is the wrapper):
    PointFrameResidual::linearize over the whole (P, F) lattice, or over
    the column of target `tgt` (an int or a 0-d device integer) with the
    reference's sticky OOB (Residuals.cc:17-21), from the precalc `pc` of
    W. Returns (the 10 fields it writes, each the whole (P, F, ...) field
    with the residuals outside `_lin_mask` (and outside the column)
    copied through, the energy sum over the whole lattice's `_lin_mask`
    in K6's order)."""
    P, F = W.P, W.F
    h = W.pt_host
    if tgt is None:
        tg = torch.arange(F, device=h.device)[None, :, None]
        th = torch.maximum(W.frame_energy_th[h][:, None],
                           W.frame_energy_th[None, :])
        out = _residual_core(
            W, pc, cfg, img_w, img_h, pc.R0[h], pc.t0[h], pc.KRKi[h],
            pc.Kt[h], pc.aff[h], pc.b0[h][:, None].expand(P, F),
            lambda Ku, Kv: _bilinear_frames(dIs, tg, Ku, Kv),
            W.pt_color[:, None, :], W.pt_weights[:, None, :],
            W.idepth_zero, W.idepth, th, W.res_state == RES_OOB,
            W.res_energy)
        upd = _lin_mask(W)
    else:
        tgt_p = torch.zeros_like(h) + tgt
        th = torch.maximum(W.frame_energy_th[h], W.frame_energy_th[tgt_p])
        out = _residual_core(
            W, pc, cfg, img_w, img_h, pc.R0[h, tgt_p], pc.t0[h, tgt_p],
            pc.KRKi[h, tgt_p], pc.Kt[h, tgt_p], pc.aff[h, tgt_p], pc.b0[h],
            lambda Ku, Kv: _bilinear_frames(dIs, tgt_p[:, None], Ku, Kv),
            W.pt_color, W.pt_weights, W.idepth_zero, W.idepth, th,
            _column(W.res_state, tgt_p) == RES_OOB,
            _column(W.res_energy, tgt_p))
        out = {k: v[:, None] for k, v in out.items()}
        upd = _lin_mask(W) & (torch.arange(F, device=h.device) == tgt)
    out = {k: _sel(upd, v, getattr(W, k)) for k, v in out.items()}
    energy = torch.where(_lin_mask(W), out["res_new_energy"],
                         torch.zeros_like(W.res_new_energy))
    return out, ordered_energy_sum(energy)


def linearize_all(W: Window, dIs, cfg: Config, img_w: int, img_h: int):
    """Batched PointFrameResidual::linearize over the whole (P, F) lattice
    (K6 on the card, `linearize_ref` on the CPU). Returns (W with
    Jacobian/new-state fields updated, energy_sum)."""
    out, energy_sum = cuda_kernels.ba_linearize(W, dIs, make_precalc(W), cfg,
                                                img_w, img_h)
    return W._replace(**out), energy_sum


def _column(x, tgt_p):
    """x[:, tgt] of a (P, F) tensor for a per-point target (P,): a gather,
    since indexing with a 0-d tensor would read it on the host."""
    return torch.gather(x, 1, tgt_p[:, None])[:, 0]


def linearize_target(W: Window, dIs, cfg: Config, img_w: int, img_h: int,
                     tgt):
    """`linearize_all` restricted to the residuals whose target is `tgt`
    (an int or a 0-d device integer), with the reference's sticky OOB
    (Residuals.cc:17-21): K6 in its column mode on the card. Returns (W',
    energy_sum over the full lattice)."""
    out, energy_sum = cuda_kernels.ba_linearize(W, dIs, make_precalc(W), cfg,
                                                img_w, img_h, tgt)
    return W._replace(**out), energy_sum


def apply_res(W: Window) -> Window:
    """Commit NewState for the active (non-linearized) residual set
    (applyRes(true), Residuals.h:70-87); OOB residuals never come back."""
    upd = _lin_mask(W) & ~(W.res_state == RES_OOB)
    active = upd & (W.res_new_state == RES_IN)
    return W._replace(
        res_active=torch.where(upd, active, W.res_active),
        res_state=torch.where(upd, W.res_new_state, W.res_state),
        res_energy=torch.where(upd, W.res_new_energy, W.res_energy),
    )


def set_new_frame_energy_th(W: Window, newest, cfg: Config) -> Window:
    """Quantile-based per-frame outlier threshold (FullSystem.cc:1762-1793)
    of frame `newest` (an int or a 0-d device integer)."""
    mask = _lin_mask(W) & (W.res_new_energy_wo >= 0)
    fsel = torch.arange(W.F, device=mask.device) == newest
    mask = mask & fsel[None, :]
    vals = torch.where(mask, W.res_new_energy_wo,
                       torch.full_like(W.res_new_energy_wo, float("inf"))).reshape(-1)
    n = torch.sum(mask)
    svals = torch.sort(vals).values
    nth = torch.clamp((cfg.frame_energy_th_n * n.to(torch.float32)).to(torch.int64),
                      0, vals.shape[0] - 1)
    default = torch.full((), 12.0 * 12.0 * 8.0, dtype=torch.float32,
                         device=mask.device)
    nth_el = torch.sqrt(torch.where(n > 0, svals.gather(0, nth.reshape(1))[0],
                                    default))
    th = nth_el * cfg.frame_energy_th_fac_median
    th = (26.0 * cfg.frame_energy_th_const_weight
          + th * (1.0 - cfg.frame_energy_th_const_weight))
    th = th * th * cfg.overall_energy_th_weight ** 2
    th = torch.where(n > 0, th, default)
    return W._replace(frame_energy_th=torch.where(fsel, th,
                                                  W.frame_energy_th))


# ---------------------------------------------------------------------------
# accumulation + stitch
# ---------------------------------------------------------------------------

def _J_delta(W: Window, pc: Precalc):
    """J * delta per residual pixel (the linearized residual change)."""
    dp = pc.adHTdelta[W.pt_host]                                    # (P,F,8)
    dd = (W.idepth - W.idepth_zero)[:, None]
    Jp_dx = (torch.einsum("pfj,pfj->pf", W.Jpdxi[:, :, 0, :], dp[..., :6])
             + torch.einsum("pfj,j->pf", W.Jpdc[:, :, 0, :], pc.c_delta)
             + W.Jpdd[..., 0] * dd)
    Jp_dy = (torch.einsum("pfj,pfj->pf", W.Jpdxi[:, :, 1, :], dp[..., :6])
             + torch.einsum("pfj,j->pf", W.Jpdc[:, :, 1, :], pc.c_delta)
             + W.Jpdd[..., 1] * dd)
    return (W.JIdx[:, :, 0, :] * Jp_dx[..., None]
            + W.JIdx[:, :, 1, :] * Jp_dy[..., None]
            + W.JabF[:, :, 0, :] * dp[..., 6:7]
            + W.JabF[:, :, 1, :] * dp[..., 7:8])


def _res_approx(W: Window, pc: Precalc, mode: int):
    """resApprox per mode (AccumulatedTopHessian.cc:40-66)."""
    if mode == 0:
        return W.resF
    if mode == 2:
        return W.res_toZero
    return W.res_toZero + _J_delta(W, pc)


def _mode_mask(W: Window, mode: int, pt_mask=None):
    base = W.res_active & W.res_exist & W.frame_valid[None, :]
    if pt_mask is None:
        pt_mask = W.pt_valid
    base = base & pt_mask[:, None]
    if mode == 0:
        return base & ~W.res_linearized
    if mode == 1:
        return base & W.res_linearized
    return base


def _host_onehot(W: Window):
    return torch.nn.functional.one_hot(W.pt_host, W.F).to(torch.float32)


def _accumulate_top(W: Window, pc: Precalc, mode: int, pt_mask=None):
    """Per-pair 13x13 blocks + per-point Hdd/bd/Hcd for one mode: K7's
    top part on the card (ops/cuda_kernels.ba_accumulate_top),
    `_accumulate_top_ref` on the CPU. Returns (acc (F, F, 13, 13), Hdd,
    bd (P,), Hcd (P, 4), nres)."""
    return cuda_kernels.ba_accumulate_top(
        W, pc, mode, W.pt_valid if pt_mask is None else pt_mask)


def _accumulate_top_ref(W: Window, pc: Precalc, mode: int, pt_mask):
    """K7's top part, plain: `_accumulate_top`'s function."""
    mask = _mode_mask(W, mode, pt_mask)
    resApprox = _res_approx(W, pc, mode)
    J0, J1 = W.JIdx[:, :, 0, :, None], W.JIdx[:, :, 1, :, None]
    rows_c = J0 * W.Jpdc[:, :, None, 0, :] + J1 * W.Jpdc[:, :, None, 1, :]
    rows_xi = J0 * W.Jpdxi[:, :, None, 0, :] + J1 * W.Jpdxi[:, :, None, 1, :]
    rows = torch.cat([rows_c, rows_xi, W.JabF[:, :, 0, :, None],
                      W.JabF[:, :, 1, :, None], resApprox[..., None]], dim=-1)
    m = mask.to(torch.float32)
    rows = rows * m[..., None, None]                                # (P,F,8,13)

    outer = torch.einsum("pfka,pfkb->pfab", rows, rows)
    acc = torch.einsum("ph,pfab->hfab", _host_onehot(W), outer)     # (F,F,13,13)

    JI_r = torch.einsum("pfik,pfk->pfi", W.JIdx, resApprox)
    JIdx2 = torch.einsum("pfik,pfjk->pfij", W.JIdx, W.JIdx)
    Ji2_Jpdd = torch.einsum("pfij,pfj->pfi", JIdx2, W.Jpdd)
    bd = torch.sum(m * torch.einsum("pfi,pfi->pf", JI_r, W.Jpdd), dim=1)
    Hdd = torch.sum(m * torch.einsum("pfi,pfi->pf", Ji2_Jpdd, W.Jpdd), dim=1)
    Hcd = torch.sum(m[..., None] * (W.Jpdc[:, :, 0, :] * Ji2_Jpdd[..., 0:1]
                                    + W.Jpdc[:, :, 1, :] * Ji2_Jpdd[..., 1:2]),
                    dim=1)
    return acc, Hdd, bd, Hcd, torch.sum(mask)


def _assemble(Hcc, colCf, Hff, bC, bF):
    H = torch.cat([torch.cat([Hcc, colCf.T], dim=1),
                   torch.cat([colCf, Hff], dim=1)], dim=0)
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

    eye = torch.eye(F, dtype=torch.bool, device=dev)[:, :, None, None]
    grid = torch.where(eye, Bht + torch.sum(Bhh, dim=1)[:, None]
                       + torch.sum(Btt, dim=0)[:, None], Bht)
    gridT = grid.transpose(0, 1).transpose(2, 3)
    sym = torch.where(eye, grid, grid + gridT)

    H, b = _assemble(
        torch.sum(Gcc, dim=(0, 1)),
        (torch.sum(col_h, dim=1) + torch.sum(col_t, dim=0)).reshape(8 * F, CPARS),
        sym.permute(0, 2, 1, 3).reshape(8 * F, 8 * F),
        torch.sum(cb, dim=(0, 1)),
        torch.sum(b_h, dim=1) + torch.sum(b_t, dim=0))

    return _add_priors(H, b, W, pc) if use_prior else (H, b)


def _add_priors(H, b, W: Window, pc: Precalc):
    """The calib and frame priors on the diagonal of a stitched system."""
    delta_prior = W.state[:, :8]        # priorZero == 0 (FrameHessian.h:156-158)
    pdiag = W.prior * W.frame_valid[:, None]
    dvec = torch.cat([W.c_prior, pdiag.reshape(-1)])
    return H + torch.diag(dvec), b + torch.cat(
        [W.c_prior * pc.c_delta, (pdiag * delta_prior).reshape(-1)])


def _sc_sums_ref(W: Window, Hdd_tot, bd_tot, Hcd_tot, shift_prior: bool,
                 pt_mask):
    """K7's Schur part, plain (ops/cuda_kernels.ba_accumulate_sc is the
    wrapper): the per-point pieces HdiF, bdSum, the gated Hcd, JpJdF
    (P, F, 8) and ngood, and their sums over the points, Hcc_sc (4, 4),
    bc_sc (4), and per host accE (F, F, 8, 4), accEB (F, F, 8) and accD
    (h, t1, t2, 8, 8)."""
    P, F = W.P, W.F
    dev = W.state.device
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
    return dict(HdiF=HdiF, bdSum=bdSum, Hcd=Hcd, JpJdF=JpJdF, ngood=ngood,
                Hcc_sc=Hcc_sc, bc_sc=bc_sc, accE=accE, accEB=accEB,
                accD=accD)


def _accumulate_sc(W: Window, pc: Precalc, Hdd_tot, bd_tot, Hcd_tot,
                   shift_prior: bool, pt_mask=None):
    """AccumulatedSCHessian accumulation + stitch (AccumulatedSCHessian.cc):
    the sums over the points are K7's Schur part on the card
    (ops/cuda_kernels.ba_accumulate_sc; `_sc_sums_ref` on the CPU), the
    adjoint stitch of its (F, F) blocks is plain."""
    F = W.F
    dev = W.state.device
    if pt_mask is None:
        pt_mask = W.pt_valid
    s = cuda_kernels.ba_accumulate_sc(W, Hdd_tot, bd_tot, Hcd_tot,
                                      shift_prior, pt_mask)
    accE, accEB, accD = s["accE"], s["accEB"], s["accD"]

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

    grid = (torch.sum(D_ATAT, dim=0) + torch.sum(D_ATAH, dim=2).permute(1, 0, 2, 3)
            + torch.sum(D_AHAT, dim=1))
    eye = torch.eye(F, dtype=torch.bool, device=dev)[:, :, None, None]
    grid = torch.where(eye, grid + torch.sum(D_AHAH, dim=(1, 2))[:, None],
                       grid)

    H, b = _assemble(s["Hcc_sc"], colC.reshape(8 * F, CPARS),
                     grid.permute(0, 2, 1, 3).reshape(8 * F, 8 * F),
                     s["bc_sc"], bF)
    aux = {k: s[k] for k in ("HdiF", "bdSum", "Hcd", "JpJdF", "ngood")}
    return H, b, aux


def build_system(W: Window):
    """Accumulate A (mode 0), L (mode 1, with priors), and SC parts.
    Returns (HA, bA, HL, bL, Hsc, bsc, aux, stitched_delta, nres_A)."""
    pc = make_precalc(W)
    accA, HddA, bdA, HcdA, nresA = _accumulate_top(W, pc, mode=0)
    accL, HddL, bdL, HcdL, _ = _accumulate_top(W, pc, mode=1)
    HA, bA = _stitch_top(accA, pc, W, use_prior=False)
    HL, bL = _stitch_top(accL, pc, W, use_prior=True)
    Hsc, bsc, aux = _accumulate_sc(W, pc, HddA + HddL, bdA + bdL,
                                   HcdA + HcdL, shift_prior=True)
    return HA, bA, HL, bL, Hsc, bsc, aux, stitched_delta(W, pc), nresA


def stitched_delta(W: Window, pc: Precalc = None):
    """The (4+8F) offset of the state from its linearization point, the
    `delta` that build_system returns (calib, then each frame's 8)."""
    pc = make_precalc(W) if pc is None else pc
    return torch.cat([pc.c_delta,
                      ((W.state - W.state_zero)[:, :8]
                       * W.frame_valid[:, None]).reshape(-1)])


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
    f_step = torch.cat([-xf, torch.zeros_like(W.frame_step[:, 8:])], dim=1)
    return W._replace(pt_step=step, c_step=(-xc).to(torch.float32),
                      frame_step=f_step)


# ---------------------------------------------------------------------------
# state stepping (FullSystem backup/doStep/load; :1546-1692)
# ---------------------------------------------------------------------------

def backup_state(W: Window) -> Window:
    return W._replace(state_backup=W.state, c_backup=W.c_value,
                      idepth_backup=W.idepth)


def do_step(W: Window, stepfac_c, stepfac_t, stepfac_r, stepfac_a, stepfac_d):
    """Returns (new W, canbreak) with canbreak a 0-d bool tensor."""
    f32 = dict(dtype=torch.float32, device=W.state.device)
    # from fills: no upload
    pstep = torch.cat([torch.full((3,), stepfac_t, **f32),
                       torch.full((3,), stepfac_r, **f32),
                       torch.full((4,), stepfac_a, **f32)])
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


def do_step_momentum(W: Window, prev_frame_step, prev_pt_step):
    """doStepFromBackup, SOLVER_MOMENTUM branch (FullSystem.cc:1557-1584):
    the applied step adds half the previous iteration's raw step on the
    pose head and the point idepths; calib and affine take the raw step.
    Returns (new W, canbreak) with the break test on the blended step."""
    step = torch.cat([W.frame_step[:, :6] + 0.5 * prev_frame_step[:, :6],
                      W.frame_step[:, 6:]], dim=1)
    new_state = W.state_backup + step
    new_c = W.c_backup + W.c_step
    pstep = W.pt_step + 0.5 * prev_pt_step
    act = W.pt_valid
    new_id = torch.where(act, W.idepth_backup + pstep, W.idepth)

    fvb = W.frame_valid
    fv = fvb[:, None].to(torch.float32)
    nf = torch.clamp(torch.sum(fvb), min=1)
    sumA = torch.sum(fv[:, 0] * step[:, 6] ** 2) / nf
    sumB = torch.sum(fv[:, 0] * step[:, 7] ** 2) / nf
    sumT = torch.sum(fv * step[:, 0:3] ** 2) / nf
    sumR = torch.sum(fv * step[:, 3:6] ** 2) / nf
    nid = torch.clamp(torch.sum(act), min=1)
    sumNID = torch.sum(act * torch.abs(W.idepth_backup)) / nid

    W = W._replace(state=torch.where(fvb[:, None], new_state, W.state),
                   c_value=new_c, idepth=new_id,
                   idepth_zero=torch.where(act, new_id, W.idepth_zero))
    th = 0.00005 * 1.2  # setting_thOptIterations = 1.2
    canbreak = ((torch.sqrt(sumA) < 0.0005 * 1.2) & (torch.sqrt(sumB) < th)
                & (torch.sqrt(sumR) < th) & (torch.sqrt(sumT) * sumNID < th))
    return W, canbreak


def load_backup(W: Window) -> Window:
    idep = torch.where(W.pt_valid, W.idepth_backup, W.idepth)
    return W._replace(state=W.state_backup, c_value=W.c_backup,
                      idepth=idep, idepth_zero=idep)


def calc_L_energy(W: Window):
    """calcLEnergyF_MT (EnergyFunctional.cc:361-378, 627-682)."""
    pc = make_precalc(W)
    delta_prior = W.state[:, :8] * W.frame_valid[:, None]
    E = torch.sum(delta_prior * W.prior * delta_prior)
    E = E + torch.sum(pc.c_delta * W.c_prior * pc.c_delta)
    Jdelta = _J_delta(W, pc)
    term = torch.sum(Jdelta * (Jdelta + 2.0 * W.res_toZero), dim=-1)
    E = E + torch.sum(torch.where(_mode_mask(W, 1), term, torch.zeros_like(term)))
    dF = (W.idepth - W.idepth_zero) * W.pt_valid
    return E + torch.sum(dF * dF * W.pt_prior)


def fix_linearization(W: Window, pt_mask) -> Window:
    """res_toZero = resF - J*delta for active residuals of the given points
    (fixLinearizationF, Residuals.cc:216-242); marks them linearized."""
    pc = make_precalc(W)
    rtz = W.resF - _J_delta(W, pc)
    mask = W.res_active & W.res_exist & pt_mask[:, None] & W.frame_valid[None, :]
    return W._replace(
        res_toZero=torch.where(mask[..., None], rtz, W.res_toZero),
        res_linearized=W.res_linearized | mask,
    )


def accumulate_marg(W: Window, pt_mask):
    """Mode-2 top accumulation + SC for the points being marginalized
    (EnergyFunctional::marginalizePointsF, :165-222). Returns (H, b, nres)
    with H = M - Msc, b = Mb - Mbsc."""
    pc = make_precalc(W)
    acc, Hdd, bd, Hcd, nres = _accumulate_top(W, pc, mode=2, pt_mask=pt_mask)
    M, Mb = _stitch_top(acc, pc, W, use_prior=False)
    Msc, Mbsc, _ = _accumulate_sc(W, pc, Hdd, bd, Hcd, shift_prior=False,
                                  pt_mask=pt_mask)
    return M - Msc, Mb - Mbsc, nres
