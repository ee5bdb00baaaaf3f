"""backend/window, ba, ba_device and energy_functional: both packages
start from one JAX window snapshot, carried over with utils/convert."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_utils import close, equal, npy, t32

from test_backend import CFG, _build_ef

from ldso_tpu.backend import ba as jba
from ldso_tpu.backend import ba_device as jbd
from ldso_tpu.backend.energy_functional import _reset_oob
from ldso_tpu.backend.window import current_poses as jposes
from ldso_tpu_torch.backend import ba as tba
from ldso_tpu_torch.backend import ba_device as tbd
from ldso_tpu_torch.backend.energy_functional import EnergyFunctional
from ldso_tpu_torch.backend.window import current_poses as tposes
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.utils import convert

TCFG = TC(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
JAC = ("Jpdxi", "Jpdc", "Jpdd", "JIdx", "JabF", "resF", "center_proj",
       "res_new_energy", "res_new_energy_wo")


def _rel(a, b, rtol, what):
    """Close relative to the array's own scale: float32 sums of many
    terms in another order differ by ~1e-6 of the largest entry."""
    b = npy(b)
    close(a, b, rtol, rtol * max(float(np.abs(b).max()), 1e-30), what)


@pytest.fixture(scope="module")
def window():
    ef, dIs, poses, idep0, calib, (w, h) = _build_ef(
        pose_noise=2e-3, idepth_noise=0.05, n_pts=100)
    W = _reset_oob(ef.W)
    return ef, W, dIs, poses, calib, (w, h)


def test_window_and_images_convert(window):
    from ldso_tpu.ops.interp import pack_taps
    ef, W, dIs, poses, calib, wh = window
    Wt = convert.window_to_torch(W)
    for f, a in convert.window_to_numpy(Wt).items():
        equal(a, getattr(W, f), f)
    assert Wt.pt_host.dtype == torch.int64
    packed = jnp.stack([pack_taps(dIs[f]) for f in range(dIs.shape[0])])
    equal(convert.window_images_to_torch(packed), dIs)
    close(tposes(Wt), jposes(W), 1e-6, 1e-6, "current poses")


def test_make_precalc(window):
    ef, W, dIs, poses, calib, wh = window
    pj = jba.make_precalc(W)
    pt = tba.make_precalc(convert.window_to_torch(W))
    for f in pj._fields:
        _rel(getattr(pt, f), getattr(pj, f), 1e-5, f)


def test_linearize_all_and_target(window):
    """The whole (P, F) lattice: states exact, Jacobian factors within
    1e-4 relative of their scale (float32 projections and bilinear
    samples)."""
    ef, W, dIs, poses, calib, (w, h) = window
    Wj, ej = jba.linearize_all(W, dIs, CFG, w, h)
    Wt, et = tba.linearize_all(convert.window_to_torch(W),
                               convert.window_images_to_torch(dIs), TCFG, w, h)
    _rel(et, ej, 1e-5, "energy")
    equal(Wt.res_new_state, Wj.res_new_state)
    for f in JAC:
        _rel(getattr(Wt, f), getattr(Wj, f), 1e-4, f)
    Wj2, ej2 = jba.linearize_target(Wj, dIs, CFG, w, h, jnp.int32(2))
    Wt2, et2 = tba.linearize_target(convert.window_to_torch(Wj),
                                    convert.window_images_to_torch(dIs),
                                    TCFG, w, h, 2)
    _rel(et2, ej2, 1e-5, "target energy")
    for f in JAC:
        _rel(getattr(Wt2, f), getattr(Wj2, f), 1e-4, f"target {f}")


def _linearized(window):
    ef, W, dIs, poses, calib, (w, h) = window
    Wj, _ = jba.linearize_all(W, dIs, CFG, w, h)
    Wj = jba.set_new_frame_energy_th(Wj, jnp.int32(2), CFG)
    return jba.apply_res(Wj)


def test_energy_threshold_and_apply(window):
    ef, W, dIs, poses, calib, (w, h) = window
    Wj, _ = jba.linearize_all(W, dIs, CFG, w, h)
    Wt = convert.window_to_torch(Wj)
    Wj = jba.apply_res(jba.set_new_frame_energy_th(Wj, jnp.int32(2), CFG))
    Wt = tba.apply_res(tba.set_new_frame_energy_th(Wt, 2, TCFG))
    close(Wt.frame_energy_th, Wj.frame_energy_th, 1e-6, 0, "frame_energy_th")
    for f in ("res_active", "res_state", "res_energy"):
        equal(getattr(Wt, f), getattr(Wj, f), f)


def test_build_system_and_resubstitute(window):
    """13x13 accumulation, adjoint stitch and Schur complement: each block
    within 1e-4 of its scale (sums over ~1e3 residual rows); the
    resubstituted steps within 1e-3."""
    Wj = _linearized(window)
    Wt = convert.window_to_torch(Wj)
    oj = jba.build_system(Wj)
    ot = tba.build_system(Wt)
    for name, a, b in zip(("HA", "bA", "HL", "bL", "Hsc", "bsc"), ot[:6], oj[:6]):
        _rel(a, b, 1e-4, name)
    for k in ("HdiF", "bdSum", "Hcd", "JpJdF"):
        _rel(ot[6][k], oj[6][k], 1e-4, k)
    _rel(ot[7], oj[7], 1e-6, "delta")
    equal(ot[8], oj[8])
    x = np.random.RandomState(3).randn(oj[0].shape[0]).astype(np.float32) * 1e-3
    Rj = jba.resubstitute(Wj, jnp.asarray(x), *[oj[6][k] for k in
                                                ("HdiF", "bdSum", "Hcd", "JpJdF")])
    Rt = tba.resubstitute(Wt, t32(x), *[ot[6][k] for k in
                                        ("HdiF", "bdSum", "Hcd", "JpJdF")])
    for f in ("pt_step", "c_step", "frame_step"):
        _rel(getattr(Rt, f), getattr(Rj, f), 1e-3, f)
    Sj, cj = jba.do_step(jba.backup_state(Rj), 1.0, 1.0, 1.0, 1.0, 1.0)
    St, ct = tba.do_step(tba.backup_state(convert.window_to_torch(Rj)),
                         1.0, 1.0, 1.0, 1.0, 1.0)
    assert bool(cj) == bool(ct)
    for f in ("state", "c_value", "idepth", "idepth_zero"):
        close(getattr(St, f), getattr(Sj, f), 1e-6, 1e-7, f)
    Lj = jba.load_backup(Sj)
    Lt = tba.load_backup(St)
    close(Lt.idepth, Lj.idepth, 1e-6, 1e-7, "load_backup")
    _rel(tba.calc_L_energy(St), jba.calc_L_energy(Sj), 1e-4, "L energy")


def test_fix_linearization_and_marg(window):
    """FEJ fix + mode-2 accumulation + Schur of a point subset."""
    Wj = _linearized(window)
    mask = np.zeros(Wj.P, bool)
    mask[np.nonzero(np.asarray(Wj.pt_valid))[0][::3]] = True
    Fj = jba.fix_linearization(Wj, jnp.asarray(mask))
    Ft = tba.fix_linearization(convert.window_to_torch(Wj), torch.from_numpy(mask))
    equal(Ft.res_linearized, Fj.res_linearized)
    _rel(Ft.res_toZero, Fj.res_toZero, 1e-4, "res_toZero")
    Hj, bj, nj = jba.accumulate_marg(Fj, jnp.asarray(mask))
    Ht, bt, nt = tba.accumulate_marg(convert.window_to_torch(Fj),
                                     torch.from_numpy(mask))
    _rel(Ht, Hj, 1e-4, "marg H")
    _rel(bt, bj, 1e-4, "marg b")
    assert int(nt) == int(nj)


def test_optimize_device(window):
    """The whole device LM (default solver mode): the f32 solves and
    relinearizations compound, so poses agree to 1e-4 and idepths to
    1e-3 relative; residual bookkeeping is equal."""
    ef, W, dIs, poses, calib, (w, h) = window
    n_full = 4 + 8 * W.F
    HM = np.zeros((n_full, n_full), np.float32)
    bM = np.zeros(n_full, np.float32)
    Wj, sj = jbd.optimize_device(ef.W, dIs, jnp.asarray(HM), jnp.asarray(bM),
                                 jnp.int32(2), CFG, w, h, 6)
    Wt, st = tbd.optimize_device(convert.window_to_torch(ef.W),
                                 convert.window_images_to_torch(dIs),
                                 t32(HM), t32(bM), 2, TCFG, w, h, 6)
    close(tposes(Wt), jposes(Wj), 0, 1e-4, "poses")
    good = np.asarray(Wj.pt_valid)
    close(npy(Wt.idepth)[good], np.asarray(Wj.idepth)[good], 1e-3, 1e-5, "idepth")
    equal(Wt.res_exist, Wj.res_exist)
    equal(Wt.pt_num_good_res, Wj.pt_num_good_res)
    close(st, sj, 1e-3, 1e-4, "stats")


def _port_ef(ef_j):
    ef = EnergyFunctional(TCFG, ef_j.calib, F=ef_j.F, P=ef_j.P)
    ef.W = convert.window_to_torch(ef_j.W)
    ef.n_frames = ef_j.n_frames
    ef.HM, ef.bM = ef_j.HM.copy(), ef_j.bM.copy()
    ef.pt_valid_np = ef_j.pt_valid_np.copy()
    ef.pt_host_np = ef_j.pt_host_np.astype(np.int64)
    return ef


def test_energy_functional_marginalization(window):
    """EnergyFunctional end to end from one state: BA, point retirement
    into the float64 prior, then frame marginalization (host Schur). HM/bM
    come from float32 device sums, compared within 1e-4 of their scale."""
    ef_j, dIs, poses, idep0, calib, (w, h) = _build_ef(
        pose_noise=2e-3, idepth_noise=0.05, n_pts=100)
    ef_t = _port_ef(ef_j)
    dIs_t = convert.window_images_to_torch(dIs)
    rj = ef_j.optimize(dIs, 6, w, h)
    rt = ef_t.optimize(dIs_t, 6, w, h)
    assert abs(rj - rt) < 1e-3 * max(rj, 1.0)
    ef_t = _port_ef(ef_j)                     # continue from one state
    cand = np.asarray(ef_j.W.pt_valid).copy()
    cand[1::2] = False
    drop = np.zeros_like(cand)
    rec_j, rm_j, dr_j = ef_j.marginalize_and_drop(cand, drop, dIs, w, h)
    rec_t, rm_t, dr_t = ef_t.marginalize_and_drop(
        torch.from_numpy(cand), torch.from_numpy(drop), dIs_t, w, h)
    equal(rm_t, rm_j)
    equal(dr_t, dr_j)
    _rel(ef_t.HM, ef_j.HM, 1e-4, "HM after point marg")
    _rel(ef_t.bM, ef_j.bM, 1e-4, "bM after point marg")
    ef_t = _port_ef(ef_j)
    pd = (np.asarray(ef_j.W.prior[0]), np.asarray(ef_j.W.state[0, :8]))
    ef_j.marginalize_frame(0, prior_delta=pd)
    ef_t.marginalize_frame(0, prior_delta=pd)
    _rel(ef_t.HM, ef_j.HM, 1e-6, "HM after frame marg")
    _rel(ef_t.bM, ef_j.bM, 1e-6, "bM after frame marg")
    for f in ("frame_valid", "T_eval", "pt_host", "res_exist", "Jpdxi"):
        close(getattr(ef_t.W, f), getattr(ef_j.W, f), 0, 0, f)
