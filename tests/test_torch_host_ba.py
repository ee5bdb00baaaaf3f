"""The host-orchestrated BA (`ba_device_lm=False` and every solver mode that
only the host LM runs): EnergyFunctional._optimize_host, solve_system, the
nullspace orthogonalizations and the orthogonalizing point
marginalizations. Both packages start from test_backend._build_ef's window,
carried over with utils/convert; the port EF sees the same window shells."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from torch_port_utils import close, equal, npy

from test_backend import CFG, _build_ef

from ldso_tpu import config as jconf
from ldso_tpu.backend.window import current_poses as jposes
from ldso_tpu_torch.backend.energy_functional import EnergyFunctional
from ldso_tpu_torch.backend.window import current_poses as tposes
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.utils import convert


def _tcfg(jcfg):
    return TC(**{f.name: getattr(jcfg, f.name)
                 for f in dataclasses.fields(jcfg)})


def _shells(kf_ids):
    return [types.SimpleNamespace(kf_id=k) for k in kf_ids]


def _pair(mode=0, kf_ids=(0, 1, 2, 3), **kw):
    """(JAX EF, port EF, dIs JAX, dIs port, (w, h)) from one four-frame
    window, both under CFG with `solver_mode=mode` and the other fields in
    kw. Four frames, so optimize runs the 6 iterations it is asked for
    (a window of 3 runs 15): SOLVER_MOMENTUM under force-accept does not
    converge on this window, and over 15 iterations both packages' LMs
    wander apart from their float32 rounding alone."""
    ef_j, dIs, poses, idep0, calib, wh = _build_ef(
        n_frames=4, pose_noise=2e-3, idepth_noise=0.05, n_pts=100)
    jcfg = dataclasses.replace(CFG, solver_mode=mode, **kw)
    ef_j.cfg = jcfg
    ef_j.window_shells = _shells(kf_ids)
    ef_t = EnergyFunctional(_tcfg(jcfg), ef_j.calib, F=ef_j.F, P=ef_j.P,
                            device="cpu")
    ef_t.W = convert.window_to_torch(ef_j.W)
    ef_t.n_frames = ef_j.n_frames
    ef_t.HM, ef_t.bM = ef_j.HM.copy(), ef_j.bM.copy()
    ef_t.pt_valid_np = ef_j.pt_valid_np.copy()
    ef_t.pt_host_np = ef_j.pt_host_np.astype(np.int64)
    ef_t.window_shells = _shells(kf_ids)
    return ef_j, ef_t, dIs, convert.window_images_to_torch(dIs), wh


S = jconf
CASES = {
    # the reference's accept/reject LM with its adaptive damping (under
    # FIX_LAMBDA a rejected step is solved again unchanged, so the loop
    # stalls at the first rejection, wherever that falls)
    "force_accept_off": dict(mode=S.SOLVER_ORTHOGONALIZE_X_LATER,
                             force_accept_step=False, ba_device_lm=False),
    "fix_lambda_orth_system_no_frame0": dict(
        mode=S.SOLVER_FIX_LAMBDA | S.SOLVER_ORTHOGONALIZE_SYSTEM,
        kf_ids=(1, 2, 3, 4), ba_device_lm=False),
    "momentum_force_accept": dict(mode=S.SOLVER_MOMENTUM),
    "momentum_accept_reject": dict(mode=S.SOLVER_MOMENTUM,
                                   force_accept_step=False,
                                   ba_device_lm=False),
    "stepmomentum_remove_poseprior": dict(
        mode=S.SOLVER_STEPMOMENTUM | S.SOLVER_REMOVE_POSEPRIOR,
        ba_device_lm=False),
    "svd_cut7_orth_x": dict(
        mode=S.SOLVER_SVD | S.SOLVER_SVD_CUT7 | S.SOLVER_ORTHOGONALIZE_X,
        ba_device_lm=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimize_host(case):
    """The whole host LM from one window: the solves run in float64 on both
    sides from float32 device sums, so poses agree to 1e-4 and idepths to
    1e-3 relative (the device-BA test's tolerances); the final RMSE within
    1e-3 relative and the residual bookkeeping equal."""
    kw = dict(CASES[case])
    ef_j, ef_t, dIs_j, dIs_t, (w, h) = _pair(**kw)
    rj = ef_j.optimize(dIs_j, 6, w, h)
    rt = ef_t.optimize(dIs_t, 6, w, h)
    assert not (ef_j.is_lost or ef_t.is_lost)
    assert abs(rj - rt) < 1e-3 * max(rj, 1.0), (rj, rt)
    close(tposes(ef_t.W), jposes(ef_j.W), 0, 1e-4, "poses")
    good = np.asarray(ef_j.W.pt_valid)
    close(npy(ef_t.W.idepth)[good], np.asarray(ef_j.W.idepth)[good], 1e-3,
          1e-5, "idepth")
    equal(ef_t.W.res_exist, ef_j.W.res_exist)
    equal(ef_t.W.pt_num_good_res, ef_j.W.pt_num_good_res)
    assert ef_t.res_in_a == ef_j.res_in_a


@pytest.mark.parametrize("mode", ["POINTMARG", "FULL"])
def test_orthogonalizing_point_marginalization(mode):
    """marginalize_points under SOLVER_ORTHOGONALIZE_POINTMARG (the prior
    projected before the point system is added; frame 0 out of the window)
    and _FULL (projected after): HM/bM within 1e-4 of their scale, as the
    plain marginalization test."""
    bit = getattr(jconf, "SOLVER_ORTHOGONALIZE_" + mode)
    ef_j, ef_t, dIs_j, dIs_t, (w, h) = _pair(mode=bit, kf_ids=(1, 2, 3, 4))
    rng = np.random.RandomState(4)
    # a non-zero prior, so the projection before the point system shows
    A = rng.randn(ef_j.HM.shape[0], ef_j.HM.shape[0])
    ef_j.HM = A @ A.T
    ef_j.bM = rng.randn(ef_j.HM.shape[0])
    ef_t.HM, ef_t.bM = ef_j.HM.copy(), ef_j.bM.copy()
    mask = np.asarray(ef_j.W.pt_valid).copy()
    mask[1::2] = False
    import jax.numpy as jnp
    ef_j.marginalize_points(jnp.asarray(mask), dIs_j)
    ef_t.marginalize_points(torch.from_numpy(mask))
    for a, b, what in ((ef_t.HM, ef_j.HM, "HM"), (ef_t.bM, ef_j.bM, "bM")):
        close(a, b, 1e-4, 1e-4 * float(np.abs(b).max()), what)
    equal(ef_t.pt_valid_np, ef_j.pt_valid_np)
    equal(ef_t.W.pt_valid, ef_j.W.pt_valid)
    assert ef_t.res_in_m == ef_j.res_in_m


def test_every_solver_mode_builds():
    """The port builds an EnergyFunctional under every solver-mode bit the
    JAX package accepts, on both BA paths where the JAX Config validates."""
    bits = [getattr(jconf, n) for n in dir(jconf) if n.startswith("SOLVER_")
            and isinstance(getattr(jconf, n), int)]
    calib = _build_ef(n_frames=2, n_pts=16)[4]
    built = 0
    for bit in bits:
        for device_lm in (True, False):
            for fa in (True, False):
                jcfg = dataclasses.replace(CFG, solver_mode=bit,
                                           ba_device_lm=device_lm,
                                           force_accept_step=fa)
                try:
                    jcfg.validate()
                except ValueError:
                    with pytest.raises(ValueError):
                        _tcfg(jcfg).validate()
                    continue
                EnergyFunctional(_tcfg(jcfg).validate(), calib, F=3, P=16,
                                 device="cpu")
                built += 1
    assert built >= 3 * len(bits)
