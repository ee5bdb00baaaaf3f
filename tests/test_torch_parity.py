"""Full-size parity on the CPU: the port's and the JAX FullSystem on the
104-frame scenes of the head-to-head at 640x480 (BASELINE.md's parity
scene: `make_scene("plane", freq_hi=25, contrast=80, n_waves=32)` on the
straight trajectory, uint8 frames, Config() with the CLI's mode=1 changes
and loop closing off, as tools/ablate_ate.py runs it; and the boxes scene
with the same texture on the same trajectory).

The bisect carries the JAX system at a frame into the port
(utils/convert.full_system_to_torch), steps both on, and at every frame
feeds each module of the port the JAX module's inputs: the tracker and
the hypothesis ranking, the trace, the activation gate (with K1's plain
version) and the activation LM, the BA and both marginalizations. Each
module's worst error is printed beside the tolerance of its slice test.

Slow (two FullSystems at 640x480 on the CPU, tens of minutes); run it
alone, as tests or as a script that prints one JSON line per system (or
per module and frame with --bisect):

    python -m pytest -q -m slow tests/test_torch_parity.py
    python tests/test_torch_parity.py [--frames 104]
        [--scene plane|boxes|bench] [--host-ba] [--bisect 33 38]
        [--config KEY=VALUE ...] [--threads N] [--packages jax port]
"""

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

MODE1 = dict(enable_loop_closing=False, photometric_calibration=0,
             affine_opt_mode_a=0.0, affine_opt_mode_b=0.0)


def _frames(n, scene="plane"):
    """The straight trajectory over the parity scene ("plane", "boxes") or
    the bench scene of chip_smoke.py's phase 3 ("bench":
    PlaneScene(freq_hi=25, contrast=80), time_modes.bench_frames)."""
    from ldso_tpu.math import lie
    from ldso_tpu.synthetic import PlaneScene, default_calib, make_scene
    calib = default_calib(640, 480)
    sc = (PlaneScene(freq_hi=25.0, contrast=80.0) if scene == "bench"
          else make_scene(scene, freq_hi=25.0, contrast=80.0, n_waves=32))
    poses, images = [], []
    for i in range(n):
        t = np.array([0.03 * i, 0.01 * np.sin(0.2 * i), 0.004 * i])
        w = np.array([0.0, 0.0018 * i, 0.0004 * i])
        T_wc = np.asarray(lie.se3_exp(jnp.asarray(np.concatenate([t, w]))))
        poses.append(np.linalg.inv(T_wc))
        img, _ = sc.render(calib, jnp.asarray(poses[-1], jnp.float32))
        images.append(np.clip(np.round(np.asarray(img)), 0, 255)
                      .astype(np.uint8))
    return calib, poses, images


def _configs(**kw):
    from ldso_tpu.config import Config as JC
    from ldso_tpu_torch.config import Config as TC
    kw = {**MODE1, **kw}
    return dataclasses.replace(JC(), **kw), dataclasses.replace(TC(), **kw)


def _summary(name, fs, poses, n, t0):
    from ldso_tpu_torch.io.trajectory import ate_rmse
    kfs = fs.global_map.get_all_kfs()
    est = [f for f in fs.all_frames if f.pose_valid]
    return dict(
        package=name, frames=n, lost=bool(fs.is_lost),
        kf_ids=[kf.id for kf in kfs],
        kf_centres=[np.linalg.inv(kf.T_cw)[:3, 3].tolist() for kf in kfs],
        ate_kf_mm=1e3 * ate_rmse([kf.T_cw for kf in kfs],
                                 [poses[kf.id] for kf in kfs]),
        ate_mm=1e3 * ate_rmse([f.T_cw for f in est],
                              [poses[f.id] for f in est]),
        wall_s=time.time() - t0)


def run_both(n: int = 104, scene: str = "plane",
             packages=("jax", "port"), **cfg_kw):
    """Both FullSystems (or those named in `packages`) on the same frames;
    returns one dict per package: keyframe frame ids, keyframe ATE
    (sim3-aligned, mm), all-frames ATE, wall seconds. cfg_kw go to both
    Configs (e.g. ba_device_lm=False)."""
    from ldso_tpu.system.full_system import FullSystem as JFS
    from ldso_tpu_torch.system.full_system import FullSystem as TFS
    calib, poses, images = _frames(n, scene)
    jc, tc = _configs(**cfg_kw)
    out = []
    make = dict(jax=lambda: JFS(calib, jc),
                port=lambda: TFS(calib, tc, device="cpu"))
    for name in packages:
        fs = make[name]()
        t0 = time.time()
        for i, img in enumerate(images):
            fs.add_active_frame(img, i, 1.0, i * 0.05)
            if fs.is_lost:
                break
        out.append(_summary(name, fs, poses, n, t0))
        if name == "port":
            out[-1]["torch_threads"] = torch.get_num_threads()
    return out


def centre_gaps_mm(a, b):
    """Distance between the two runs' keyframe centres, keyframe by
    keyframe, in mm."""
    return [1e3 * float(np.linalg.norm(np.subtract(x, y)))
            for x, y in zip(a["kf_centres"], b["kf_centres"])]


# ---------------------------------------------------------------- the bisect

def _worst(frame, module, checks):
    """One row: the field whose error is largest against its tolerance.
    checks: (field, port, jax, rtol, atol) with rtol None for a discrete
    field (error = mismatch count, tolerance 0)."""
    from torch_port_utils import npy
    best = None
    for field, got, ref, rtol, atol in checks:
        got, ref = npy(got), npy(ref)
        if rtol is None:
            err = int(np.sum(got != ref))
            row = (float(err > 0) * np.inf if err else 0.0, field, err, 0)
        else:
            got = got.astype(np.float64)
            ref = ref.astype(np.float64)
            both = np.isfinite(got) & np.isfinite(ref)
            bad = int(np.sum(np.isfinite(got) != np.isfinite(ref)))
            d = np.where(both, np.abs(got - ref), 0.0)
            tol = atol + rtol * np.abs(np.where(both, ref, 0.0))
            r = np.where(d > tol, np.inf, 0.0)
            r = np.where(tol > 0, d / np.where(tol > 0, tol, 1.0), r)
            k = int(np.argmax(r)) if d.size else 0
            e, t = (float(d.flat[k]), float(tol.flat[k])) if d.size else (0., 1.)
            rk = float(r.flat[k]) if d.size else 0.0
            row = (np.inf if bad else rk, field, e if not bad else bad, t)
        if best is None or row[0] > best[0]:
            best = row
    ratio, field, err, tol = best
    return dict(frame=frame, module=module, field=field, max_err=err,
                tol=tol, within=bool(ratio <= 1.0))


def _trace_f64_oracle(arena, dI, transforms, n, calib, jcfg, pj, pt, tols):
    """Where the port's trace leaves its tolerance against the JAX trace,
    run the JAX trace in float64 on the same inputs and count, over the
    (lane, field) pairs out of tolerance, on how many the port is closer
    to the float64 result than the JAX package is. Both are float32
    evaluations of one formula: rounding leaves either one the closer at
    random (about half the pairs), a port fault leaves the port the
    farther on nearly all. `rounding` is True when the port is the closer
    on at least a third. (The quality ratio of two near-zero SSD minima,
    the pixel-to-idepth interval conversion and near-tied search steps
    amplify the rounding past the slice test's tolerance.)"""
    import jax
    from ldso_tpu.frontend import immature as jim
    from torch_port_utils import npy
    with jax.enable_x64(True):
        f64 = lambda a: (jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
                         if np.asarray(a).dtype == np.float32
                         else jnp.asarray(np.asarray(a)))
        ref = jim.trace_arena_prefix(
            jim.ImmatureArena(pool=jim.ImmaturePool(*map(f64, arena.pool)),
                              host=f64(arena.host)),
            f64(dI), *map(f64, transforms), calib, jcfg, n).pool
        ref = {f: np.asarray(getattr(ref, f)) for f, _ in tols}
    stats, closer, pairs = {}, 0, 0
    for f, rtol in tols:
        j, t, r = (npy(getattr(pj, f))[:n].astype(np.float64),
                   npy(getattr(pt, f))[:n].astype(np.float64), ref[f][:n])
        fin = np.isfinite(j) & np.isfinite(t) & np.isfinite(r)
        out = fin & (np.abs(t - j) > 1e-4 + rtol * np.abs(j))
        if out.any():
            dt, dj = np.abs(t - r)[out], np.abs(j - r)[out]
            stats[f] = dict(lanes=int(out.sum()),
                            port_closer=int(np.sum(dt < dj)),
                            median_port_vs_f64=float(np.median(dt)),
                            median_jax_vs_f64=float(np.median(dj)))
            closer += stats[f]["port_closer"]
            pairs += stats[f]["lanes"]
    return dict(rounding=3 * closer >= pairs, port_closer=closer,
                out_of_tolerance=pairs, f64_oracle=stats)


def _activate_f64(arena, idm, sane, tables, masks, dIs, calib, jcfg):
    """The JAX activation in float64 on the same inputs: (n, 3) rows
    [idepth, ok, n_good]."""
    import jax
    from ldso_tpu.frontend import immature as jim
    with jax.enable_x64(True):
        f64 = lambda a: (jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
                         if np.asarray(a).dtype == np.float32
                         else jnp.asarray(np.asarray(a)))
        return np.asarray(jim.activate_arena(
            jim.ImmatureArena(pool=jim.ImmaturePool(*map(f64, arena.pool)),
                              host=f64(arena.host)),
            f64(idm), jnp.asarray(sane), *map(f64, tables), jnp.asarray(masks),
            f64(dIs), calib, jcfg))


def _activate_counts_oracle(a64, actj, actt, sane):
    """Where the activation's discrete outputs (ok, n_good) differ: the
    float64 activation's, candidate by candidate. As for the trace,
    rounding leaves either package the one that agrees with float64 at
    random, a port fault leaves the port the one that disagrees on nearly
    all: `rounding` is True when the port agrees with float64 on at least
    a third of the differing candidates. Lanes that are not candidates
    (not `sane`) carry no result anyone reads and are not counted."""
    diff = sane & (((actj[:, 1] > 0.5) != (actt[:, 1] > 0.5))
                   | (actj[:, 2] != actt[:, 2]))
    ref = a64[diff]
    port_agrees = int(np.sum(((actt[diff, 1] > 0.5) == (ref[:, 1] > 0.5))
                             & (actt[diff, 2] == ref[:, 2])))
    n = int(diff.sum())
    return dict(rounding=3 * port_agrees >= n, differing_candidates=n,
                port_agrees_with_f64=port_agrees,
                jax_agrees_with_f64=int(np.sum(
                    ((actj[diff, 1] > 0.5) == (ref[:, 1] > 0.5))
                    & (actj[diff, 2] == ref[:, 2]))))


def _activate_f64_oracle(arena, idm, sane, tables, masks, dIs, calib, jcfg,
                         actj, actt, both):
    """Where the activation's idepths leave their tolerance: the JAX
    activation in float64 on the same inputs. `rounding` is True when the
    port's largest distance from it, over the candidates out of
    tolerance, is no larger than the JAX package's own largest float32
    distance from it over every optimized candidate: the port stays
    inside the rounding envelope the JAX package shows on this input."""
    a64 = _activate_f64(arena, idm, sane, tables, masks, dIs, calib,
                        jcfg)[:, 0]
    j, t = actj[:, 0].astype(np.float64), actt[:, 0].astype(np.float64)
    out = both & (np.abs(t - j) > 1e-6 + 1e-4 * np.abs(j))
    ok = both & np.isfinite(a64)
    port_err = float(np.max(np.abs(t - a64)[out & ok], initial=0.0))
    jax_env = float(np.max(np.abs(j - a64)[ok], initial=0.0))
    sel = out & ok
    return dict(rounding=bool(port_err <= jax_env),
                port_vs_f64_max=port_err, jax_vs_f64_envelope=jax_env,
                out_of_tolerance=int(sel.sum()),
                port_closer=int(np.sum(np.abs(t - a64)[sel]
                                       < np.abs(j - a64)[sel])))


def _rank_unbatched_oracle(ref, pyr, T_inits, aff, exposure, calib, jcfg,
                           sj, st):
    """Where the ranking leaves its tolerance: the JAX package's own
    unbatched evaluation of each such hypothesis (its `_calc_res` on one
    pose; `rank_hypotheses` vmaps it). `rounding` is True when the port
    agrees with that within the ranking's tolerance, i.e. the JAX batched
    and unbatched evaluations differ by as much as the port does (points
    on the in-bounds border of the coarsest level flip with rounding)."""
    from ldso_tpu.frontend import tracker as jtr
    from torch_port_utils import npy
    sj, st = npy(sj), npy(st)
    out = np.abs(st - sj) > 1e-4 + 1e-4 * np.abs(sj)
    single = []
    for k in np.flatnonzero(out):
        _, stats = jtr._calc_res(
            ref, pyr, calib.levels - 1, jnp.asarray(T_inits[k], jnp.float32),
            jnp.asarray(aff, jnp.float32), jnp.float32(exposure),
            jcfg.coarse_cutoff_th, calib, jcfg, compute_flow=False)
        E, num = (float(x) for x in np.asarray(stats)[:2])
        single.append(E / max(num, 1.0) if num > 10 else np.inf)
    single = np.asarray(single)
    d = np.abs(st[out] - single)
    tol = 1e-4 + 1e-4 * np.abs(single)
    return dict(rounding=bool(np.all(d <= tol)),
                vs_jax_unbatched_max_err=float(d.max()),
                jax_batched_vs_unbatched_max_err=float(
                    np.abs(sj[out] - single).max()))


@contextlib.contextmanager
def _jax_precalc(W, fields):
    """While inside, the port's BA precalc takes `fields` from the JAX
    package's make_precalc of window W (float32 values)."""
    from ldso_tpu.backend import ba as jba
    from ldso_tpu_torch.backend import ba as tba
    pj = jba.make_precalc(W)
    make = tba.make_precalc

    def patched(Wt):
        return make(Wt)._replace(**{f: torch.from_numpy(
            np.array(getattr(pj, f), np.float32)) for f in fields})
    tba.make_precalc = patched
    try:
        yield
    finally:
        tba.make_precalc = make


def _port_ef(jef, tcfg):
    """A port EnergyFunctional in the JAX one's current state."""
    from ldso_tpu_torch.backend.energy_functional import EnergyFunctional
    from ldso_tpu_torch.utils import convert
    ef = EnergyFunctional(tcfg, jef.calib, F=jef.F, P=jef.P, device="cpu")
    ef.W = convert.window_to_torch(jef.W)
    ef.n_frames = jef.n_frames
    ef.HM, ef.bM = jef.HM.copy(), jef.bM.copy()
    ef.res_in_m = jef.res_in_m
    ef.pt_valid_np = jef.pt_valid_np.copy()
    ef.pt_host_np = jef.pt_host_np.astype(np.int64)
    ef.window_shells = [types.SimpleNamespace(kf_id=f.kf_id)
                        for f in jef.window_shells]
    return ef


@contextlib.contextmanager
def module_hooks(jfs, tcfg, rows, frame):
    """While active, every module call of the JAX system `jfs` also runs
    the port's module on the JAX module's inputs and appends the
    comparison to `rows` (frame number from frame[0])."""
    from ldso_tpu.frontend import immature as jim
    from ldso_tpu.frontend import tracker as jtr
    from ldso_tpu.system import full_system as jfull
    from ldso_tpu_torch.frontend import immature as tim
    from ldso_tpu_torch.frontend import tracker as ttr
    from ldso_tpu_torch.system import full_system as tfull
    from ldso_tpu_torch.utils import convert
    calib, jcfg = jfs.calib, jfs.cfg
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    j32 = lambda a: jnp.asarray(np.asarray(a, np.float32))       # noqa: E731
    ef = jfs.ef
    orig = dict(track=jfs._track_new_coarse, act=jfull._activate_fused,
                opt=ef.optimize, mdisp=ef.marginalize_and_drop_dispatch,
                mcons=ef.marginalize_and_drop_consume,
                mframe=ef.marginalize_frame)
    pending = {}

    def track(shell, image, *a, **k):
        ref, ref_shell = jfs._tracker_ref_pair
        if ref is None:
            ref, ref_shell = jfs.tracker_ref, jfs.tracker_ref_shell
        fr = jfs.all_frames
        if (len(fr) >= 3 and fr[-2].pose_valid and fr[-3].pose_valid
                and ref_shell.pose_valid):
            tries = jfull._motion_hypotheses(
                fr[-2].T_cw @ np.linalg.inv(ref_shell.T_cw),
                fr[-3].T_cw @ np.linalg.inv(fr[-2].T_cw))
            aff_last = fr[-2].aff.copy()
        else:
            tries, aff_last = [np.eye(4)], np.zeros(2)
        arena0 = jfs.imm_arena
        window = list(jfs.window_frames)
        ok = orig["track"](shell, image, *a, **k)
        pyr = jfs._frame_pyr
        ref_t = convert.tracker_ref_to_torch(ref)
        pyr_t = convert.pyramid_to_torch(pyr)
        L = calib.levels
        noab = np.full(L, 1e9, np.float32)
        oj = jtr.track_frame(ref, pyr, j32(tries[0]), j32(aff_last),
                             jnp.float32(shell.exposure), j32(noab), calib,
                             jcfg, L - 1)
        ot = ttr.track_frame(ref_t, pyr_t, f32(tries[0]), f32(aff_last),
                             f32(shell.exposure), f32(noab), calib, tcfg,
                             L - 1)
        rows.append(_worst(frame[0], "track_frame", [
            ("T", ot[0], oj[0], 0, 1e-4), ("aff", ot[1], oj[1], 0, 1e-3),
            ("ok", ot[2], oj[2], None, None),
            ("residuals", ot[3], oj[3], 1e-3, 1e-4),
            ("flow", ot[4], oj[4], 1e-3, 1e-4)]))
        if len(tries) > 1:
            sj = jtr.rank_hypotheses(ref, pyr, j32(np.stack(tries[1:])),
                                     j32(aff_last), jnp.float32(shell.exposure),
                                     calib, jcfg, L - 1)
            st = ttr.rank_hypotheses(ref_t, pyr_t, f32(np.stack(tries[1:])),
                                     f32(aff_last), f32(shell.exposure),
                                     calib, tcfg, L - 1)
            row = _worst(frame[0], "rank_hypotheses",
                         [("scores", st, sj, 1e-4, 1e-4)])
            if not row["within"]:
                row.update(_rank_unbatched_oracle(
                    ref, pyr, np.stack(tries[1:]), aff_last, shell.exposure,
                    calib, jcfg, sj, st))
            rows.append(row)
        # the trace of the pre-frame arena against this frame, with the
        # host-side transforms of _trace_new_coarse from the tracked pose
        F = ef.F
        K, Ki = calib.K(0), calib.Ki(0)
        KRKis = np.tile(np.eye(3), (F, 1, 1))
        Kts = np.zeros((F, 3))
        affs = np.tile(np.array([1.0, 0.0]), (F, 1))
        for i, host in enumerate(window):
            T_rel = shell.T_cw @ np.linalg.inv(host.T_cw)
            KRKis[i] = K @ T_rel[:3, :3] @ Ki
            Kts[i] = K @ T_rel[:3, 3]
            ra = (np.exp(shell.aff[0] - host.aff[0])
                  * (shell.exposure or 1.0) / (host.exposure or 1.0))
            affs[i] = (ra, shell.aff[1] - ra * host.aff[1])
        a_t = convert.arena_to_torch(arena0)
        n = tim.arena_watermark(a_t)
        if n:
            aj = jim.trace_arena_prefix(arena0, pyr.dI[0], j32(KRKis),
                                        j32(Kts), j32(affs), calib, jcfg, n)
            at = tim.trace_arena_prefix(a_t, pyr_t.dI[0], f32(KRKis),
                                        f32(Kts), f32(affs), calib, tcfg, n)
            pj, pt = aj.pool, at.pool
            tols = [(f, 1e-4) for f in ("idepth_min", "idepth_max", "last_u",
                                        "last_v", "last_interval")]
            tols.append(("quality", 2e-3))
            row = _worst(frame[0], "trace", [
                ("status", pt.status, pj.status, None, None)]
                + [(f, getattr(pt, f), getattr(pj, f), rtol, 1e-4)
                   for f, rtol in tols])
            if not row["within"]:
                row.update(_trace_f64_oracle(
                    arena0, pyr.dI[0], (KRKis, Kts, affs), n, calib, jcfg,
                    pj, pt, tols))
            rows.append(row)
        return ok

    def activate(W, arena, dIs, KRKis, Kts, Rs, ts, affs_a, masks,
                 min_act_dist, marg_flags, newest, nf, cfg, calib_, w1, h1,
                 n_act=1 << 30):
        out = orig["act"](W, arena, dIs, KRKis, Kts, Rs, ts, affs_a, masks,
                          min_act_dist, marg_flags, newest, nf, cfg, calib_,
                          w1, h1, n_act=n_act)
        n = min(n_act, arena.host.shape[0])
        arena_n = jim.ImmatureArena(
            pool=jim.ImmaturePool(*[x[:n] for x in arena.pool]),
            host=arena.host[:n])
        gj = np.asarray(jfull._gate_candidates_fused(
            W, newest, arena_n, KRKis, Kts, min_act_dist, marg_flags, cfg,
            w1, h1))
        Wt = convert.window_to_torch(W)
        at = convert.arena_to_torch(arena_n)
        to_opt, remove, idm = tfull._gate_candidates_fused(
            Wt, int(newest), at, f32(KRKis), f32(Kts), float(min_act_dist),
            torch.from_numpy(np.asarray(marg_flags)), tcfg, w1, h1)
        rows.append(_worst(frame[0], "activation_gate", [
            ("to_opt", to_opt, gj[:, 0] > 0.5, None, None),
            ("remove", remove, gj[:, 1] > 0.5, None, None),
            ("idm", idm, gj[:, 2], 1e-6, 0.0)]))
        host = np.asarray(arena_n.host)
        sane = ((gj[:, 0] > 0.5) & (host >= 0) & (host < int(nf))
                & (host != int(newest)))
        actj = np.asarray(jim.activate_arena(
            arena_n, jnp.asarray(gj[:, 2]), jnp.asarray(sane), Rs, ts,
            affs_a, masks, dIs, calib_, cfg))
        actt = tim.activate_arena(
            at, torch.from_numpy(gj[:, 2].copy()), torch.from_numpy(sane),
            f32(Rs), f32(ts), f32(affs_a), torch.from_numpy(np.asarray(masks)),
            convert.window_images_to_torch(dIs), calib_, tcfg).numpy()
        both = sane & (actj[:, 1] > 0.5) & (actt[:, 1] > 0.5)
        row = _worst(frame[0], "activate", [
            ("ok", actt[:, 1] > 0.5, actj[:, 1] > 0.5, None, None),
            ("n_good", actt[:, 2], actj[:, 2], None, None),
            ("idepth", actt[both, 0], actj[both, 0], 1e-4, 1e-6)])
        if not row["within"] and row["field"] == "idepth":
            row.update(_activate_f64_oracle(
                arena_n, gj[:, 2], sane, (Rs, ts, affs_a), masks, dIs,
                calib_, cfg, actj, actt, both))
        elif not row["within"]:
            row.update(_activate_counts_oracle(_activate_f64(
                arena_n, gj[:, 2], sane, (Rs, ts, affs_a), masks, dIs,
                calib_, cfg), actj, actt, sane))
        rows.append(row)
        return out

    def optimize(dIs, max_it, w, h, defer_stats=False):
        ef_t = _port_ef(ef, tcfg)
        rj = orig["opt"](dIs, max_it, w, h)
        rt = ef_t.optimize(convert.window_images_to_torch(dIs), max_it, w, h)
        from ldso_tpu.backend.window import current_poses as jposes
        from ldso_tpu_torch.backend.window import current_poses as tposes
        good = np.asarray(ef.W.pt_valid)
        rows.append(_worst(frame[0], "optimize", [
            ("poses", tposes(ef_t.W), jposes(ef.W), 0, 1e-4),
            ("idepth", ef_t.W.idepth.numpy()[good],
             np.asarray(ef.W.idepth)[good], 1e-3, 1e-5),
            ("res_exist", ef_t.W.res_exist, ef.W.res_exist, None, None),
            ("rmse", np.float64(rt), np.float64(rj), 1e-3, 1e-3)]))
        return rj

    def marg_dispatch(marg_cand, drop, dIs, w, h):
        args = (torch.from_numpy(np.asarray(marg_cand)),
                torch.from_numpy(np.asarray(drop)),
                convert.window_images_to_torch(dIs), w, h)
        ef_t = _port_ef(ef, tcfg)
        pending["marg"] = (ef_t, ef_t.marginalize_and_drop(*args))
        # the same from the same state with the JAX package's float32
        # precalc matrices (K R K^-1 per frame pair), for the oracle
        ef_k = _port_ef(ef, tcfg)
        with _jax_precalc(ef.W, ("KRKi", "Kt")):
            ef_k.marginalize_and_drop(*args)
        pending["marg_krki"] = ef_k
        return orig["mdisp"](marg_cand, drop, dIs, w, h)

    def marg_consume(packed):
        rec, really, dropped = orig["mcons"](packed)
        ef_t, (rec_t, really_t, dropped_t) = pending.pop("marg")
        ef_k = pending.pop("marg_krki")
        sH = max(float(np.abs(ef.HM).max()), 1e-30)
        sb = max(float(np.abs(ef.bM).max()), 1e-30)
        row = _worst(frame[0], "marginalize_points", [
            ("really", really_t, really, None, None),
            ("dropped", dropped_t, dropped, None, None),
            ("HM", ef_t.HM, ef.HM, 0, 1e-4 * sH),
            ("bM", ef_t.bM, ef.bM, 0, 1e-4 * sb)])
        if not row["within"]:
            # rounding when the port lands within tolerance once it
            # starts from the JAX package's float32 rounding of K R K^-1
            k = _worst(frame[0], "", [("HM", ef_k.HM, ef.HM, 0, 1e-4 * sH),
                                      ("bM", ef_k.bM, ef.bM, 0, 1e-4 * sb)])
            row.update(rounding=k["within"], with_jax_KRKi_max_err=k["max_err"],
                       with_jax_KRKi_tol=k["tol"])
        rows.append(row)
        return rec, really, dropped

    def marg_frame(idx, pre_drop=None, prior_delta=None):
        ef_t = _port_ef(ef, tcfg)
        pd = None if pre_drop is None else torch.from_numpy(
            np.asarray(pre_drop))
        orig["mframe"](idx, pre_drop=pre_drop, prior_delta=prior_delta)
        ef_t.marginalize_frame(idx, pre_drop=pd, prior_delta=prior_delta)
        sH = max(float(np.abs(ef.HM).max()), 1e-30)
        sb = max(float(np.abs(ef.bM).max()), 1e-30)
        rows.append(_worst(frame[0], "marginalize_frame", [
            ("HM", ef_t.HM, ef.HM, 0, 1e-6 * sH),
            ("bM", ef_t.bM, ef.bM, 0, 1e-6 * sb),
            ("frame_valid", ef_t.W.frame_valid, ef.W.frame_valid, None, None),
            ("res_exist", ef_t.W.res_exist, ef.W.res_exist, None, None)]))

    jfs._track_new_coarse = track
    jfull._activate_fused = activate
    ef.optimize = optimize
    ef.marginalize_and_drop_dispatch = marg_dispatch
    ef.marginalize_and_drop_consume = marg_consume
    ef.marginalize_frame = marg_frame
    try:
        yield
    finally:
        jfull._activate_fused = orig["act"]
        for k in ("_track_new_coarse",):
            jfs.__dict__.pop(k, None)
        for k in ("optimize", "marginalize_and_drop_dispatch",
                  "marginalize_and_drop_consume", "marginalize_frame"):
            ef.__dict__.pop(k, None)


def bisect(first: int = 33, last: int = 38, scene: str = "plane",
           frames=None, configs=None, **cfg_kw):
    """Step the JAX FullSystem through frame `first`, carry it into the
    port, then step both through frame `last`, each JAX module call
    checked against the port's module on the same inputs. `frames`
    (calib, poses, images) and `configs` (JAX, port) override the
    full-size scene and Config. Returns
    (module rows, per-frame rows with the two systems' camera centres'
    distance in um)."""
    from ldso_tpu.system.full_system import FullSystem as JFS
    from ldso_tpu_torch.utils.convert import full_system_to_torch
    calib, poses, images = frames or _frames(last + 1, scene)
    jc, tc = configs or _configs(**cfg_kw)
    jfs = JFS(calib, jc)
    for i in range(first + 1):
        jfs.add_active_frame(images[i], i, 1.0, i * 0.05)
    tfs = full_system_to_torch(jfs, tc, "cpu")
    rows, frames, frame = [], [], [0]
    with module_hooks(jfs, tc, rows, frame):
        for i in range(first + 1, last + 1):
            frame[0] = i
            sj = jfs.add_active_frame(images[i], i, 1.0, i * 0.05)
            st = tfs.add_active_frame(images[i], i, 1.0, i * 0.05)
            frames.append(dict(
                frame=i, keyframe_jax=sj.kf_id >= 0, keyframe_port=st.kf_id >= 0,
                centre_gap_um=1e6 * float(np.linalg.norm(
                    np.linalg.inv(sj.T_cw)[:3, 3]
                    - np.linalg.inv(st.T_cw)[:3, 3]))))
    return rows, frames


@pytest.mark.slow
def test_plane_parity_at_full_size():
    """The same keyframes, both keyframe ATEs under the 5 mm end-to-end
    bound. The North-star criterion also asks for the two ATEs within 5%
    of each other; they are 10-29% apart, and the port alone moves 17%
    with torch's thread count: float32 rounding amplified by the closed
    loop, as the bisect shows (test_bisect_plane; ROADMAP §3), so the gap
    is printed here, not asserted."""
    jax_run, port_run = run_both()
    for r in (jax_run, port_run):
        print(json.dumps({k: v for k, v in r.items() if k != "kf_centres"}))
    assert port_run["kf_ids"] == jax_run["kf_ids"]
    assert not (port_run["lost"] or jax_run["lost"])
    assert max(port_run["ate_kf_mm"], jax_run["ate_kf_mm"]) < 5.0


@pytest.mark.slow
def test_boxes_parity_at_full_size():
    """The boxes half of the North-star criterion: both systems track all
    104 frames under the 5 mm bound; the keyframes and the ATE gap (5.7%
    with 3 threads) are printed, not asserted, as on the plane (ROADMAP
    §3 logs them)."""
    jax_run, port_run = run_both(scene="boxes")
    for r in (jax_run, port_run):
        print(json.dumps({k: v for k, v in r.items() if k != "kf_centres"}))
    assert not (port_run["lost"] or jax_run["lost"])
    assert max(port_run["ate_kf_mm"], jax_run["ate_kf_mm"]) < 5.0


@pytest.mark.slow
def test_bisect_plane():
    """The plane scene carried at frame 33 and stepped through 38: every
    port module, fed the JAX module's inputs, stays within its slice
    test's tolerance or, where it leaves it, an oracle shows float32
    rounding (the float64 trace and activation, the JAX package's own
    unbatched ranking, its float32 K R K^-1; see the oracles' docstrings);
    and the carried port
    system keeps the same keyframes."""
    rows, frames = bisect()
    for r in rows + frames:
        print(json.dumps(r))
    assert {r["module"] for r in rows} >= {"track_frame", "trace",
                                           "activation_gate", "activate",
                                           "optimize", "marginalize_points"}
    assert all(f["keyframe_jax"] == f["keyframe_port"] for f in frames)
    bad = [r for r in rows if not (r["within"] or r.get("rounding"))]
    assert not bad, bad


def config_overrides(pairs):
    """`key=value` strings -> Config keyword arguments (Python literals,
    else strings): `--config force_accept_step=False`."""
    import ast
    out = {}
    for p in pairs:
        k, v = p.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=104)
    ap.add_argument("--scene", default="plane",
                    choices=("plane", "boxes", "bench"))
    ap.add_argument("--host-ba", action="store_true",
                    help="ba_device_lm=False in both packages")
    ap.add_argument("--config", nargs="+", default=[], metavar="KEY=VALUE",
                    help="Config fields set in both packages, after the "
                         "mode=1 changes")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch's intra-op thread count for the port")
    ap.add_argument("--packages", nargs="+", default=["jax", "port"],
                    choices=("jax", "port"))
    ap.add_argument("--bisect", type=int, nargs=2, metavar=("FIRST", "LAST"))
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    kw = dict(ba_device_lm=False) if args.host_ba else {}
    kw.update(config_overrides(args.config))
    if args.bisect:
        rows, frames = bisect(*args.bisect, scene=args.scene, **kw)
        for r in rows + frames:
            print(json.dumps(r), flush=True)
    else:
        runs = run_both(args.frames, args.scene, args.packages, **kw)
        for r in runs:
            print(json.dumps(dict(r, config=kw)), flush=True)
        if len(runs) < 2:
            sys.exit(0)
        jax_run, port_run = runs
        gaps = centre_gaps_mm(jax_run, port_run)
        first = next((k for k, g in enumerate(gaps) if g > 4.2e-3), None)
        print(json.dumps(dict(
            kf_centre_gap_mm=gaps,
            first_kf_parting_over_4_2um=(None if first is None
                                         else jax_run["kf_ids"][first]))),
              flush=True)
