"""The revisit head-to-head on the CPU at full size: the port's and the JAX
package's FullSystem with loop closing on, on the 150-frame out-and-back
of tools/head_to_head.py (`--traj revisit --frames 150`, BASELINE.md's r5
loop run): `make_scene("plane", freq_hi=25, contrast=80, n_waves=32)` at
640x480, the exposure ramp, frames rendered once by the JAX renderer and
rounded to uint8, the vocabulary trained once by the JAX package (8
views, k=8, L=3, seed 7) and carried into the port; Config() with the
CLI's mode=1 changes, loop closing on, strict, and the CLI's final
pose-graph pass (examples/run_common.py:200-203). The JAX package runs
as its CLI runs it, with x64 off.

The port runs on the JAX package's RANSAC draws (tests/torch_port_utils
shared_draws) or on its own. Each run gives one JSON line: the keyframe
frame ids, every loop pair (frame -> frame), both ATEs (sim3-aligned
keyframes), the per-keyframe loop decisions and wall seconds.

The loop bisect carries the JAX system at a frame into the port
(utils/convert.full_system_to_torch, loop closing included), steps both
on, and at every keyframe feeds each port loop module the JAX module's
inputs on shared draws: features, BoW and the query, the matchers, the
PnP and Umeyama seeds, refine_sim3, the loop edge and the pose graph.

Slow (two 150-frame FullSystems at 640x480 on the CPU, tens of minutes
each); run it alone, as tests or as a script in the background:

    python -m pytest -q -m slow tests/test_torch_loop_parity.py
    python tests/test_torch_loop_parity.py --package jax|port
        [--draws jax|own] [--threads 3] [--frames 150]
    python tests/test_torch_loop_parity.py --compare RUN_A RUN_B
    python tests/test_torch_loop_parity.py --bisect-loop FIRST LAST
"""

import argparse
import contextlib
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.head_to_head import brightness_gain, revisit_poses  # noqa: E402

N_REVISIT = 150


def revisit_frames(n: int = N_REVISIT, w: int = 640, h: int = 480):
    """(calib, poses, uint8 frames, scene) of the revisit head-to-head
    (tools/head_to_head.py:82-101), rendered by the JAX renderer."""
    from ldso_tpu.synthetic import default_calib, make_scene
    calib = default_calib(w, h)
    scene = make_scene("plane", freq_hi=25.0, contrast=80.0, n_waves=32)
    poses = revisit_poses(n)
    gains = brightness_gain("revisit", n)
    images = []
    for T, g in zip(poses, gains):
        img, _ = scene.render(calib, jnp.asarray(T, jnp.float32))
        images.append(np.clip(np.round(np.asarray(img) * float(g)), 0, 255)
                      .astype(np.uint8))
    return calib, poses, images, scene


def train_vocab(scene, calib):
    """The head-to-head's vocabulary (tools/head_to_head.py:112-131): ORB
    corners of 8 shifted views, k=8, L=3, seed 7, by the JAX package."""
    from ldso_tpu.frontend import detector
    from ldso_tpu.loop.vocab import Vocabulary
    from ldso_tpu.ops.preprocess import make_pyramid
    descs = []
    for k in range(8):
        T = np.eye(4)
        T[:3, 3] = [-0.3 * k, 0.08 * k, 0.0]
        img, _ = scene.render(calib, jnp.asarray(np.linalg.inv(T),
                                                 jnp.float32))
        pyr = make_pyramid(img, calib.levels)
        feats = detector.detect_corners(pyr.dI[0], pyr.abs_grad[0], 500)
        valid = np.asarray(feats["valid"] & feats["is_corner"])
        descs.append(np.asarray(feats["desc"])[valid])
    return Vocabulary.train(np.concatenate(descs, axis=0), k=8, L=3, seed=7)


def loop_configs():
    """(JAX, port) Config() with the CLI's mode=1 changes, loop closing on."""
    from test_torch_parity import _configs
    return _configs(enable_loop_closing=True)


def log_decisions(lc, log):
    """Record every keyframe the LoopClosing `lc` sees: its frame id, the
    candidate's frame id (None when the query gave none or the gate
    rejected it) and whether a loop closed. Instance attributes only."""
    detect, insert = lc._detect_loop, lc.insert_keyframe
    seen = {}

    def _detect_loop(kf, window_kf_ids):
        cand = detect(kf, window_kf_ids)
        seen["cand"] = None if cand is None else cand.id
        return cand

    def insert_keyframe(kf, window_kf_ids):
        seen["cand"] = None
        ok = insert(kf, window_kf_ids)
        log.append(dict(frame=kf.id, cand=seen["cand"], closed=bool(ok)))
        return ok

    lc._detect_loop = _detect_loop
    lc.insert_keyframe = insert_keyframe


@contextlib.contextmanager
def jax_pose_graph_dtypes(out):
    """While inside, every JAX pose-graph solve made with x64 off appends
    its output's dtype to `out` (the solver is looked up at call time,
    posegraph.py:357)."""
    from ldso_tpu.loop import posegraph as jpg
    orig = jpg.optimize_pose_graph

    def solver(*a, **k):
        S = orig(*a, **k)
        if not jax.config.jax_enable_x64:
            out.append(str(S.dtype))
        return S
    jpg.optimize_pose_graph = solver
    try:
        yield
    finally:
        jpg.optimize_pose_graph = orig


def loop_summary(name, fs, poses, wall, decisions, **extra):
    """One run's record: keyframe frame ids, loop pairs (frame -> frame),
    the loop count, odometry and loop-closed ATE (mm, sim3-aligned
    keyframes, io/trajectory.ate_rmse), wall seconds, the decisions."""
    from ldso_tpu_torch.io.trajectory import ate_rmse
    kfs = fs.global_map.get_all_kfs()
    id_of = {kf.kf_id: kf.id for kf in kfs}
    lc = fs.loop_closing
    gt = [poses[kf.id] for kf in kfs]
    return dict(
        package=name, frames=len(fs.all_frames), lost=bool(fs.is_lost),
        kf_ids=[kf.id for kf in kfs],
        loop_pairs=[[id_of[a], id_of[b]] for a, b in lc.loop_pairs],
        loops=lc.n_loops_closed,
        ate_odometry_mm=1e3 * ate_rmse([kf.T_cw for kf in kfs], gt),
        ate_loop_mm=1e3 * ate_rmse([kf.get_S_cw() for kf in kfs], gt),
        s_cw_dtype=str(np.asarray(kfs[-1].get_S_cw()).dtype),
        wall_s=wall, decisions=decisions, **extra)


def first_parting(a, b):
    """The first keyframe (frame id) at which two runs' loop decisions
    part: a different keyframe, candidate or outcome; None if none."""
    for x, y in zip(a["decisions"], b["decisions"]):
        if x != y:
            return min(x["frame"], y["frame"])
    na, nb = len(a["decisions"]), len(b["decisions"])
    if na != nb:
        longer = a if na > nb else b
        return longer["decisions"][min(na, nb)]["frame"]
    return None


@contextlib.contextmanager
def shadow_pose_graph(module, run_other, out):
    """While inside, every `module.run_pose_graph(gm, ...)` (the loop
    closer's and the final pass) first runs `run_other(solve, gm)` on a
    shadow chain of S_cw: keyframes optimized by an earlier shadow pass
    start from its result, newer ones from their S_cw (the T_cw copies
    both chains share, full_system.py:594); the map then goes on with
    the real call. At exit `out["shadow"]` maps kf_id -> shadow S_cw, so
    one run gives the loop-closed result of both pose-graph precisions."""
    orig = module.run_pose_graph
    shadow = {}

    def run_pose_graph(gm, *a, **k):
        latest = gm.latest_optimized_kf_id
        kfs = gm.get_all_kfs()
        saved = {kf.kf_id: kf.S_cw for kf in kfs}
        for kf in kfs:
            if kf.kf_id < latest and kf.kf_id in shadow:
                kf.S_cw = shadow[kf.kf_id]
        run_other(orig, gm)
        for kf in kfs:
            shadow[kf.kf_id] = np.array(kf.get_S_cw())
            kf.S_cw = saved[kf.kf_id]
        gm.latest_optimized_kf_id = latest
        return orig(gm, *a, **k)
    module.run_pose_graph = run_pose_graph
    try:
        yield
    finally:
        module.run_pose_graph = orig
        out["shadow"] = shadow


def shadow_ate_mm(fs, poses, shadow):
    from ldso_tpu_torch.io.trajectory import ate_rmse
    kfs = fs.global_map.get_all_kfs()
    return 1e3 * ate_rmse([shadow.get(kf.kf_id, kf.get_S_cw()) for kf in kfs],
                          [poses[kf.id] for kf in kfs])


def run_jax(frames, vocab, cfg):
    """The JAX FullSystem as its CLI runs it (strict, x64 off, the final
    pose-graph pass), with a float64 shadow chain of the pose graph."""
    from ldso_tpu.loop import posegraph as jpg
    from ldso_tpu.system.full_system import FullSystem
    calib, poses, images = frames
    decisions, dtypes, sh = [], [], {}

    def f64(solve, gm):
        with jax.enable_x64(True):
            solve(gm)
    with jax.enable_x64(False), jax_pose_graph_dtypes(dtypes), \
            shadow_pose_graph(jpg, f64, sh):
        fs = FullSystem(calib, cfg, vocab=vocab)
        log_decisions(fs.loop_closing, decisions)
        t0 = time.time()
        for i, img in enumerate(images):
            fs.add_active_frame(img, i, 1.0, i * 0.05)
            if fs.is_lost:
                break
        if fs.global_map.num_frames() > 4:
            jpg.run_pose_graph(fs.global_map)
        wall = time.time() - t0
    return loop_summary(
        "jax", fs, poses, wall, decisions,
        pose_graph_dtypes_x64_off=sorted(set(dtypes)),
        ate_loop_mm_f64_pose_graph=shadow_ate_mm(fs, poses, sh["shadow"])), fs


def run_port(frames, vocab, cfg, draws="jax", threads=None):
    """The port's FullSystem on the CPU, strict, the final pose-graph pass;
    on the JAX package's RANSAC draws (draws="jax") or its own; with a
    float64 shadow chain of the (float32) pose graph."""
    from torch_port_utils import shared_draws
    from ldso_tpu_torch.loop import posegraph as tpg
    from ldso_tpu_torch.system.full_system import FullSystem
    from ldso_tpu_torch.utils.convert import vocabulary_to_torch
    if threads:
        torch.set_num_threads(threads)
    calib, poses, images = frames
    decisions, sh = [], {}

    def f64(solve, gm):
        solve(gm, device="cpu", dtype=torch.float64)
    ctx = (shared_draws(seed=cfg.seed) if draws == "jax"
           else contextlib.nullcontext())
    with ctx, shadow_pose_graph(tpg, f64, sh):
        fs = FullSystem(calib, cfg, vocab=vocabulary_to_torch(vocab),
                        device="cpu")
        log_decisions(fs.loop_closing, decisions)
        t0 = time.time()
        for i, img in enumerate(images):
            fs.add_active_frame(img, i, 1.0, i * 0.05)
            if fs.is_lost:
                break
        if fs.global_map.num_frames() > 4:
            tpg.run_pose_graph(fs.global_map, device="cpu")
        wall = time.time() - t0
    return loop_summary(
        "port", fs, poses, wall, decisions, draws=draws,
        torch_threads=torch.get_num_threads(),
        ate_loop_mm_f64_pose_graph=shadow_ate_mm(fs, poses, sh["shadow"])), fs


# ---------------------------------------------------------------- the bisect

def _row(frame, module, field, err, tol, **kw):
    return dict(frame=frame, module=module, field=field, max_err=err,
                tol=tol, within=bool(err <= tol), **kw)


def _bit_flips(a, b):
    """Flipped bits of two uint32 descriptor arrays over all their bits."""
    a, b = np.asarray(a, np.uint32), np.asarray(b, np.uint32)
    if a.shape != b.shape:
        return np.inf
    if not a.size:
        return 0.0
    x = np.bitwise_xor(a, b)
    return float(np.unpackbits(x.view(np.uint8)).sum()) / (x.size * 32)


def _f64_verdict(port, jax32, jax64, tol):
    """Rounding verdict from a float64 oracle: the port is no farther from
    the float64 result than the JAX package's float32 result is, plus the
    slice test's tolerance (the tolerance held against the exact value in
    place of the JAX package's own rounding of it)."""
    from torch_port_utils import npy
    p, j, r = (np.asarray(npy(x), np.float64) for x in (port, jax32, jax64))
    pe, je = float(np.abs(p - r).max()), float(np.abs(j - r).max())
    return dict(rounding=bool(pe <= je + tol), port_vs_f64=pe,
                jax_vs_f64=je)


def _wrap(d):
    """Angle differences into [-pi, pi)."""
    return (np.asarray(d, np.float64) + np.pi) % (2 * np.pi) - np.pi


def _sim3_err(A, B):
    from ldso_tpu_torch.math import lie
    return float(torch.linalg.norm(lie.sim3_log(torch.from_numpy(
        np.linalg.inv(A) @ np.asarray(B, np.float64)))))


@contextlib.contextmanager
def loop_module_hooks(jfs, tcfg, rows, frame):
    """While active, every loop module call of the JAX system `jfs` also
    runs the port's module on the JAX module's inputs, on the JAX draws,
    and appends the comparison to `rows` (frame number from frame[0]):
    the features of make_kf_record, the depth refresh, the BoW transform,
    the database query, both matchers, the PnP and Umeyama seeds,
    refine_sim3, the loop edge of _correct_loop, and the pose graph in
    float32 (the JAX package with x64 off, as its CLI runs it) and float64
    (x64 on)."""
    from torch_port_utils import jax_picks, npy, shared_draws
    from test_torch_parity import _worst
    from ldso_tpu.frontend import detector as jdet
    from ldso_tpu.loop import loopclosing as jlcm
    from ldso_tpu.loop import matcher as jmatch
    from ldso_tpu.loop import pnp as jpnp
    from ldso_tpu.loop import posegraph as jpg
    from ldso_tpu_torch.frontend import detector as tdet
    from ldso_tpu_torch.loop import matcher as tmatch
    from ldso_tpu_torch.loop import pnp as tpnp
    from ldso_tpu_torch.loop import posegraph as tpg
    from ldso_tpu_torch.loop import sim3_solver as tsim
    from ldso_tpu_torch.loop.database import KeyframeDatabase
    from ldso_tpu_torch.loop.loopclosing import LoopClosing
    from ldso_tpu_torch.slam_map import FrameShell, GlobalMap
    from ldso_tpu_torch.system import full_system as tfull
    from ldso_tpu_torch.utils import convert
    lc, calib = jfs.loop_closing, jfs.calib
    tvoc = convert.vocabulary_to_torch(lc.vocab)
    tl = LoopClosing(calib, tcfg, GlobalMap(), vocab=tvoc, device="cpu")
    tdb = KeyframeDatabase(tvoc)
    db_n = [0]
    ctx = {}
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    orig = dict(record=lc.make_kf_record, refresh=lc._refresh_feat_depths,
                bow=lc._compute_bow, detect=lc._detect_loop,
                correct=lc._correct_loop, seed_pnp=lc._seed_pnp,
                seed_ume=lc._seed_umeyama, by_bow=jmatch.search_by_bow,
                by_proj=jmatch.search_by_projection, pnp=jpnp.pnp_ransac,
                ume=jlcm.umeyama_ransac, refine=jlcm.refine_sim3,
                pgo=jpg.run_pose_graph)

    def make_kf_record(kf, pyr, pui):
        orig["record"](kf, pyr, pui)
        # the rows the features take their depths from, the port's from
        # the carried JAX window (FullSystem._loop_closing_step)
        pt_ = tfull.loop_feature_depths(convert.window_to_torch(jfs.ef.W),
                                        len(jfs.window_frames) - 1)
        nt, nj = (0 if a is None else len(a) for a in (pt_, pui))
        rows.append(_worst(frame[0], "loop_feature_depths", [
            ("rows", nt, nj, None, None)]
            + ([("u, v, idepth", pt_, pui, 0, 0)] if nt == nj > 0 else [])))
        n = int(lc.cfg.desired_immature_density)
        fj = jdet.detect_corners(pyr.dI[0], pyr.abs_grad[0], n)
        pt = convert.pyramid_to_torch(pyr)
        ft = tdet.detect_corners(pt.dI[0], pt.abs_grad[0], n)
        used = npy(fj["valid"] & fj["is_corner"])
        row = _worst(frame[0], "detect_corners", [
            (k, ft[k], fj[k], None, None)
            for k in ("u", "v", "valid", "is_corner")]
            + [("angle", _wrap(npy(ft["angle"])[used] - npy(fj["angle"])[used]),
                np.zeros(int(used.sum())), 0, 1e-5)])
        if not row["within"] and row["field"] == "angle":
            # the JAX package's ic_angle in float64 on the same pixels
            with jax.enable_x64(True):
                a64 = npy(jdet.ic_angle(
                    jnp.asarray(np.asarray(pyr.dI[0], np.float64)),
                    fj["u"], fj["v"]))[used]
            aj = npy(fj["angle"])[used].astype(np.float64)  # unwrapped
            at = aj + _wrap(npy(ft["angle"])[used] - aj)      # about JAX's
            row.update(_f64_verdict(at, aj, aj + _wrap(a64 - aj), 1e-5))
        rows.append(row)
        flips = _bit_flips(tdet.desc_to_numpy(ft["desc"]), npy(fj["desc"]))
        rows.append(_row(frame[0], "compute_descriptors", "desc bit flips",
                         flips, 1e-3))
        ts = FrameShell(id=kf.id, kf_id=kf.kf_id)
        tl.make_kf_record(ts, pt, pui)
        rows.append(_worst(frame[0], "make_kf_record", [
            ("feat_uv", ts.feat_uv, kf.feat_uv, None, None),
            ("feat_idepth", ts.feat_idepth, kf.feat_idepth, None, None)]))

    def _refresh_feat_depths(sh):
        ts = convert.frame_shell_to_torch(sh)
        orig["refresh"](sh)
        tl._refresh_feat_depths(ts)
        rows.append(_worst(frame[0], "_refresh_feat_depths", [
            ("feat_idepth", ts.feat_idepth, sh.feat_idepth, None, None)]))

    def _compute_bow(kf):
        ts = convert.frame_shell_to_torch(kf)
        orig["bow"](kf)
        tl._compute_bow(ts)
        bj, bt = kf.bow_vector, ts.bow_vector
        err = (max((abs(bt[w] - bj[w]) for w in bj), default=0.0)
               if sorted(bj) == sorted(bt) else np.inf)
        rows.append(_worst(frame[0], "_compute_bow", [
            ("feat_word", ts.feat_word, kf.feat_word, None, None),
            ("feat_node", ts.feat_node, kf.feat_node, None, None)]))
        rows.append(_row(frame[0], "bow_vector", "weights", err, 0.0))

    def _detect_loop(kf, window_kf_ids):
        for kid in lc._db_order[db_n[0]:]:          # the port's index, in
            tdb.add(kid, lc.global_map.keyframes[kid].bow_vector)  # order
        db_n[0] = len(lc._db_order)
        cfg = lc.cfg
        exclude = (set(lc._db_order[-cfg.loop_kf_gap:]) if cfg.loop_kf_gap
                   else set())
        exclude.add(kf.kf_id)
        rj = lc.db.query(kf.bow_vector, exclude)
        rt = tdb.query(kf.bow_vector, exclude)
        order = [i for i, _ in rt] == [i for i, _ in rj]
        err = (max((abs(a[1] - b[1]) for a, b in zip(rt, rj)), default=0.0)
               if order else np.inf)
        rows.append(_row(frame[0], "db.query", "candidates, scores", err,
                         0.0, candidates=[i for i, _ in rj]))
        return orig["detect"](kf, window_kf_ids)

    def search_by_bow(*a, **k):
        mj = orig["by_bow"](*a, **k)
        rows.append(_worst(frame[0], "search_by_bow", [
            ("match", tmatch.search_by_bow(*a, **k), mj, None, None)]))
        return mj

    def search_by_projection(*a, **k):
        mj = orig["by_proj"](*a, **k)
        rows.append(_worst(frame[0], "search_by_projection", [
            ("match", tmatch.search_by_projection(*a, **k), mj, None,
             None)]))
        return mj

    def _seed_pnp(kf, cand, mi, mj):
        ctx["n"] = len(mi)
        return orig["seed_pnp"](kf, cand, mi, mj)

    def _seed_umeyama(kf, cand, mi, mj):
        ctx["n"] = len(mi)
        return orig["seed_ume"](kf, cand, mi, mj)

    def pnp_ransac(X, uv, valid, K, key, inlier_px=3.0, **kw):
        out = orig["pnp"](X, uv, valid, K, key, inlier_px=inlier_px, **kw)
        n = ctx["n"]
        picks = torch.from_numpy(jax_picks(valid, 256, 6, key))
        ot = tpnp.pnp_ransac_from_picks(
            f32(npy(X)[:n]), f32(npy(uv)[:n]),
            torch.from_numpy(npy(valid)[:n].copy()), K, picks, inlier_px)
        row = _worst(frame[0], "pnp_ransac", [
            ("T", ot[0], out[0], 0, 1e-4),
            ("inliers", ot[1], npy(out[1])[:n], None, None),
            ("n_inliers", ot[2], out[2], None, None)])
        gate = [int(x) >= jlcm.MIN_PNP_INLIERS for x in (out[2], ot[2])]
        row.update(n_inliers=[int(out[2]), int(ot[2])], seed_accepted=gate)
        if not row["within"]:
            with jax.enable_x64(True):
                o64 = orig["pnp"](jnp.asarray(np.asarray(X, np.float64)),
                                  jnp.asarray(np.asarray(uv, np.float64)),
                                  valid, K, key, inlier_px=inlier_px, **kw)
            row.update(_f64_verdict(ot[0], out[0], o64[0], 1e-4))
            # a degenerate minimal-set problem: the JAX package's own float32
            # solve leaves the tolerance around its float64 solve, so only
            # the seed gate's outcome can be held; rounding when both
            # packages' gates give the float64 solve's outcome
            g64 = int(o64[2]) >= jlcm.MIN_PNP_INLIERS
            row["f64_seed_accepted"] = g64
            if row["jax_vs_f64"] > 1e-4:
                row["rounding"] = row["rounding"] or gate == [g64, g64]
        rows.append(row)
        return out

    def umeyama_ransac(P, Q, valid, key, *a, **kw):
        out = orig["ume"](P, Q, valid, key, *a, **kw)
        n = ctx["n"]
        picks = torch.from_numpy(jax_picks(valid, 256, 3, key))
        ot = tsim.umeyama_ransac_from_picks(
            f32(npy(P)[:n]), f32(npy(Q)[:n]),
            torch.from_numpy(npy(valid)[:n].copy()), picks)
        row = _worst(frame[0], "umeyama_ransac", [
            ("S", ot[0], out[0], 0, 1e-4),
            ("inliers", ot[1], npy(out[1])[:n], None, None),
            ("n_inliers", ot[2], out[2], None, None)])
        if not row["within"]:
            with jax.enable_x64(True):
                S64 = orig["ume"](jnp.asarray(np.asarray(P, np.float64)),
                                  jnp.asarray(np.asarray(Q, np.float64)),
                                  valid, key, *a, **kw)[0]
            row.update(_f64_verdict(ot[0], out[0], S64, 1e-4))
        rows.append(row)
        return out

    def refine_sim3(S0, P_ref, uv, m, P_ref2, P_cur, m2, K, iterations=10):
        out = orig["refine"](S0, P_ref, uv, m, P_ref2, P_cur, m2, K,
                             iterations=iterations)
        if ctx.get("refine_n") is None:        # the first pass: m = 1^n 0^k
            ctx["refine_n"] = int(np.asarray(m).sum())
        n = ctx["refine_n"]
        cut = [f32(npy(x)[:n]) for x in (P_ref, uv, m, P_ref2, P_cur, m2)]
        ot = tsim.refine_sim3(f32(npy(S0)), *cut, K, iterations=iterations)
        Hs = float(np.abs(npy(out[1])).max())
        row = _worst(frame[0], "refine_sim3", [
            ("S", ot[0], out[0], 0, 1e-4),
            ("H", ot[1], out[1], 1e-3, 1e-3 * Hs),
            ("inl2d", ot[2], npy(out[2])[:n], None, None),
            ("inl3d", ot[3], npy(out[3])[:n], None, None)])
        if not row["within"]:
            with jax.enable_x64(True):
                a64 = [jnp.asarray(np.asarray(x, np.float64))
                       for x in (S0, P_ref, uv, m, P_ref2, P_cur, m2)]
                S64 = orig["refine"](*a64, K, iterations=iterations)[0]
            row.update(_f64_verdict(ot[0], out[0], S64, 1e-4))
        rows.append(row)
        return out

    def _correct_loop(kf, cand):
        tk, tc_ = (convert.frame_shell_to_torch(kf),
                   convert.frame_shell_to_torch(cand))
        with shared_draws(key=lc.key):
            ok_t = tl._correct_loop(tk, tc_)
        ctx["refine_n"] = None
        ok_j = orig["correct"](kf, cand)
        row = _row(frame[0], "_correct_loop", "closed", float(ok_t != ok_j),
                   0.0, jax=bool(ok_j), port=bool(ok_t))
        if ok_t and ok_j:
            row = _row(frame[0], "_correct_loop", "edge |sim3_log|",
                       _sim3_err(kf.pose_rel[cand.kf_id][0],
                                 tk.pose_rel[cand.kf_id][0]), 1e-3,
                       jax=True, port=True)
        rows.append(row)
        return ok_j

    def run_pose_graph(gm, *a, **k):
        t32, t64 = (convert.global_map_to_torch(gm),
                    convert.global_map_to_torch(gm))
        j64 = convert.global_map_to_torch(gm)    # a deep copy, JAX reads it
        orig["pgo"](gm, *a, **k)
        with jax.enable_x64(True):
            orig["pgo"](j64, *a, **k)
        tpg.run_pose_graph(t32, device="cpu", dtype=torch.float32)
        tpg.run_pose_graph(t64, device="cpu", dtype=torch.float64)
        ids = sorted(gm.keyframes)

        def S(m):
            return np.stack([np.asarray(m.keyframes[i].get_S_cw(), np.float64)
                             for i in ids])
        sj, s64, p32, p64 = S(gm), S(j64), S(t32), S(t64)
        row = _row(frame[0], "run_pose_graph", "S_cw float32 (x64 off)",
                   float(np.abs(p32 - sj).max()), 1e-4,
                   jax_dtype=str(np.asarray(
                       gm.keyframes[ids[0]].S_cw).dtype))
        if not row["within"]:
            row.update(_f64_verdict(p32, sj, s64, 1e-4))
        rows.append(row)
        rows.append(_row(frame[0], "run_pose_graph", "S_cw float64 (x64 on)",
                         float(np.abs(p64 - s64).max()), 1e-10))

    lc.make_kf_record = make_kf_record
    lc._refresh_feat_depths = _refresh_feat_depths
    lc._compute_bow = _compute_bow
    lc._detect_loop = _detect_loop
    lc._correct_loop = _correct_loop
    lc._seed_pnp = _seed_pnp
    lc._seed_umeyama = _seed_umeyama
    jmatch.search_by_bow = search_by_bow
    jmatch.search_by_projection = search_by_projection
    jpnp.pnp_ransac = pnp_ransac
    jlcm.umeyama_ransac = umeyama_ransac
    jlcm.refine_sim3 = refine_sim3
    jpg.run_pose_graph = run_pose_graph
    try:
        yield
    finally:
        for k in ("make_kf_record", "_refresh_feat_depths", "_compute_bow",
                  "_detect_loop", "_correct_loop", "_seed_pnp",
                  "_seed_umeyama"):
            lc.__dict__.pop(k, None)
        jmatch.search_by_bow = orig["by_bow"]
        jmatch.search_by_projection = orig["by_proj"]
        jpnp.pnp_ransac = orig["pnp"]
        jlcm.umeyama_ransac = orig["ume"]
        jlcm.refine_sim3 = orig["refine"]
        jpg.run_pose_graph = orig["pgo"]


def bisect_loop(first: int, last: int, frames=None, configs=None,
                vocab=None, vo_modules=True):
    """Step the JAX FullSystem (x64 off) through frame `first`, carry it
    into the port with its LoopClosing, then step both through frame
    `last`, the port on the JAX draws, each JAX loop module call checked
    against the port's module on the same inputs. `frames` (calib, poses,
    images), `configs` (JAX, port) and `vocab` (JAX) override the revisit
    scene. With `vo_modules` the VO modules are checked too, as
    tests/test_torch_parity.py's bisect checks them. Returns (module rows,
    per-frame rows: keyframe and loop decisions of both systems, their
    camera centres' distance in um)."""
    from torch_port_utils import shared_draws
    from test_torch_parity import module_hooks
    from ldso_tpu.system.full_system import FullSystem as JFS
    from ldso_tpu_torch.utils.convert import full_system_to_torch
    if frames is None:
        calib, poses, images, scene = revisit_frames()
        vocab = train_vocab(scene, calib)
    else:
        calib, poses, images = frames
    jc, tc = configs or loop_configs()
    rows, per_frame, frame = [], [], [0]
    with jax.enable_x64(False):
        jfs = JFS(calib, jc, vocab=vocab)
        for i in range(first + 1):
            jfs.add_active_frame(images[i], i, 1.0, i * 0.05)
        tfs = full_system_to_torch(jfs, tc, "cpu")
        dj, dt = [], []
        log_decisions(jfs.loop_closing, dj)
        log_decisions(tfs.loop_closing, dt)
        vo = (module_hooks(jfs, tc, rows, frame) if vo_modules
              else contextlib.nullcontext())
        with shared_draws(key=jfs.loop_closing.key), vo, \
                loop_module_hooks(jfs, tc, rows, frame):
            for i in range(first + 1, last + 1):
                frame[0] = i
                nj, nt = len(dj), len(dt)
                sj = jfs.add_active_frame(images[i], i, 1.0, i * 0.05)
                st = tfs.add_active_frame(images[i], i, 1.0, i * 0.05)
                per_frame.append(dict(
                    frame=i, keyframe_jax=sj.kf_id >= 0,
                    keyframe_port=st.kf_id >= 0,
                    loop_jax=dj[nj:], loop_port=dt[nt:],
                    centre_gap_um=1e6 * float(np.linalg.norm(
                        np.linalg.inv(sj.T_cw)[:3, 3]
                        - np.linalg.inv(st.T_cw)[:3, 3]))))
    return rows, per_frame


def check_run(r, n):
    """The phase-4 criteria: every loop pair from the return leg to the out
    leg, odometry ATE under 5 mm, loop-closed ATE under 20 mm."""
    half = n // 2
    assert not r["lost"], r["package"]
    assert r["loops"] >= 1, r["package"]
    assert all(a >= half and b < half for a, b in r["loop_pairs"]), \
        r["loop_pairs"]
    assert r["ate_odometry_mm"] < 5.0 and r["ate_loop_mm"] < 20.0, r


@pytest.fixture(scope="module")
def revisit():
    calib, poses, images, scene = revisit_frames()
    jc, tc = loop_configs()
    vocab = train_vocab(scene, calib)
    jax_run, _ = run_jax((calib, poses, images), vocab, jc)
    return (calib, poses, images), vocab, tc, jax_run


@pytest.mark.slow
@pytest.mark.parametrize("draws", ["jax", "own"])
def test_revisit_loop_parity_at_full_size(revisit, draws):
    """Both packages meet phase 4's criteria on the revisit scene; the
    keyframes, loop pairs, ATEs and the first keyframe where the loop
    decisions part are printed, not asserted (ROADMAP §3)."""
    frames, vocab, tc, jax_run = revisit
    port_run, _ = run_port(frames, vocab, tc, draws=draws)
    for r in (jax_run, port_run):
        print(json.dumps(r))
    print(json.dumps(compare_runs(jax_run, port_run)))
    for r in (jax_run, port_run):
        check_run(r, N_REVISIT)


@pytest.mark.slow
def test_bisect_loop_revisit():
    """The revisit scene carried at frame 112 and stepped through 131, past
    frame 116, where the two packages' own runs first part (JAX closes
    116 -> 8, the port does not): every port loop module, fed the JAX
    module's inputs on the JAX draws, stays within its slice test's
    tolerance or, where it leaves it, a float64 oracle shows rounding;
    and the carried port takes the same keyframe and loop decisions. (The
    VO modules' bisect is tests/test_torch_parity.py's.)"""
    rows, frames = bisect_loop(112, 131, vo_modules=False)
    for r in rows + frames:
        print(json.dumps(r))
    assert {r["module"] for r in rows} >= {
        "detect_corners", "_compute_bow", "db.query", "search_by_bow",
        "pnp_ransac", "refine_sim3", "_correct_loop", "run_pose_graph"}
    assert all(f["keyframe_jax"] == f["keyframe_port"]
               and f["loop_jax"] == f["loop_port"] for f in frames)
    bad = [r for r in rows if not (r["within"] or r.get("rounding"))]
    assert not bad, bad


def compare_runs(a, b):
    """The gap between two runs' records: the first keyframe where their
    loop decisions part, keyframes and loop pairs in one only, both ATEs
    of each."""
    ka, kb = set(a["kf_ids"]), set(b["kf_ids"])
    pa, pb = set(map(tuple, a["loop_pairs"])), set(map(tuple, b["loop_pairs"]))
    return dict(
        runs=[f"{r['package']}:{r.get('draws', 'jax')}" for r in (a, b)],
        first_parting=first_parting(a, b),
        keyframes=[len(ka), len(kb)], kf_only=[sorted(ka - kb), sorted(kb - ka)],
        loops=[a["loops"], b["loops"]],
        pairs_only=[sorted(pa - pb), sorted(pb - pa)],
        ate_odometry_mm=[a["ate_odometry_mm"], b["ate_odometry_mm"]],
        ate_loop_mm=[a["ate_loop_mm"], b["ate_loop_mm"]])


def main_revisit(args):
    calib, poses, images, scene = revisit_frames(args.frames)
    jc, tc = loop_configs()
    vocab = train_vocab(scene, calib)
    frames = (calib, poses, images)
    if args.package == "jax":
        r, _ = run_jax(frames, vocab, jc)
    else:
        r, _ = run_port(frames, vocab, tc, draws=args.draws,
                        threads=args.threads)
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--draws", choices=("jax", "own"), default="jax")
    ap.add_argument("--threads", type=int, default=3)
    ap.add_argument("--frames", type=int, default=N_REVISIT)
    ap.add_argument("--bisect-loop", type=int, nargs=2,
                    metavar=("FIRST", "LAST"))
    ap.add_argument("--compare", nargs=2, metavar=("RUN_A", "RUN_B"),
                    help="two files whose last line is a run's record")
    args = ap.parse_args()
    if args.compare:
        a, b = (json.loads(open(f).read().strip().splitlines()[-1])
                for f in args.compare)
        print(json.dumps(compare_runs(a, b)))
    elif args.bisect_loop:
        torch.set_num_threads(args.threads)
        rows, frames = bisect_loop(*args.bisect_loop)
        for r in rows + frames:
            print(json.dumps(r, default=str), flush=True)
    else:
        main_revisit(args)
