"""Smoke run of the PyTorch + CUDA port (ldso_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device facts: needs CUDA; prints the nvidia-smi name/power-limit line
     and the torch/CUDA versions, then builds the hand-written kernels from
     ldso_tpu_torch/csrc with nvcc and prints the build time;
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shapes and more, with max |kernel - plain| == 0 required,
     plus CUDA-event timings of both; then the two float scatters of the
     path (the tracker-reference splat, the initializer's level
     averaging) 20 times each on the same inputs, every output bitwise
     equal;
  3. the pure-VO path: the synchronous monocular VO FullSystem at 640x480
     with the production Config and loop closing off on 64 synthetic uint8
     frames of the bench trajectory; asserts tracking, >= 8 keyframes, the
     kernel launched on every keyframe after the bootstrap, and a
     similarity-aligned ATE under 5 mm;
  4. the loop slice: the default Config (mode=1 photometrics, loop closing
     on, ORB corner selection) on the 150-frame out-and-back revisit scene
     at 640x480 with an exposure ramp, a vocabulary trained from 8 views;
     asserts at least one return-leg -> out-leg loop, the pose graph ran,
     Sim(3) scales in (0.5, 2), odometry ATE < 5 mm, loop-closed ATE
     < 20 mm and the kernel launched on every keyframe after the bootstrap.
The line before the last is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

N_FRAMES = 64
ATE_BOUND_M = 0.005          # the JAX package's own bound (test_full_system)
LOOP_FRAMES = 150            # tools/head_to_head.py --traj revisit --frames
LOOP_ATE_BOUND_M = 0.020     # ~2x the JAX package's 10.19 mm on this scene
DET_REPEATS = 20
DIST_CASES = dict(shapes=((240, 320), (96, 128), (61, 97)),
                  occupancy=(0.005, 0.02, 0.10, "empty", "full"),
                  max_k=(18, 40))


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _median_event_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_device():
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    from ldso_tpu_torch.ops import cuda_kernels
    t0 = time.time()
    path = cuda_kernels.build(verbose=True)
    print(f"kernels built in {time.time() - t0:.2f} s: {path}", flush=True)


def phase_kernels():
    """K1 against its plain version; returns the kernel record."""
    import torch
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.ops.distance_map import distance_transform_ref
    rng = np.random.RandomState(1234)
    worst = 0.0
    n_cases = 0
    for (H, W) in DIST_CASES["shapes"]:
        for occ_kind in DIST_CASES["occupancy"]:
            if occ_kind == "empty":
                occ_np = np.zeros((H, W), bool)
            elif occ_kind == "full":
                occ_np = np.ones((H, W), bool)
            else:
                occ_np = rng.rand(H, W) < occ_kind
            occ = torch.from_numpy(occ_np).cuda()
            for max_k in DIST_CASES["max_k"]:
                got = cuda_kernels.distance_transform(occ, max_k)
                want = distance_transform_ref(occ, max_k)
                torch.cuda.synchronize()
                err = float(torch.max(torch.abs(got - want)).item())
                worst = max(worst, err)
                n_cases += 1
                if err != 0.0:
                    _fail(f"distance_transform {H}x{W} occ={occ_kind} "
                          f"max_k={max_k}: max|kernel - plain| = {err}")
    occ = torch.from_numpy(rng.rand(240, 320) < 0.02).cuda()
    ms = _median_event_ms(lambda: cuda_kernels.distance_transform(occ, 18))
    plain_ms = _median_event_ms(lambda: distance_transform_ref(occ, 18))
    print(f"K1 distance_transform: {n_cases} cases, max|kernel - plain| = "
          f"{worst}; at 240x320, max_k=18: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (median of 50, CUDA events); comparison "
          f"launches {cuda_kernels.LAUNCHES['distance_transform']}", flush=True)
    return dict(name="distance_transform", route="cuda",
                source="ldso_tpu_torch/csrc/distance_map.cu",
                replaces="ldso_tpu/ops/pallas_kernels.py:63",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms)


def phase_determinism(seed: int = 7):
    """The tracker-reference splat and the initializer's level averaging,
    DET_REPEATS times each on the same inputs at the main path's shapes:
    every output must be bitwise equal (their float scatters are
    deterministic by construction, ops/scatter.py)."""
    import torch
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.frontend import initializer, tracker
    from ldso_tpu_torch.ops.preprocess import make_pyramid
    from ldso_tpu_torch.synthetic import PlaneScene, default_calib
    calib = default_calib(640, 480)
    cfg = Config()
    img, _ = PlaneScene(freq_hi=25.0, contrast=80.0).render(
        calib, np.eye(4), device="cuda")
    pyr = make_pyramid(img, calib.levels)
    g = torch.Generator("cuda").manual_seed(seed)
    P = cfg.max_points

    def rnd(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    # half the points pile onto 64 pixels, so the sums have many terms
    u = torch.where(rnd(P) < 0.5, 320.0 + torch.floor(rnd(P) * 8),
                    rnd(P) * 639.0)
    v = torch.where(rnd(P) < 0.5, 240.0 + torch.floor(rnd(P) * 8),
                    rnd(P) * 479.0)
    args = (u, v, 0.2 + rnd(P), 0.5 + rnd(P), rnd(P) < 0.9, pyr.dI, 1.0,
            torch.zeros(2, device="cuda"), calib,
            cfg.tracker_caps[:calib.levels])

    def splat():
        ref = tracker.make_tracker_ref(*args)
        return list(ref.points) + list(ref.valid)

    state = initializer.set_first(pyr, calib, cfg)
    Lf, Lc = state.levels[0], state.levels[1]
    n = Lf.iR.shape[0]
    Lf = Lf._replace(iR=0.5 + rnd(n), last_hessian=rnd(n) * 100.0,
                     is_good=Lf.valid & (rnd(n) < 0.8))

    def level_mean():
        return list(initializer._propagate_up(Lf, Lc, False)[:])

    for name, fn, points in (("make_tracker_ref", splat, P),
                             ("initializer._propagate_up", level_mean, n)):
        first = [t.clone() for t in fn()]
        for rep in range(1, DET_REPEATS):
            for a, b in zip(first, fn()):
                if not torch.equal(a, b):
                    _fail(f"{name}: repeat {rep} differs from repeat 0")
        print(f"determinism: {name} gave {DET_REPEATS} bitwise-identical "
              f"results ({len(first)} outputs, {points} points)", flush=True)


def bench_poses(n: int):
    """The bench.py trajectory (bench.py:135-140), camera-from-world."""
    from ldso_tpu_torch.math import lie_np
    poses = []
    for i in range(n):
        t = np.array([0.03 * i, 0.01 * np.sin(0.2 * i), 0.004 * i])
        w = np.array([0.0, 0.0018 * i, 0.0004 * i])
        poses.append(np.linalg.inv(lie_np.se3_exp(np.concatenate([t, w]))))
    return poses


def sim_align_ate(est_poses, gt_poses):
    """Umeyama similarity alignment -> RMSE of camera centres (m)."""
    est_c = np.stack([np.linalg.inv(T)[:3, 3] for T in est_poses])
    gt_c = np.stack([np.linalg.inv(T)[:3, 3] for T in gt_poses])
    ec, gc = est_c - est_c.mean(0), gt_c - gt_c.mean(0)
    s = np.sqrt((gc ** 2).sum() / max((ec ** 2).sum(), 1e-12))
    U, _, Vt = np.linalg.svd(ec.T @ gc)
    R = (U @ Vt).T
    return float(np.sqrt(np.mean(np.sum((gc - s * (ec @ R.T)) ** 2, 1))))


def phase_main_path(n_frames: int = N_FRAMES):
    """Drive FullSystem.add_active_frame on the bench scene; returns the
    main path's kernel launch counts."""
    import torch
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.synthetic import PlaneScene, default_calib
    from ldso_tpu_torch.system.full_system import FullSystem

    calib = default_calib(640, 480)
    cfg = dataclasses.replace(Config(), enable_loop_closing=False)
    scene = PlaneScene(freq_hi=25.0, contrast=80.0)
    poses = bench_poses(n_frames)
    images = []
    for T in poses:           # rendering is set-up, not the measured path
        img, _ = scene.render(calib, T, device="cuda")
        images.append(torch.clamp(torch.round(img), 0, 255)
                      .to(torch.uint8).cpu().numpy())
    fs = FullSystem(calib, cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    frame_ms = []
    for i, img in enumerate(images):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fs.add_active_frame(img, i, 1.0, i * 0.05)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if fs.is_lost or fs.init_failed:
            _fail(f"main path: lost={fs.is_lost} init_failed={fs.init_failed} "
                  f"at frame {i}")
    launches = dict(cuda_kernels.LAUNCHES)

    kf_ids = [f.id for f in fs.all_frames if f.kf_id >= 0]
    post_boot = sum(1 for f in fs.all_frames if f.kf_id >= 2)
    est_ids = [f.id for f in fs.all_frames if f.pose_valid]
    _, est = fs.trajectory()
    ate = sim_align_ate(est, [poses[i] for i in est_ids])
    kf_ms = [frame_ms[i] for i in kf_ids if i > 0]
    peak = torch.cuda.max_memory_allocated()
    print(f"main path: {n_frames} frames 640x480 uint8, {len(kf_ids)} keyframes "
          f"{kf_ids}, {len(est_ids)} tracked, ATE {ate * 1e3:.4f} mm "
          f"(sim3-aligned), median {np.median(frame_ms[-16:]):.2f} ms/frame over "
          f"the last 16 frames, median {np.median(kf_ms):.2f} ms/keyframe, "
          f"peak device memory {peak / 2**20:.1f} MiB, K1 launches "
          f"{launches['distance_transform']} for {post_boot} post-bootstrap "
          f"keyframes", flush=True)
    print("stage timers (host wall, s):\n" + fs.timer.summary(), flush=True)
    if len(kf_ids) < 8:
        _fail(f"only {len(kf_ids)} keyframes (need >= 8)")
    if not ate < ATE_BOUND_M:
        _fail(f"ATE {ate * 1e3:.4f} mm >= {ATE_BOUND_M * 1e3} mm")
    if launches["distance_transform"] < post_boot:
        _fail(f"K1 launched {launches['distance_transform']} times for "
              f"{post_boot} post-bootstrap keyframes")
    return launches


def revisit_poses(n: int):
    """Out-and-back with constant heading, camera-from-world (a copy of
    tools/head_to_head.py:46-59, revisit_poses)."""
    half = n // 2
    xs = np.concatenate([np.linspace(0.0, 0.03 * half, half),
                         np.linspace(0.03 * half, 0.0, n - half)])
    poses = []
    for i, x in enumerate(xs):
        T_wc = np.eye(4)
        T_wc[:3, 3] = np.array([x, 0.04 * np.sin(0.15 * i), 0.0])
        poses.append(np.linalg.inv(T_wc))
    return poses


def brightness_gain(n: int):
    """The revisit scene's exposure sweep: a log-gain triangle 0 -> -0.9
    -> 0 (a copy of tools/head_to_head.py:62-79, brightness_gain)."""
    half = n // 2
    return np.exp(np.concatenate([np.linspace(0.0, -0.9, half),
                                  np.linspace(-0.9, 0.0, n - half)]))


def train_vocab(scene, calib):
    """The revisit run's vocabulary (tools/head_to_head.py:112-131,
    write_vocab): ORB corners of 8 shifted views, k=8, L=3, seed 7."""
    import torch
    from ldso_tpu_torch.frontend import detector
    from ldso_tpu_torch.loop.vocab import Vocabulary
    from ldso_tpu_torch.ops.preprocess import make_pyramid
    descs = []
    for k in range(8):
        T = np.eye(4)
        T[:3, 3] = [-0.3 * k, 0.08 * k, 0.0]
        img, _ = scene.render(calib, np.linalg.inv(T), device="cuda")
        pyr = make_pyramid(img, calib.levels)
        feats = detector.detect_corners(pyr.dI[0], pyr.abs_grad[0], 500)
        keep = feats["valid"] & feats["is_corner"]
        descs.append(detector.desc_to_numpy(feats["desc"][keep]))
    torch.cuda.synchronize()
    return Vocabulary.train(np.concatenate(descs, axis=0), k=8, L=3, seed=7)


def phase_loop_slice(n_frames: int = LOOP_FRAMES):
    """Drive the default-Config FullSystem (loop closing on) on the revisit
    scene; returns the path's kernel launch counts."""
    import torch
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.loop import posegraph
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.synthetic import PlaneScene, default_calib
    from ldso_tpu_torch.system.full_system import FullSystem

    calib = default_calib(640, 480)
    # examples/run_common.py mode=1: no photometric calibration, free affine
    cfg = dataclasses.replace(Config(), photometric_calibration=0,
                              affine_opt_mode_a=0.0, affine_opt_mode_b=0.0)
    assert cfg.enable_loop_closing and cfg.point_selection == 1
    scene = PlaneScene(freq_hi=25.0, contrast=80.0, n_waves=32)
    poses = revisit_poses(n_frames)
    gains = brightness_gain(n_frames)
    images = []
    for T, gain in zip(poses, gains):     # rendering is set-up
        img, _ = scene.render(calib, T, device="cuda")
        images.append(torch.clamp(torch.round(img * float(gain)), 0, 255)
                      .to(torch.uint8).cpu().numpy())
    t0 = time.time()
    vocab = train_vocab(scene, calib)
    print(f"loop slice: vocabulary of {vocab.n_words} words trained in "
          f"{time.time() - t0:.2f} s", flush=True)

    fs = FullSystem(calib, cfg, vocab=vocab, device="cuda")
    lc = fs.loop_closing
    loop_ms, pgo_ms = [], []
    step, pgo = fs._loop_closing_step, lc.run_pose_graph_if_needed

    def timed(fn, out):
        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
            return r
        return run

    fs._loop_closing_step = timed(step, loop_ms)
    lc.run_pose_graph_if_needed = timed(pgo, pgo_ms)
    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    frame_ms = []
    for i, img in enumerate(images):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fs.add_active_frame(img, i, 1.0, i * 0.05)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        if fs.is_lost or fs.init_failed:
            _fail(f"loop slice: lost={fs.is_lost} "
                  f"init_failed={fs.init_failed} at frame {i}")
    launches = dict(cuda_kernels.LAUNCHES)
    # the CLI's strict-mode final pose-graph pass before results.txt
    # (examples/run_common.py:200-203)
    torch.cuda.synchronize()
    t = time.perf_counter()
    posegraph.run_pose_graph(fs.global_map, device="cuda")
    final_pgo_ms = (time.perf_counter() - t) * 1e3

    kfs = fs.global_map.get_all_kfs()
    kf_frames = [kf.id for kf in kfs]
    post_boot = sum(1 for kf in kfs if kf.kf_id >= 2)
    gt = [poses[i] for i in kf_frames]
    ate_odo = sim_align_ate([kf.T_cw for kf in kfs], gt)
    ate_loop = sim_align_ate([kf.get_S_cw() for kf in kfs], gt)
    scales = [float(np.cbrt(np.linalg.det(kf.get_S_cw()[:3, :3])))
              for kf in kfs]
    id_of = {kf.kf_id: kf.id for kf in kfs}
    pairs = [(id_of[a], id_of[b]) for a, b in lc.loop_pairs]
    half = n_frames // 2
    kf_ms = [frame_ms[i] for i in kf_frames if i > 0]
    peak = torch.cuda.max_memory_allocated()
    print(f"loop slice: {n_frames} frames 640x480 uint8, {len(kfs)} "
          f"keyframes, {lc.n_loops_closed} loops closed, first pairs "
          f"(kf -> kf) {lc.loop_pairs[:8]} = (frame -> frame) {pairs[:8]}, "
          f"ATE odometry {ate_odo * 1e3:.4f} mm, ATE loop-closed "
          f"{ate_loop * 1e3:.4f} mm (sim3-aligned keyframes), median "
          f"{np.median(frame_ms):.2f} ms/frame, median {np.median(kf_ms):.2f} "
          f"ms/keyframe, median kf.loop {np.median(loop_ms):.2f} ms over "
          f"{len(loop_ms)} keyframes, PGO median "
          f"{np.median(pgo_ms) if pgo_ms else float('nan'):.2f} ms over "
          f"{len(pgo_ms)} runs, final PGO {final_pgo_ms:.2f} ms, scales "
          f"[{min(scales):.4f}, {max(scales):.4f}], peak device memory "
          f"{peak / 2**20:.1f} MiB, K1 launches "
          f"{launches['distance_transform']} for {post_boot} post-bootstrap "
          f"keyframes", flush=True)
    print("stage timers (host wall, s):\n" + fs.timer.summary(), flush=True)
    if lc.n_loops_closed < 1:
        _fail("loop slice: no loop closed")
    bad = [p for p in pairs if not (p[0] >= half and p[1] < half)]
    if bad:
        _fail(f"loop slice: loop pairs (frames) not return leg -> out leg: "
              f"{bad}")
    if fs.global_map.latest_optimized_kf_id < 0:
        _fail("loop slice: the pose graph never ran")
    if not all(0.5 < sc < 2.0 for sc in scales):
        _fail(f"loop slice: Sim(3) scales out of (0.5, 2): "
              f"[{min(scales)}, {max(scales)}]")
    if not ate_odo < ATE_BOUND_M:
        _fail(f"loop slice: odometry ATE {ate_odo * 1e3:.4f} mm >= "
              f"{ATE_BOUND_M * 1e3} mm")
    if not ate_loop < LOOP_ATE_BOUND_M:
        _fail(f"loop slice: loop-closed ATE {ate_loop * 1e3:.4f} mm >= "
              f"{LOOP_ATE_BOUND_M * 1e3} mm")
    if launches["distance_transform"] < post_boot:
        _fail(f"loop slice: K1 launched {launches['distance_transform']} "
              f"times for {post_boot} post-bootstrap keyframes")
    return launches


def main() -> int:
    phase_device()
    import torch
    record = phase_kernels()
    phase_determinism()
    launches_vo = phase_main_path()
    launches = phase_loop_slice()
    print(f"K1 launches: {launches_vo['distance_transform']} on the pure-VO "
          f"path, {launches['distance_transform']} on the loop slice",
          flush=True)
    record["launches"] = launches["distance_transform"]
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
