"""Smoke run of the PyTorch + CUDA port (ldso_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device facts: needs CUDA; prints the nvidia-smi name/power-limit line
     and the torch/CUDA versions, then builds the hand-written kernels from
     ldso_tpu_torch/csrc with nvcc and prints the build time;
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shapes and larger maps (KITTI's, 1280x1024 and 1920x1080
     inputs, 1000x1000), with max |kernel - plain| == 0 required; at
     240x320 and 540x960 the kernel's single-call CUDA-event time (the
     record's `ms`, timed as the plain version's `plain_ms` is), its
     device time per launch from queued launches (`device_ms`), the bound
     and the share of it, and the wrapper's host time per call; then the
     two float scatters of the path (the tracker-reference splat, the
     initializer's level averaging) 20 times each on the same inputs,
     every output bitwise equal;
  3. the pure-VO path: the synchronous monocular VO FullSystem at 640x480
     with the production Config and loop closing off on 64 synthetic uint8
     frames of the bench trajectory, on the package's default device (the
     card), timed by one wall clock from the first frame to a synchronise
     after the last; asserts tracking, >= 8 keyframes, the kernel
     launched on every keyframe after the bootstrap, and a
     similarity-aligned ATE under 5 mm;
  4. the loop slice: the default Config (mode=1 photometrics, loop closing
     on, ORB corner selection) on the 150-frame out-and-back revisit scene
     at 640x480 with an exposure ramp, a vocabulary trained from 8 views;
     asserts at least one return-leg -> out-leg loop, the pose graph ran,
     Sim(3) scales in (0.5, 2), odometry ATE < 5 mm, loop-closed ATE
     < 20 mm and the kernel launched on every keyframe after the bootstrap;
  5. the pipelines: phase 3's frames through DeterministicPipeline twice
     and AsyncPipeline once, by phase 3's driver
     (ldso_tpu_torch/examples/time_modes.run_mode, one wall clock per run,
     drain included); asserts the two lookahead runs bitwise equal, >= 8
     keyframes and ATE < 5 mm, the kernel launched once per post-bootstrap
     keyframe in every mode and, in async, only on the mapping thread's
     stream; one JSON line per mode;
  6. the CLI: phase 3's frames written as a KITTI sequence with the port's
     PNG writer, then run_common.run with pipeline=lookahead and with
     pipeline=async; asserts both trajectory files of each run, orthonormal
     rotations, keyframe ATE < 5 mm and the kernel's launches.
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
# the main path's map at 640x480, KITTI's (1241x376), 1280x1024 and
# 1920x1080 inputs, and a 1000x1000 map
DIST_CASES = dict(shapes=((240, 320), (96, 128), (61, 97), (188, 620),
                          (512, 640), (540, 960), (1000, 1000)),
                  occupancy=(0.005, 0.02, 0.10, "empty", "full"),
                  max_k=(1, 2, 18, 40))
DIST_TIMED = ((240, 320), (540, 960))
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, and the float32
# rate outside the tensor cores, taken for the map's integer compares
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


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


def _queued_device_ms(fn, n: int = 20, reps: int = 30) -> float:
    """Device time per call: n calls queued behind a sleeping kernel, so
    they run back to back whatever the host costs, CUDA events around the
    n; the median over reps."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(5_000_000)     # ~3 ms: the host queues the n calls
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def _host_us_per_call(fn, n: int = 2000) -> float:
    """Synchronised wall time over n calls, divided by n."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def distance_bound_ms(occ, out, max_k: int):
    """The least time for K1's function on these inputs: one read of the
    occupancy bytes and one write of the float32 map, against the neighbour
    tests this data needs (each cell still unreached before sweep k tests
    its 4 neighbours, 8 on odd k). Returns (ms, "bytes" or "operations")."""
    import torch
    n_bytes = occ.numel() * (occ.element_size() + 4)
    ops = sum((8 if k % 2 else 4) * int(torch.count_nonzero(out >= k))
              for k in range(1, max_k))
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), bound_by


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
    print(f"K1 distance_transform: {n_cases} cases, max|kernel - plain| = "
          f"{worst}; comparison launches "
          f"{cuda_kernels.LAUNCHES['distance_transform']}", flush=True)
    timed = {}
    for (H, W) in DIST_TIMED:
        occ = torch.from_numpy(rng.rand(H, W) < 0.02).cuda()
        kernel = lambda: cuda_kernels.distance_transform(occ, 18)  # noqa: E731,B023
        t = dict(ms=_median_event_ms(kernel),
                 device_ms=_queued_device_ms(kernel),
                 plain_ms=_median_event_ms(
                     lambda: distance_transform_ref(occ, 18)),  # noqa: B023
                 host_us=_host_us_per_call(kernel))
        t["bound_ms"], t["bound_by"] = distance_bound_ms(occ, kernel(), 18)
        timed[(H, W)] = t
        print(f"K1 at {H}x{W}, max_k=18, 2% occupied: kernel {t['ms']:.4f} ms "
              f"per single call (median of 50, CUDA events, the wrapper's "
              f"host time included), {t['device_ms']:.4f} ms of device time "
              f"per launch (20 queued launches, median of 30); plain "
              f"{t['plain_ms']:.4f} ms (single call, median of 50); bound "
              f"{t['bound_ms'] * 1e3:.4f} us set by {t['bound_by']}, "
              f"{100 * t['bound_ms'] / t['ms']:.2f}% of it reached per "
              f"single call, {100 * t['bound_ms'] / t['device_ms']:.2f}% in "
              f"device time; wrapper host {t['host_us']:.2f} us per call "
              f"(2000 calls, synchronised wall)", flush=True)
    main = timed[DIST_TIMED[0]]
    # ms and plain_ms are both single-call CUDA-event medians (as in the
    # earlier records); device_ms is the queued device time per launch
    return dict(name="distance_transform", route="cuda",
                source="ldso_tpu_torch/csrc/distance_map.cu",
                replaces="ldso_tpu/ops/pallas_kernels.py:63",
                max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                device_ms=main["device_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None)


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


def phase_main_path(n_frames: int = N_FRAMES):
    """Drive FullSystem.add_active_frame (strict) on the bench scene, on
    the package's default device (the card); returns the main
    path's kernel launch counts and the run's frames and numbers, which
    phases 5 and 6 reuse."""
    import torch
    from ldso_tpu_torch.examples import time_modes

    calib, poses, images = time_modes.bench_frames(n_frames)   # set-up
    torch.cuda.reset_peak_memory_stats()
    strict, fs = time_modes.run_mode("strict", calib, poses, images,
                                     gpu=time_modes.gpu_facts())
    if fs.device.type != "cuda":
        _fail(f"FullSystem(calib, cfg) runs on {fs.device}, not the card")
    if strict["lost"] or strict["init_failed"]:
        _fail(f"main path: lost={strict['lost']} "
              f"init_failed={strict['init_failed']}")
    launches = dict(distance_transform=strict["k1_launches"])
    tracked = sum(1 for f in fs.all_frames if f.pose_valid)
    peak = torch.cuda.max_memory_allocated()
    print(f"main path: {n_frames} frames 640x480 uint8, "
          f"{strict['keyframes']} keyframes {strict['kf_ids']}, {tracked} "
          f"tracked, ATE {strict['ate_mm']:.4f} mm (sim3-aligned), "
          f"{strict['ms_per_frame_wall']:.2f} ms/frame wall, median "
          f"{strict['ms_per_frame_median']:.2f} ms per call, peak device "
          f"memory {peak / 2**20:.1f} MiB, K1 launches "
          f"{strict['k1_launches']} for {strict['post_bootstrap_keyframes']} "
          f"post-bootstrap keyframes", flush=True)
    if strict["keyframes"] < 8:
        _fail(f"only {strict['keyframes']} keyframes (need >= 8)")
    if not strict["ate_mm"] < ATE_BOUND_M * 1e3:
        _fail(f"ATE {strict['ate_mm']:.4f} mm >= {ATE_BOUND_M * 1e3} mm")
    if strict["k1_launches"] < strict["post_bootstrap_keyframes"]:
        _fail(f"K1 launched {strict['k1_launches']} times for "
              f"{strict['post_bootstrap_keyframes']} post-bootstrap keyframes")
    return launches, calib, images, poses, strict


def _mode_line(run: dict) -> str:
    keys = ("mode", "frames", "keyframes", "ate_mm", "ms_per_frame_median",
            "ms_per_frame_wall", "wall_s", "k1_launches", "k1_streams",
            "post_bootstrap_keyframes", "retrack_trips", "lm_frames", "gpu")
    return json.dumps({k: run[k] for k in keys})


def phase_pipelines(calib, images, poses, strict: dict, device="cuda"):
    """Phase 5: the phase-3 frames through DeterministicPipeline twice and
    AsyncPipeline once, by phase 3's driver; prints one JSON line per mode
    (strict is phase 3's run). Returns the runs."""
    from ldso_tpu_torch.examples import time_modes
    gpu = strict["gpu"]
    runs, poses_of = [], []
    for mode in ("lookahead", "lookahead", "async"):
        run, fs = time_modes.run_mode(mode, calib, poses, images, gpu=gpu,
                                      device=device)
        if run["lost"] or run["init_failed"]:
            _fail(f"pipelines: {mode}: lost={run['lost']} "
                  f"init_failed={run['init_failed']}")
        runs.append(run)
        poses_of.append([f.T_cw.tobytes() for f in fs.all_frames])
    look1, look2, asyn = runs
    print(f"pipelines: lookahead keyframes {look1['kf_ids']} and "
          f"{look2['kf_ids']}, async {asyn['kf_ids']}; K1 launches by "
          f"stream in async {asyn['k1_streams']}", flush=True)
    if look1["kf_ids"] != look2["kf_ids"] or poses_of[0] != poses_of[1]:
        _fail("pipelines: two lookahead runs are not bitwise identical")
    for run in (look1, asyn):
        if run["keyframes"] < 8:
            _fail(f"pipelines: {run['mode']} made {run['keyframes']} "
                  f"keyframes (need >= 8)")
        if not run["ate_mm"] < ATE_BOUND_M * 1e3:
            _fail(f"pipelines: {run['mode']} ATE {run['ate_mm']:.4f} mm >= "
                  f"{ATE_BOUND_M * 1e3} mm")
    if device == "cuda":
        for run in (strict, look1, look2, asyn):
            if not (run["k1_launches"] == run["post_bootstrap_keyframes"]
                    and run["k1_launches"] > 0):
                _fail(f"pipelines: {run['mode']}: K1 launched "
                      f"{run['k1_launches']} times for "
                      f"{run['post_bootstrap_keyframes']} post-bootstrap "
                      f"keyframes")
        if asyn["k1_streams"] != {"mapping": asyn["k1_launches"]}:
            _fail(f"pipelines: async K1 launches by stream "
                  f"{asyn['k1_streams']}, not all on the mapping thread's")
    for run in (strict, look1, look2, asyn):
        print(_mode_line(run), flush=True)
    return look1, look2, asyn


def write_kitti_sequence(seq: str, calib, images):
    """`images` as a KITTI sequence (image_0/%06d.png with the port's PNG
    writer, times.txt, a pinhole camera.txt with `none` rectification)."""
    import os
    import shutil
    from ldso_tpu_torch.io.png import write_png
    shutil.rmtree(seq, ignore_errors=True)
    os.makedirs(os.path.join(seq, "image_0"))
    for i, img in enumerate(images):
        write_png(os.path.join(seq, "image_0", f"{i:06d}.png"), img)
    with open(os.path.join(seq, "times.txt"), "w") as f:
        f.writelines(f"{i * 0.05:.6f}\n" for i in range(len(images)))
    with open(os.path.join(seq, "camera.txt"), "w") as f:
        f.write(f"Pinhole {calib.fx[0]} {calib.fy[0]} {calib.cx[0]} "
                f"{calib.cy[0]} 0\n{calib.w[0]} {calib.h[0]}\nnone\n"
                f"{calib.w[0]} {calib.h[0]}\n")


def phase_cli(calib, images, poses, root: str, device="cuda"):
    """Phase 6: the phase-3 frames written as a KITTI sequence with the
    port's PNG writer, then the port's CLI run on it with pipeline=lookahead
    and with pipeline=async (loop closing off, preset 0, the KITTI runner's
    mode=1; the async reader hands the mapping thread frames made on the
    card). Checks both trajectory files of each run, their rotations, the
    keyframe ATE, and K1's launches (async: all on the mapping thread, on
    one stream that is not the caller's). Returns K1's launches per mode."""
    import os
    import torch
    from ldso_tpu_torch.examples import run_common, time_modes
    from ldso_tpu_torch.io.trajectory import ate_rmse
    from ldso_tpu_torch.ops import cuda_kernels
    seq = os.path.join(root, "kitti_00")
    t0 = time.time()
    write_kitti_sequence(seq, calib, images)
    print(f"cli: wrote {len(images)} PNG frames in {time.time() - t0:.2f} s",
          flush=True)
    caller = (torch.cuda.current_stream().cuda_stream if device == "cuda"
              else None)
    out_launches = {}
    for pmode in ("lookahead", "async"):
        out = os.path.join(seq, f"results_{pmode}.txt")
        argv = [f"files={seq}", f"calib={os.path.join(seq, 'camera.txt')}",
                "preset=0", "mode=1", "loopclosing=0", f"pipeline={pmode}",
                "quiet=1", f"output={out}"]
        t0 = time.time()
        with time_modes.traced_k1() as k1:
            cuda_kernels.reset_launch_counts()
            fs = run_common.run(run_common.parse_args(argv), "kitti",
                                kitti_output=True, device=device)
            launches = cuda_kernels.LAUNCHES["distance_transform"]
        wall = time.time() - t0
        if fs.device.type != device:
            _fail(f"cli {pmode}: ran on {fs.device}, not {device}")
        if fs.is_lost:
            _fail(f"cli {pmode}: lost")
        for path in (out, out + ".noloop"):
            if not os.path.exists(path):
                _fail(f"cli {pmode}: {path} was not written")
        rows = [r.split() for r in open(out) if r.strip()]
        est, gt = [], []
        for r in rows:
            M = np.array([float(x) for x in r[1:]]).reshape(3, 4)
            err = float(np.abs(M[:, :3] @ M[:, :3].T - np.eye(3)).max())
            if not (len(r) == 13 and err < 1e-4):
                _fail(f"cli {pmode}: row of frame {r[0]} is not a rotation "
                      f"(|RR^T - I| = {err})")
            T_wc = np.eye(4)
            T_wc[:3] = M
            est.append(np.linalg.inv(T_wc))
            gt.append(poses[int(r[0])])
        ate = ate_rmse(est, gt)
        post_boot = sum(1 for kf in fs.global_map.get_all_kfs()
                        if kf.kf_id >= 2)
        print(f"cli {pmode}: {len(rows)} keyframe rows in {out} and "
              f".noloop, keyframe ATE {ate * 1e3:.4f} mm, {wall:.2f} s, K1 "
              f"launches {launches} for {post_boot} post-bootstrap keyframes, "
              f"by (thread, stream) {dict(k1)}", flush=True)
        if not ate < ATE_BOUND_M:
            _fail(f"cli {pmode}: keyframe ATE {ate * 1e3:.4f} mm >= "
                  f"{ATE_BOUND_M * 1e3} mm")
        if device == "cuda":
            if not launches == post_boot > 0:
                _fail(f"cli {pmode}: K1 launched {launches} times for "
                      f"{post_boot} post-bootstrap keyframes")
            streams = {s for _, s in k1}
            if pmode == "async" and not (
                    {t for t, _ in k1} == {"ldso-mapping"}
                    and len(streams) == 1 and caller not in streams):
                _fail(f"cli async: K1 launches by (thread, stream) "
                      f"{dict(k1)}, not all on the mapping thread's stream")
        out_launches[pmode] = launches
    return out_launches


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
    from ldso_tpu_torch.io.trajectory import ate_rmse
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

    fs = FullSystem(calib, cfg, vocab=vocab)
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
    posegraph.run_pose_graph(fs.global_map)
    final_pgo_ms = (time.perf_counter() - t) * 1e3

    kfs = fs.global_map.get_all_kfs()
    kf_frames = [kf.id for kf in kfs]
    post_boot = sum(1 for kf in kfs if kf.kf_id >= 2)
    gt = [poses[i] for i in kf_frames]
    ate_odo = ate_rmse([kf.T_cw for kf in kfs], gt)
    ate_loop = ate_rmse([kf.get_S_cw() for kf in kfs], gt)
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
    return launches, post_boot


def main() -> int:
    import os
    phase_device()
    import torch
    record = phase_kernels()
    phase_determinism()
    launches_vo, calib, images, poses, strict = phase_main_path()
    launches, post_boot = phase_loop_slice()
    look, _, asyn = phase_pipelines(calib, images, poses, strict)
    cli = phase_cli(calib, images, poses, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke"))
    by_path = dict(vo_strict=launches_vo["distance_transform"],
                   loop=launches["distance_transform"],
                   vo_lookahead=look["k1_launches"],
                   vo_async=asyn["k1_launches"],
                   cli_lookahead=cli["lookahead"], cli_async=cli["async"])
    print(f"K1 launches per path: {by_path}", flush=True)
    record["launches"] = launches["distance_transform"]
    record["launches_per_keyframe"] = launches["distance_transform"] / post_boot
    record["launches_by_path"] = by_path
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
