"""Smoke run of the PyTorch + CUDA port (ldso_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device facts: needs CUDA; prints the nvidia-smi name/power-limit line
     and the torch/CUDA versions, then builds the hand-written kernels from
     ldso_tpu_torch/csrc with nvcc and prints the build time;
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shapes and more, with max |kernel - plain| == 0 required,
     plus CUDA-event timings of both;
  3. the main path: the synchronous monocular VO FullSystem at 640x480 with
     the production Config (loop closing off) on 64 synthetic uint8 frames
     of the bench trajectory; asserts tracking, >= 8 keyframes, the kernel
     launched on every keyframe after the bootstrap, and a similarity-
     aligned ATE under 5 mm.
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


def main() -> int:
    phase_device()
    import torch
    record = phase_kernels()
    launches = phase_main_path()
    record["launches"] = launches["distance_transform"]
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
