"""Time the three modes of the port against each other, in one process.

    python -m ldso_tpu_torch.examples.time_modes [--frames 64] [--reps 2]

Renders `chip_smoke.py`'s phase-3 scene (the bench trajectory, 640x480
uint8 PlaneScene frames, `Config()` with loop closing off) and drives it
through strict, lookahead and async in turns (strict, lookahead, async,
then the reverse, `--reps` times), so that a drift of the host's speed
during the call falls on every mode alike. Each run prints one JSON line:
the wall clock from the first frame to the end of the drain (with a
synchronise) per frame (`ms_per_frame_wall`), the median host time of one
add_active_frame call from the bootstrap on (`ms_per_frame_median`), the
keyframes, the ATE, K1's launches and the streams they went to, the
retrack-gate trips, how many frames the tracker ran on (a pipeline
re-tracks its frames in flight after each keyframe) and the host time of
those calls (on the card a graph replay that does not wait for the
track), the tracker graphs captured inside the run (0: the FullSystem
captures them when it is built), and the card's name and power limit.
Needs the card; the stage timers of each run go to stderr.

`bench_frames` and `run_mode` are also the driver of `chip_smoke.py`'s
phases 3 and 5.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ldso_tpu_torch.config import Config
from ldso_tpu_torch.examples.run_common import PIPELINES, make_driver
from ldso_tpu_torch.frontend import track_graph, tracker
from ldso_tpu_torch.io.trajectory import ate_rmse
from ldso_tpu_torch.math import lie_np
from ldso_tpu_torch.ops import cuda_kernels
from ldso_tpu_torch.synthetic import PlaneScene, default_calib
from ldso_tpu_torch.system.full_system import FullSystem
from ldso_tpu_torch.utils.device import DEFAULT_DEVICE


def gpu_facts() -> dict:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    name, limit = (x.strip() for x in out[0].split(",", 1))
    return dict(name=name, power_limit=limit)


def bench_frames(n: int, w: int = 640, h: int = 480, device="cuda"):
    """The bench trajectory (bench.py:135-140) over PlaneScene(freq_hi=25,
    contrast=80), rendered on `device` and returned as uint8 numpy frames
    with the camera-from-world poses: (calib, poses, images)."""
    calib = default_calib(w, h)
    scene = PlaneScene(freq_hi=25.0, contrast=80.0)
    poses, images = [], []
    for i in range(n):
        t = np.array([0.03 * i, 0.01 * np.sin(0.2 * i), 0.004 * i])
        w_ = np.array([0.0, 0.0018 * i, 0.0004 * i])
        T = np.linalg.inv(lie_np.se3_exp(np.concatenate([t, w_])))
        img, _ = scene.render(calib, T, device=device)
        poses.append(T)
        images.append(torch.clamp(torch.round(img), 0, 255)
                      .to(torch.uint8).cpu().numpy())
    return calib, poses, images


@contextlib.contextmanager
def traced_k1():
    """Count K1's launches by (thread name, CUDA stream handle) while
    inside; the launch counts themselves stay the wrapper's."""
    seen = collections.Counter()
    kernel = cuda_kernels.distance_transform

    def traced(occ, max_k=cuda_kernels.MAX_K):
        if occ.is_cuda:
            stream = torch.cuda.current_stream(occ.device).cuda_stream
            seen[(threading.current_thread().name, stream)] += 1
        return kernel(occ, max_k)
    cuda_kernels.distance_transform = traced
    try:
        yield seen
    finally:
        cuda_kernels.distance_transform = kernel


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_mode(mode: str, calib, poses, images, gpu=None,
             device=DEFAULT_DEVICE, cfg=None):
    """One run of `mode` over `images` with `cfg` (default `Config()` with
    loop closing off), K1's counts set to 0 just before the first frame and
    read after the drain. No synchronise per frame (it would stall the
    mapping thread). Returns (the run's numbers, the FullSystem)."""
    if cfg is None:
        cfg = dataclasses.replace(Config(), enable_loop_closing=False)
    fs = FullSystem(calib, cfg, device=device)
    drv = make_driver(fs, mode)
    on_card = fs.device.type == "cuda"
    caller = (torch.cuda.current_stream(fs.device).cuda_stream if on_card
              else None)
    mapping = getattr(drv, "map_stream", None)
    mapping = mapping.cuda_stream if mapping is not None else None
    lm = dict(frames=0, s=0.0)
    track_frame = tracker.track_frame

    def counted(*a):
        t = time.perf_counter()
        out = track_frame(*a)           # not the retry batches
        lm["frames"] += 1
        lm["s"] += time.perf_counter() - t
        return out
    tracker.track_frame = counted
    try:
        with traced_k1() as k1:
            _sync(fs.device)
            cuda_kernels.reset_launch_counts()
            captures = track_graph.CAPTURES["count"]
            call_ms = []
            t0 = time.perf_counter()
            for i, img in enumerate(images):
                t = time.perf_counter()
                drv.add_active_frame(img, i, 1.0, i * 0.05)
                call_ms.append((time.perf_counter() - t) * 1e3)
                if fs.is_lost or fs.init_failed:
                    break
            if drv is not fs:
                drv.block_until_mapping_is_finished()
            _sync(fs.device)
            wall = time.perf_counter() - t0
            launches = cuda_kernels.LAUNCHES["distance_transform"]
            captures = track_graph.CAPTURES["count"] - captures
    finally:
        tracker.track_frame = track_frame
    streams = collections.Counter()
    for (_, s), n in k1.items():
        streams["mapping" if s == mapping else
                "caller" if s == caller else "other"] += n
    kfs = fs.global_map.get_all_kfs()
    kf_ids = [kf.id for kf in kfs]
    est = [f for f in fs.all_frames if f.pose_valid]
    ate = ate_rmse([f.T_cw for f in est], [poses[f.id] for f in est])
    ate_kf = (ate_rmse([kf.T_cw for kf in kfs], [poses[i] for i in kf_ids])
              if len(kfs) >= 3 else float("nan"))
    print(f"--- {mode}\n{fs.timer.summary()}", file=sys.stderr, flush=True)
    run = dict(mode=mode, frames=len(images), keyframes=len(kfs),
               kf_ids=kf_ids, ate_mm=ate * 1e3, ate_kf_mm=ate_kf * 1e3,
               ms_per_frame_wall=wall * 1e3 / len(images), wall_s=wall,
               ms_per_frame_median=float(np.median(call_ms[kf_ids[1]:]))
               if len(kf_ids) > 1 else None,
               k1_launches=launches, k1_streams=dict(streams),
               post_bootstrap_keyframes=sum(1 for kf in kfs if kf.kf_id >= 2),
               lm_frames=lm["frames"], lm_s=lm["s"], graph_captures=captures,
               retrack_trips=getattr(drv, "retrack_trips",
                                     fs._n_retry_sweeps),
               lost=fs.is_lost, init_failed=fs.init_failed, gpu=gpu)
    return run, fs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_modes: needs a CUDA card", file=sys.stderr)
        return 1
    gpu = gpu_facts()
    calib, poses, images = bench_frames(args.frames)
    cuda_kernels.build()
    run_mode("strict", calib, poses, images[:16], gpu)      # warm-up
    for r in range(args.reps):
        for mode in (PIPELINES if r % 2 == 0 else PIPELINES[::-1]):
            run, _ = run_mode(mode, calib, poses, images, gpu)
            print(json.dumps(run), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
