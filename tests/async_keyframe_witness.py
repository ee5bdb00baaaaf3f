"""Async keyframes when tracking outruns mapping, in both packages.

    PYTHONPATH=$PWD python tests/async_keyframe_witness.py \
        [--frames 32] [--ratios 0,1,3] [--packages jax,torch]

Runs the JAX package's AsyncPipeline and the port's (ldso_tpu_torch, on
the CPU) on the same uint8 PlaneScene frames (192x144,
tests/test_pipeline.py's trajectory and Config): first linearized (the
strict loop, every frame mapped before the next is tracked), then
threaded once per mapping delay. The delay is `ratio` times the package's
own tracking time per frame, read from its undelayed threaded run: every
frame the mapping thread takes (make_keyframe, make_keyframe_dispatch,
make_non_keyframe) first sleeps that long, so tracking runs ahead of
mapping by that margin. Both pipelines make a popped frame a keyframe
only when the mapping queue is empty behind it (FullSystem.cc:1825-1864),
so their keyframes should fall alike below the strict loop's as tracking
runs further ahead.

Prints one JSON line per run: the package, the mode, the ratio and the
delay, the keyframes and their frame ids, the frames the mapping thread
took (the rest were skipped by catch-up), the deepest queue behind a
frame the mapping thread took, the caller's time per frame, and the ATE.
A warm-up run of each package (its compiles) comes first and is not
printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

KW = dict(max_points=512, max_immature=512,
          tracker_caps=(4096, 2048, 1024, 512, 256, 128),
          desired_point_density=300, desired_immature_density=250,
          enable_loop_closing=False)
MAPPING_CALLS = ("make_keyframe", "make_keyframe_dispatch",
                 "make_non_keyframe")


def frames(n: int):
    """tests/test_pipeline.py's async trajectory as uint8 frames, rendered
    by the JAX package: (calib, poses, images)."""
    import jax.numpy as jnp
    from ldso_tpu.math import lie
    from ldso_tpu.synthetic import PlaneScene, default_calib
    calib = default_calib(192, 144)
    scene = PlaneScene(freq_hi=25.0, contrast=80.0)
    poses, images = [], []
    for i in range(n):
        t = np.array([0.035 * i, 0.01 * np.sin(0.2 * i), 0.003 * i,
                      0.0, 0.0015 * i, 0.0])
        T = np.linalg.inv(np.asarray(lie.se3_exp(jnp.asarray(t))))
        img, _ = scene.render(calib, jnp.asarray(T, jnp.float32))
        poses.append(T)
        images.append(np.clip(np.round(np.asarray(img)), 0,
                              255).astype(np.uint8))
    return calib, poses, images


def make_system(package: str, calib, linearize: bool):
    """A FullSystem of `package` and its AsyncPipeline."""
    if package == "jax":
        from ldso_tpu.config import Config
        from ldso_tpu.system.full_system import FullSystem
        from ldso_tpu.system.pipeline import AsyncPipeline
        fs = FullSystem(calib, Config(**KW))
    else:
        from ldso_tpu_torch.config import Config
        from ldso_tpu_torch.synthetic import default_calib
        from ldso_tpu_torch.system.full_system import FullSystem
        from ldso_tpu_torch.system.pipeline import AsyncPipeline
        fs = FullSystem(default_calib(calib.w[0], calib.h[0]), Config(**KW),
                        device="cpu")
    return fs, AsyncPipeline(fs, linearize_operation=linearize)


def run(package: str, calib, poses, images, delay_s: float,
        linearize: bool = False) -> dict:
    """One async run with `delay_s` of sleep before each mapping call."""
    fs, drv = make_system(package, calib, linearize)
    mapped, depth = [], [0]
    for name in MAPPING_CALLS:
        fn = getattr(fs, name, None)
        if fn is None:
            continue

        def slowed(*a, _fn=fn, **k):
            if delay_s > 0:
                time.sleep(delay_s)
            mapped.append(a[0].id)
            depth[0] = max(depth[0], len(drv.unmapped))
            return _fn(*a, **k)
        setattr(fs, name, slowed)
    call_s = []
    t0 = time.perf_counter()
    for i, img in enumerate(images):
        t = time.perf_counter()
        drv.add_active_frame(img, i, 1.0, i * 0.05)
        call_s.append(time.perf_counter() - t)
        if fs.is_lost:
            break
    drv.block_until_mapping_is_finished()
    wall = time.perf_counter() - t0
    kf_ids = sorted(kf.id for kf in fs.global_map.get_all_kfs())
    est = [f for f in fs.all_frames if f.pose_valid]
    if package == "jax":
        from ldso_tpu.io.trajectory import ate_rmse
    else:
        from ldso_tpu_torch.io.trajectory import ate_rmse
    ate = ate_rmse([f.T_cw for f in est], [poses[f.id] for f in est])
    boot = kf_ids[1] if len(kf_ids) > 1 else len(images)
    return dict(package=package,
                mode="linearized" if linearize else "threaded",
                delay_ms=delay_s * 1e3,
                keyframes=len(kf_ids), kf_ids=kf_ids,
                frames_mapped=len(set(mapped)), frames=len(images),
                max_queue=depth[0],
                caller_ms_per_frame=1e3 * float(np.mean(call_s[boot:])),
                wall_s=wall, ate_mm=ate * 1e3, lost=bool(fs.is_lost))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--ratios", default="0,1,3")
    ap.add_argument("--packages", default="jax,torch")
    args = ap.parse_args(argv)
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["LDSO_TPU_NO_COMPILE_CACHE"] = "1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir", None)
    calib, poses, images = frames(args.frames)
    ratios = [float(r) for r in args.ratios.split(",")]
    if ratios[0] != 0:
        ap.error("the first ratio is the undelayed run: 0")
    for package in args.packages.split(","):
        run(package, calib, poses, images[:12], 0.0)         # warm-up
        print(json.dumps(run(package, calib, poses, images, 0.0, True)),
              flush=True)
        base = None
        for ratio in ratios:
            delay = ratio * base if ratio else 0.0
            out = run(package, calib, poses, images, delay)
            if not ratio:
                base = out["caller_ms_per_frame"] / 1e3
            out["ratio"] = ratio
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
