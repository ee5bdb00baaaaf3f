"""The frame step's track on the bench's frames, held against float64: the
JAX package's jitted tracker, the port's and the JAX tracker run in float64
on the same inputs, call by call, with signed differences.

    PYTHONPATH=$PWD python tests/tools/tracker_rounding.py [--threads 3] \\
        [--frames 160] [--every 1] > tracker_rounding.json

Runs the JAX system over the bench's schedule on the CPU, as
`tests/tools/bench_ate_cpu.py --package jax` does, with its frame step in
separately jitted parts (`tests/torch_module_swap.py`'s `defused`, bitwise
the fused step on this run). At every `--every`-th track of hypothesis 0
(the frame and chain steps) it also runs the port's track
(`tracker._track_batch`) and the JAX package's `track_frame` with x64 on,
on the same inputs cast to float64. Per call: the pose's translation t
(of the new frame relative to the tracking reference), its rotation and
the brightness affine (a, b) in each; the signed difference of |t| from
the float64 result, of t along the float64 result's direction and along
the direction back to the track's start (T0: positive where the LM
stopped short of float64's end), of a and of b, for the JAX package and
for the port.
With `--terms`, per call also the level-0 warp and reduce at the float64
track's end in each package (`torch_module_swap.tracker_gs_vs_float64`):
the gradient b's rounding there, and the pose offset it implies where a
float32 LM stops (-H^-1 db). Prints one JSON line per call and a
summary: the mean of each signed difference, how many calls had it
positive, and the mean |difference|.
A module whose rounding only scatters shows as many positive calls as
negative ones; a bias as a signed mean well away from 0 with most calls on
one side.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=3)
    ap.add_argument("--every", type=int, default=1)
    ap.add_argument("--terms", action="store_true",
                    help="also the level-0 gradient b's rounding at the "
                         "float64 track's end and the pose it implies "
                         "(torch_module_swap.tracker_gs_vs_float64)")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--warm", type=int, default=56)
    ap.add_argument("--sync-warm", type=int, default=8)
    ap.add_argument("--window", type=int, default=16)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(HERE))
    sys.path.insert(0, HERE)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(args.threads)
    import bench_ate_cpu
    import torch_module_swap as sw
    from ldso_tpu.config import Config
    from ldso_tpu.frontend import tracker as jtr
    from ldso_tpu.synthetic import default_calib
    from ldso_tpu.system.full_system import FullSystem
    from ldso_tpu.system.pipeline import DeterministicPipeline
    from ldso_tpu_torch.config import Config as TConfig
    from ldso_tpu_torch.examples import time_modes
    n = args.warm + args.sync_warm + 6 * args.window
    tcalib, poses, images = time_modes.bench_frames(n, args.width,
                                                    args.height, "cpu")
    calib = default_calib(args.width, args.height)
    fs = FullSystem(calib, dataclasses.replace(Config(),
                                               enable_loop_closing=False))
    tcfg = dataclasses.replace(TConfig(), enable_loop_closing=False)
    rows = []
    track = jtr.track_frame
    count = [0]

    def recorded(ref, pyr, T0, aff0, exposure, no_abort, calib_, cfg,
                 coarsest):
        out = track(ref, pyr, T0, aff0, exposure, no_abort, calib_, cfg,
                    coarsest)
        count[0] += 1
        if (count[0] - 1) % args.every == 0:
            row = dict(call=count[0] - 1, **sw.tracker_vs_float64(
                track, out, (ref, pyr, T0, aff0, exposure, no_abort, calib_,
                             cfg, coarsest), tcalib, tcfg, terms=args.terms))
            rows.append(row)
            print(json.dumps(row), flush=True)
        return out

    t0 = time.time()
    jtr.track_frame = recorded
    try:
        with sw.swap_hooks(fs, tcfg, tcalib, ("defused",)):
            pipe = None
            for kind, ids in bench_ate_cpu._schedule(
                    args.warm, args.sync_warm, args.window, False):
                if kind == "lookahead" and pipe is None:
                    pipe = DeterministicPipeline(fs, depth=3)
                target = pipe if kind == "lookahead" else fs
                for i in ids:
                    target.add_active_frame(images[i], i, 1.0, i * 0.05)
                if kind == "lookahead":
                    pipe.block_until_mapping_is_finished()
    finally:
        jtr.track_frame = track
    summary = dict(calls=len(rows), wall_s=time.time() - t0,
                   **sw.tracker_summary(rows))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
