"""The bench's ATE on the card, for several trees of the port in turns.

    python tests/tools/bench_ate_turns.py --tree parent=build/turns/P \\
        --tree change=build/turns/C [--tree NAME=PATH ...] [--rounds 3] \\
        [--out build/ate_turns.jsonl] [--device cuda] [--bench "ARGS"]
        [--noise-seeds 1 2 3]

Each PATH holds a copy of `ldso_tpu_torch/` (for instance `git archive
<commit> ldso_tpu_torch | tar -x -C PATH`). Every tree's kernels are built
first, all trees at once, each into its own PATH/build/. Then each round
runs every tree once, in a process of its own, in the order given on even
rounds and reversed on odd ones (parent, change, change, parent, ...).
A run drives that tree's own bench legs (`examples/bench.py`) on one
FullSystem as the bench does: warmup, lookahead and strict over the
bench's first 160 frames, then the async leg. It records:

  ate_pre_m   the bench's ATE (`bench.bench_ate`) over every posed frame
              before the async leg, read before the async leg runs (the
              frames `tests/tools/bench_ate_cpu.py` feeds);
  ate_m       the same frames read after the async leg, as the bench's
              `ate_m_sim_aligned` is (the async leg's BA still moves the
              keyframes of its first window);
  kf_ids, scale_per_40 (the sim3 scale of each 40 frames, read before
  the async leg), centres_sha (a hash of those camera centres: equal
  hashes are bitwise equal trajectories), async_moved (how many of those
  frames the async leg moved, and the farthest move in the system's
  units), async_keyframes (the async leg's keyframes per window),
  wall_s.

`--noise-seeds S0 S1 ...` makes a rounding control: round r moves every
tracked pose by a random se(3) step of NOISE_SIGMA a coordinate, seeded by
S_r (shell.T_cw <- exp(step) T_cw after each `_track_new_coarse`; the
step the JAX package's control took in tests/torch_module_swap.py's
`tracker_noise`), so the runs' spread is the system's sensitivity to
rounding of that size; there are as many rounds as seeds.
`--bench` passes its arguments to the bench's parser (a smaller frame or
fewer frames, for a check of the tool on the CPU with `--device cpu`).
Prints one JSON line a run and a summary line (per tree, the runs' ATEs)
with the card's name and power limit, and appends them to `--out`.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# the standard deviation of each coordinate of --noise-seeds' steps
# (torch_module_swap.NOISE_SIGMA)
NOISE_SIGMA = 6e-8


def scale_per_segment(est, poses, seg: int) -> list:
    """The scale of the sim3 alignment (estimate onto the truth) of the
    camera centres of each `seg` consecutive frames."""
    from ldso_tpu_torch.io.trajectory import umeyama_alignment
    out = []
    by_id = {f.id: f for f in est}
    ids = sorted(by_id)
    for k in range(0, ids[-1] + 1 if ids else 0, seg):
        sel = [i for i in ids if k <= i < k + seg]
        if len(sel) < 3:
            continue
        ec = np.stack([np.linalg.inv(by_id[i].T_cw)[:3, 3] for i in sel])
        gc = np.stack([np.linalg.inv(poses[i])[:3, 3] for i in sel])
        out.append(float(umeyama_alignment(ec, gc)[0]))
    return out


def _noisy_tracks(seed: int):
    """Move every tracked pose by a random se(3) step of NOISE_SIGMA a
    coordinate (a generator seeded by `seed`), for the rest of the
    process."""
    from ldso_tpu_torch.math import lie_np
    from ldso_tpu_torch.system import full_system as fsm
    rng = np.random.RandomState(seed)
    track = fsm.FullSystem._track_new_coarse

    def noisy(self, shell, *a, **k):
        ok = track(self, shell, *a, **k)
        step = rng.randn(6) * NOISE_SIGMA
        shell.T_cw = lie_np.se3_exp(step) @ shell.T_cw
        return ok
    fsm.FullSystem._track_new_coarse = noisy


def one_run(root: str, device: str, bench_argv, noise_seed=None) -> dict:
    """The bench's first legs on the tree at `root` (its package first on
    sys.path), on `device`, with the bench's arguments `bench_argv`;
    with `noise_seed`, every tracked pose moved (`_noisy_tracks`)."""
    sys.path.insert(0, os.path.abspath(root))
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.examples import bench, time_modes
    if noise_seed is not None:
        _noisy_tracks(noise_seed)
    args = bench.parse_args(bench_argv)
    run = bench.Run(args, bench.entry_device(device))
    run.cfg = dataclasses.replace(Config(), enable_loop_closing=False)
    n = run.ids("async")[-1] + 1
    run.calib, run.poses, run.images = time_modes.bench_frames(
        n, args.width, args.height, run.dev)
    end = run.ids("async")[0]
    t0 = time.perf_counter()
    result = {}
    for leg in (bench.leg_warmup, bench.leg_lookahead, bench.leg_strict):
        leg(run, result)
    est = [f for f in run.fs.all_frames if f.pose_valid and f.id < end]
    centres = np.stack([np.linalg.inv(f.T_cw)[:3, 3] for f in est])
    out = dict(
        ate_pre_m=bench.bench_ate([f.T_cw for f in est],
                                  [run.poses[f.id] for f in est]),
        kf_ids=[kf.id for kf in run.fs.global_map.get_all_kfs()],
        scale_per_40=scale_per_segment(est, run.poses, 40),
        centres_sha=hashlib.sha256(centres.tobytes()).hexdigest()[:16])
    bench.leg_async(run, result)
    bench.leg_ate(run, result)
    moved = np.linalg.norm(np.stack([np.linalg.inv(f.T_cw)[:3, 3]
                                     for f in est]) - centres, axis=1)
    out.update(ate_m=result["ate_m_sim_aligned"],
               async_moved=dict(frames=int((moved > 0).sum()),
                                farthest=float(moved.max())),
               async_keyframes=result["piped_keyframes_windows"],
               wall_s=time.perf_counter() - t0)
    return out


def _spawn(root: str, what: str, extra=()) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), f"--{what}", root,
         *extra], stdout=subprocess.PIPE, text=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="build/ate_turns.jsonl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bench", default="", metavar="ARGS",
                    help="arguments for the bench's parser")
    ap.add_argument("--noise-seeds", type=int, nargs="+", default=None,
                    help="a rounding control: one round per seed")
    ap.add_argument("--noise-seed", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--run", metavar="PATH", help=argparse.SUPPRESS)
    ap.add_argument("--build", metavar="PATH", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.build:
        sys.path.insert(0, os.path.abspath(args.build))
        from ldso_tpu_torch.ops import cuda_kernels
        print(json.dumps(dict(library=cuda_kernels.build())), flush=True)
        return 0
    if args.run:
        print(json.dumps(one_run(args.run, args.device, args.bench.split(),
                                 args.noise_seed)), flush=True)
        return 0
    trees = [t.split("=", 1) for t in args.tree]
    if not trees:
        ap.error("no --tree")
    builds = ([(name, _spawn(path, "build")) for name, path in trees]
              if args.device == "cuda" else [])
    for name, proc in builds:
        proc.communicate()
        if proc.returncode:
            print(f"{name}: the build failed", file=sys.stderr)
            return 1
    sys.path.insert(0, os.path.abspath(trees[0][1]))
    from ldso_tpu_torch.examples import time_modes
    facts = time_modes.gpu_facts() if args.device == "cuda" else None
    lines = []
    ok = True
    seeds = args.noise_seeds or [None] * args.rounds
    for r, seed in enumerate(seeds):
        extra = ("--device", args.device, f"--bench={args.bench}")
        if seed is not None:
            extra += ("--noise-seed", str(seed))
        for name, path in (trees if r % 2 == 0 else trees[::-1]):
            proc = _spawn(path, "run", extra)
            stdout, _ = proc.communicate()
            line = dict(tree=name, round=r, noise_seed=seed,
                        rc=proc.returncode)
            if proc.returncode == 0:
                line.update(json.loads(stdout.strip().splitlines()[-1]))
            ok = ok and proc.returncode == 0
            print(json.dumps(line), flush=True)
            lines.append(line)
    summary = dict(device=facts, trees={
        name: dict(ate_pre_mm=[1e3 * l["ate_pre_m"] for l in lines
                               if l["tree"] == name and "ate_pre_m" in l],
                   ate_mm=[1e3 * l["ate_m"] for l in lines
                           if l["tree"] == name and "ate_m" in l])
        for name, _ in trees})
    print(json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        for line in lines + [summary]:
            f.write(json.dumps(line) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
