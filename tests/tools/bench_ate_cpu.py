"""The bench's ATE on the CPU, through the port or through the JAX package.

    PYTHONPATH=$PWD python tests/tools/bench_ate_cpu.py --package port \\
        [--threads 3] [--width 640 --height 480] > port.json
    PYTHONPATH=$PWD python tests/tools/bench_ate_cpu.py --package jax > jax.json
    python tests/tools/bench_ate_cpu.py --compare jax.json port.json
    PYTHONPATH=$PWD python tests/tools/bench_ate_cpu.py --package jax \\
        --swap track,act [--source port|jax] [--threads 3] > swap.json
    PYTHONPATH=$PWD python tests/tools/bench_ate_cpu.py --package jax \\
        --eager opt > control.json

Feeds the frames the port's bench feeds its main system before the async
leg (`ldso_tpu_torch/examples/bench.py`: the bench trajectory over
PlaneScene(freq_hi=25, contrast=80), uint8 frames rendered once by the
port and given to both packages; `Config()` with loop closing off), in
the bench's schedule: `warm` strict frames, then a DeterministicPipeline
of depth 3 over `sync_warm` frames and three windows of `window`, each
ended by a drain, then three strict windows of `window` on the same
system (`--strict`: every frame strict). Prints one JSON line: the
package, the bench's ATE
(`bench.bench_ate`, bench.py's formula, in metres) over every posed frame
before the async leg, the all-frames sim3-aligned ATE (`io/trajectory.
ate_rmse`), the keyframe ids, the retrack gate's retry sweeps, every
frame's camera centre and the wall seconds. `--compare A B` prints the two ATEs, their ratio and the first
frame where the centres part by more than 1, 10 and 100 µm.
Each package runs in its own process: the JAX package on the CPU with
x64 off, as its CLI and bench run it (JAX_ENABLE_X64=1 for x64 on); the
port on `--threads` threads. Beside the ATEs the line gives the scale of
the sim3 alignment of each 40 frames (`scale_per_40`): a drift in scale
shows as a trend along it.

`--swap MODULE[,MODULE...]` (with `--package jax`; `all` for every one)
runs the JAX system with each call of the named modules carrying on with
the port's output on the JAX module's inputs (`tests/torch_module_swap.py`:
track, act, opt, mpts, mframe), the port on `--threads` threads, and adds
`bias`: per module the signed mean of port - JAX over its outputs'
inverse depths, its translations' norms and the priors' b. `--source jax`
swaps in the JAX module's own output through the port's types and back
(bitwise the plain run). `--eager MODULE[,...]` runs the named JAX
modules op by op (`jax.disable_jit()`) and swaps nothing: the rounding
control of a module whose swap moves the ATE.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np


def _schedule(warm: int, sync_warm: int, window: int, strict: bool):
    """[(kind, ids)]: ("strict", ids) frames fed to the FullSystem;
    ("lookahead", ids) frames fed to the pipeline then drained. With
    `strict`, every frame goes to the FullSystem."""
    if strict:
        return [("strict", range(warm + sync_warm + 6 * window))]
    out = [("strict", range(warm))]
    start = warm
    out.append(("lookahead", range(start, start + sync_warm)))
    start += sync_warm
    for _ in range(3):
        out.append(("lookahead", range(start, start + window)))
        start += window
    for _ in range(3):
        out.append(("strict", range(start, start + window)))
        start += window
    return out


def run(package: str, args) -> dict:
    from ldso_tpu_torch.examples import bench, time_modes
    from ldso_tpu_torch.io.trajectory import ate_rmse
    n = args.warm + args.sync_warm + 6 * args.window
    calib, poses, images = time_modes.bench_frames(n, args.width,
                                                   args.height, "cpu")
    hooks = contextlib.nullcontext()
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from ldso_tpu.config import Config
        from ldso_tpu.synthetic import default_calib
        from ldso_tpu.system.full_system import FullSystem
        from ldso_tpu.system.pipeline import DeterministicPipeline
        tcalib = calib
        calib = default_calib(args.width, args.height)
        fs = FullSystem(calib, dataclasses.replace(
            Config(), enable_loop_closing=False))
        if args.swap or args.eager:
            import torch
            torch.set_num_threads(args.threads)
            sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))
            import torch_module_swap
            from ldso_tpu_torch.config import Config as TConfig
            tcfg = dataclasses.replace(TConfig(), enable_loop_closing=False)
            hooks = torch_module_swap.swap_hooks(
                fs, tcfg, tcalib, (args.swap or args.eager).split(","),
                source=args.source, eager=bool(args.eager),
                noise_seed=args.noise_seed)
    else:
        import torch
        torch.set_num_threads(args.threads)
        from ldso_tpu_torch.config import Config
        from ldso_tpu_torch.system.full_system import FullSystem
        from ldso_tpu_torch.system.pipeline import DeterministicPipeline
        fs = FullSystem(calib, dataclasses.replace(
            Config(), enable_loop_closing=False), device="cpu")
    t0 = time.time()
    pipe = None
    with hooks as bias:
        for kind, ids in _schedule(args.warm, args.sync_warm, args.window,
                                   args.strict):
            if kind == "lookahead" and pipe is None:
                pipe = DeterministicPipeline(fs, depth=3)
            target = pipe if kind == "lookahead" else fs
            for i in ids:
                target.add_active_frame(images[i], i, 1.0, i * 0.05)
                if fs.is_lost or fs.init_failed:
                    break
            if kind == "lookahead":
                pipe.block_until_mapping_is_finished()
    est = [f for f in fs.all_frames if f.pose_valid and f.id < n]
    centres = {f.id: np.linalg.inv(f.T_cw)[:3, 3].tolist() for f in est}
    extra = {}
    if bias is not None:
        extra = dict(swap=args.swap, eager=args.eager, source=args.source,
                     noise_seed=args.noise_seed, bias=bias.table())
    return dict(
        package=package, frames=n, lost=bool(fs.is_lost),
        bench_ate_m=bench.bench_ate([f.T_cw for f in est],
                                    [poses[f.id] for f in est]),
        ate_mm=1e3 * ate_rmse([f.T_cw for f in est],
                              [poses[f.id] for f in est]),
        kf_ids=[kf.id for kf in fs.global_map.get_all_kfs()],
        strict=args.strict, retry_sweeps=getattr(fs, "_n_retry_sweeps", 0),
        scale_per_40=scale_per_segment(est, poses, 40),
        centres=centres, wall_s=time.time() - t0,
        threads=args.threads if package == "port" or extra else None,
        **extra)


def scale_per_segment(est, poses, seg: int) -> list:
    """The scale of the sim3 alignment (estimate onto the truth) of the
    camera centres of each `seg` consecutive frames."""
    from ldso_tpu_torch.io.trajectory import umeyama_alignment
    out = []
    ids = sorted(f.id for f in est)
    by_id = {f.id: f for f in est}
    for k in range(0, ids[-1] + 1 if ids else 0, seg):
        sel = [i for i in ids if k <= i < k + seg]
        if len(sel) < 3:
            continue
        ec = np.stack([np.linalg.inv(by_id[i].T_cw)[:3, 3] for i in sel])
        gc = np.stack([np.linalg.inv(poses[i])[:3, 3] for i in sel])
        out.append(float(umeyama_alignment(ec, gc)[0]))
    return out


def compare(a: dict, b: dict) -> dict:
    ids = sorted(set(map(int, a["centres"])) & set(map(int, b["centres"])))
    gaps = [float(np.linalg.norm(np.subtract(a["centres"][str(i)],
                                             b["centres"][str(i)])))
            for i in ids]
    first = {f"{um}um": next((ids[k] for k, g in enumerate(gaps)
                              if g > um * 1e-6), None)
             for um in (1, 10, 100)}
    return dict(packages=[a["package"], b["package"]],
                bench_ate_m=[a["bench_ate_m"], b["bench_ate_m"]],
                ratio=b["bench_ate_m"] / a["bench_ate_m"],
                ate_mm=[a["ate_mm"], b["ate_mm"]],
                kf_ids_equal=a["kf_ids"] == b["kf_ids"],
                first_frame_parting=first, max_gap_mm=1e3 * max(gaps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "port"))
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--threads", type=int, default=3)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--warm", type=int, default=56)
    ap.add_argument("--sync-warm", type=int, default=8)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--strict", action="store_true",
                    help="every frame strict, no lookahead leg")
    ap.add_argument("--swap", default="", metavar="MODULE[,MODULE...]",
                    help="with --package jax: the modules whose calls carry "
                         "on with the port's output (track, act, opt, mpts, "
                         "mframe, or all)")
    ap.add_argument("--source", default="port", choices=("port", "jax"),
                    help="what --swap swaps in: the port's output or the "
                         "JAX module's own through the port's types")
    ap.add_argument("--noise-seed", type=int, default=0,
                    help="the seed of --swap tracker_noise's steps")
    ap.add_argument("--eager", default="", metavar="MODULE[,MODULE...]",
                    help="with --package jax: run these modules op by op "
                         "(the rounding control); swaps nothing")
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (json.loads(open(p).read().splitlines()[-1])
                for p in args.compare)
        print(json.dumps(compare(a, b)))
        return 0
    print(json.dumps(run(args.package, args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
