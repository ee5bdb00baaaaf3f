"""Which part of the trace moves the port's runs: its order of sums or its
speed.

    git show <parent>:ldso_tpu_torch/frontend/immature.py \\
        > build/parent_immature.py
    PYTHONPATH=$PWD python tests/tools/trace_order_split.py \\
        --parent-immature build/parent_immature.py k4 plain parent

For each variant named, in that order and each in a process of its own,
FullSystem's arena trace (`immature.trace_arena`) is one of
  k4      the wrapper, as the system runs it (K4 on the card);
  plain   `immature.trace_arena_ref`, the plain version in K4's order of
          sums: the same bits as k4 at the plain version's speed;
  parent  the plain version of another checkout's
          `ldso_tpu_torch/frontend/immature.py`, in that checkout's own
          order of sums (--parent-immature),
and the process runs
  * `time_modes.run_mode` in strict, lookahead and async (async --async
    times) on the 64-frame bench scene;
  * the bench's legs warmup, lookahead, strict and async
    (`examples/bench.py`, its defaults), with its ATE (`leg_ate`, over the
    frames before the async leg) taken before the async leg and after it;
  * with --loop, `chip_smoke.phase_loop_slice`: loop closing on the
    150-frame revisit scene.
Each process prints one JSON line: per mode the keyframes, the ATE and the
wall ms per frame; the bench's fps, async's keyframes per window and both
ATEs; the loop slice's keyframes, loops and ATEs; K4's launches and the
traces; the card's name and power limit. The order of sums shows where k4
and plain agree and parent differs; the speed where plain and parent agree
and k4 differs. Needs the card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
VARIANTS = ("k4", "plain", "parent")


def swap_trace(variant: str, parent_immature: str | None) -> None:
    """Put the variant's arena trace where FullSystem._trace_arena finds
    it."""
    from ldso_tpu_torch.frontend import immature
    if variant == "plain":
        immature.trace_arena = immature.trace_arena_ref
    elif variant == "parent":
        spec = importlib.util.spec_from_file_location("parent_immature",
                                                      parent_immature)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        immature.trace_arena = mod.trace_arena


def modes(n_async: int) -> list:
    from ldso_tpu_torch.examples import time_modes
    calib, poses, images = time_modes.bench_frames(64)
    time_modes.run_mode("strict", calib, poses, images[:16])    # warm-up
    out = []
    for mode in ("strict", "lookahead") + ("async",) * n_async:
        run, _ = time_modes.run_mode(mode, calib, poses, images)
        out.append({k: run[k] for k in (
            "mode", "keyframes", "kf_ids", "ate_mm", "ms_per_frame_wall",
            "k4_launches", "traces")})
    return out


def bench_legs() -> dict:
    import torch
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.examples import bench, time_modes
    run = bench.Run(bench.parse_args([]), torch.device("cuda"))
    run.cfg = dataclasses.replace(Config(), enable_loop_closing=False)
    n = run.ids("async")[-1] + 1
    run.calib, run.poses, run.images = time_modes.bench_frames(
        n, run.args.width, run.args.height, run.dev)
    result, ate = {}, {}
    with time_modes.counted_traces() as run.traces:
        for leg in (bench.leg_warmup, bench.leg_lookahead, bench.leg_strict):
            leg(run, result)
        bench.leg_ate(run, result)
        ate["before_async_mm"] = result["ate_m_sim_aligned"] * 1e3
        bench.leg_async(run, result)
        bench.leg_ate(run, result)
        ate["after_async_mm"] = result["ate_m_sim_aligned"] * 1e3
    return dict(ate, **{k: result[k] for k in (
        "sync_fps", "strict_fps", "value", "piped_keyframes_windows")})


def loop_slice(variant: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke
    if variant != "k4":                  # K4 does not launch in these
        chip_smoke._k4_check = lambda *a: None
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        chip_smoke.phase_loop_slice()
    for line in text.getvalue().splitlines():
        if line.startswith('{"phase": "4 loop_slice"'):
            r = json.loads(line)
            return dict(keyframes=len(r["kf_ids"]), loops=r["loops"],
                        loop_pairs=r["loop_pairs"],
                        ate_odometry_mm=r["ate_odometry_mm"],
                        ate_loop_mm=r["ate_loop_mm"])
    raise RuntimeError("the loop slice printed no result line")


def one(args) -> int:
    from ldso_tpu_torch.examples import time_modes
    from ldso_tpu_torch.ops import cuda_kernels
    cuda_kernels.build()
    swap_trace(args.one, args.parent_immature)
    out = dict(variant=args.one, gpu=time_modes.gpu_facts())
    with time_modes.counted_traces() as traces:
        cuda_kernels.reset_launch_counts()
        out["modes"] = modes(args.n_async)
        out["bench"] = bench_legs()
        if args.loop:
            out["loop"] = loop_slice(args.one)
        out.update(k4_launches=cuda_kernels.LAUNCHES["trace"],
                   traces=traces["traces"])
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", choices=VARIANTS,
                    help="default: all three, in this order")
    ap.add_argument("--parent-immature", default=None,
                    help="the immature.py of the checkout whose plain "
                    "trace the parent variant runs")
    ap.add_argument("--async", dest="n_async", type=int, default=2,
                    help="async runs of time_modes per variant")
    ap.add_argument("--loop", action="store_true",
                    help="also run chip_smoke's loop slice (phase 4)")
    ap.add_argument("--one", choices=VARIANTS, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return one(args)
    args.variants = args.variants or list(VARIANTS)
    if "parent" in args.variants and not args.parent_immature:
        ap.error("the parent variant needs --parent-immature")
    rc = 0
    for v in args.variants:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", v,
               "--async", str(args.n_async)]
        if args.parent_immature:
            cmd += ["--parent-immature",
                    os.path.abspath(args.parent_immature)]
        if args.loop:
            cmd.append("--loop")
        rc |= subprocess.run(cmd, cwd=ROOT).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
