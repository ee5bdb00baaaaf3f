"""Which part of the activation moves the port's runs: its order of sums or
its speed.

    git archive <parent> | tar -x -C build/parent
    PYTHONPATH=$PWD python tests/tools/activate_order_split.py \\
        --parent-root build/parent --loop k5 plain parent

For each variant named, in that order and each in a process of its own,
the per-lane function of the keyframe's activation pass
(`cuda_kernels.activate_arena`, which FullSystem's `_activate_fused`
calls) is one of
  k5      the wrapper, as the system runs it (K5 on the card);
  plain   `immature.activate_arena_ref`, the plain version in K5's order
          of sums: the same bits as k5 at the plain version's speed;
  parent  the same function from another checkout's plain versions, in
          that checkout's order of sums (its `full_system._gate_candidates`
          and `immature.activate_arena`, with the `sane` and `remove`
          masks as `_activate_fused` applies them), at the plain speed
          (--parent-root);
everything around it (the splat, K1, the insert, the deferred pull) being
this checkout's. The process runs
  * `time_modes.run_mode` in strict, lookahead and async (async --async
    times) on the 64-frame bench scene (phase 3's run is strict's);
  * the bench's legs warmup, lookahead, strict and async
    (`examples/bench.py`, its defaults), with its ATE (`leg_ate`, over the
    frames before the async leg) taken before the async leg and after it;
  * with --loop, `chip_smoke.phase_loop_slice`: loop closing on the
    150-frame revisit scene (phase 4).
Each process prints one JSON line: per mode the keyframes, the ATE and the
wall ms per frame; the bench's fps, async's keyframes per window and both
ATEs; the loop slice's keyframes, loops and ATEs; K5's launches and the
activation passes; the card's name and power limit. The order of sums
shows where k5 and plain agree and parent differs; the speed where plain
and parent agree and k5 differs. Needs the card.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "tests", "tools"))
import trace_order_split as tos  # noqa: E402  (the bench legs)

VARIANTS = ("k5", "plain", "parent")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parent_activation(root: str):
    """The activation's per-lane function from the checkout at `root`, in
    its own order of sums, with activate_arena_ref's signature and
    outputs."""
    import torch
    pkg = os.path.join(root, "ldso_tpu_torch")
    pim = _load(os.path.join(pkg, "frontend", "immature.py"),
                "parent_immature")
    pfs = _load(os.path.join(pkg, "system", "full_system.py"),
                "parent_full_system")

    def activate(arena, dist_map, KRKis, Kts, Rs, ts, affs, masks, dIs,
                 min_act_dist, marg_flags, newest, nf, calib, cfg):
        F = KRKis.shape[0]
        hostc = arena.host
        h = torch.clamp(hostc, 0, F - 1).long()
        pool = arena.pool._replace(valid=arena.pool.valid & (hostc >= 0))
        h1, w1 = dist_map.shape
        to_opt, remove, idm = pfs._gate_candidates(
            pool, KRKis[h], Kts[h], dist_map, float(min_act_dist),
            marg_flags[h], w1, h1, cfg)
        to_opt = to_opt & (hostc >= 0) & (hostc < nf) & (hostc != newest)
        remove = remove & (hostc >= 0) & (hostc < nf)
        act = pim.activate_arena(arena, idm, to_opt, Rs, ts, affs, masks,
                                 dIs, calib, cfg)
        n_good = torch.where(to_opt, act[:, 2], torch.zeros_like(act[:, 2]))
        return (to_opt, remove, torch.where(to_opt, act[:, 0], idm),
                act[:, 1] > 0.5, n_good.to(torch.int32))
    return activate


def swap_activation(variant: str, parent_root: str | None) -> None:
    """Put the variant's per-lane activation where _activate_fused finds
    it."""
    from ldso_tpu_torch.frontend import immature
    from ldso_tpu_torch.ops import cuda_kernels
    if variant == "plain":
        cuda_kernels.activate_arena = immature.activate_arena_ref
    elif variant == "parent":
        cuda_kernels.activate_arena = parent_activation(parent_root)


def modes(n_async: int) -> list:
    from ldso_tpu_torch.examples import time_modes
    calib, poses, images = time_modes.bench_frames(64)
    time_modes.run_mode("strict", calib, poses, images[:16])    # warm-up
    out = []
    for mode in ("strict", "lookahead") + ("async",) * n_async:
        run, _ = time_modes.run_mode(mode, calib, poses, images)
        out.append({k: run[k] for k in (
            "mode", "keyframes", "kf_ids", "ate_mm", "ms_per_frame_wall",
            "k5_launches", "activations")})
    return out


def loop_slice(variant: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke
    if variant != "k5":                  # K5 does not launch in these
        chip_smoke._k5_check = lambda *a: None
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
    swap_activation(args.one, args.parent_root)
    out = dict(variant=args.one, gpu=time_modes.gpu_facts())
    with time_modes.counted_activations() as acts:
        cuda_kernels.reset_launch_counts()
        out["modes"] = modes(args.n_async)
        out["bench"] = tos.bench_legs()
        if args.loop:
            out["loop"] = loop_slice(args.one)
        out.update(k5_launches=cuda_kernels.LAUNCHES["activate"],
                   activations=acts["activations"])
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", choices=VARIANTS,
                    help="default: all three, in this order")
    ap.add_argument("--parent-root", default=None,
                    help="the checkout whose plain activation the parent "
                    "variant runs")
    ap.add_argument("--async", dest="n_async", type=int, default=2,
                    help="async runs of time_modes per variant")
    ap.add_argument("--loop", action="store_true",
                    help="also run chip_smoke's loop slice (phase 4)")
    ap.add_argument("--one", choices=VARIANTS, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return one(args)
    args.variants = args.variants or list(VARIANTS)
    if "parent" in args.variants and not args.parent_root:
        ap.error("the parent variant needs --parent-root")
    rc = 0
    for v in args.variants:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", v,
               "--async", str(args.n_async)]
        if args.parent_root:
            cmd += ["--parent-root", os.path.abspath(args.parent_root)]
        if args.loop:
            cmd.append("--loop")
        rc |= subprocess.run(cmd, cwd=ROOT).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
