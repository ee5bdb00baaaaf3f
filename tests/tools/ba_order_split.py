"""Which part of K6 and K7 moves the port's runs: their order of sums or
their speed.

    git archive <parent> | tar -x -C build/parent
    PYTHONPATH=$PWD python tests/tools/ba_order_split.py \\
        --parent-root build/parent --loop kernels plain parent

For each variant named, in that order and each in a process of its own,
the windowed BA's linearization and accumulation (what
`backend/ba.linearize_all`, `linearize_target`, `_accumulate_top` and
`_accumulate_sc` run, in the device LM's graph, the host LM and the point
marginalization's graph) are
  kernels  the wrappers, as the system runs them (K6 and K7 on the card);
  plain    the plain versions on the card (`ba.linearize_ref`,
           `_accumulate_top_ref`, `_sc_sums_ref`): K6's bits (its plain
           version is written in its order) and the einsums' order of K7's
           sums, at the plain versions' speed;
  parent   the four functions of another checkout's `backend/ba.py`
           (--parent-root), in that checkout's order (its residual core
           and energy sum too), at the plain speed;
everything else being this checkout's. The process runs
  * `time_modes.run_mode` in strict, lookahead and async (async --async
    times) on the 64-frame bench scene (phase 3's run is strict's);
  * the bench's legs warmup, lookahead, strict and async
    (`examples/bench.py`, its defaults), with its ATE before the async leg
    and after it;
  * with --loop, `chip_smoke.phase_loop_slice`: loop closing on the
    150-frame revisit scene (phase 4).
Each process prints one JSON line: per mode the keyframes, the ATE and the
wall ms per frame; the bench's fps, async's keyframes per window and both
ATEs; the loop slice's keyframes, loops and ATEs; K6's and K7's launches;
the card's name and power limit. K7's order of sums shows where kernels
and plain differ and plain and parent agree; K6's order where plain and
parent differ; the speed where plain differs from kernels at the same
order of K6. Needs the card.
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

VARIANTS = ("kernels", "plain", "parent")
_SWAPPED = ("linearize_all", "linearize_target", "_accumulate_top",
            "_accumulate_sc")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def swap_ba(variant: str, parent_root: str | None) -> None:
    """Put the variant's linearization and accumulation where the BA and
    the marginalization find them."""
    from ldso_tpu_torch.backend import ba
    from ldso_tpu_torch.ops import cuda_kernels
    if variant == "plain":
        cuda_kernels.ba_linearize = \
            lambda W, dIs, pc, cfg, w, h, tgt=None: ba.linearize_ref(
                W, dIs, pc, cfg, w, h, tgt)
        cuda_kernels.ba_accumulate_top = ba._accumulate_top_ref
        cuda_kernels.ba_accumulate_sc = ba._sc_sums_ref
    elif variant == "parent":
        pba = _load(os.path.join(parent_root, "ldso_tpu_torch", "backend",
                                 "ba.py"), "parent_ba")
        for name in _SWAPPED:
            setattr(ba, name, getattr(pba, name))


def modes(n_async: int) -> list:
    from ldso_tpu_torch.examples import time_modes
    calib, poses, images = time_modes.bench_frames(64)
    time_modes.run_mode("strict", calib, poses, images[:16])    # warm-up
    out = []
    for mode in ("strict", "lookahead") + ("async",) * n_async:
        run, _ = time_modes.run_mode(mode, calib, poses, images)
        out.append({k: run[k] for k in (
            "mode", "keyframes", "kf_ids", "ate_mm", "ms_per_frame_wall",
            "k6_launches", "k7_launches", "ba_plain_calls")})
    return out


def loop_slice(variant: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke
    if variant != "kernels":             # K6 and K7 do not launch in these
        chip_smoke._k67_run_check = lambda *a, **k: None
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
    swap_ba(args.one, args.parent_root)
    out = dict(variant=args.one, gpu=time_modes.gpu_facts())
    cuda_kernels.reset_launch_counts()
    out["modes"] = modes(args.n_async)
    out["bench"] = tos.bench_legs()
    if args.loop:
        out["loop"] = loop_slice(args.one)
    out.update(k6_launches=cuda_kernels.LAUNCHES["ba_linearize"],
               k7_launches=cuda_kernels.LAUNCHES["ba_accumulate"])
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", choices=VARIANTS,
                    help="default: all three, in this order")
    ap.add_argument("--parent-root", default=None,
                    help="the checkout whose BA functions the parent "
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
