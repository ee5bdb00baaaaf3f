"""Which part of the bootstrap's change moves the port's runs: its rounding
or its structure.

    PYTHONPATH=$PWD python tests/tools/init_order_split.py [--loop]
        [graph early_exit early_exit_div]

For each variant named, in that order and each in a process of its own,
the bootstrap's frame (`initializer.track_frame`, which
FullSystem._do_initialize calls) is one of
  graph           as the system runs it: the masked LM, one captured
                  program a frame, one read;
  early_exit      the early-exit loop as it ran before
                  (tests/torch_init_parent.track_frame): a host read a
                  trip, `_do_step` dividing by a Python float, which the
                  card turns into a multiply by its float32 reciprocal;
  early_exit_div  the same loop with `_do_step` dividing by a 0-d tensor,
                  as the masked program does: the program's rounding at
                  the early-exit loop's speed and structure;
everything else being this checkout's. The process runs
`time_modes.run_mode("strict", ...)` on the 64-frame bench scene (phase
3's run) and, with --loop, `chip_smoke.phase_loop_slice` (phase 4: loop
closing on the 150-frame revisit scene). Each prints one JSON line: phase
3's keyframes, ATE, wall ms per frame and host ms per bootstrap call
(`_do_initialize`, each and the median), the loop slice's keyframes,
loops and ATEs, and the card's name and power limit. Where
early_exit_div and graph agree and early_exit differs, the move is the
division's rounding. Needs the card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
VARIANTS = ("graph", "early_exit", "early_exit_div")


def swap_bootstrap(variant: str) -> None:
    """Put the variant's bootstrap frame where FullSystem finds it."""
    import torch
    from ldso_tpu_torch.frontend import initializer
    if variant == "graph":
        return
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_init_parent as parent
    if variant == "early_exit_div":
        step = parent._do_step

        def do_step(L, inc, one_plus_lam):
            return step(L, inc, torch.tensor(one_plus_lam, dtype=inc.dtype,
                                             device=inc.device))
        parent._do_step = do_step
    initializer.track_frame = parent.track_frame


def loop_slice() -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke
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
    import time
    import numpy as np
    from ldso_tpu_torch.examples import time_modes
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.system.full_system import FullSystem
    cuda_kernels.build()
    swap_bootstrap(args.one)
    out = dict(variant=args.one, gpu=time_modes.gpu_facts())
    calib, poses, images = time_modes.bench_frames(64)
    time_modes.run_mode("strict", calib, poses, images[:16])    # warm-up
    init_ms = []
    do_init = FullSystem._do_initialize

    def timed(self, *a, **k):
        t = time.perf_counter()
        do_init(self, *a, **k)
        init_ms.append((time.perf_counter() - t) * 1e3)
    FullSystem._do_initialize = timed
    try:
        run, _ = time_modes.run_mode("strict", calib, poses, images)
    finally:
        FullSystem._do_initialize = do_init
    out["phase3"] = {k: run[k] for k in (
        "keyframes", "kf_ids", "ate_mm", "ms_per_frame_wall")}
    out["phase3"]["initialize_ms"] = init_ms
    out["phase3"]["initialize_ms_median"] = float(np.median(init_ms))
    if args.loop:
        out["loop"] = loop_slice()
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", choices=VARIANTS,
                    help="default: all three, in this order")
    ap.add_argument("--loop", action="store_true",
                    help="also run chip_smoke's loop slice (phase 4)")
    ap.add_argument("--one", choices=VARIANTS, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return one(args)
    rc = 0
    for v in args.variants or VARIANTS:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", v]
        if args.loop:
            cmd.append("--loop")
        rc |= subprocess.run(cmd, cwd=ROOT).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
