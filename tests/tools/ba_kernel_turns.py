"""K6's and K7's times on the card, and the device LM's, for the checkout
it is run from.

    PYTHONPATH=$PWD python tests/tools/ba_kernel_turns.py --label change

Builds the checkout's kernels (ldso_tpu_torch/ops/cuda_kernels), makes the
main path's BA window (8 frames in 8 slots, 2,048 points, 640x480;
tests/torch_kernel_checks.ba_scene, chip_smoke.phase_ba_kernels's seed)
and prints one JSON line: K6's device us per launch on the whole window
and on its newest column, and K7's per call for build_system's three
(top modes 0 and 1, the Schur part) and their mean, each from 20 calls
captured in one CUDA graph (chip_smoke._graph_device_ms); then it runs
the 64 strict frames of chip_smoke.py's phase 3
(time_modes.run_mode("strict")), records their BA calls and gives 3d's
device ms per 6-trip BA call (the last call's graph replayed behind a
sleep, chip_smoke._queued_device_ms) and 7e's per vmapped batch of its
last 8 calls (chip_smoke.phase_batched_ba); and the card's name and power
limit. With --kernels-only it stops after K6's and K7's times. The
helpers, the window and the frames come from the checkout's
own chip_smoke.py and tests/, so the script times a parent commit too:
unpack it (`git archive`) into a directory of the repo, and run this file
with the parent as the current directory and on PYTHONPATH. Compare two
versions only in one call, in turns (parent, change, change, parent).
Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--kernels-only", action="store_true",
                    help="K6's and K7's times alone, without phase 3")
    args = ap.parse_args()
    root = os.getcwd()
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch
    import chip_smoke as cs
    import torch_kernel_checks as kc
    from ldso_tpu_torch.backend import energy_functional as efm
    from ldso_tpu_torch.examples import time_modes
    from ldso_tpu_torch.ops import cuda_kernels
    if not torch.cuda.is_available():
        print("ba_kernel_turns: needs a CUDA card", file=sys.stderr)
        return 1
    cuda_kernels.build()
    scene = kc.ba_scene(kc.BA_SLOTS, kc.BA_SLOTS, kc.BA_POINTS, 640, 480,
                        seed=3, device="cuda")
    W, dIs, cfg, _ = kc.lin_cases(scene)["window"]
    w, h = scene["w"], scene["h"]
    k6 = cs._graph_device_ms(cs._lin_call(W, dIs, cfg, w, h, None))
    k6_column = cs._graph_device_ms(
        cs._lin_call(W, dIs, cfg, w, h, kc.BA_SLOTS - 1))
    Wl = scene["W_lin"]
    cases = kc.acc_cases(Wl)
    k7 = {name: cs._graph_device_ms(
        lambda c=cases[name]: kc.kernel_acc(c[0], Wl, c[1]))
        for name in ("top mode 0", "top mode 1", "sc build")}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    line = dict(label=args.label, k6_us=k6 * 1e3,
                k6_column_us=k6_column * 1e3,
                k7_us={k: v * 1e3 for k, v in k7.items()},
                k7_mean_us=sum(k7.values()) / len(k7) * 1e3,
                gpu=smi.stdout.strip())
    if args.kernels_only:
        print(json.dumps(line), flush=True)
        return 0
    calib, poses, images = time_modes.bench_frames(cs.N_FRAMES)
    with cs.recorded_ba() as records:
        strict, _ = time_modes.run_mode("strict", calib, poses, images)
    last = cs._ba_calls(records)[-1]
    ba_ms = cs._queued_device_ms(lambda: efm.replay_ba(*last), n=5, reps=5)
    batched = cs.phase_batched_ba(records)
    line.update(ba_trips=last[-1], ba_device_ms=ba_ms,
                batched_ba_device_ms=batched["device_ms"],
                phase3_ate_mm=strict["ate_mm"], keyframes=strict["keyframes"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
