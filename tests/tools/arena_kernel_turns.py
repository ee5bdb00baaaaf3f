"""K4's and K5's times on the card, for the checkout it is run from.

    PYTHONPATH=$PWD python tests/tools/arena_kernel_turns.py --label change

Builds the checkout's kernels (ldso_tpu_torch/ops/cuda_kernels) and prints
one JSON line:
  * K4's device us per launch (20 launches captured in one CUDA graph,
    chip_smoke._graph_device_ms) on the bench scene's arena of 4,096 live
    lanes at 640x480 (tests/torch_kernel_checks.trace_scene: its first,
    uninitialised trace in the default search against bench frame
    TRACE_TARGETS[0]) and on phase 3's last arena;
  * K5's on the bench scene's activation against a window of 8 frames
    (activate_scene, activate_inputs) and on phase 3's last activation;
  * the live and working lanes of each shape, and the lanes where the
    kernel's output is not bitwise its plain version's on the card;
  * each source's registers per kernel from ptxas
    (cuda_kernels.ptxas_report);
  * phase 3's keyframes and ATE, and the card's name and power limit.
Phase 3 is chip_smoke.py's 64 strict frames (time_modes.run_mode("strict")),
its traces and activations recorded as they ran
(chip_smoke.recorded_traces, recorded_activations). With --kernels-only
the script skips phase 3 (the bench scene's shapes alone); with --loop it
also runs phase 4 (chip_smoke.phase_loop_slice, the revisit scene with
loop closing) and gives its loops.

The helpers, scenes and frames come from the checkout's own chip_smoke.py
and tests/, so the script times a parent commit too: unpack it (`git
archive`) into a directory of the repo, and run this file with the parent
as the current directory and on PYTHONPATH. Compare two versions only in
one call, in turns (parent, change, change, parent). Needs the card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys

SOURCES = ("immature_trace.cu", "immature_activate.cu")


def registers(report: str) -> dict:
    """{kernel: registers} of every entry function in a ptxas report."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # the kernel's name and template argument in the mangled one
            short = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E)?", m[1])
            name = (short[1] + (f"<{short[2]}>" if short[2] else "")
                    if short else m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = int(m[1])
            name = None
    return out


def _not_bitwise(got, want) -> int:
    """Lanes where any of the outputs differ in their bits."""
    import torch
    same = None
    for g, w in zip(got, want):
        eq = (g == w) if g.dtype == torch.bool else (
            g.view(torch.int32) == w.view(torch.int32))
        same = eq if same is None else same & eq
    return int((~same).sum())


def trace_shape(kc, inputs, calib) -> dict:
    """K4 on one trace's inputs (arena, dI, KRKis, Kts, affs, cfg): a
    launcher, the live and searched lanes and the lanes not bitwise."""
    from ldso_tpu_torch.ops import cuda_kernels
    arena, dI, KRKis, Kts, affs, cfg = inputs

    def launch():
        return cuda_kernels.trace_arena(arena, dI, KRKis, Kts, affs, calib,
                                        cfg)
    want, parts = kc.plain_trace(arena, dI, KRKis, Kts, affs, calib, cfg)
    fields = cuda_kernels.TRACE_OUTPUTS
    got = launch()
    return dict(launch=launch, live=int(parts["active"].sum()),
                working=int(parts["do_search"].sum()),
                not_bitwise=_not_bitwise(
                    [getattr(got.pool, f) for f in fields],
                    [getattr(want.pool, f) for f in fields]))


def activate_shape(kc, inputs, calib) -> dict:
    """K5 on one activation's inputs (activate_inputs's tuple): a launcher,
    the live and optimised lanes and the lanes not bitwise."""
    from ldso_tpu_torch.ops import cuda_kernels

    def launch():
        return cuda_kernels.activate_arena(*inputs[:13], calib, inputs[13])
    want, parts = kc.plain_activate(inputs, calib)
    return dict(launch=launch, live=int(parts["live"].sum()),
                working=int(parts["to_opt"].sum()),
                not_bitwise=_not_bitwise(launch(), want))


def shapes(cs, kc, phase3: bool):
    """{name: trace_shape's or activate_shape's dict} at the shapes the
    script times, and phase 3's run (None without it)."""
    from ldso_tpu_torch.examples import time_modes
    out, strict = {}, None
    scene = kc.trace_scene(640, 480, "cuda")
    t0 = kc.TRACE_TARGETS[0]
    out["k4 bench_4096"] = trace_shape(
        kc, (scene["arena"], scene["pyrs"][t0].dI[0],
                 *kc.trace_inputs(scene, t0), scene["cfg"]), scene["calib"])
    act = kc.activate_scene(640, 480, "cuda")
    out["k5 window_8"] = activate_shape(
        kc, kc.activate_inputs(act, kc.TRACE_SLOTS), act["calib"])
    if phase3:
        calib, poses, images = time_modes.bench_frames(cs.N_FRAMES)
        with cs.recorded_traces() as traces, \
                cs.recorded_activations() as acts:
            strict, _ = time_modes.run_mode("strict", calib, poses, images)
        inputs, calib3, _ = traces[-1]
        out["k4 phase3_last"] = trace_shape(kc, inputs, calib3)
        inputs, calib3, _ = acts[-1]
        out["k5 phase3_last"] = activate_shape(kc, inputs, calib3)
    return out, strict


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--kernels-only", action="store_true",
                    help="the bench scene's shapes alone, without phase 3")
    ap.add_argument("--loop", action="store_true",
                    help="also run phase 4 and give its loops")
    args = ap.parse_args()
    root = os.getcwd()
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch
    import chip_smoke as cs
    import torch_kernel_checks as kc
    from ldso_tpu_torch.ops import cuda_kernels
    if not torch.cuda.is_available():
        print("arena_kernel_turns: needs a CUDA card", file=sys.stderr)
        return 1
    cuda_kernels.build()
    found, strict = shapes(cs, kc, not args.kernels_only)
    line = dict(label=args.label)
    for name, s in found.items():
        kernel, shape = name.split()
        line.setdefault(f"{kernel}_us", {})[shape] = (
            cs._graph_device_ms(s["launch"]) * 1e3)
        line.setdefault(f"{kernel}_lanes", {})[shape] = [s["live"],
                                                         s["working"]]
        line.setdefault("not_bitwise", {})[name] = s["not_bitwise"]
    line["registers"] = {src: registers(cuda_kernels.ptxas_report(src))
                         for src in SOURCES}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    line["gpu"] = smi.stdout.strip()
    if strict is not None:
        line.update(phase3_ate_mm=strict["ate_mm"],
                    keyframes=strict["keyframes"])
    if args.loop:
        buf = io.StringIO()
        cuda_kernels.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            cs.phase_loop_slice()
        print(buf.getvalue(), end="")
        for text in buf.getvalue().splitlines():
            if text.startswith("{") and '"4 loop_slice"' in text:
                four = json.loads(text)
                line.update(loops=four["loops"],
                            loop_ate_mm=four["ate_loop_mm"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
