"""Where unpaced async's wall time goes, on the card, with the device LM as
it runs and with two controls in its place.

    PYTHONPATH=$PWD python tests/tools/async_split.py [--reps 2]
        [--variants graph ...]

Renders phase 3's 64 frames (`time_modes.bench_frames`, 640x480), warms up
each variant below with 16 frames of strict, then runs
`time_modes.run_mode("async", ...)` unpaced, in turns, with each BA variant
the checkout has:
  * `graph`: `EnergyFunctional.optimize` as it runs, one CUDA graph replay
    per call (`energy_functional.replay_ba`);
  * `eager`: `ba_device.optimize_device` called op by op in its place (the
    same masked trips, no graph);
  * `early_exit`: the device LM before it became one device program
    (tests/torch_ba_parent.early_exit_optimize): a host read of the break
    test after each trip, stopping early, an SVD per trip from the third.
A checkout without `replay_ba` (a parent's, run from an unpacked `git
archive` with PYTHONPATH set there) runs only its own BA, as `as_is`.

Prints one JSON line per run: run_mode's record; `boot_ms`, from the first
frame to the end of the one that initialised the system (the initializer
and the first keyframe's BA, on the caller's thread); `after_ms_per_frame`,
the wall time from there to the end of the drain over the frames after it;
the tracking thread's host ms per `add_active_frame` after the boot
(median, mean); every stage timer's host ms by thread (sum, median, n,
and the calls themselves for `initialize`); and per BA call the window's
frames, its host ms (the call ends with the read of its stats, so it waits
for the card) and the ms between CUDA events recorded around it on the
calling thread's stream (`stream_ms`: the call's span on that stream,
queueing behind earlier work and sharing the card with the other stream
included). Needs the card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import threading
import time

import numpy as np
import torch


def _stats(ms):
    return dict(sum=float(np.sum(ms)), median=float(np.median(ms)),
                mean=float(np.mean(ms)), n=len(ms))


@contextlib.contextmanager
def _swapped(owner, name, new):
    old = getattr(owner, name)
    setattr(owner, name, new(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def _variants():
    """The BA variants this checkout runs: name -> the function to put in
    place of energy_functional.replay_ba (None: as it is)."""
    from ldso_tpu_torch.backend import ba_device, energy_functional
    if not hasattr(energy_functional, "replay_ba"):
        return {"as_is": None}
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    from torch_ba_parent import early_exit_optimize

    def early_exit(W, dIs, HM, bM, newest, cfg, img_w, img_h, trips):
        W, stats, _ = early_exit_optimize(W, dIs, HM, bM, int(newest), cfg,
                                          img_w, img_h, trips)
        return W, stats
    return {"graph": None, "eager": ba_device.optimize_device,
            "early_exit": early_exit}


@contextlib.contextmanager
def instrumented(variant):
    """Inside: the BA variant in place, and the run's samples (stage ms by
    thread, BA calls, the async pipeline's frame ends) gathered into the
    yielded dict."""
    from ldso_tpu_torch.backend import energy_functional
    from ldso_tpu_torch.system.pipeline import AsyncPipeline
    from ldso_tpu_torch.utils import timing
    out = dict(stages=collections.defaultdict(list), ba=[], frames=[],
               drained=None)

    def stage(orig):
        @contextlib.contextmanager
        def sampled(self, name):
            t = time.perf_counter()
            with orig(self, name):
                yield
            out["stages"][(threading.current_thread().name, name)].append(
                (time.perf_counter() - t) * 1e3)
        return sampled

    def optimize(orig):
        def timed(self, *a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            nf = self.n_frames
            t = time.perf_counter()
            e0.record()
            r = orig(self, *a, **k)
            e1.record()
            out["ba"].append(dict(frames=nf, host_ms=(time.perf_counter()
                                                      - t) * 1e3,
                                  events=(e0, e1)))
            return r
        return timed

    def add_frame(orig):
        def timed(self, *a, **k):
            t = time.perf_counter()
            r = orig(self, *a, **k)
            out["frames"].append((t, time.perf_counter(),
                                  self.fs.initialized))
            return r
        return timed

    def drain(orig):
        def timed(self):
            r = orig(self)
            out["drained"] = time.perf_counter()
            return r
        return timed
    with contextlib.ExitStack() as stack:
        stack.enter_context(_swapped(timing.StageTimer, "stage", stage))
        stack.enter_context(_swapped(energy_functional.EnergyFunctional,
                                     "optimize", optimize))
        stack.enter_context(_swapped(AsyncPipeline, "add_active_frame",
                                     add_frame))
        stack.enter_context(_swapped(AsyncPipeline,
                                     "block_until_mapping_is_finished", drain))
        if variant is not None:
            stack.enter_context(_swapped(energy_functional, "replay_ba",
                                         lambda _: variant))
        yield out


def summary(out) -> dict:
    """The samples of one run as JSON."""
    torch.cuda.synchronize()
    frames = out["frames"]
    boot = next(i for i, f in enumerate(frames) if f[2])
    boot_end = frames[boot][1]
    after = frames[boot + 1:]
    host_ms = [(b - a) * 1e3 for a, b, _ in after]
    stages = {}
    for (thread, name), ms in sorted(out["stages"].items()):
        stages.setdefault(thread, {})[name] = _stats(ms)
        if name == "initialize":
            stages[thread][name]["calls"] = ms
    return dict(
        boot_ms=(boot_end - frames[0][0]) * 1e3,
        after_ms_per_frame=(out["drained"] - boot_end) * 1e3
        / max(len(after), 1),
        after_frames=len(after),
        track_host_ms_after=dict(median=float(np.median(host_ms)),
                                 mean=float(np.mean(host_ms))),
        stages=stages,
        ba_calls=[dict(frames=c["frames"], host_ms=c["host_ms"],
                       stream_ms=c["events"][0].elapsed_time(c["events"][1]))
                  for c in out["ba"]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--variants", nargs="*", default=None,
                    help="the BA variants to run, of those the checkout "
                    "has (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("async_split: needs the card", file=sys.stderr)
        return 1
    from ldso_tpu_torch.examples import time_modes
    from ldso_tpu_torch.ops import cuda_kernels
    gpu = time_modes.gpu_facts()
    calib, poses, images = time_modes.bench_frames(64)
    cuda_kernels.build()
    variants = _variants()
    if args.variants:
        variants = {k: v for k, v in variants.items()
                    if k in args.variants} or {k: v for k, v in
                                               variants.items()
                                               if k == "as_is"}
    for variant in variants.values():         # warm-up: each BA once
        with instrumented(variant):
            time_modes.run_mode("strict", calib, poses, images[:16], gpu)
    order = list(variants)
    for r in range(args.reps):
        for name in (order if r % 2 == 0 else order[::-1]):
            with instrumented(variants[name]) as out:
                run, _ = time_modes.run_mode("async", calib, poses, images,
                                             gpu)
            print(json.dumps(dict(variant=name, rep=r, **summary(out),
                                  run=run)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
