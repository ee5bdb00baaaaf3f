"""Where a frame's and a keyframe's time goes, per stage, on the card.

    PYTHONPATH=$PWD python tests/tools/stage_medians.py

Runs `chip_smoke.py`'s phase 3 (strict, loop closing off, 64 frames of the
bench scene) and phase 4 (loop closing on, the 150-frame revisit scene),
imported from the current directory, so that the same script times the
checkout it is run from (a parent commit's too: run it from an unpacked
`git archive` with PYTHONPATH set there). Prints one JSON line per phase:
  * `stages`: every `fs.timer` stage's median, mean and count of host ms
    per call (the StageTimer's calls, sampled one by one);
  * `track_split` (phase 3): strict's frame step (`_frame_step`) cut into
    its parts, each with its host ms per call and its device ms per call
    from CUDA events around it: where the step is one captured program
    (FRAME_STEP_GRAPHS), its dispatch (the upload and the replay,
    `_frame_step_dispatch`, whose events span the replay's device time);
    in an older checkout the eager pyramid, the tracker (a graph replay)
    and the candidate trace it queues. The rest of the frame step is
    `read_gate_and_trace` (the one read of the result, which waits for the
    card; in an older checkout the host gate and the trace's set-up too);
  * `activate_split` (phase 3): `kf.activate` cut into the host tables
    and their one upload (`_activation_upload`; `_activation_tables` in a
    checkout that runs the pass eagerly) and the pass: one replay of the
    activation's graph (`replay`), or in an eager checkout the occupancy
    splat and K1 (`_occupancy`, `distance_transform`), K5
    (`activate_arena`) and the insertion (`insert_points_dev`); each with
    its host ms per call and its device ms per call from CUDA events
    around it, and the rest (the density policy, the replay's results, the
    pull's queueing, in an eager checkout the slot allocation and the
    arena's mask); none for a checkout without these functions;
  * phase 3's keyframe ids, ATE and the SHA-256 of every frame's pose
    (`poses_sha256`), so that two checkouts' runs compare bitwise;
  * `keyframe_split` (phases 3 and 4): each keyframe's host ms in its
    two halves, `make_keyframe_dispatch` (from the trace through the new
    candidates) and its `finish()` (the reads of the device results, the
    host mirrors, the frame marginalization, loop closing), and their
    sum; the same wrappers time a parent checkout;
  * `loop_split` (phase 4): `kf.loop` cut into ORB features, BoW
    (vocabulary transform, database query and insert), matching, the
    RANSAC solvers, `refine_sim3` and the pose graph, host ms per
    keyframe (mean over the keyframes, each piece timed with a device
    synchronise on both sides, so that its device work is its own).
Needs the card.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch


def _stats(ms):
    return dict(median=float(np.median(ms)), mean=float(np.mean(ms)),
                n=len(ms)) if ms else dict(median=None, mean=None, n=0)


@contextlib.contextmanager
def stage_samples():
    """Every StageTimer.stage call's host ms inside, by stage name."""
    from ldso_tpu_torch.utils import timing
    samples = collections.defaultdict(list)
    stage = timing.StageTimer.stage

    @contextlib.contextmanager
    def sampled(self, name):
        t = time.perf_counter()
        with stage(self, name):
            yield
        samples[name].append((time.perf_counter() - t) * 1e3)
    timing.StageTimer.stage = sampled
    try:
        yield samples
    finally:
        timing.StageTimer.stage = stage


@contextlib.contextmanager
def _patched(owner, name, wrap):
    fn = getattr(owner, name)
    setattr(owner, name, wrap(fn))
    try:
        yield
    finally:
        setattr(owner, name, fn)


@contextlib.contextmanager
def track_split():
    """strict's frame step in parts: host ms and CUDA-event device ms of
    its dispatch (one replay of the frame step's graph), or in an older
    checkout of the pyramid, the tracker and the trace; the read of the
    result is the rest of `_frame_step`'s host time."""
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.system import full_system
    host = collections.defaultdict(list)
    events = collections.defaultdict(list)
    inside = []          # the parts timed so far in the current _frame_step

    def timed(part):
        def wrap(fn):
            def call(*a, **k):
                outer = part == "frame_step"
                if not (outer or inside):
                    return fn(*a, **k)      # not on the tracking path
                if outer:
                    inside.append(True)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t = time.perf_counter()
                e0.record()
                try:
                    out = fn(*a, **k)
                finally:
                    if outer:
                        inside.clear()
                e1.record()
                host[part].append((time.perf_counter() - t) * 1e3)
                events[part].append((e0, e1))
                return out
            return call
        return wrap
    fs_cls = full_system.FullSystem
    if hasattr(fs_cls, "_frame_step_dispatch"):
        parts = ((fs_cls, "_frame_step_dispatch", "dispatch"),)
    else:
        parts = ((full_system, "make_pyramid", "pyramid"),
                 (tracker, "track_frame", "tracker"),
                 (fs_cls, "_trace_arena", "trace"))
    with contextlib.ExitStack() as stack:
        for owner, name, part in parts:
            stack.enter_context(_patched(owner, name, timed(part)))
        stack.enter_context(_patched(fs_cls, "_frame_step",
                                     timed("frame_step")))
        out = {}
        yield out
    torch.cuda.synchronize()
    for part, ms in host.items():
        dev = [a.elapsed_time(b) for a, b in events[part]]
        out[part] = dict(host=_stats(ms), device=_stats(dev))
    # what _frame_step spends besides the parts before the read: the
    # result's read (which waits for the card) and, in an older checkout,
    # the host gate and the trace's set-up and queueing when it runs
    n = len(host["frame_step"])
    timed_parts = [p for _, _, p in parts if p != "trace"]
    rest = [host["frame_step"][i] - sum(host[p][i] for p in timed_parts)
            for i in range(n)]
    out["read_gate_and_trace"] = dict(host=_stats(rest))


@contextlib.contextmanager
def activate_split():
    """`kf.activate` in parts: host ms and CUDA-event device ms of the
    tables and upload, the splat and K1, K5 and the insert, per
    FullSystem._activate_points call that ran the pass (one that found no
    candidates returns at once and is left out); the rest is its host
    time less theirs. Yields {} for a checkout without the one-pass
    activation."""
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.system import full_system
    out = {}
    captured = hasattr(full_system, "ACTIVATE_GRAPHS")
    if not (captured or hasattr(full_system.FullSystem,
                                "_activation_tables")):
        yield out
        return
    # the part each pass that ran has: the replay, or K5 in an eager pass
    marker = "replay" if captured else "k5"
    calls = []           # per pass: {part: [(host ms, (e0, e1)), ...]}
    current = []         # the pass being timed

    def timed(part):
        def wrap(fn):
            def call(*a, **k):
                outer = part == "activate"
                if not (outer or current) or (
                        part == "replay"
                        and a[0] is not full_system.ACTIVATE_GRAPHS):
                    return fn(*a, **k)
                if outer:
                    current.append({})
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t = time.perf_counter()
                e0.record()
                try:
                    res = fn(*a, **k)
                finally:
                    e1.record()
                    ms = (time.perf_counter() - t) * 1e3
                    parts = current[-1]
                    parts.setdefault(part, []).append((ms, (e0, e1)))
                    if outer:
                        current.clear()
                        if marker in parts:
                            calls.append(parts)
                return res
            return call
        return wrap
    if captured:
        patches = ((full_system.FullSystem, "_activate_points", "activate"),
                   (full_system.FullSystem, "_activation_upload", "tables"),
                   (full_system, "_program", "replay"))
    else:
        patches = ((full_system.FullSystem, "_activate_points", "activate"),
                   (full_system.FullSystem, "_activation_tables", "tables"),
                   (full_system, "_occupancy", "splat_k1"),
                   (cuda_kernels, "distance_transform", "splat_k1"),
                   (cuda_kernels, "activate_arena", "k5"),
                   (full_system, "insert_points_dev", "insert"))
    with contextlib.ExitStack() as stack:
        for owner, name, part in patches:
            stack.enter_context(_patched(owner, name, timed(part)))
        yield out
    torch.cuda.synchronize()
    host, dev = collections.defaultdict(list), collections.defaultdict(list)
    for parts in calls:
        for part, samples in parts.items():
            host[part].append(sum(ms for ms, _ in samples))
            dev[part].append(sum(a.elapsed_time(b) for _, (a, b) in samples))
        host["rest"].append(host["activate"][-1] - sum(
            host[p][-1] for p in parts if p != "activate"))
    for part in host:
        out[part] = dict(host=_stats(host[part]))
        if part in dev:
            out[part]["device"] = _stats(dev[part])


@contextlib.contextmanager
def keyframe_split():
    """Host ms of each keyframe's dispatch (FullSystem.make_keyframe_
    dispatch) and of its finish() closure, and their sum per keyframe."""
    from ldso_tpu_torch.system import full_system
    out = {}
    dispatch, finish = [], []

    def wrap(fn):
        def call(*a, **k):
            t = time.perf_counter()
            fin = fn(*a, **k)
            dispatch.append((time.perf_counter() - t) * 1e3)

            def timed():
                t = time.perf_counter()
                fin()
                finish.append((time.perf_counter() - t) * 1e3)
            timed.ready = fin.ready
            return timed
        return call
    with _patched(full_system.FullSystem, "make_keyframe_dispatch", wrap):
        yield out
    out.update(dispatch=_stats(dispatch), finish=_stats(finish),
               sum=_stats([a + b for a, b in zip(dispatch, finish)]))


@contextlib.contextmanager
def loop_split():
    """kf.loop in parts, each synchronised on both sides: host ms summed
    per part over the run, and the keyframes it ran on."""
    from ldso_tpu_torch.loop import loopclosing, matcher, posegraph
    from ldso_tpu_torch.loop.database import KeyframeDatabase
    from ldso_tpu_torch.loop.vocab import Vocabulary
    total = collections.defaultdict(float)

    def timed(part):
        def wrap(fn):
            def call(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                total[part] += (time.perf_counter() - t) * 1e3
                return out
            return call
        return wrap
    parts = ((loopclosing.detector, "detect_corners", "orb"),
             (Vocabulary, "transform", "bow"), (Vocabulary, "bow_vector", "bow"),
             (Vocabulary, "node_ids", "bow"),
             (KeyframeDatabase, "query", "bow"), (KeyframeDatabase, "add", "bow"),
             (matcher, "search_by_bow", "matching"),
             (matcher, "search_by_projection", "matching"),
             (loopclosing, "pnp_ransac", "ransac"),
             (loopclosing, "umeyama_ransac", "ransac"),
             (loopclosing, "refine_sim3", "refine_sim3"),
             (posegraph, "run_pose_graph", "pgo"))
    with contextlib.ExitStack() as stack:
        for owner, name, part in parts:
            if hasattr(owner, name):
                stack.enter_context(_patched(owner, name, timed(part)))
        yield total


def main() -> int:
    if not torch.cuda.is_available():
        print("stage_medians: needs the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    chip_smoke.phase_device()
    with stage_samples() as samples, track_split() as split, \
            activate_split() as act, keyframe_split() as kf:
        out = chip_smoke.phase_main_path()
    strict, fs = out[4], out[5]
    print(json.dumps(dict(
        phase="3 strict", stages={k: _stats(v) for k, v in
                                  sorted(samples.items())},
        track_split=split, activate_split=act, keyframe_split=kf,
        kf_ids=strict["kf_ids"], ate_mm=strict["ate_mm"],
        poses_sha256=hashlib.sha256(b"".join(
            f.T_cw.tobytes() for f in fs.all_frames)).hexdigest())),
        flush=True)
    del out, fs
    with stage_samples() as samples, loop_split() as parts, \
            keyframe_split() as kf:
        chip_smoke.phase_loop_slice()
    n_loop = len(samples.get("kf.loop", ()))
    print(json.dumps(dict(
        phase="4 loop_slice", stages={k: _stats(v) for k, v in
                                      sorted(samples.items())},
        keyframe_split=kf,
        loop_split_ms_per_keyframe={k: v / max(n_loop, 1)
                                    for k, v in parts.items()},
        loop_keyframes=n_loop)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
