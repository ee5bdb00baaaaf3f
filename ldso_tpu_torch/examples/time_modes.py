"""Time the three modes of the port against each other, in one process.

    python -m ldso_tpu_torch.examples.time_modes [--frames 64] [--reps 2]
        [--async-paces PACE ...]

Renders `chip_smoke.py`'s phase-3 scene (the bench trajectory, 640x480
uint8 PlaneScene frames, `Config()` with loop closing off) and drives it
through strict, lookahead and async in turns (strict, lookahead, async,
then the reverse, `--reps` times), so that a drift of the host's speed
during the call falls on every mode alike. Each run prints one JSON line:
the wall clock from the first frame to the end of the drain (with a
synchronise) per frame (`ms_per_frame_wall`), the median host time of one
add_active_frame call from the bootstrap on (`ms_per_frame_median`), the
keyframes, the ATE, K1's launches and the streams they went to, K3's
launches beside the count the run's tracks imply, K4's launches beside
the count the frame steps and FullSystem._trace_arena calls imply and the
traces committed (the frame steps' trace flags and the _trace_arena
calls), K2's pyramid launches beside the count the steps' replays and
the bootstrap's frames imply, K5's launches beside the activation passes
(FullSystem._activation_pass calls), the retrack-gate trips, how many
frames the tracker ran on (a pipeline re-tracks its frames in flight
after each keyframe) and the host time of those calls (on the card a
graph replay that does not wait for the track), the tracker's and the
frame and chain steps' graphs captured inside the run (0: the FullSystem
captures them when it is built) and the steps' replays (one per strict
frame after the bootstrap, one per chain dispatch), K12's launches and
the device LM's graph
replays and captures (one replay per BA call; 0 captures, as the
tracker's), the keyframe's dispatches and its three programs' replays and
captures (the post-BA flags, the tracker reference and the new
candidates: one replay each per dispatch, 0 captures), the activation's
replays and captures (one replay per pass, 0 captures), the bootstrap's
frames, pulls, replays and captures and the frames it captured at (one
replay and one pull per frame; its graph captured at the first frame or
before), the host time of the mapping stages per
frame (`mapping_ms_per_frame`), and the card's name and power limit.
With `--async-paces`, each turn then feeds async one frame per PACE times
its strict run's `ms_per_frame_wall`, for each PACE (async keeps a
keyframe only when its mapping queue is empty, so its keyframes depend on
that rate).
Needs the card; the stage timers of each run go to stderr.

`bench_frames` and `run_mode` are also the driver of `chip_smoke.py`'s
phases 3 and 5.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ldso_tpu_torch.backend import ba
from ldso_tpu_torch.backend.energy_functional import (
    BA_GRAPHS, MARG_GRAPHS, EnergyFunctional)
from ldso_tpu_torch.config import Config
from ldso_tpu_torch.examples.run_common import PIPELINES, make_driver
from ldso_tpu_torch.frontend import initializer, track_graph, tracker
from ldso_tpu_torch.io.trajectory import ate_rmse
from ldso_tpu_torch.math import lie_np
from ldso_tpu_torch.ops import cuda_kernels
from ldso_tpu_torch.synthetic import PlaneScene, default_calib
from ldso_tpu_torch.system import full_system as fsm
from ldso_tpu_torch.system.full_system import FullSystem
from ldso_tpu_torch.utils.device import DEFAULT_DEVICE


# the stage timers of the mapping side: strict's, and a pipeline's mapping
# thread's
MAPPING_STAGES = ("keyframe", "non_keyframe", "pipe.map_kf", "pipe.map_nonkf",
                  "pipe.map_kf_finish")


def gpu_facts() -> dict:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    name, limit = (x.strip() for x in out[0].split(",", 1))
    return dict(name=name, power_limit=limit)


def bench_pose(i: int, seq: int = 0) -> np.ndarray:
    """The camera-from-world pose of frame i of the bench trajectory
    (bench.py:135-140); seq > 0 gives sequence `seq` of its aggregate leg,
    whose sine and yaw rate are shifted by it (bench.py:511-514)."""
    t = np.array([0.03 * i, 0.01 * np.sin(0.2 * i + seq), 0.004 * i])
    w = np.array([0.0, 0.0018 * i, 0.0004 * i + 0.0002 * seq])
    return np.linalg.inv(lie_np.se3_exp(np.concatenate([t, w])))


def bench_frames(n: int, w: int = 640, h: int = 480, device="cuda",
                 seq: int = 0):
    """The bench trajectory (`bench_pose`, sequence `seq`) over
    PlaneScene(freq_hi=25, contrast=80), rendered on `device` and returned
    as uint8 numpy frames with the camera-from-world poses: (calib, poses,
    images)."""
    calib = default_calib(w, h)
    scene = PlaneScene(freq_hi=25.0, contrast=80.0)
    poses, images = [], []
    for i in range(n):
        T = bench_pose(i, seq)
        img, _ = scene.render(calib, T, device=device)
        poses.append(T)
        images.append(torch.clamp(torch.round(img), 0, 255)
                      .to(torch.uint8).cpu().numpy())
    return calib, poses, images


@contextlib.contextmanager
def traced_k1():
    """Count K1's launches by (thread name, CUDA stream handle) while
    inside. On the card K1 runs only inside the activation's graph, one
    launch per activation pass (FullSystem._activation_pass, one replay
    on the caller's stream), so each pass on the card counts once for its
    thread and stream; the eager launches of a graph's capture are not the
    run's. The launch counts themselves stay the graphs'."""
    seen = collections.Counter()
    act = FullSystem._activation_pass

    def traced_pass(self, *a, **k):
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device).cuda_stream
            seen[(threading.current_thread().name, stream)] += 1
        return act(self, *a, **k)
    FullSystem._activation_pass = traced_pass
    try:
        yield seen
    finally:
        FullSystem._activation_pass = act


# the frame step's and the chain step's captured programs by the name
# run_mode reports them under
STEP_FAMILIES = dict(frame_step=fsm.FRAME_STEP_GRAPHS,
                     chain_step=fsm.CHAIN_STEP_GRAPHS)


def _step_counts(key: str) -> int:
    return sum(f.counts[key] for f in STEP_FAMILIES.values())


@contextlib.contextmanager
def counted_tracks():
    """Count the tracks while inside and yield the counts: tracks (the
    frame and chain steps, FullSystem._frame_step_dispatch and _chain_step,
    each with hypothesis 0's track in its program, and the tracker's
    entry calls track_frame and track_frame_hypotheses), ranks
    (rank_hypotheses calls), captures (the steps' and the tracker's graphs
    captured, each of which also runs its program once eagerly), and
    lm_frames and lm_s, the steps and track_frame calls (not the retry
    batches) and their host seconds (on the card a graph replay that does
    not wait for the track)."""
    counts = dict(tracks=0, ranks=0, lm_frames=0, lm_s=0.0)
    captures = track_graph.CAPTURES["count"] + _step_counts("count")
    saved = {name: getattr(tracker, name) for name in
             ("track_frame", "track_frame_hypotheses", "rank_hypotheses")}
    steps = {name: getattr(FullSystem, name)
             for name in ("_frame_step_dispatch", "_chain_step")}
    lock = threading.Lock()

    def wrap(fn, key, timed=False):
        def counted(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            with lock:
                counts[key] += 1
                if timed:
                    counts["lm_frames"] += 1
                    counts["lm_s"] += time.perf_counter() - t
            return out
        return counted
    tracker.track_frame = wrap(saved["track_frame"], "tracks", timed=True)
    tracker.track_frame_hypotheses = wrap(saved["track_frame_hypotheses"],
                                          "tracks")
    tracker.rank_hypotheses = wrap(saved["rank_hypotheses"], "ranks")
    for name, fn in steps.items():
        setattr(FullSystem, name, wrap(fn, "tracks", timed=True))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(tracker, name, fn)
        for name, fn in steps.items():
            setattr(FullSystem, name, fn)
        counts["captures"] = (track_graph.CAPTURES["count"]
                              + _step_counts("count") - captures)


@contextlib.contextmanager
def counted_traces():
    """Count the arena's traces while inside, on every thread, and yield
    the counts: `traces`, the traces committed (each frame step's trace
    flag, from its packed row, and each FullSystem._trace_arena call);
    `trace_calls`, the _trace_arena calls; `frame_steps`, the strict frame
    steps (FullSystem._frame_step calls); and, at the block's end,
    `k4_expected`, the K4 launches they imply on the card: one per
    _trace_arena call, one per replay of the frame step's graph (its trace
    runs whatever the gate decides) and one per graph captured (its eager
    warm-up). A caller that traces by itself adds to `traces` and
    `trace_calls`."""
    counts = dict(traces=0, trace_calls=0, frame_steps=0)
    lock = threading.Lock()
    trace, step = FullSystem._trace_arena, FullSystem._frame_step
    fam = fsm.FRAME_STEP_GRAPHS
    before = fam.counts["replays"] + fam.counts["count"]

    def counted(self, *a, **k):
        with lock:
            counts["traces"] += 1
            counts["trace_calls"] += 1
        return trace(self, *a, **k)

    def counted_step(self, *a, **k):
        pyr, pk = step(self, *a, **k)
        with lock:
            counts["frame_steps"] += 1
            counts["traces"] += int(pk[19] > 0.5)
        return pyr, pk
    FullSystem._trace_arena = counted
    FullSystem._frame_step = counted_step
    try:
        yield counts
    finally:
        FullSystem._trace_arena = trace
        FullSystem._frame_step = step
        counts["k4_expected"] = (counts["trace_calls"] + fam.counts["replays"]
                                 + fam.counts["count"] - before)


@contextlib.contextmanager
def counted_pyramids():
    """Count the pyramids the system's frames imply while inside, on every
    thread, and yield the counts: `boot_pyramids`, the bootstrap's frames
    (FullSystem._do_initialize calls, each after one pyramid of its
    frame), and at the block's end `k2_expected`, K2's pyramid launches
    they imply on the card: one per replay of the frame step's and the
    chain step's graphs, one per such graph captured (its eager warm-up)
    and one per bootstrap frame."""
    counts = dict(boot_pyramids=0)
    lock = threading.Lock()
    boot = FullSystem._do_initialize
    before = _step_counts("replays") + _step_counts("count")

    def counted(self, *a, **k):
        with lock:
            counts["boot_pyramids"] += 1
        return boot(self, *a, **k)
    FullSystem._do_initialize = counted
    try:
        yield counts
    finally:
        FullSystem._do_initialize = boot
        counts["k2_expected"] = (_step_counts("replays") + _step_counts("count")
                                 - before + counts["boot_pyramids"])


@contextlib.contextmanager
def counted_activations():
    """Count the keyframes' activation passes (FullSystem._activation_pass
    calls) while inside, on every thread, and yield the count
    ({"activations": n}): each is one replay of the activation's graph on
    the card, with one K1 and one K5 launch."""
    counts = dict(activations=0)
    lock = threading.Lock()
    act = FullSystem._activation_pass

    def counted(self, *a, **k):
        with lock:
            counts["activations"] += 1
        return act(self, *a, **k)
    FullSystem._activation_pass = counted
    try:
        yield counts
    finally:
        FullSystem._activation_pass = act


@contextlib.contextmanager
def counted_boot():
    """Count the bootstrap's frames while inside, on every thread: its
    dispatches (initializer.track_frame_dispatch, each one program and one
    HostCopy) and its pulls (track_frame_finish, each one read of the
    card). Yields {"boot_dispatches": n, "boot_pulls": n}."""
    counts = dict(boot_dispatches=0, boot_pulls=0)
    lock = threading.Lock()
    saved = dict(boot_dispatches=initializer.track_frame_dispatch,
                 boot_pulls=initializer.track_frame_finish)

    def wrap(name, fn):
        def counted(*a, **k):
            with lock:
                counts[name] += 1
            return fn(*a, **k)
        return counted
    initializer.track_frame_dispatch = wrap("boot_dispatches",
                                            saved["boot_dispatches"])
    initializer.track_frame_finish = wrap("boot_pulls", saved["boot_pulls"])
    try:
        yield counts
    finally:
        initializer.track_frame_dispatch = saved["boot_dispatches"]
        initializer.track_frame_finish = saved["boot_pulls"]


# the keyframe's captured programs by the name run_mode reports them under
KF_FAMILIES = dict(post_ba=fsm.POST_BA_GRAPHS,
                   tracker_ref=fsm.TRACKER_REF_GRAPHS,
                   new_traces=fsm.NEW_TRACES_GRAPHS)
# the programs that do not run once per keyframe dispatch: the activation
# (only where a slot hosts candidates) and the bootstrap frame
PASS_FAMILIES = dict(activate=fsm.ACTIVATE_GRAPHS,
                     init=initializer.INIT_GRAPHS)


def kf_graph_counts() -> dict:
    """The keyframe programs', the bootstrap's and the frame and chain
    steps' graphs captured and replays so far: {"<name>_captures": n,
    "<name>_replays": n} for each of KF_FAMILIES, PASS_FAMILIES and
    STEP_FAMILIES."""
    out = {}
    for name, fam in {**KF_FAMILIES, **PASS_FAMILIES,
                      **STEP_FAMILIES}.items():
        out[f"{name}_captures"] = fam.counts["count"]
        out[f"{name}_replays"] = fam.counts["replays"]
    return out


@contextlib.contextmanager
def counted_ba():
    """While inside, on every thread: count the keyframe's dispatches
    (FullSystem.make_keyframe_dispatch), the point marginalization's
    dispatches (EnergyFunctional.marginalize_and_drop_dispatch) and the
    calls of K6's and K7's plain versions on card tensors (backend/ba.
    linearize_ref, _accumulate_top_ref, _sc_sums_ref, which the wrappers
    reach only for CPU tensors: a call here is a linearize or accumulate
    that did not go through the kernels). Yields {"kf_dispatches": n,
    "marg_dispatches": n, "ba_plain_calls": n}."""
    counts = dict(kf_dispatches=0, marg_dispatches=0, ba_plain_calls=0)
    lock = threading.Lock()
    dispatch = EnergyFunctional.marginalize_and_drop_dispatch
    kf_dispatch = FullSystem.make_keyframe_dispatch

    def counted_kf(self, *a, **k):
        with lock:
            counts["kf_dispatches"] += 1
        return kf_dispatch(self, *a, **k)
    plain = {name: getattr(ba, name) for name in
             ("linearize_ref", "_accumulate_top_ref", "_sc_sums_ref")}

    def counted_dispatch(self, *a, **k):
        with lock:
            counts["marg_dispatches"] += 1
        return dispatch(self, *a, **k)

    def wrap(fn):
        def counted(W, *a, **k):
            if W.state.device.type == "cuda":
                with lock:
                    counts["ba_plain_calls"] += 1
            return fn(W, *a, **k)
        return counted
    EnergyFunctional.marginalize_and_drop_dispatch = counted_dispatch
    FullSystem.make_keyframe_dispatch = counted_kf
    for name, fn in plain.items():
        setattr(ba, name, wrap(fn))
    try:
        yield counts
    finally:
        EnergyFunctional.marginalize_and_drop_dispatch = dispatch
        FullSystem.make_keyframe_dispatch = kf_dispatch
        for name, fn in plain.items():
            setattr(ba, name, fn)


def graph_launches() -> dict:
    """K6's and K7's launches made so far through the device LM's and the
    point marginalization's graphs (captures' warm-ups and replays)."""
    return {k: BA_GRAPHS.launches(k) + MARG_GRAPHS.launches(k)
            for k in ("ba_linearize", "ba_accumulate")}


def k3_expected(counts: dict, cfg, levels: int) -> int:
    """The K3 launches that `counted_tracks`' counts imply: one track's
    trips (tracker.trips_per_track, from the coarsest level as FullSystem
    tracks) per track and per capture, and one per rank."""
    trips = tracker.trips_per_track(cfg, levels, levels - 1)
    return trips * (counts["tracks"] + counts["captures"]) + counts["ranks"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_mode(mode: str, calib, poses, images, gpu=None,
             device=DEFAULT_DEVICE, cfg=None, interval_s: float = 0.0):
    """One run of `mode` over `images` with `cfg` (default `Config()` with
    loop closing off), the kernels' counts set to 0 just before the first
    frame and read after the drain. No synchronise per frame (it would
    stall the mapping thread). Frames go in as fast as the caller takes
    them, or with `interval_s` > 0 no earlier than i * interval_s after
    the first, as a camera of that period delivers them.
    Returns (the run's numbers, the FullSystem)."""
    if cfg is None:
        cfg = dataclasses.replace(Config(), enable_loop_closing=False)
    fs = FullSystem(calib, cfg, device=device)
    drv = make_driver(fs, mode)
    on_card = fs.device.type == "cuda"
    caller = (torch.cuda.current_stream(fs.device).cuda_stream if on_card
              else None)
    mapping = getattr(drv, "map_stream", None)
    mapping = mapping.cuda_stream if mapping is not None else None
    with traced_k1() as k1, counted_tracks() as tracks, \
            counted_traces() as traces, counted_activations() as acts, \
            counted_ba() as bas, counted_boot() as boot, \
            counted_pyramids() as pyrs:
        _sync(fs.device)
        cuda_kernels.reset_launch_counts()
        ba_graphs = dict(BA_GRAPHS.counts)
        marg_graphs = dict(MARG_GRAPHS.counts)
        kf_graphs = kf_graph_counts()
        in_graphs = graph_launches()
        call_ms = []
        init_capture_frames = []
        t0 = time.perf_counter()
        for i, img in enumerate(images):
            if interval_s > 0:
                time.sleep(max(0.0, t0 + i * interval_s
                               - time.perf_counter()))
            t = time.perf_counter()
            n_init = initializer.INIT_GRAPHS.counts["count"]
            drv.add_active_frame(img, i, 1.0, i * 0.05)
            call_ms.append((time.perf_counter() - t) * 1e3)
            if initializer.INIT_GRAPHS.counts["count"] != n_init:
                init_capture_frames.append(i)
            if fs.is_lost or fs.init_failed:
                break
        if drv is not fs:
            drv.block_until_mapping_is_finished()
        _sync(fs.device)
        wall = time.perf_counter() - t0
        launches = dict(cuda_kernels.LAUNCHES)
        ba_graphs = {k: BA_GRAPHS.counts[k] - v for k, v in ba_graphs.items()}
        marg_graphs = {k: MARG_GRAPHS.counts[k] - v
                       for k, v in marg_graphs.items()}
        kf_graphs = {k: n - kf_graphs[k] for k, n in kf_graph_counts().items()}
        in_graphs = {k: n - in_graphs[k] for k, n in graph_launches().items()}
        k3_by_mode = dict(cuda_kernels.TRIP_LAUNCHES)
    streams = collections.Counter()
    for (_, s), n in k1.items():
        streams["mapping" if s == mapping else
                "caller" if s == caller else "other"] += n
    kfs = fs.global_map.get_all_kfs()
    kf_ids = [kf.id for kf in kfs]
    est = [f for f in fs.all_frames if f.pose_valid]
    ate = ate_rmse([f.T_cw for f in est], [poses[f.id] for f in est])
    ate_kf = (ate_rmse([kf.T_cw for kf in kfs], [poses[i] for i in kf_ids])
              if len(kfs) >= 3 else float("nan"))
    print(f"--- {mode}\n{fs.timer.summary()}", file=sys.stderr, flush=True)
    run = dict(mode=mode, interval_ms=interval_s * 1e3, frames=len(images),
               keyframes=len(kfs),
               kf_ids=kf_ids, ate_mm=ate * 1e3, ate_kf_mm=ate_kf * 1e3,
               ms_per_frame_wall=wall * 1e3 / len(images), wall_s=wall,
               mapping_ms_per_frame=sum(
                   fs.timer.total.get(s, 0.0) for s in MAPPING_STAGES)
               * 1e3 / len(images),
               ms_per_frame_median=float(np.median(call_ms[kf_ids[1]:]))
               if len(kf_ids) > 1 else None,
               k1_launches=launches["distance_transform"],
               k1_streams=dict(streams),
               k3_launches=launches["tracker_trip"],
               k3_by_mode=k3_by_mode,
               k3_expected=k3_expected(tracks, cfg, calib.levels),
               k12_launches=launches["ba_projector"],
               k2_launches=launches["pyramid"],
               k2_expected=pyrs["k2_expected"],
               k4_launches=launches["trace"], traces=traces["traces"],
               trace_calls=traces["trace_calls"],
               frame_steps=traces["frame_steps"],
               k4_expected=traces["k4_expected"],
               k5_launches=launches["activate"],
               activations=acts["activations"],
               ba_replays=ba_graphs["replays"],
               ba_captures=ba_graphs["count"],
               k6_launches=launches["ba_linearize"],
               k7_launches=launches["ba_accumulate"],
               k6_in_graphs=in_graphs["ba_linearize"],
               k7_in_graphs=in_graphs["ba_accumulate"],
               ba_plain_calls=bas["ba_plain_calls"],
               marg_dispatches=bas["marg_dispatches"],
               marg_replays=marg_graphs["replays"],
               marg_captures=marg_graphs["count"],
               kf_dispatches=bas["kf_dispatches"], **kf_graphs,
               boot_dispatches=boot["boot_dispatches"],
               boot_pulls=boot["boot_pulls"],
               init_capture_frames=init_capture_frames,
               tracks=tracks["tracks"],
               rank_calls=tracks["ranks"],
               post_bootstrap_keyframes=sum(1 for kf in kfs if kf.kf_id >= 2),
               lm_frames=tracks["lm_frames"], lm_s=tracks["lm_s"],
               graph_captures=tracks["captures"],
               retrack_trips=getattr(drv, "retrack_trips",
                                     fs._n_retry_sweeps),
               lost=fs.is_lost, init_failed=fs.init_failed, gpu=gpu)
    return run, fs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--async-paces", type=float, nargs="*", default=(),
                    help="after each turn, async fed one frame per PACE "
                    "times the turn's strict wall ms per frame, for each "
                    "PACE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_modes: needs a CUDA card", file=sys.stderr)
        return 1
    gpu = gpu_facts()
    calib, poses, images = bench_frames(args.frames)
    cuda_kernels.build()
    run_mode("strict", calib, poses, images[:16], gpu)      # warm-up
    for r in range(args.reps):
        for mode in (PIPELINES if r % 2 == 0 else PIPELINES[::-1]):
            run, _ = run_mode(mode, calib, poses, images, gpu)
            print(json.dumps(run), flush=True)
            if mode == "strict":
                strict_ms = run["ms_per_frame_wall"]
        for pace in args.async_paces:
            run, _ = run_mode("async", calib, poses, images, gpu,
                              interval_s=pace * strict_ms / 1e3)
            print(json.dumps(dict(run, pace=pace)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
