"""Smoke run of the PyTorch + CUDA port (ldso_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device facts: needs CUDA; prints the nvidia-smi name/power-limit line
     and the torch/CUDA versions, then builds the hand-written kernels from
     ldso_tpu_torch/csrc with nvcc and prints the build time;
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shapes and larger maps (KITTI's, 1280x1024 and 1920x1080
     inputs, 1000x1000), with max |kernel - plain| == 0 required; at
     240x320 and 540x960 the kernel's single-call CUDA-event time (the
     record's `ms`, timed as the plain version's `plain_ms` is), its
     device time per launch from 20 launches in one CUDA graph
     (`device_ms`), the bound
     and the share of it, and the wrapper's host time per call; then the
     two float scatters of the path (the tracker-reference splat, the
     initializer's level averaging) 20 times each on the same inputs,
     every output bitwise equal. K2 (the frame's pyramid and the readers'
     rectification, csrc/preprocess.cu) against its plain versions
     (ops/preprocess.make_pyramid_ref and rectify_ref), bitwise: the
     pyramid on the bench scene's 640x480 uint8 frame at the main path's 4
     levels with and without a b_grad table, a float32 frame with steps
     of more than 255, uint16, levels that end odd, 6 levels and one
     level, one launch each; the rectification with uint8 and int32 raw
     and a response table, the inverse vignette, invalid and edge-clamped
     remap coordinates and float32 raw, one launch each; 20 launches of
     each bitwise; its device time per launch (20 in a graph) beside the
     bound, `ms`, `plain_ms` and ptxas's registers. K3 (the tracker trip with its LM control,
     csrc/tracker_trip.cu) in its three modes against their plain versions
     (frontend/tracker.tracker_trip_ref, cutoff_trip_ref, lm_trip_ref) at
     every level of a 640x480 scene, batch 1 and 8, on the scene and on
     four edge cases (every point out of bounds, a saturating cutoff, a NaN
     patch in the intensity and in all three channels, where the plain
     version's H and b turn NaN and K3's must alike): the trip's stats
     within 1e-4 relative with numTerms exact, H and b within 1e-3
     relative or 1e-5 of their scale; the cutoff and lm modes from a state
     with live, done and not-run members, held as
     tests/torch_kernel_checks.py says (idle members bit for bit, the step
     within the solve's rounding, the accept and done decisions equal but
     within their rounding margins); 20 launches of each mode bitwise
     equal; then, right after phase 3, the same comparisons on phase 3's
     last frame and reference at every level and batch, with K3's times
     (`ms`, `plain_ms`, `device_ms`; each mode with every member live and,
     for the cutoff and lm modes, every member idle) and bounds. K12 (the
     windowed BA's nullspace projector, csrc/ba_projector.cu) against its
     plain version (the SVD) on windows of 1-8 frames of the main path's 8
     slots, an empty one and planted bases (a repeated and a zero column,
     condition numbers 1e3 and 10^4.5, a singular value at 1.01 and 0.99
     times the gate, which are reported and not held to the tolerance)
     (tests/torch_kernel_checks.projector_err), and on each against
     projector_emulated (its own algorithm in float64 PyTorch on the card:
     P within PROJ_EMU_ULPS float32 ulps, sweeps and rotations equal), P
     symmetric bitwise, 20 launches bitwise, its times at the full window
     and ptxas's registers, shared memory and spills. K4 (the epipolar
     trace of the candidate arena, csrc/immature_trace.cu) against its
     plain version (frontend/immature.trace_arena_ref) on the bench scene
     at 640x480 with all 4,096 lanes live: every search (packed, rotated,
     nearest over either pattern, with and without the re-score), an
     uninitialised and a narrowing trace, and planted lanes (at and past
     the border, sticky OOB, skipped, badcondition, idepth_min < 0, steps
     at the cap, a former outlier, dead lanes between live ones, NaN
     pixels in the target), held by tests/torch_kernel_checks.trace_err
     (status exact, intervals and positions within 1e-4 relative, quality
     within 2e-3, dead lanes bitwise, a difference only at the plain
     version's own ties and on at most 1% of the live lanes); 20 launches
     bitwise; then, right after phase 3, every trace phase 3 ran again
     through the plain version from its recorded inputs, held the same
     way, and K4's times on phase 3's last arena (`ms`, `plain_ms`,
     `device_ms`) beside its bound. K5 (the keyframe's activation of the
     arena, csrc/immature_activate.cu: the gate against the newest
     keyframe with K1's map, then the depth-only LM against every window
     slot) against its plain version (frontend/immature.
     activate_arena_ref) on the bench scene at 640x480 with the full
     4,096-lane arena: windows of 2, 4 and 8 frames and planted lanes
     (patterns out of bounds at the border, masked targets, NaN pixels,
     Hdd under min_idepth_h_act, a first step that converges, an energy at
     the outlier limit, host == newest and out of range, dead lanes
     between live ones, among others), held by
     tests/torch_kernel_checks.activate_err (dead lanes bitwise, to_opt,
     remove, ok and n_good exact, idepths within 1e-4 relative, a
     difference only at the plain version's own ties and on at most 1% of
     the live lanes); 20 launches bitwise; its times on the window of 8
     beside its bound; FullSystem's activation under
     set_sync_debug_mode("error") behind 50 ms of sleep (one K1 and one K5
     launch, nothing read back, bitwise a run without the sleep); then,
     right after phase 3, every activation phase 3 ran again through the
     plain version from its recorded inputs, held the same way. K6 (the
     windowed BA's linearization, csrc/ba_linearize.cu) and K7 (its
     accumulation, csrc/ba_accumulate.cu) against their plain versions
     (backend/ba.linearize_ref, _accumulate_top_ref, _sc_sums_ref) at the
     main path's shape (2,048 points, 8 frames in 8 slots, 640x480,
     tests/torch_kernel_checks.ba_scene): K6 on the window, its newest
     column, the planted window (points off the image, outliers, sticky
     OOB, masked, linearized and missing residuals, one tap on the Huber
     threshold, a NaN patch) whole and by column and with the affine
     parameters off, every field and the energy sum bitwise (lin_err);
     K7's top part in modes 0-2 and its Schur part with and without the
     shifted prior on the scene's and the planted window, within acc_err
     (1e-4 of each entry's magnitude sum, NaN where the plain version's
     is); 20 launches of each bitwise; both under vmap over two windows,
     one launch each; their times (K7's per call, the mean of
     build_system's three) beside their bounds; then, right after phase
     3, every BA call and point marginalization of phase 3 again, eagerly,
     with each K6 and K7 call held to its plain version (phase_ba_frame);
  3. the pure-VO path: the synchronous monocular VO FullSystem at 640x480
     with the production Config and loop closing off on 64 synthetic uint8
     frames of the bench trajectory, on the package's default device (the
     card), timed by one wall clock from the first frame to a synchronise
     after the last; asserts tracking, >= 8 keyframes, the kernel
     launched on every keyframe after the bootstrap, and a
     similarity-aligned ATE under 5 mm; then, on phase 3's system:
     3a. hypothesis 0's track inside the frame step's graph: phase 3's
         last frame-step replay against its eager program, bitwise (K3
         316 and K4 one launch in each); the captured tracker
         (frontend/track_graph.py) against the eager masked tracker,
         bitwise, at the retry batch, its device time per track (also
         behind a fixed sleep) and the aten operations of an eager track
         (< 2,000); then every track of phase 3 (hypothesis 0's from each
         frame step's eager re-run, recorded_frame_steps, and the retry
         batches') again through the plain tracker (the plain modes
         patched in) from the same inputs: every ok flag equal, T within
         1e-4, aff within 1e-3, residuals and flow within 1e-3 relative,
         and the trips per track that K3 runs in full, from the plain
         flags;
     3b. track_chain_dispatch under torch.cuda.set_sync_debug_mode("error")
         behind ~50 ms of sleep queued on a tracking stream: it returns
         well inside the sleep, its HostCopy not ready, its result bitwise
         that of a dispatch without the sleep; each dispatch one replay of
         the chain step's graph (full_system.CHAIN_STEP_GRAPHS, none
         captured) and one HostCopy, each replay bitwise its eager
         program;
     3c. the map checkpoint: save_all to .bin and .npz, load_all into a
         fresh system, keyframe ids and T_cw bitwise equal;
     3d. the device LM (backend/ba_device.optimize_device, one CUDA graph
         per call): every BA call of phase 3 was one graph replay, none
         captured inside the run (the FullSystem captures them when it is
         built), K12 launched once per call; on phase 3's recorded BA
         inputs: the last call's replay bitwise the eager call, its
         uploads and replay under set_sync_debug_mode("error") behind 50
         ms of sleep, its device ms (queued replays) beside phase 3's wall
         ms per call, the aten operations of an eager call, the live trips
         of every call, K12 against its plain version and its emulation on
         every call, and K12's device time as a share of a call's; a
         replay's launches: K6 trips + 2, K7 3 x trips, K12 once;
     3e. the point marginalization (energy_functional.replay_marg, one
         CUDA graph per call, one packed pull): every keyframe's was one
         replay and one HostCopy; on phase 3's last recorded inputs the
         replay bitwise the eager program, one K6 and two K7 launches per
         replay, the replay and its pull under set_sync_debug_mode
         ("error") behind 50 ms of sleep (queued inside it, the copy not
         ready, its result bitwise the eager one), its device ms;
     3f. the keyframe's dispatch with no host read: the post-BA flags
         and packed row, the tracker reference and the new candidates are
         one captured program each (system/full_system's POST_BA_GRAPHS,
         TRACKER_REF_GRAPHS, NEW_TRACES_GRAPHS), replayed once per
         keyframe dispatch of phase 3 with no capture inside the run; on
         phase 3's last inputs each replay bitwise its eager program, its
         device ms (20 replays behind a sleep); then phase 3's first 24
         frames again, each keyframe's dispatch from the activation
         through the new candidates under set_sync_debug_mode("error")
         behind 50 ms of queued sleep: returned within 25 ms,
         finish.ready() false until the sleep ends, no graph captured,
         keyframes and tracked poses bitwise phase 3's;
     3g. the activation pass as one captured program (full_system.
         ACTIVATE_GRAPHS, a graph per window size, captured when the
         system is built): every post-bootstrap activation of phase 3 one
         replay with one K1 and one K5 launch, no capture inside the run,
         every replay's outputs bitwise its eager program; on the last
         inputs the replay again, its device ms (20 replays behind a
         sleep), and the card memory of the graphs;
     3h. the bootstrap's frames as one captured program (initializer.
         INIT_GRAPHS): in phase 3 captured at the first frame only, one
         replay and one pull per bootstrap frame; a fresh bootstrap of
         phase 3's frames with each frame's dispatch under
         set_sync_debug_mode("error") behind 50 ms of queued sleep
         (returned before its pull was ready), each replay bitwise its
         eager masked program, the live trips per level beside the
         early-exit loop's (tests/torch_init_parent.py), and the device
         ms per replay;
     3i. the frame step as one captured program (full_system.
         FRAME_STEP_GRAPHS: the pyramid, hypothesis 0's track, the
         retrack gate on the device, the trace's tables, K4 over the whole
         arena and the select of its 7 traced fields): every
         post-bootstrap strict frame of phase 3 one replay (and one
         pull), no capture in the run, each replay bitwise its eager
         program (recorded_frame_steps), K3 316 and K4 one launch a
         replay; on phase 3's last inputs a replay that fails the gate
         and one with commit 0 leave the arena bitwise as it went in,
         with the trace flag 0; the strict dispatch under
         set_sync_debug_mode("error") behind 50 ms of queued sleep returns
         within 25 ms, its HostCopy not ready, its result bitwise a
         dispatch without the sleep; the device ms per replay (20 replays
         behind a sleep), the replay's split by part from torch.profiler
         (copies, pyramid (K2's kernel), K3, the tracker's other kernels,
         tables, K4, selects), K2's bound beside the pyramid's part, K2
         one launch a replay, and the graphs' static buffers and the card
         memory their capture takes;
  4. the loop slice: the default Config (mode=1 photometrics, loop closing
     on, ORB corner selection) on the 150-frame out-and-back revisit scene
     at 640x480 with an exposure ramp, a vocabulary trained from 8 views;
     asserts at least one return-leg -> out-leg loop, the pose graph ran,
     Sim(3) scales in (0.5, 2), odometry ATE < 5 mm, loop-closed ATE
     < 20 mm and the kernel launched on every keyframe after the bootstrap;
     prints one JSON line (phase "4 loop_slice") with every keyframe's
     frame id, every loop pair (frame -> frame), the loop count, both ATEs
     and the dtype of the pose graph's S_cw;
     4b. the boxes scene (BoxScene, depth discontinuities and occlusion):
         104 frames at 640x480 on the straight head-to-head trajectory,
         strict, the CLI's mode=1 changes, loop closing off; keyframe ATE
         under 5 mm and the kernel's launches;
  5. the pipelines: phase 3's frames through DeterministicPipeline twice
     and AsyncPipeline twice, by phase 3's runner
     (ldso_tpu_torch/examples/time_modes.run_mode, one wall clock per run,
     drain included): async as fast as the caller takes the frames, then
     fed one frame per ASYNC_PACE times strict's wall ms per frame in
     phase 3;
     asserts the two lookahead runs bitwise equal, >= 8 keyframes
     (lookahead and the paced async; unpaced, async's keyframes fall as
     tracking outruns mapping, and it is held to the 3 its pipeline
     guarantees) and ATE < 5 mm, the kernel launched
     once per post-bootstrap keyframe in every mode and, in async, only on
     the mapping thread's stream; one JSON line per run;
  6. the CLI: phase 3's frames written as a KITTI sequence with the port's
     PNG writer, then run_common.run with pipeline=lookahead and with
     pipeline=async; asserts both trajectory files of each run, orthonormal
     rotations, keyframe ATE < 5 mm and the kernel's launches; the
     lookahead run has the live viewer on (nogui=0 viewer_port=0), whose
     /state must count the keyframe rows of results.txt and whose /frame
     must decode (io/png.py) to a frame of the input's shape;
  7. the modules of the later slice, on the card:
     7a. phase 3's frames, strict, through the host-orchestrated BA
         (ba_device_lm=False) and then the accept/reject LM
         (force_accept_step=False): >= 8 keyframes, ATE < 5 mm, the
         median BA call beside phase 3's;
     7b. the same with the reference's trace search (trace_packed=False);
     7c. 8 sequences tracked in lockstep (parallel/replay's batched
         tracker, one CUDA graph) against 8 single tracks, and the device
         ms of each;
     7d. the sharded build system and the sharded PCG through one NCCL
         group of world size 1, against the unsharded functions on phase
         3's final window and phase 4's final pose graph;
     7e. phase 3's last 8 BA inputs in one vmapped CUDA graph against 8
         single replays (each member no farther from its window's float64
         result than BA_F64_FACTOR times the farthest single replay, tests/
         torch_kernel_checks.ba_batch_err; four planted faults refused,
         two of them reruns of a member near the tolerance),
         K12 once, K6 trips + 2 and
         K7 3 x trips times for the 8, and the device ms of the batch and
         of the singles; K12 alone on the 8 windows, one launch against 8
         single ones.
Every run of the device LM (3, 4b, 5, 7b) holds K12's launches to its BA
graph replays, with no graph captured inside the run; K12's record gives
phase 3's count and each path's.
Every phase that drives a path (3, 3b, 4, 4b, 5, 6, 7a, 7b and the
bench's legs) asserts K2's pyramid launches: one per replay of the frame
step's and the chain step's graphs, one per such graph captured inside
the block and one per bootstrap frame (time_modes.counted_pyramids'
`k2_expected`; the util and batched tracking legs build pyramids of
their own, more than that), and phase 6 one rectify launch per frame the
reader read; a `k2_by_path` line.
Every phase that tracks (3, 3a, 3b, 4, 4b, 5, 6, 7a-7c) asserts K3's
launches, counted through graph replays: exactly
tracker.trips_per_track (316 at 640x480) per track (a frame step, a
chain step, a retry batch) and per graph capture (the steps' and the
tracker's), plus one per rank_hypotheses call; K3's record gives phase 3's launches
of each mode, counted as they ran (cuda_kernels.TRIP_LAUNCHES). Every
phase that drives a path (3, 4, 4b, 5, 6, 7a, 7b and every bench leg
that traces, phase 8) asserts that K4 launched exactly as often as the
path's frame steps and traces imply (time_modes.counted_traces'
`k4_expected`: one launch per replay of the frame step's graph, whatever
its gate decided, one per FullSystem._trace_arena call, one per frame-step
graph captured inside the block, and the bench's util trace calls) and
that some trace was committed (the frame steps' trace flags and the
_trace_arena calls): no trace went through the plain version; and that
K5 launched once for each post-bootstrap keyframe (the bench: once for each
activation pass, util's timed ones among them), printed per path in a
`k5_by_path` line; and that K6 and K7 launched on the path, no call of
their plain versions ran on the card, every point marginalization was one
graph replay, and with the device LM every K6 and K7 launch was one of
the BA's or the marginalization's graphs (`k6_by_path`, `k7_by_path`
lines; the bench per leg); and that each of the keyframe's three
programs after the BA replayed once per keyframe dispatch (and once per
system built inside the block), the activation once per pass and the
bootstrap once per bootstrap frame, the frame step and the chain step
(captured for uint8 and float32 frames when a system is built) once per
frame they track, with no graph captured inside a run
(the bootstrap's at its first frame; a system built inside a counted
block adds one K1 and one K5 launch for each activation graph it
captures).
  8. the port's benchmark (ldso_tpu_torch/examples/bench.py, bench.py's
     legs) in this process at its defaults: no error; three windows in
     each of lookahead, strict, async and the two aggregate legs; value
     > 0; ATE under 5 mm; util's three device times finite and positive;
     K3 launched in every leg that tracks, K12 once per BA graph replay
     (and capture) in every leg and in every leg that runs the BA, both
     counted through graph replays; its JSON line and its wall time.
One JSON line per 7a/7b run and for 7c and 7d, a JSON line of the
captured tracker's numbers, the BA's, the marginalization's, the
keyframe programs' (3f), the activation's (3g), the bootstrap's (3h)
and the frame step's (3i),
the bench's JSON line, then a JSON record of
the kernels (K1, K2's pyramid and rectify, K3, K12, K4, K5, K6, K7), then the last line {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

N_FRAMES = 64
ATE_BOUND_M = 0.005          # the JAX package's own bound (test_full_system)
# async's keyframes whatever its queue: the first frame, the initializer's
# and the first tracked one (the mapping loop's num_frames() <= 2 branch)
ASYNC_BOOTSTRAP_KEYFRAMES = 3
# the paced async run's frame interval over strict's wall ms per frame in
# phase 3's run, the rate at which strict, tracking and mapping in turn,
# keeps every frame: async keeps a keyframe only when its mapping queue is
# empty, and its feed at that rate starts behind, by the initializer's
# frames. `time_modes --reps 4 --async-paces 1.0 1.25 1.5 2.0` on the card
# made 7-9 keyframes at 1.0, 9-11 at 1.25 and 11-12 at 1.5 (PERF.md); the
# run is held to >= 8 on every call, so it takes 1.5
ASYNC_PACE = 1.5
LOOP_FRAMES = 150            # tools/head_to_head.py --traj revisit --frames
LOOP_ATE_BOUND_M = 0.020     # ~2x the JAX package's 10.19 mm on this scene
DET_REPEATS = 20
BOX_FRAMES = 104             # the boxes head-to-head (BASELINE.md:80-89)
ORTHO_BOUND = 1e-3           # |RR^T - I| of a results.txt row
# the main path's map at 640x480, KITTI's (1241x376), 1280x1024 and
# 1920x1080 inputs, and a 1000x1000 map
DIST_CASES = dict(shapes=((240, 320), (96, 128), (61, 97), (188, 620),
                          (512, 640), (540, 960), (1000, 1000)),
                  occupancy=(0.005, 0.02, 0.10, "empty", "full"),
                  max_k=(1, 2, 18, 40))
DIST_TIMED = ((240, 320), (540, 960))
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, and the float32
# rate outside the tensor cores, taken for the map's integer compares
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# the keyframe's captured programs (system/full_system's POST_BA_GRAPHS,
# TRACKER_REF_GRAPHS, NEW_TRACES_GRAPHS) by the names time_modes.run_mode
# reports their replays and captures under
KF_PROGRAMS = ("post_ba", "tracker_ref", "new_traces")
# 3f: the sleep queued ahead of each watched keyframe's activation, the
# host time its dispatch from the activation through the new candidates
# must return within, and the frames of phase 3's scene it drives again
KF_SLEEP_MS = 50.0
KF_QUEUED_MS = 25.0
# 3h: the sleep queued ahead of each watched bootstrap frame's dispatch
INIT_SLEEP_MS = 50.0
# 3i: the sleep queued ahead of the watched strict frame step's dispatch,
# and the host time the dispatch must return within
STEP_SLEEP_MS = 50.0
STEP_QUEUED_MS = 25.0
KF_FRAMES = 24


def _kernel_checks():
    """tests/torch_kernel_checks.py: how K3 is held against its plain
    version (tolerances, edge cases), shared with the tests."""
    import importlib
    import os
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module("torch_kernel_checks")


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _median_event_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _queued_device_ms(fn, n: int = 20, reps: int = 30,
                      sleep_cycles: int = 0) -> float:
    """Device time per call: n calls queued behind a sleeping kernel, so
    they run back to back whatever the host costs, CUDA events around the
    n; the median over reps. For a call that replays a CUDA graph itself
    (the captured tracker), which `_graph_device_ms` cannot capture. The
    sleep lasts twice the host's time to queue the n calls (and 1 ms), so
    the card never waits for the host inside the window; or, when given,
    a fixed sleep of `sleep_cycles`, which the host's queueing of fast
    calls can outlast."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    cycles = sleep_cycles or int(_sleep_cycles_per_ms()
                                 * (2.0 * host_ms + 1.0))
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


# about 3 ms of the card's sleep kernel: the fixed sleep behind which 3a's
# earlier readings of the device time per track were taken; 3a reads both
# ways, so that those readings compare with its own
FIXED_SLEEP_CYCLES = 5_000_000


def _graph_device_ms(fn, n: int = 20, reps: int = 30) -> float:
    """Device time per call: n calls captured in one CUDA graph, the graph
    replayed between CUDA events reps times, the median over n. What the
    host spends per call (the operator's dispatch, the wrapper's checks)
    drops out, as it does where the captured tracker runs the kernel."""
    import torch
    from ldso_tpu_torch.ops import cuda_kernels
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with cuda_kernels.recording_launches(), torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def _host_us_per_call(fn, n: int = 2000) -> float:
    """Synchronised wall time over n calls, divided by n."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def distance_bound_ms(occ, out, max_k: int):
    """The least time for K1's function on these inputs: one read of the
    occupancy bytes and one write of the float32 map, against the neighbour
    tests this data needs (each cell still unreached before sweep k tests
    its 4 neighbours, 8 on odd k). Returns (ms, "bytes" or "operations")."""
    import torch
    n_bytes = occ.numel() * (occ.element_size() + 4)
    ops = sum((8 if k % 2 else 4) * int(torch.count_nonzero(out >= k))
              for k in range(1, max_k))
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), bound_by


def phase_device():
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    from ldso_tpu_torch.ops import cuda_kernels
    t0 = time.time()
    path = cuda_kernels.build(verbose=True)
    print(f"kernels built in {time.time() - t0:.2f} s: {path}", flush=True)


def phase_kernels():
    """K1 against its plain version; returns the kernel record."""
    import torch
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.ops.distance_map import distance_transform_ref
    rng = np.random.RandomState(1234)
    worst = 0.0
    n_cases = 0
    for (H, W) in DIST_CASES["shapes"]:
        for occ_kind in DIST_CASES["occupancy"]:
            if occ_kind == "empty":
                occ_np = np.zeros((H, W), bool)
            elif occ_kind == "full":
                occ_np = np.ones((H, W), bool)
            else:
                occ_np = rng.rand(H, W) < occ_kind
            occ = torch.from_numpy(occ_np).cuda()
            for max_k in DIST_CASES["max_k"]:
                got = cuda_kernels.distance_transform(occ, max_k)
                want = distance_transform_ref(occ, max_k)
                torch.cuda.synchronize()
                err = float(torch.max(torch.abs(got - want)).item())
                worst = max(worst, err)
                n_cases += 1
                if err != 0.0:
                    _fail(f"distance_transform {H}x{W} occ={occ_kind} "
                          f"max_k={max_k}: max|kernel - plain| = {err}")
    print(f"K1 distance_transform: {n_cases} cases, max|kernel - plain| = "
          f"{worst}; comparison launches "
          f"{cuda_kernels.LAUNCHES['distance_transform']}", flush=True)
    timed = {}
    for (H, W) in DIST_TIMED:
        occ = torch.from_numpy(rng.rand(H, W) < 0.02).cuda()
        kernel = lambda: cuda_kernels.distance_transform(occ, 18)  # noqa: E731,B023
        t = dict(ms=_median_event_ms(kernel),
                 device_ms=_graph_device_ms(kernel),
                 plain_ms=_median_event_ms(
                     lambda: distance_transform_ref(occ, 18)),  # noqa: B023
                 host_us=_host_us_per_call(kernel))
        t["bound_ms"], t["bound_by"] = distance_bound_ms(occ, kernel(), 18)
        timed[(H, W)] = t
        print(f"K1 at {H}x{W}, max_k=18, 2% occupied: kernel {t['ms']:.4f} ms "
              f"per single call (median of 50, CUDA events, the wrapper's "
              f"host time included), {t['device_ms']:.4f} ms of device time "
              f"per launch (20 in a CUDA graph, median of 30); plain "
              f"{t['plain_ms']:.4f} ms (single call, median of 50); bound "
              f"{t['bound_ms'] * 1e3:.4f} us set by {t['bound_by']}, "
              f"{100 * t['bound_ms'] / t['ms']:.2f}% of it reached per "
              f"single call, {100 * t['bound_ms'] / t['device_ms']:.2f}% in "
              f"device time; wrapper host {t['host_us']:.2f} us per call "
              f"(2000 calls, synchronised wall)", flush=True)
    main = timed[DIST_TIMED[0]]
    # ms and plain_ms are both single-call CUDA-event medians (as in the
    # earlier records); device_ms is the device time per launch in a graph
    return dict(name="distance_transform", route="cuda",
                source="ldso_tpu_torch/csrc/distance_map.cu",
                replaces="ldso_tpu/ops/pallas_kernels.py:63",
                max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                device_ms=main["device_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None)


def phase_determinism(seed: int = 7):
    """The tracker-reference splat and the initializer's level averaging,
    DET_REPEATS times each on the same inputs at the main path's shapes:
    every output must be bitwise equal (their float scatters are
    deterministic by construction, ops/scatter.py)."""
    import torch
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.frontend import initializer, tracker
    from ldso_tpu_torch.ops.preprocess import make_pyramid
    from ldso_tpu_torch.synthetic import PlaneScene, default_calib
    calib = default_calib(640, 480)
    cfg = Config()
    img, _ = PlaneScene(freq_hi=25.0, contrast=80.0).render(
        calib, np.eye(4), device="cuda")
    pyr = make_pyramid(img, calib.levels)
    g = torch.Generator("cuda").manual_seed(seed)
    P = cfg.max_points

    def rnd(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    # half the points pile onto 64 pixels, so the sums have many terms
    u = torch.where(rnd(P) < 0.5, 320.0 + torch.floor(rnd(P) * 8),
                    rnd(P) * 639.0)
    v = torch.where(rnd(P) < 0.5, 240.0 + torch.floor(rnd(P) * 8),
                    rnd(P) * 479.0)
    args = (u, v, 0.2 + rnd(P), 0.5 + rnd(P), rnd(P) < 0.9, pyr.dI, 1.0,
            torch.zeros(2, device="cuda"), calib,
            cfg.tracker_caps[:calib.levels])

    def splat():
        ref = tracker.make_tracker_ref(*args)
        return list(ref.points) + list(ref.valid)

    state = initializer.set_first(pyr, calib, cfg)
    Lf, Lc = state.levels[0], state.levels[1]
    n = Lf.iR.shape[0]
    Lf = Lf._replace(iR=0.5 + rnd(n), last_hessian=rnd(n) * 100.0,
                     is_good=Lf.valid & (rnd(n) < 0.8))

    unsnapped = torch.zeros((), dtype=torch.bool, device="cuda")

    def level_mean():
        return list(initializer._propagate_up(Lf, Lc, unsnapped)[:])

    for name, fn, points in (("make_tracker_ref", splat, P),
                             ("initializer._propagate_up", level_mean, n)):
        first = [t.clone() for t in fn()]
        for rep in range(1, DET_REPEATS):
            for a, b in zip(first, fn()):
                if not torch.equal(a, b):
                    _fail(f"{name}: repeat {rep} differs from repeat 0")
        print(f"determinism: {name} gave {DET_REPEATS} bitwise-identical "
              f"results ({len(first)} outputs, {points} points)", flush=True)


TRIP_BATCHES = (1, 8)
# float operations per point of K3's function (csrc/tracker_trip.cu),
# counted from its code by what the point reaches: every valid point is
# warped and bounds-tested; an ok one is sampled (3 channels, 4 taps) and
# scored; at level 0 it adds the two flow sums; a good one forms J, its
# 36 H and 8 b products
TRIP_OPS = dict(valid=30, ok=50, flow=66, good=124)


def trip_taps(ref, pyr, lvl, T, aff, expo, cut, calib, cfg):
    """The distinct pixels of level `lvl` that K3 gathers on these inputs:
    the four bilinear taps (ops/interp.bilinear's clamp and floor) of
    every valid, in-bounds point of every member, counted once."""
    import torch
    from ldso_tpu_torch.frontend import tracker
    bufs, _ = tracker._calc_res(ref, pyr, lvl, T, aff, expo, cut, calib,
                                cfg, False)
    h, w = pyr.dI[lvl].shape[:2]
    Ku = calib.fx[lvl] * bufs["u"] + calib.cx[lvl]
    Kv = calib.fy[lvl] * bufs["v"] + calib.cy[lvl]
    inb = (ref.valid[lvl][None, :] & (Ku > 2) & (Kv > 2) & (Ku < w - 3)
           & (Kv < h - 3) & (bufs["idepth"] > 0))
    x0 = torch.floor(torch.clamp(Ku[inb], 0.0, w - 1.001)).long()
    y0 = torch.floor(torch.clamp(Kv[inb], 0.0, h - 1.001)).long()
    idx = y0 * w + x0
    taps = torch.cat([idx, idx + 1, idx + w, idx + w + 1])
    return int(torch.unique(taps).numel())


# float operations of the lm mode's step per live member, counted from
# csrc/tracker_trip.cu's lm_step: the damped augmented 8x9 system (16), the
# elimination with pivoting (~560), the back substitution (~72), the
# extrapolation and scaling (~30), se3_exp (~90) and the 4x4 product (112)
STEP_OPS = 880
# state bytes a member reads and writes in each mode (T 64, aff 8, cutoff,
# cutoff_rep, lam 4, stats 24, H 256, b 32, run or done 1)
STATE_BYTES = dict(trip=(76, 312), cutoff=(389, 316), lm=(393, 389))


def trip_bound_ms(args, stats, mode: str = "trip", live=None):
    """The least time for K3's function on these inputs (`args` as
    tracker_trip takes them, at the poses the trip warps with: an LM
    trip's new poses; `stats` the trip's result; `live` the members with
    work to do, all by default): the bytes it must move, each once (every
    member's state in and out, STATE_BYTES; where a member is live, every
    point's mask byte and each valid point's 16 bytes, once, and the 12
    bytes of I, dx and dy at each distinct level pixel that the live
    members' in-bounds points gather, trip_taps), against the operations
    this data needs (TRIP_OPS per valid, ok and good point of a live
    member, STEP_OPS per live LM member). Returns (ms, "bytes" or
    "operations", the distinct pixels gathered)."""
    import torch
    ref, pyr, lvl, T = args[:4]
    flow = args[-1]
    B = T.shape[0]
    live = torch.ones(B, dtype=torch.bool) if live is None else live.cpu()
    n_live = int(live.sum())
    N = ref.points[lvl].shape[0]
    n_valid = int(ref.valid[lvl].sum())
    n_bytes = 16 + B * sum(STATE_BYTES[mode])
    ops = 0.0
    n_px = 0
    if n_live:
        sel = live.to(T.device)
        sub = [x[sel] if i in (3, 4, 6) else x for i, x in enumerate(args)]
        n_px = trip_taps(*sub[:-1])
        n_bytes += N + n_valid * 16 + n_px * 12
        num = stats[sel, 1]
        sat = torch.round(stats[sel, 5] * torch.clamp(num, min=1.0))
        ops = (n_live * n_valid * TRIP_OPS["valid"]
               + float(num.sum()) * (TRIP_OPS["ok"] + flow * TRIP_OPS["flow"])
               + float((num - sat).sum()) * TRIP_OPS["good"])
        if mode == "lm":
            ops += n_live * STEP_OPS
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", n_px)


def trip_poses(T0, B: int):
    """B poses about T0: T0 and B - 1 translations of up to 1 cm."""
    import torch
    T = T0.expand(B, 4, 4).clone()
    off = np.random.RandomState(5).randn(max(B - 1, 0), 3) * 0.01
    T[1:, :3, 3] += torch.as_tensor(off, dtype=T.dtype, device=T.device)
    return T


def phase_trip_edges():
    """K3 against its plain version on a 640x480 scene at every level and
    at batch 1 and 8, on the scene itself and on the edge cases (a pose
    that puts every point out of bounds, a cutoff that saturates most
    terms, a NaN patch in the level's intensity, and one in all three
    channels, where the plain version's H and b turn NaN and K3's must
    turn NaN alike); then 20 launches on the same inputs, bitwise equal.
    Returns the worst errors."""
    import torch
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.math import lie_np
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.ops.preprocess import make_pyramid
    from ldso_tpu_torch.synthetic import PlaneScene, default_calib
    kc = _kernel_checks()
    calib, cfg = default_calib(640, 480), Config()
    L = calib.levels
    scene = PlaneScene(freq_hi=25.0, contrast=80.0)
    img0, idep0 = scene.render(calib, np.eye(4), device="cuda")
    ref = tracker.make_tracker_ref_from_idepth(
        idep0, make_pyramid(img0, L), calib, cfg.tracker_caps[:L], stride=2)
    T_true = lie_np.se3_exp(np.array([0.02, -0.01, 0.005, 0.002, 0.004,
                                      -0.001]))
    img1, _ = scene.render(calib, T_true, device="cuda")
    pyr = make_pyramid(img1, L)
    f32 = dict(dtype=torch.float32, device="cuda")
    expo = torch.ones((), **f32)
    worst = dict(abs=0.0, share=0.0)
    modes = dict(abs=0.0, share=0.0, floor_E=0.0, floor_b=0.0)
    nan_members = dict(nan_intensity=0, nan_patch=0)
    for case in kc.TRIP_CASES:
        head = None
        for lvl in range(L):
            for B in TRIP_BATCHES:
                p, T, aff, cut = kc.trip_case(
                    case, pyr, lvl, trip_poses(torch.as_tensor(T_true, **f32),
                                               B),
                    torch.tensor([[0.01, 0.5]], **f32).expand(B, 2), cfg)
                args = (ref, p, lvl, T, aff, expo, cut, calib, cfg, lvl == 0)
                got = cuda_kernels.tracker_trip(*args)
                want = tracker.tracker_trip_ref(*args)
                err, share, same_n = kc.trip_err(got, want,
                                                 kc.trip_allowance(*args))
                worst["abs"] = max(worst["abs"], err)
                worst["share"] = max(worst["share"], share)
                if not (share <= 1.0 and same_n):
                    _fail(f"K3 {case} level {lvl} batch {B}: max|kernel - "
                          f"plain| {err}, {share:.3g} of the tolerance, "
                          f"numTerms equal {same_n}")
                n = got[0][:, 1]
                if head is None:
                    head = (float(n[0]), float(got[0][0, 5]))
                if case == "out_of_bounds" and bool(torch.any(n != 0)):
                    _fail(f"K3 out_of_bounds level {lvl}: numTerms {n}")
                if case.startswith("nan"):
                    nan_members[case] += int(torch.isnan(want[1]).any(
                        (1, 2)).sum())
                # the cutoff and lm modes from a state with live, done and
                # not-run members (torch_kernel_checks.mode_state)
                err, share, faults, info = kc.mode_errs(
                    cuda_kernels.cutoff_trip, cuda_kernels.lm_trip,
                    tracker.tracker_trip_ref, ref, p, lvl, T, aff, expo, cut,
                    calib, cfg, lvl == 0)
                modes["abs"] = max(modes["abs"], err)
                modes["share"] = max(modes["share"], share)
                for k in ("floor_E", "floor_b"):
                    modes[k] = max(modes[k], info[k])
                if faults:
                    _fail(f"K3 cutoff/lm modes, {case} level {lvl} batch "
                          f"{B}: " + "; ".join(faults))
        print(f"K3 {case}: {L} levels x batch {TRIP_BATCHES} within "
              f"tolerance in the trip, cutoff and lm modes; level 0, batch "
              f"1: numTerms {head[0]}, saturated share {head[1]:.4f}",
              flush=True)
    T = trip_poses(torch.as_tensor(T_true, **f32), 8)
    aff = torch.tensor([[0.01, 0.5]], **f32).expand(8, 2).contiguous()
    cut = torch.full((8,), 20.0, **f32)
    state = kc.mode_state(tracker.tracker_trip_ref, ref, pyr, 0, T, aff, expo,
                          cut, calib, cfg, True)
    stats, H, b, rep_, run, lam, done = state
    calls = dict(
        trip=lambda: cuda_kernels.tracker_trip(ref, pyr, 0, T, aff, expo, cut,
                                               calib, cfg, True),
        cutoff=lambda: cuda_kernels.cutoff_trip(
            ref, pyr, 0, T, aff, expo, stats, H, b, rep_, run, calib, cfg,
            True),
        lm=lambda: cuda_kernels.lm_trip(
            ref, pyr, 0, T, aff, expo, stats, H, b, lam, done, 20.0 * rep_,
            calib, cfg, True))
    for mode, call in calls.items():
        first = [x.clone() for x in call()]
        for rep in range(1, DET_REPEATS):
            for a, b_ in zip(first, call()):
                if not _same(a, b_):
                    _fail(f"K3 {mode} mode: launch {rep} differs from "
                          f"launch 0")
    if not all(nan_members.values()):
        _fail(f"K3's NaN cases: no member with a NaN H in the plain version "
              f"({nan_members}): the cases test nothing")
    print(f"K3's NaN cases: the plain version's H is NaN in {nan_members} "
          f"members (over the levels and batches), and K3's alike",
          flush=True)
    print(f"K3: {len(kc.TRIP_CASES)} cases x {L} levels x 2 batches; trip "
          f"mode max|kernel - plain| {worst['abs']:.6g}, at most "
          f"{worst['share']:.4f} of the tolerance; cutoff and lm modes "
          f"max|kernel - plain| {modes['abs']:.6g}, at most "
          f"{modes['share']:.4f} of the tolerance; {DET_REPEATS} launches of "
          f"each mode bitwise equal (level 0, batch 8); the lm check's "
          f"rounding floors (trip_floor) at most {modes['floor_E']:.4g} of E "
          f"and {modes['floor_b']:.4g} of the member's max |b| at the "
          f"candidates' poses", flush=True)
    worst["modes_abs"], worst["modes_share"] = modes["abs"], modes["share"]
    return worst


def _mode_timings(ref, pyr, lvl, T, aff, expo, cut, calib, cfg, flow,
                  trip_out):
    """K3's cutoff and lm modes at these poses, each with every member
    live and with every member idle: device time per launch (20 launches
    of the operator in one CUDA graph), the plain version's single-call
    time (CUDA events, median of 50) and the bound (trip_bound_ms at the
    poses the trip warps with). `trip_out` is the plain trip at T."""
    import torch
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.ops import cuda_kernels
    B = T.shape[0]
    dev = T.device
    stats, H, b = trip_out
    params = cuda_kernels.trip_params(calib, lvl, cfg)
    lead = (ref.points[lvl], ref.valid[lvl], pyr.dI[lvl], T, aff,
            ref.ref_aff, ref.ref_exposure, expo)
    yes = torch.ones(B, dtype=torch.bool, device=dev)
    rep = torch.ones(B, dtype=torch.float32, device=dev)
    lam = torch.full((B,), 0.01, dtype=torch.float32, device=dev)
    sat = stats.clone()
    sat[:, 5] = 0.9              # over 60% saturated: the cutoff doubles
    args = (ref, pyr, lvl, T, aff, expo, cut, calib, cfg, flow)
    out = {}
    for mode in ("cutoff", "lm"):
        for live in (True, False):
            if mode == "cutoff":
                state = (sat, H, b, rep, yes if live else ~yes)
                op = torch.ops.ldso_tpu_torch.cutoff_trip
                plain = tracker.cutoff_trip_ref
            else:
                state = (stats, H, b, lam, ~yes if live else yes, cut)
                op = torch.ops.ldso_tpu_torch.lm_trip
                plain = tracker.lm_trip_ref
            got = op(*lead, *state, params, flow)
            if mode == "cutoff":
                t_args = args[:6] + (cfg.coarse_cutoff_th * got[3],) + args[7:]
                t_stats = got[0]
            else:
                t_args = args[:3] + (got[0], got[1]) + args[5:]
                t_stats = got[2]
                if live:     # the candidates, accepted or not
                    cand = _kernel_checks().lm_candidate(
                        cuda_kernels.lm_trip,
                        (ref, pyr, lvl, T, aff, expo, calib, cfg, flow), state)
                    t_args = args[:3] + (cand[0], cand[1]) + args[5:]
                    t_stats = cand[2]
            bound, bound_by, _ = trip_bound_ms(
                t_args, t_stats, mode, None if live else ~yes)
            key = f"{mode}_{'live' if live else 'idle'}"
            out[key] = dict(
                device_ms=_graph_device_ms(
                    lambda: op(*lead, *state, params, flow)),  # noqa: B023
                plain_ms=_median_event_ms(
                    lambda: plain(ref, pyr, lvl, T, aff, expo,  # noqa: B023
                                  *state, calib, cfg, flow)),  # noqa: B023
                bound_ms=bound, bound_by=bound_by)
    return out


def phase_trip_frame(fs, images, edges, by_mode):
    """K3 on phase 3's last frame against phase 3's last tracking
    reference, at every level and batch 1 and 8, from the previous frame's
    pose (the batch adds the retry batch's offsets): each mode's error
    against its plain version (the cutoff and lm modes from
    torch_kernel_checks.mode_state, with live, done and not-run members);
    the trip mode's single-call time through the wrapper (`ms`, CUDA
    events, median of 50, host time included, as the plain version's
    `plain_ms`), each mode's device time per launch (`device_ms`) with
    every member live and, for the cutoff and lm modes, with every member
    idle (the early exit), the bounds (trip_bound_ms) and their shares.
    Returns K3's kernel record, headed by level 0 at batch 1, with each
    mode's launches in phase 3's run (`by_mode`, counted as it ran).

    Why not the frame's own pose: phase 3's last frame is its last
    keyframe, so that pose is the identity, where the points on the
    reference's border pixels land exactly on the bounds (Ku = 2, Kv =
    h - 3) and each version's rounding decides them; and at a converged
    pose the pose entries of b are float32 noise in either version.

    `device_ms` is 20 launches of the operator captured in one CUDA graph
    (the captured tracker's setting), so the operator's host dispatch,
    which can exceed the kernel, does not enter it; `host_us` is the
    wrapper's synchronised wall time per call."""
    import torch
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kernel_checks()
    calib, cfg = fs.calib, fs.cfg
    k = len(images) - 1
    ref, pyr, _, expo, _, aff0 = _track_inputs(fs, images, k)
    shell = fs._current_tracker_ref()[1]
    T_start = torch.as_tensor(
        fs.all_frames[k - 1].T_cw @ np.linalg.inv(shell.T_cw),
        dtype=torch.float32, device=fs.device)
    rows, worst, bad = [], dict(edges), []
    for lvl in range(calib.levels):
        for B in TRIP_BATCHES:
            T = trip_poses(T_start, B)
            aff = aff0.expand(B, 2).contiguous()
            cut = torch.full((B,), cfg.coarse_cutoff_th, dtype=torch.float32,
                             device=T.device)
            flow = lvl == 0
            args = (ref, pyr, lvl, T, aff, expo, cut, calib, cfg, flow)
            got = cuda_kernels.tracker_trip(*args)
            want = tracker.tracker_trip_ref(*args)
            err, share, same_n = kc.trip_err(got, want,
                                             kc.trip_allowance(*args))
            worst["abs"] = max(worst["abs"], err)
            worst["share"] = max(worst["share"], share)
            if not (share <= 1.0 and same_n):
                bad.append(f"level {lvl} batch {B}: max|kernel - plain| "
                           f"{err}, {share:.3g} of the tolerance, numTerms "
                           f"{got[0][:, 1].tolist()} against "
                           f"{want[0][:, 1].tolist()}")
            m_err, m_share, faults, info = kc.mode_errs(
                cuda_kernels.cutoff_trip, cuda_kernels.lm_trip,
                tracker.tracker_trip_ref, *args)
            worst["modes_abs"] = max(worst.get("modes_abs", 0.0), m_err)
            worst["modes_share"] = max(worst.get("modes_share", 0.0),
                                       m_share)
            bad += [f"level {lvl} batch {B}: {f}" for f in faults]
            op_args = (ref.points[lvl], ref.valid[lvl], pyr.dI[lvl], T, aff,
                       ref.ref_aff, ref.ref_exposure, expo, cut,
                       cuda_kernels.trip_params(calib, lvl, cfg), flow)
            row = dict(
                level=lvl, batch=B, points=int(ref.points[lvl].shape[0]),
                valid=int(ref.valid[lvl].sum()),
                num_terms=[int(x) for x in got[0][:, 1].tolist()],
                max_abs_err=err, err_share=share, modes_max_abs_err=m_err,
                modes_err_share=m_share, floor_E=info["floor_E"],
                floor_b=info["floor_b"],
                ms=_median_event_ms(
                    lambda: cuda_kernels.tracker_trip(*args)),  # noqa: B023
                device_ms=_graph_device_ms(
                    lambda: torch.ops.ldso_tpu_torch.tracker_trip(  # noqa: B023
                        *op_args)),
                host_us=_host_us_per_call(
                    lambda: cuda_kernels.tracker_trip(*args),  # noqa: B023
                    n=200),
                plain_ms=_median_event_ms(
                    lambda: tracker.tracker_trip_ref(*args)))  # noqa: B023
            row["bound_ms"], row["bound_by"], row["pixels"] = trip_bound_ms(
                args, want[0])
            row.update(_mode_timings(*args, want))
            rows.append(row)
            print(f"K3 at level {lvl} ({pyr.dI[lvl].shape[1]}x"
                  f"{pyr.dI[lvl].shape[0]}, {row['valid']} of "
                  f"{row['points']} points valid), batch {B}: trip mode "
                  f"max|kernel - plain| {err:.6g} ({share:.4f} of the "
                  f"tolerance), cutoff and lm modes {m_err:.6g} "
                  f"({m_share:.4f}; floors {row['floor_E']:.4g} of E, "
                  f"{row['floor_b']:.4g} of max |b|); trip {row['ms']:.4f} "
                  f"ms per single "
                  f"call (wrapper, CUDA events, median of 50), "
                  f"{row['device_ms']:.4f} ms of device time per launch (20 "
                  f"in a CUDA graph, median of 30), wrapper host "
                  f"{row['host_us']:.1f} us per call; plain "
                  f"{row['plain_ms']:.4f} ms; bound "
                  f"{row['bound_ms'] * 1e3:.4f} us set by {row['bound_by']} "
                  f"({row['pixels']} level pixels gathered), "
                  f"{100 * row['bound_ms'] / row['device_ms']:.2f}% in device "
                  f"time", flush=True)
            for key in ("cutoff_live", "cutoff_idle", "lm_live", "lm_idle"):
                t = row[key]
                print(f"  K3 {key.replace('_', ' ')} at level {lvl}, batch "
                      f"{B}: {t['device_ms']:.5f} ms of device time per "
                      f"launch (20 in a CUDA graph), plain "
                      f"{t['plain_ms']:.4f} ms, bound "
                      f"{t['bound_ms'] * 1e3:.4f} us set by {t['bound_by']}, "
                      f"{100 * t['bound_ms'] / t['device_ms']:.2f}%",
                      flush=True)
    if bad:
        _fail("K3 on phase 3's last frame: " + "; ".join(bad))
    head = rows[0]
    modes = [dict(mode="trip", launches=by_mode["trip"],
                  device_ms=head["device_ms"], plain_ms=head["plain_ms"],
                  bound_ms=head["bound_ms"], bound_by=head["bound_by"])]
    for mode in ("cutoff", "lm"):
        live, idle = head[f"{mode}_live"], head[f"{mode}_idle"]
        modes.append(dict(
            mode=mode, launches=by_mode[mode], device_ms=live["device_ms"],
            idle_device_ms=idle["device_ms"], plain_ms=live["plain_ms"],
            idle_plain_ms=idle["plain_ms"], bound_ms=live["bound_ms"],
            bound_by=live["bound_by"], idle_bound_ms=idle["bound_ms"]))
    return dict(name="tracker_trip", route="cuda",
                source="ldso_tpu_torch/csrc/tracker_trip.cu",
                replaces="ldso_tpu/frontend/tracker.py:319",
                max_abs_err=max(worst["abs"], worst.get("modes_abs", 0.0)),
                max_err_share=max(worst["share"],
                                  worst.get("modes_share", 0.0)),
                ms=head["ms"], plain_ms=head["plain_ms"],
                device_ms=head["device_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=None, modes=modes,
                by_level=rows)


def _k3_check(what: str, launches: int, expected: int) -> None:
    """K3 ran on this path (its launches counted through graph replays),
    exactly as often as the path's tracker calls imply."""
    if not launches == expected > 0:
        _fail(f"{what}: K3 launched {launches} times, the tracker calls "
              f"imply {expected}")


def _k3_run_check(run: dict) -> None:
    what = f"{run.get('phase', run['mode'])}"
    _k3_check(what, run["k3_launches"], run["k3_expected"])
    if "k3_by_mode" in run and sum(run["k3_by_mode"].values()) != \
            run["k3_launches"]:
        _fail(f"{what}: K3's launches by mode {run['k3_by_mode']} do not "
              f"add up to its {run['k3_launches']} launches")


@contextlib.contextmanager
def recorded_frame_steps():
    """Yields a dict of lists: `tracks` gets, for each track inside, its
    inputs and outputs (ref, pyramid, (T_inits, aff, exposure,
    min_res_abort), calib, cfg, coarsest, outputs); `traces`, for each call
    of K4's wrapper (every trace of the arena), ((arena, dI, KRKis, Kts,
    affs, cfg), calib, output); `steps`, for each replay of the frame or
    the chain step's graph (full_system._program with FRAME_STEP_GRAPHS or
    CHAIN_STEP_GRAPHS), (family, static, program, inputs). The tracker's
    entry points (the retry batches) and FullSystem._trace_arena run
    Python and are recorded as they run. A replay runs none, so when the
    block ends each recorded step runs again as its eager program with the
    tracker's masked program (`tracker._track_batch`) and K4's wrapper
    recording, and the eager program's outputs must be bitwise the
    replay's (so the replay's track and trace gave the recorded outputs).
    The system writes none of the inputs in place."""
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.system import full_system as fsm
    rec = dict(tracks=[], traces=[], steps=[])
    outs = []
    track, batch = tracker._track, tracker._track_batch
    wrapper, program = cuda_kernels.trace_arena, fsm._program
    fams = (fsm.FRAME_STEP_GRAPHS, fsm.CHAIN_STEP_GRAPHS)

    def recording(fn):
        def recorded(ref, pyr, T, aff, expo, abort, calib, cfg, coarsest):
            out = fn(ref, pyr, T, aff, expo, abort, calib, cfg, coarsest)
            rec["tracks"].append((ref, pyr, (T, aff, expo, abort), calib,
                                  cfg, coarsest, out))
            return out
        return recorded

    def recorded_trace(arena, dI, KRKis, Kts, affs, calib, cfg):
        out = wrapper(arena, dI, KRKis, Kts, affs, calib, cfg)
        rec["traces"].append(((arena, dI, KRKis, Kts, affs, cfg), calib,
                              out))
        return out

    def recorded_step(family, static, fn, inputs):
        out = program(family, static, fn, inputs)
        if any(family is f for f in fams):
            rec["steps"].append((family, static, fn, tuple(inputs)))
            outs.append(out)
        return out
    tracker._track = recording(track)
    cuda_kernels.trace_arena = recorded_trace
    fsm._program = recorded_step
    try:
        yield rec
    finally:
        tracker._track = track
        cuda_kernels.trace_arena = wrapper
        fsm._program = program
    tracker._track_batch = recording(batch)
    cuda_kernels.trace_arena = recorded_trace
    try:
        for k, ((_, _, fn, inputs), out) in enumerate(zip(rec["steps"],
                                                          outs)):
            want = fn(*inputs)
            bad = [i for i, (g, w) in enumerate(zip(out, want))
                   if not _same(g, w)]
            if bad or len(out) != len(want):
                _fail(f"frame step {k}: the replay differs from its eager "
                      f"program in outputs {bad} of {len(want)}")
            outs[k] = None
    finally:
        tracker._track_batch = batch
        cuda_kernels.trace_arena = wrapper


def phase_main_path(n_frames: int = N_FRAMES):
    """Drive FullSystem.add_active_frame (strict) on the bench scene, on
    the package's default device (the card); returns the main
    path's kernel launch counts and the run's frames and numbers, which
    phases 5 and 6 reuse."""
    import torch
    from ldso_tpu_torch.examples import time_modes

    calib, poses, images = time_modes.bench_frames(n_frames)   # set-up
    torch.cuda.reset_peak_memory_stats()
    strict, fs = time_modes.run_mode("strict", calib, poses, images,
                                     gpu=time_modes.gpu_facts())
    if fs.device.type != "cuda":
        _fail(f"FullSystem(calib, cfg) runs on {fs.device}, not the card")
    if strict["lost"] or strict["init_failed"]:
        _fail(f"main path: lost={strict['lost']} "
              f"init_failed={strict['init_failed']}")
    launches = dict(distance_transform=strict["k1_launches"],
                    tracker_trip=strict["k3_launches"],
                    trace=strict["k4_launches"],
                    pyramid=strict["k2_launches"],
                    activate=strict["k5_launches"],
                    ba_linearize=strict["k6_launches"],
                    ba_accumulate=strict["k7_launches"])
    tracked = sum(1 for f in fs.all_frames if f.pose_valid)
    peak = torch.cuda.max_memory_allocated()
    print(f"main path: {n_frames} frames 640x480 uint8, "
          f"{strict['keyframes']} keyframes {strict['kf_ids']}, {tracked} "
          f"tracked, ATE {strict['ate_mm']:.4f} mm (sim3-aligned), "
          f"{strict['ms_per_frame_wall']:.2f} ms/frame wall, median "
          f"{strict['ms_per_frame_median']:.2f} ms per call, peak device "
          f"memory {peak / 2**20:.1f} MiB, K1 launches "
          f"{strict['k1_launches']} for {strict['post_bootstrap_keyframes']} "
          f"post-bootstrap keyframes, K2 launches {strict['k2_launches']} "
          f"for {strict['frame_steps']} frame steps and "
          f"{strict['boot_dispatches'] + 1} bootstrap frames, K3 launches "
          f"{strict['k3_launches']} "
          f"({strict['k3_by_mode']} by mode) for {strict['tracks']} tracks "
          f"and {strict['rank_calls']} rankings, K4 launches "
          f"{strict['k4_launches']} for {strict['frame_steps']} frame steps "
          f"({strict['traces']} traces of the arena committed) and "
          f"{strict['trace_calls']} other traces, K5 launches "
          f"{strict['k5_launches']} for "
          f"{strict['activations']} activations, K6 and K7 launches "
          f"{strict['k6_launches']} and {strict['k7_launches']} (all in "
          f"{strict['ba_replays']} BA and {strict['marg_replays']} "
          f"marginalization graph replays)", flush=True)
    if strict["keyframes"] < 8:
        _fail(f"only {strict['keyframes']} keyframes (need >= 8)")
    if not strict["ate_mm"] < ATE_BOUND_M * 1e3:
        _fail(f"ATE {strict['ate_mm']:.4f} mm >= {ATE_BOUND_M * 1e3} mm")
    if strict["k1_launches"] < strict["post_bootstrap_keyframes"]:
        _fail(f"K1 launched {strict['k1_launches']} times for "
              f"{strict['post_bootstrap_keyframes']} post-bootstrap keyframes")
    _no_capture_inside(strict)
    _k3_run_check(strict)
    _k2_run_check(strict)
    _k4_run_check(strict)
    _k5_run_check(strict)
    _k67_run_check(strict)
    return launches, calib, images, poses, strict, fs


def _same(a, b) -> bool:
    """Bitwise equality of two bool, 32-bit or 64-bit tensors (0-d ones
    too), NaN payloads included."""
    import torch
    if a.dtype == torch.bool:
        return bool(torch.equal(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(
        a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32)))


def _track_inputs(fs, images, k: int):
    """The tracker's inputs for frame k of a run against fs's current
    tracking reference: (ref, pyramid, T0, exposure, min_res_abort,
    aff0)."""
    import torch
    from ldso_tpu_torch.ops.preprocess import make_pyramid, upload_image
    ref, shell = fs._current_tracker_ref()
    L = fs.calib.levels
    pyr = make_pyramid(upload_image(images[k], fs.device), L, fs.b_grad)
    f32 = dict(dtype=torch.float32, device=fs.device)
    # the frame's tracked pose relative to the reference: a converged start
    T0 = torch.as_tensor(fs.all_frames[k].T_cw @ np.linalg.inv(shell.T_cw),
                         **f32)
    return (ref, pyr, T0, torch.ones((), **f32),
            torch.full((L,), 1e9, **f32), torch.zeros(2, **f32))


def _last_step(steps, family):
    """The last recorded step of `family` (recorded_frame_steps' `steps`):
    (static, program, inputs)."""
    for fam, static, fn, inputs in reversed(steps):
        if fam is family:
            return static, fn, inputs
    _fail("no step of the family was recorded")


def phase_tracker_graph(fs, images, tracks, steps):
    """3a. Hypothesis 0's track runs inside the frame step's graph: phase
    3's last frame-step replay against its eager program on the card,
    bitwise, K3 launched tracker.trips_per_track times and K4 once in
    each; the captured tracker (frontend/track_graph.py) at the retry
    path's batch against the eager masked function, bitwise, on the last
    frame of phase 3 against phase 3's last tracking reference; then the
    batch's device time per track (replays queued behind a sleeping
    kernel) beside the eager function's synchronised wall time at batch 1,
    and the aten operations of one eager track (fewer than
    MAX_TRACK_OPS); then phase 3's tracks through the plain tracker
    (phase_plain_tracker). Returns the numbers."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from ldso_tpu_torch.frontend import track_graph, tracker
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.system import full_system as fsm
    from ldso_tpu_torch.system.full_system import RETRY_K
    calib, cfg = fs.calib, fs.cfg
    L = calib.levels
    trips = tracker.trips_per_track(cfg, L, L - 1)
    fam = fsm.FRAME_STEP_GRAPHS
    static, fn, inputs = _last_step(steps, fam)
    outs = {}
    for name, run in (("replay", lambda: fam.replay(static, fn, inputs)),
                      ("eager", lambda: fn(*inputs))):
        cuda_kernels.reset_launch_counts()
        outs[name] = run()
        _k3_check(f"3a frame step {name}",
                  cuda_kernels.LAUNCHES["tracker_trip"], trips)
        if cuda_kernels.LAUNCHES["trace"] != 1:
            _fail(f"3a frame step {name}: K4 launched "
                  f"{cuda_kernels.LAUNCHES['trace']} times")
    torch.cuda.synchronize()
    bad = [i for i, (g, e) in enumerate(zip(outs["replay"], outs["eager"]))
           if not _same(g, e)]
    if bad:
        _fail(f"3a: the frame step's replay differs from its eager program "
              f"in outputs {bad}")
    print(f"tracker graph: the frame step's replay (hypothesis 0 at batch 1) "
          f"equals its eager program bitwise ({len(outs['eager'])} "
          f"outputs); K3 launched {trips} times and K4 once in each",
          flush=True)
    ref, pyr, T_last, expo, abort, aff0 = _track_inputs(fs, images,
                                                        len(images) - 1)
    rng = np.random.RandomState(5)
    T_b = T_last.expand(RETRY_K, 4, 4).clone()
    T_b[1:, :3, 3] += torch.as_tensor(rng.randn(RETRY_K - 1, 3) * 0.01,
                                      dtype=torch.float32, device=fs.device)
    name = f"batch {RETRY_K}"
    cuda_kernels.reset_launch_counts()
    graph = tracker.track_frame_hypotheses(ref, pyr, T_b, aff0, expo, abort,
                                           calib, cfg, L - 1)
    _k3_check(f"3a {name} graph replay",
              cuda_kernels.LAUNCHES["tracker_trip"], trips)
    cuda_kernels.reset_launch_counts()
    eager = tracker._track_batch(ref, pyr, T_b, aff0, expo, abort, calib,
                                 cfg, L - 1)
    _k3_check(f"3a {name} eager", cuda_kernels.LAUNCHES["tracker_trip"],
              trips)
    torch.cuda.synchronize()
    for i, (g, e) in enumerate(zip(graph, eager)):
        if not _same(g, e):
            _fail(f"tracker graph: {name}: output {i} differs from the "
                  f"eager function")
    print(f"tracker graph: {name}: graph replay equals the eager masked "
          f"function bitwise (5 outputs); K3 launched {trips} times in "
          f"each", flush=True)

    def replay_b():
        return tracker.track_frame_hypotheses(ref, pyr, T_b, aff0, expo, abort,
                                              calib, cfg, L - 1)

    def eager():
        return tracker._track_batch(ref, pyr, T_last[None], aff0, expo, abort,
                                    calib, cfg, L - 1)

    class Count(TorchDispatchMode):
        n = views = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            Count.views += int(func.is_view)
            return func(*args, **(kwargs or {}))

    with Count():
        eager()
    out = dict(step_bitwise=True,
               device_ms_batch=_queued_device_ms(replay_b, n=4, reps=5),
               device_ms_batch_fixed_sleep=_queued_device_ms(
                   replay_b, n=4, reps=5, sleep_cycles=FIXED_SLEEP_CYCLES),
               eager_ms=1e3 * _host_us_per_call(eager, n=3) / 1e6,
               ops=Count.n, view_ops=Count.views,
               captures=track_graph.CAPTURES["count"],
               capture_s=track_graph.CAPTURES["s"])
    print(f"tracker graph at {calib.w[0]}x{calib.h[0]}, {L} levels: "
          f"{out['device_ms_batch']:.4f} ms of device time per track at "
          f"batch {RETRY_K} (4 replays queued, median of 5; behind a fixed "
          f"sleep of {FIXED_SLEEP_CYCLES} cycles: "
          f"{out['device_ms_batch_fixed_sleep']:.4f} ms); the eager masked "
          f"function at batch 1 {out['eager_ms']:.2f} "
          f"ms per track (synchronised wall, 3 calls); {out['ops']} aten "
          f"operations per eager track, {out['view_ops']} of them views; "
          f"{out['captures']} tracker graphs captured so far in "
          f"{out['capture_s']:.2f} s", flush=True)
    if not out["ops"] < MAX_TRACK_OPS:
        _fail(f"3a: {out['ops']} aten operations per eager track (the trips "
              f"should leave fewer than {MAX_TRACK_OPS})")
    out["against_plain"] = phase_plain_tracker(tracks)
    return out


# the captured tracker against the plain tracker on the card over phase 3's
# tracks, stated before the first run of K3's cutoff and lm modes: the LM
# amplifies float32 rounding (the step's solve, the trip's sums, an accept
# test between two energies that agree to their rounding), so T is held to
# tests/test_torch_tracker.py::test_track_frame's 1e-4 and aff to its
# 1e-3, the residuals and flow to 1e-3 relative (1e-4 absolute), and every
# ok flag must be equal
PLAIN_T_TOL = 1e-4
PLAIN_AFF_TOL = 1e-3
PLAIN_RES_RTOL = 1e-3
PLAIN_RES_ATOL = 1e-4
# aten operations per eager track once each trip is one K3 launch
MAX_TRACK_OPS = 2000


@contextlib.contextmanager
def plain_trips(live):
    """Every trip of the tracker through its plain version (the CPU's
    route), as the tests patch it. Each cutoff and lm trip adds to `live`
    (an int64 tensor (4,) on the card, no host read) what K3 would run in
    full, from the plain version's flags: [cutoff trips with a member to
    double (run, over 60% saturated, under the limit), those members, lm
    trips with a member not done, those members]. K3 exits at once for
    the other members."""
    import torch
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.ops import cuda_kernels
    saved = (cuda_kernels.tracker_trip, cuda_kernels.cutoff_trip,
             cuda_kernels.lm_trip)

    def count(at, members):
        live[at:at + 2] += torch.stack([members.any().long(), members.sum()])

    def cutoff(*a, **k):
        stats, rep, run = a[6], a[9], a[10]
        count(0, (stats[:, 5] > 0.6) & (rep < tracker._CUTOFF_LIMIT) & run)
        return tracker.cutoff_trip_ref(*a, **k)

    def lm(*a, **k):
        count(2, ~a[10])
        return tracker.lm_trip_ref(*a, **k)
    cuda_kernels.tracker_trip = tracker.tracker_trip_ref
    cuda_kernels.cutoff_trip = cutoff
    cuda_kernels.lm_trip = lm
    try:
        yield
    finally:
        (cuda_kernels.tracker_trip, cuda_kernels.cutoff_trip,
         cuda_kernels.lm_trip) = saved


def _plain_track(ref, pyr, xs, calib, cfg, coarsest):
    """The masked tracker with the plain trips, replayed from a CUDA graph
    of its own (captured at its key's first call), on a track's inputs.
    Returns (its outputs, its live trips as plain_trips counts them)."""
    import torch
    from ldso_tpu_torch.frontend import track_graph, tracker
    from ldso_tpu_torch.ops.preprocess import FramePyramid
    L, P = len(ref.points), len(pyr.dI)

    def program(*x):
        r = tracker.TrackerRef(points=x[:L], valid=x[L:2 * L],
                               ref_exposure=x[2 * L], ref_aff=x[2 * L + 1])
        p = FramePyramid(dI=x[2 * L + 2:2 * L + 2 + P], abs_grad=())
        live = torch.zeros(4, dtype=torch.int64, device=x[0].device)
        with plain_trips(live):
            out = tracker._track_batch(r, p, *x[2 * L + 2 + P:], calib, cfg,
                                       coarsest)
        return (*out, live)
    inputs = (*ref.points, *ref.valid, ref.ref_exposure, ref.ref_aff,
              *pyr.dI, *xs)
    out = track_graph.replay(("plain", calib, tracker.graph_key(cfg),
                              coarsest, L, P), program, inputs)
    return out[:-1], out[-1]


def phase_plain_tracker(tracks):
    """3a: every track of phase 3 (inputs and outputs recorded as it ran,
    recorded_tracks) again through the plain tracker on the card, from the
    same inputs: every ok flag equal, T, aff, residuals and flow within
    PLAIN_*; and the trips per track that K3 runs in full, counted from the
    plain version's flags (plain_trips). Returns the worst differences and
    the live trips per track."""
    import torch
    worst = dict(T=0.0, aff=0.0, res=0.0, flow=0.0)
    bad, members = [], 0
    live = torch.zeros(4, dtype=torch.int64, device="cuda")
    for k, (ref, pyr, xs, calib, cfg, coarsest, got) in enumerate(tracks):
        want, live_k = _plain_track(ref, pyr, xs, calib, cfg, coarsest)
        live = live + live_k
        members += int(want[0].shape[0])
        if not torch.equal(got[2], want[2]):
            bad.append(f"track {k}: ok {got[2].tolist()} against "
                       f"{want[2].tolist()}")
        d = {"T": torch.abs(got[0] - want[0]),
             "aff": torch.abs(got[1] - want[1])}
        for name, i in (("res", 3), ("flow", 4)):
            g, w = got[i], want[i]
            same = (torch.isnan(g) & torch.isnan(w)) | (g == w)
            diff = torch.where(same, torch.zeros_like(g),
                               torch.nan_to_num(torch.abs(g - w),
                                                nan=float("inf")))
            d[name] = diff / (PLAIN_RES_RTOL * torch.nan_to_num(
                torch.abs(w), nan=0.0, posinf=0.0) + PLAIN_RES_ATOL)
        for name, x in d.items():
            worst[name] = max(worst[name], float(x.max()))
    torch.cuda.synchronize()
    n = max(len(tracks), 1)
    live = live.tolist()
    res = dict(tracks=len(tracks), members=members, max_T_err=worst["T"],
               max_aff_err=worst["aff"], res_err_share=worst["res"],
               flow_err_share=worst["flow"], ok_flags_equal=not bad,
               live_per_track=dict(
                   cutoff_trips=live[0] / n, cutoff_members=live[1] / n,
                   lm_trips=live[2] / n, lm_members=live[3] / n))
    print(f"3a: the captured tracker (K3's trip, cutoff and lm modes) "
          f"against the plain tracker on the card over phase 3's "
          f"{len(tracks)} tracks ({members} members): max |dT| "
          f"{worst['T']:.3g} (tol {PLAIN_T_TOL}), max |daff| "
          f"{worst['aff']:.3g} (tol {PLAIN_AFF_TOL}), residuals at most "
          f"{worst['res']:.3g} and flow {worst['flow']:.3g} of their "
          f"tolerance ({PLAIN_RES_RTOL} relative + {PLAIN_RES_ATOL}), ok "
          f"flags equal: {not bad}; live trips per track (the plain "
          f"version's flags): {res['live_per_track']}", flush=True)
    if bad:
        _fail("3a against the plain tracker: " + "; ".join(bad))
    if not (worst["T"] <= PLAIN_T_TOL and worst["aff"] <= PLAIN_AFF_TOL
            and worst["res"] <= 1.0 and worst["flow"] <= 1.0):
        _fail(f"3a against the plain tracker: {res}")
    return res


def _sleep_cycles_per_ms() -> float:
    from ldso_tpu_torch.examples.bench import sleep_cycles_per_ms
    return sleep_cycles_per_ms()


def phase_dispatch_ahead(fs, images, sleep_ms: float = 50.0):
    """3b. track_chain_dispatch runs ahead of the card: with ~50 ms of
    sleep queued on a tracking stream, a dispatch under
    torch.cuda.set_sync_debug_mode("error") returns in well under the sleep
    with its HostCopy not ready, and its packed result equals bitwise a
    dispatch of the same frame from the same chain with no sleep. Each
    dispatch is one replay of the chain step's graph (CHAIN_STEP_GRAPHS,
    none captured) and one HostCopy, and the replay's outputs (the
    pyramid, the packed row, the new chain) are bitwise its eager
    program's."""
    import torch
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.slam_map import FrameShell
    from ldso_tpu_torch.system import full_system as fsm
    from ldso_tpu_torch.utils import device as devm
    k = len(images) - 1
    cuda_kernels.reset_launch_counts()
    fam = fsm.CHAIN_STEP_GRAPHS
    counts0 = dict(fam.counts)
    program, host_copy = fsm._program, devm.HostCopy
    steps, pulls = [], []

    def recorded(family, static, fn, inputs):
        out = program(family, static, fn, inputs)
        if family is fam:
            steps.append((static, fn, tuple(inputs), out))
        return out

    def counted_copy(t):
        pulls.append(t)
        return host_copy(t)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    cycles = int(_sleep_cycles_per_ms() * sleep_ms)
    fsm._program, fsm.HostCopy = recorded, counted_copy
    try:
        with torch.cuda.stream(stream):
            fs.chain_reset()
            chain = fs.track_chain
            _, first, _ = fs.track_chain_dispatch(FrameShell(id=k), images[k])
            want = first.numpy().copy()
            fs.track_chain = chain
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            torch.cuda.set_sync_debug_mode("error")
            try:
                t = time.perf_counter()
                _, packed, _ = fs.track_chain_dispatch(FrameShell(id=k),
                                                       images[k])
                call_ms = (time.perf_counter() - t) * 1e3
                ready = packed.is_ready()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            got = packed.numpy()
    finally:
        fsm._program, fsm.HostCopy = program, host_copy
    torch.cuda.synchronize()
    L = fs.calib.levels
    _k3_check("3b dispatch ahead (two dispatches)",
              cuda_kernels.LAUNCHES["tracker_trip"],
              2 * tracker.trips_per_track(fs.cfg, L, L - 1))
    _k2_check("3b dispatch ahead (two dispatches)",
              cuda_kernels.LAUNCHES["pyramid"], 2)
    replays = fam.counts["replays"] - counts0["replays"]
    captures = fam.counts["count"] - counts0["count"]
    if not (replays == len(steps) == len(pulls) == 2 and captures == 0):
        _fail(f"3b: two chain dispatches made {replays} replays of the chain "
              f"step's graph ({captures} captured) and {len(pulls)} "
              f"HostCopys")
    bad = []
    for static, fn, inputs, out in steps:
        want_e = fn(*inputs)
        bad += [i for i, (g, w) in enumerate(zip(out, want_e))
                if not _same(g, w)]
    print(f"dispatch ahead: track_chain_dispatch returned in {call_ms:.3f} ms "
          f"under set_sync_debug_mode('error') behind {sleep_ms:.0f} ms of "
          f"queued sleep; HostCopy ready on return: {ready}; packed result "
          f"bitwise equal to the dispatch without sleep: "
          f"{got.tobytes() == want.tobytes()}; each dispatch one replay of "
          f"the chain step's graph and one HostCopy, each replay bitwise "
          f"its eager program: {not bad}", flush=True)
    if not call_ms < sleep_ms / 2:
        _fail(f"dispatch ahead: the call took {call_ms:.3f} ms")
    if ready:
        _fail("dispatch ahead: the HostCopy was ready before the sleep ended")
    if got.tobytes() != want.tobytes():
        _fail("dispatch ahead: the result differs from the one without sleep")
    if bad:
        _fail(f"3b: the chain step's replay differs from its eager program in "
              f"outputs {sorted(set(bad))}")
    fs.chain_reset()
    return call_ms


def phase_checkpoint(fs, root: str):
    """save_all to .bin (the reference's binary layout) and to .npz, then
    load_all into a fresh system of the same configuration: keyframe ids and
    T_cw must come back exactly (both formats store float64)."""
    import os
    from ldso_tpu_torch.system.full_system import FullSystem
    os.makedirs(root, exist_ok=True)
    kfs = fs.global_map.get_all_kfs()
    for ext in (".bin", ".npz"):
        path = os.path.join(root, "map" + ext)
        fs.save_all(path)
        back = FullSystem(fs.calib, fs.cfg, device=fs.device)
        back.load_all(path)
        got = back.global_map.get_all_kfs()
        same = ([k.kf_id for k in got] == [k.kf_id for k in kfs]
                and [k.id for k in got] == [k.id for k in kfs]
                and all(a.T_cw.tobytes() == b.T_cw.tobytes()
                        for a, b in zip(got, kfs)))
        print(f"checkpoint: {ext} of {os.path.getsize(path)} bytes, "
              f"{len(got)} keyframes back, ids and T_cw bitwise equal: "
              f"{same}", flush=True)
        if not same:
            _fail(f"checkpoint: {ext} did not round-trip the keyframes")


def phase_boxes(n_frames: int = BOX_FRAMES):
    """The boxes scene (BoxScene, the multi-depth occlusion family) at
    640x480 on the straight trajectory of the boxes head-to-head, strict,
    with the CLI's mode=1 changes and loop closing off; keyframe ATE under
    5 mm. Returns the run."""
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.examples import time_modes
    from ldso_tpu_torch.synthetic import default_calib, make_scene
    import torch
    calib = default_calib(640, 480)
    scene = make_scene("boxes", freq_hi=25.0, contrast=80.0, n_waves=32)
    poses = straight_poses(n_frames)
    images = []
    for T in poses:                      # rendering is set-up
        img, _ = scene.render(calib, T, device="cuda")
        images.append(torch.clamp(torch.round(img), 0, 255).to(torch.uint8)
                      .cpu().numpy())
    cfg = dataclasses.replace(Config(), enable_loop_closing=False,
                              photometric_calibration=0,
                              affine_opt_mode_a=0.0, affine_opt_mode_b=0.0)
    run, fs = time_modes.run_mode("strict", calib, poses, images, cfg=cfg,
                                  gpu=time_modes.gpu_facts())
    print(f"boxes: {n_frames} frames 640x480 uint8, {run['keyframes']} "
          f"keyframes {run['kf_ids']}, keyframe ATE {run['ate_kf_mm']:.4f} mm, "
          f"all-frames ATE {run['ate_mm']:.4f} mm (sim3-aligned), "
          f"{run['ms_per_frame_wall']:.2f} ms/frame wall, K1 launches "
          f"{run['k1_launches']} for {run['post_bootstrap_keyframes']} "
          f"post-bootstrap keyframes, K3 launches {run['k3_launches']}",
          flush=True)
    if run["lost"] or run["init_failed"]:
        _fail(f"boxes: lost={run['lost']} init_failed={run['init_failed']}")
    _no_capture_inside(run)
    run["phase"] = "4b boxes"
    _k3_run_check(run)
    _k2_run_check(run)
    _k4_run_check(run)
    _k5_run_check(run)
    _k67_run_check(run)
    if not run["ate_kf_mm"] < ATE_BOUND_M * 1e3:
        _fail(f"boxes: keyframe ATE {run['ate_kf_mm']:.4f} mm >= "
              f"{ATE_BOUND_M * 1e3} mm")
    if not run["k1_launches"] == run["post_bootstrap_keyframes"] > 0:
        _fail(f"boxes: K1 launched {run['k1_launches']} times for "
              f"{run['post_bootstrap_keyframes']} post-bootstrap keyframes")
    return run


def _no_capture_inside(run: dict) -> None:
    """The tracker's, the frame and chain steps', the device LM's, the
    point marginalization's and the keyframe programs' graphs are captured
    when the FullSystem is built, never inside a timed run; with the
    device LM, each
    BA call of the run is one replay with one K12 launch."""
    what = run.get("phase", run["mode"])
    kf = {k: run[k] for k in run if k.endswith("_captures") and k.split(
        "_captures")[0] in KF_PROGRAMS + ("activate", "frame_step",
                                          "chain_step")}
    if run["graph_captures"] or run["ba_captures"] or run["marg_captures"] \
            or any(kf.values()):
        _fail(f"{what}: {run['graph_captures']} tracker and step graphs, "
              f"{run['ba_captures']} BA graphs, {run['marg_captures']} "
              f"marginalization graphs and the keyframe programs' and "
              f"steps' {kf} were captured inside the timed run")
    # the bootstrap's graph: captured at the first frame if at all (its
    # level capacities are set_first's), one replay and one pull a frame
    if set(run["init_capture_frames"]) - {0} or not (
            run["init_replays"] == run["boot_dispatches"]
            == run["boot_pulls"] > 0):
        _fail(f"{what}: the bootstrap's graph captured at frames "
              f"{run['init_capture_frames']}, {run['init_replays']} replays "
              f"for {run['boot_dispatches']} bootstrap frames and "
              f"{run['boot_pulls']} pulls")
    if run["k12_launches"] != run["ba_replays"]:
        _fail(f"{what}: K12 launched {run['k12_launches']} times for "
              f"{run['ba_replays']} BA graph replays")


def _mode_line(run: dict) -> str:
    keys = ("mode", "interval_ms", "frames", "keyframes", "ate_mm",
            "ms_per_frame_median",
            "ms_per_frame_wall", "wall_s", "k1_launches", "k1_streams",
            "k3_launches", "tracks", "rank_calls", "k4_launches",
            "k4_expected", "traces", "frame_step_replays",
            "chain_step_replays",
            "k5_launches", "activations", "post_bootstrap_keyframes",
            "retrack_trips", "lm_frames",
            "graph_captures", "ba_replays", "k12_launches", "k6_launches",
            "k7_launches", "marg_replays", "gpu")
    return json.dumps({k: run[k] for k in keys})


def phase_pipelines(calib, images, poses, strict: dict, device="cuda"):
    """Phase 5: the phase-3 frames through DeterministicPipeline twice and
    AsyncPipeline twice, by phase 3's runner: as fast as the caller takes
    them, and then one frame per ASYNC_PACE times strict's wall ms per
    frame in phase 3, a rate at which this card maps the frames. Async's
    keyframes depend on how far tracking runs ahead of mapping (a frame
    becomes a keyframe only when the mapping queue is empty behind it,
    FullSystem.cc:1825-1864), so the paced run is the one held to >= 8
    keyframes, and the
    unpaced run to the ASYNC_BOOTSTRAP_KEYFRAMES that the pipeline
    guarantees whatever the queue (tests/async_keyframe_witness.py: with
    tracking ahead, the JAX package's AsyncPipeline keeps just those on
    32 frames). Prints one JSON line per run (strict is phase 3's).
    Returns (lookahead, lookahead, async, paced async)."""
    from ldso_tpu_torch.examples import time_modes
    gpu = strict["gpu"]
    runs, poses_of = [], []
    paced_s = ASYNC_PACE * strict["ms_per_frame_wall"] / 1e3
    for mode, interval_s in (("lookahead", 0.0), ("lookahead", 0.0),
                             ("async", 0.0), ("async", paced_s)):
        run, fs = time_modes.run_mode(mode, calib, poses, images, gpu=gpu,
                                      device=device, interval_s=interval_s)
        if run["lost"] or run["init_failed"]:
            _fail(f"pipelines: {mode}: lost={run['lost']} "
                  f"init_failed={run['init_failed']}")
        _no_capture_inside(run)
        if device == "cuda":
            _k3_run_check(run)
            _k2_run_check(run)
            _k4_run_check(run)
            _k5_run_check(run)
            _k67_run_check(run)
        runs.append(run)
        poses_of.append([f.T_cw.tobytes() for f in fs.all_frames])
    look1, look2, asyn, paced = runs
    print(f"pipelines: lookahead keyframes {look1['kf_ids']} and "
          f"{look2['kf_ids']}, async {asyn['kf_ids']}, async fed every "
          f"{paced['interval_ms']:.2f} ms {paced['kf_ids']}; K1 launches by stream in async "
          f"{asyn['k1_streams']} and {paced['k1_streams']}", flush=True)
    if look1["kf_ids"] != look2["kf_ids"] or poses_of[0] != poses_of[1]:
        _fail("pipelines: two lookahead runs are not bitwise identical")
    for run, floor in ((look1, 8), (paced, 8),
                       (asyn, ASYNC_BOOTSTRAP_KEYFRAMES)):
        if run["keyframes"] < floor:
            _fail(f"pipelines: {run['mode']} (fed every "
                  f"{run['interval_ms']:.2f} ms) made {run['keyframes']} "
                  f"keyframes (need >= {floor})")
    for run in (look1, asyn, paced):
        if not run["ate_mm"] < ATE_BOUND_M * 1e3:
            _fail(f"pipelines: {run['mode']} ATE {run['ate_mm']:.4f} mm >= "
                  f"{ATE_BOUND_M * 1e3} mm")
    if device == "cuda":
        for run in (strict, look1, look2, asyn, paced):
            if not (run["k1_launches"] == run["post_bootstrap_keyframes"]
                    and run["k1_launches"] > 0):
                _fail(f"pipelines: {run['mode']}: K1 launched "
                      f"{run['k1_launches']} times for "
                      f"{run['post_bootstrap_keyframes']} post-bootstrap "
                      f"keyframes")
        for run in (asyn, paced):
            if run["k1_streams"] != {"mapping": run["k1_launches"]}:
                _fail(f"pipelines: async K1 launches by stream "
                      f"{run['k1_streams']}, not all on the mapping "
                      f"thread's")
    for run in (strict, look1, look2, asyn, paced):
        print(_mode_line(run), flush=True)
    return look1, look2, asyn, paced


def write_kitti_sequence(seq: str, calib, images):
    """`images` as a KITTI sequence (image_0/%06d.png with the port's PNG
    writer, times.txt, a pinhole camera.txt with `none` rectification)."""
    import os
    import shutil
    from ldso_tpu_torch.io.png import write_png
    shutil.rmtree(seq, ignore_errors=True)
    os.makedirs(os.path.join(seq, "image_0"))
    for i, img in enumerate(images):
        write_png(os.path.join(seq, "image_0", f"{i:06d}.png"), img)
    with open(os.path.join(seq, "times.txt"), "w") as f:
        f.writelines(f"{i * 0.05:.6f}\n" for i in range(len(images)))
    with open(os.path.join(seq, "camera.txt"), "w") as f:
        f.write(f"Pinhole {calib.fx[0]} {calib.fy[0]} {calib.cx[0]} "
                f"{calib.cy[0]} 0\n{calib.w[0]} {calib.h[0]}\nnone\n"
                f"{calib.w[0]} {calib.h[0]}\n")


def phase_cli(calib, images, poses, root: str, device="cuda"):
    """Phase 6: the phase-3 frames written as a KITTI sequence with the
    port's PNG writer, then the port's CLI run on it with pipeline=lookahead
    and with pipeline=async (loop closing off, preset 0, the KITTI runner's
    mode=1; the async reader hands the mapping thread frames made on the
    card). Checks both trajectory files of each run, their rotations, the
    keyframe ATE, and K1's launches (async: all on the mapping thread, on
    one stream that is not the caller's). Returns K1's launches per mode."""
    import os
    import torch
    from ldso_tpu_torch.examples import run_common, time_modes
    from ldso_tpu_torch.io.trajectory import ate_rmse
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.system import full_system as fsm
    seq = os.path.join(root, "kitti_00")
    t0 = time.time()
    write_kitti_sequence(seq, calib, images)
    print(f"cli: wrote {len(images)} PNG frames in {time.time() - t0:.2f} s",
          flush=True)
    caller = (torch.cuda.current_stream().cuda_stream if device == "cuda"
              else None)
    out_launches = {}
    for pmode in ("lookahead", "async"):
        out = os.path.join(seq, f"results_{pmode}.txt")
        argv = [f"files={seq}", f"calib={os.path.join(seq, 'camera.txt')}",
                "preset=0", "mode=1", "loopclosing=0", f"pipeline={pmode}",
                "quiet=1", f"output={out}"]
        if pmode == "lookahead":
            argv += ["nogui=0", "viewer_port=0"]    # the live viewer
        t0 = time.time()
        with time_modes.traced_k1() as k1, \
                time_modes.counted_tracks() as tracks, \
                time_modes.counted_traces() as traces, \
                time_modes.counted_pyramids() as pyrs:
            cuda_kernels.reset_launch_counts()
            act_caps = fsm.ACTIVATE_GRAPHS.counts["count"]
            with k67_counted() as k67:
                fs = run_common.run(run_common.parse_args(argv), "kitti",
                                    kitti_output=True, device=device)
            # the activation graphs the run's FullSystem captured when it
            # was built ran K1 and K5 once each, eagerly, before capture
            act_caps = fsm.ACTIVATE_GRAPHS.counts["count"] - act_caps
            launches = cuda_kernels.LAUNCHES["distance_transform"] - act_caps
            k3 = cuda_kernels.LAUNCHES["tracker_trip"]
            k12 = cuda_kernels.LAUNCHES["ba_projector"]
            k4 = cuda_kernels.LAUNCHES["trace"]
            k2 = cuda_kernels.LAUNCHES["pyramid"]
            rect = cuda_kernels.LAUNCHES["rectify"]
            k5 = cuda_kernels.LAUNCHES["activate"] - act_caps
            k67.update(k6_launches=cuda_kernels.LAUNCHES["ba_linearize"],
                       k7_launches=cuda_kernels.LAUNCHES["ba_accumulate"],
                       phase=f"cli {pmode}")
        wall = time.time() - t0
        if fs.device.type != device:
            _fail(f"cli {pmode}: ran on {fs.device}, not {device}")
        if fs.is_lost:
            _fail(f"cli {pmode}: lost")
        for path in (out, out + ".noloop"):
            if not os.path.exists(path):
                _fail(f"cli {pmode}: {path} was not written")
        rows = [r.split() for r in open(out) if r.strip()]
        est, gt = [], []
        for r in rows:
            M = np.array([float(x) for x in r[1:]]).reshape(3, 4)
            err = float(np.abs(M[:, :3] @ M[:, :3].T - np.eye(3)).max())
            # the poses are float32 products that compound along the
            # keyframe chain: |RR^T - I| reaches ~1e-4 within 64 frames
            if not (len(r) == 13 and err < ORTHO_BOUND):
                _fail(f"cli {pmode}: row of frame {r[0]} is not a rotation "
                      f"(|RR^T - I| = {err})")
            T_wc = np.eye(4)
            T_wc[:3] = M
            est.append(np.linalg.inv(T_wc))
            gt.append(poses[int(r[0])])
        ate = ate_rmse(est, gt)
        post_boot = sum(1 for kf in fs.global_map.get_all_kfs()
                        if kf.kf_id >= 2)
        print(f"cli {pmode}: {len(rows)} keyframe rows in {out} and "
              f".noloop, keyframe ATE {ate * 1e3:.4f} mm, {wall:.2f} s, K1 "
              f"launches {launches} for {post_boot} post-bootstrap keyframes, "
              f"by (thread, stream) {dict(k1)}; K3 launches {k3} for "
              f"{tracks['tracks']} tracks, {tracks['ranks']} rankings and "
              f"{tracks['captures']} captures; K4 launches {k4} for "
              f"{traces['k4_expected']} expected ({traces['traces']} traces "
              f"committed); K2 {k2} pyramid launches for "
              f"{pyrs['k2_expected']} expected and {rect} rectify launches "
              f"for {len(images)} frames read; K5 launches {k5}", flush=True)
        if not ate < ATE_BOUND_M:
            _fail(f"cli {pmode}: keyframe ATE {ate * 1e3:.4f} mm >= "
                  f"{ATE_BOUND_M * 1e3} mm")
        if device == "cuda":
            _k3_check(f"cli {pmode}", k3, time_modes.k3_expected(
                tracks, fs.cfg, fs.calib.levels))
            _k4_check(f"cli {pmode}", k4, traces["k4_expected"],
                      traces["traces"])
            _k2_check(f"cli {pmode}", k2, pyrs["k2_expected"])
            if rect != len(images):
                _fail(f"cli {pmode}: K2's rectify launched {rect} times for "
                      f"{len(images)} frames read")
            _k5_check(f"cli {pmode}", k5, post_boot)
            k67["post_bootstrap_keyframes"] = post_boot
            _k67_run_check(k67, built=1)
            if not launches == post_boot > 0:
                _fail(f"cli {pmode}: K1 launched {launches} times for "
                      f"{post_boot} post-bootstrap keyframes")
            streams = {s for _, s in k1}
            if pmode == "async" and not (
                    {t for t, _ in k1} == {"ldso-mapping"}
                    and len(streams) == 1 and caller not in streams):
                _fail(f"cli async: K1 launches by (thread, stream) "
                      f"{dict(k1)}, not all on the mapping thread's stream")
        out_launches[pmode] = launches
        out_launches[f"k3_{pmode}"] = k3
        out_launches[f"k12_{pmode}"] = k12
        out_launches[f"k4_{pmode}"] = k4
        out_launches[f"k2_{pmode}"] = k2
        out_launches[f"rectify_{pmode}"] = rect
        out_launches[f"k5_{pmode}"] = k5
        out_launches[f"k6_{pmode}"] = k67["k6_launches"]
        out_launches[f"k7_{pmode}"] = k67["k7_launches"]
        if fs.viewer is not None:
            check_viewer(fs.viewer, len(rows), (calib.h[0], calib.w[0]))
    return out_launches


def check_viewer(viewer, n_rows: int, shape):
    """The CLI run's live viewer, over HTTP on localhost: /state counts the
    keyframe rows of results.txt, /frame is a PNG of the frame's shape
    (decoded by io/png.py). Stops the viewer."""
    import urllib.request
    from ldso_tpu_torch.io.png import decode_png
    base = f"http://127.0.0.1:{viewer.port}"
    try:
        with urllib.request.urlopen(base + "/state", timeout=30) as r:
            state = json.loads(r.read())
        with urllib.request.urlopen(base + "/frame", timeout=30) as r:
            frame = decode_png(r.read())
    finally:
        viewer.stop()
    print(f"viewer: /state frame {state['frame_id']}, {state['n_kfs']} "
          f"keyframes, {len(state['points'])} points, "
          f"{len(state['traj_odo'])} poses; /frame a {frame.shape} "
          f"{frame.dtype} PNG", flush=True)
    if state["n_kfs"] != n_rows:
        _fail(f"viewer: /state has {state['n_kfs']} keyframes, results.txt "
              f"{n_rows} rows")
    if frame.shape != shape:
        _fail(f"viewer: /frame is {frame.shape}, not {shape}")


def straight_poses(n: int):
    """The straight head-to-head trajectory, camera-from-world (a copy of
    tools/head_to_head.py:34-43, straight_poses)."""
    from ldso_tpu_torch.math import lie_np
    poses = []
    for i in range(n):
        t = np.array([0.03 * i, 0.01 * np.sin(0.2 * i), 0.004 * i])
        w = np.array([0.0, 0.0018 * i, 0.0004 * i])
        poses.append(np.linalg.inv(lie_np.se3_exp(np.concatenate([t, w]))))
    return poses


def revisit_poses(n: int):
    """Out-and-back with constant heading, camera-from-world (a copy of
    tools/head_to_head.py:46-59, revisit_poses)."""
    half = n // 2
    xs = np.concatenate([np.linspace(0.0, 0.03 * half, half),
                         np.linspace(0.03 * half, 0.0, n - half)])
    poses = []
    for i, x in enumerate(xs):
        T_wc = np.eye(4)
        T_wc[:3, 3] = np.array([x, 0.04 * np.sin(0.15 * i), 0.0])
        poses.append(np.linalg.inv(T_wc))
    return poses


def brightness_gain(n: int):
    """The revisit scene's exposure sweep: a log-gain triangle 0 -> -0.9
    -> 0 (a copy of tools/head_to_head.py:62-79, brightness_gain)."""
    half = n // 2
    return np.exp(np.concatenate([np.linspace(0.0, -0.9, half),
                                  np.linspace(-0.9, 0.0, n - half)]))


def train_vocab(scene, calib):
    """The revisit run's vocabulary (tools/head_to_head.py:112-131,
    write_vocab): ORB corners of 8 shifted views, k=8, L=3, seed 7."""
    import torch
    from ldso_tpu_torch.frontend import detector
    from ldso_tpu_torch.loop.vocab import Vocabulary
    from ldso_tpu_torch.ops.preprocess import make_pyramid
    descs = []
    for k in range(8):
        T = np.eye(4)
        T[:3, 3] = [-0.3 * k, 0.08 * k, 0.0]
        img, _ = scene.render(calib, np.linalg.inv(T), device="cuda")
        pyr = make_pyramid(img, calib.levels)
        feats = detector.detect_corners(pyr.dI[0], pyr.abs_grad[0], 500)
        keep = feats["valid"] & feats["is_corner"]
        descs.append(detector.desc_to_numpy(feats["desc"][keep]))
    torch.cuda.synchronize()
    return Vocabulary.train(np.concatenate(descs, axis=0), k=8, L=3, seed=7)


def phase_loop_slice(n_frames: int = LOOP_FRAMES):
    """Drive the default-Config FullSystem (loop closing on) on the revisit
    scene; returns the path's kernel launch counts."""
    import torch
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.examples import time_modes
    from ldso_tpu_torch.io.trajectory import ate_rmse
    from ldso_tpu_torch.loop import posegraph
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.synthetic import PlaneScene, default_calib
    from ldso_tpu_torch.system.full_system import FullSystem

    calib = default_calib(640, 480)
    # examples/run_common.py mode=1: no photometric calibration, free affine
    cfg = dataclasses.replace(Config(), photometric_calibration=0,
                              affine_opt_mode_a=0.0, affine_opt_mode_b=0.0)
    assert cfg.enable_loop_closing and cfg.point_selection == 1
    scene = PlaneScene(freq_hi=25.0, contrast=80.0, n_waves=32)
    poses = revisit_poses(n_frames)
    gains = brightness_gain(n_frames)
    images = []
    for T, gain in zip(poses, gains):     # rendering is set-up
        img, _ = scene.render(calib, T, device="cuda")
        images.append(torch.clamp(torch.round(img * float(gain)), 0, 255)
                      .to(torch.uint8).cpu().numpy())
    t0 = time.time()
    vocab = train_vocab(scene, calib)
    print(f"loop slice: vocabulary of {vocab.n_words} words trained in "
          f"{time.time() - t0:.2f} s", flush=True)

    fs = FullSystem(calib, cfg, vocab=vocab)
    lc = fs.loop_closing
    loop_ms, pgo_ms = [], []
    step, pgo = fs._loop_closing_step, lc.run_pose_graph_if_needed

    def timed(fn, out):
        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
            return r
        return run

    fs._loop_closing_step = timed(step, loop_ms)
    lc.run_pose_graph_if_needed = timed(pgo, pgo_ms)
    torch.cuda.reset_peak_memory_stats()
    frame_ms = []
    with time_modes.counted_tracks() as tracks, \
            time_modes.counted_traces() as traces, \
            time_modes.counted_pyramids() as pyrs:
        cuda_kernels.reset_launch_counts()
        with k67_counted() as k67:
            for i, img in enumerate(images):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fs.add_active_frame(img, i, 1.0, i * 0.05)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t) * 1e3)
                if fs.is_lost or fs.init_failed:
                    _fail(f"loop slice: lost={fs.is_lost} "
                          f"init_failed={fs.init_failed} at frame {i}")
        launches = dict(cuda_kernels.LAUNCHES)
    _k3_check("4 loop slice", launches["tracker_trip"],
              time_modes.k3_expected(tracks, cfg, calib.levels))
    _k4_check("4 loop slice", launches["trace"], traces["k4_expected"],
              traces["traces"])
    _k2_check("4 loop slice", launches["pyramid"], pyrs["k2_expected"])
    # the CLI's strict-mode final pose-graph pass before results.txt
    # (examples/run_common.py:200-203)
    torch.cuda.synchronize()
    t = time.perf_counter()
    posegraph.run_pose_graph(fs.global_map)
    final_pgo_ms = (time.perf_counter() - t) * 1e3

    kfs = fs.global_map.get_all_kfs()
    kf_frames = [kf.id for kf in kfs]
    post_boot = sum(1 for kf in kfs if kf.kf_id >= 2)
    gt = [poses[i] for i in kf_frames]
    ate_odo = ate_rmse([kf.T_cw for kf in kfs], gt)
    ate_loop = ate_rmse([kf.get_S_cw() for kf in kfs], gt)
    scales = [float(np.cbrt(np.linalg.det(kf.get_S_cw()[:3, :3])))
              for kf in kfs]
    id_of = {kf.kf_id: kf.id for kf in kfs}
    pairs = [(id_of[a], id_of[b]) for a, b in lc.loop_pairs]
    half = n_frames // 2
    kf_ms = [frame_ms[i] for i in kf_frames if i > 0]
    peak = torch.cuda.max_memory_allocated()
    print(f"loop slice: {n_frames} frames 640x480 uint8, {len(kfs)} "
          f"keyframes, {lc.n_loops_closed} loops closed, first pairs "
          f"(kf -> kf) {lc.loop_pairs[:8]} = (frame -> frame) {pairs[:8]}, "
          f"ATE odometry {ate_odo * 1e3:.4f} mm, ATE loop-closed "
          f"{ate_loop * 1e3:.4f} mm (sim3-aligned keyframes), median "
          f"{np.median(frame_ms):.2f} ms/frame, median {np.median(kf_ms):.2f} "
          f"ms/keyframe, median kf.loop {np.median(loop_ms):.2f} ms over "
          f"{len(loop_ms)} keyframes, PGO median "
          f"{np.median(pgo_ms) if pgo_ms else float('nan'):.2f} ms over "
          f"{len(pgo_ms)} runs, final PGO {final_pgo_ms:.2f} ms, scales "
          f"[{min(scales):.4f}, {max(scales):.4f}], peak device memory "
          f"{peak / 2**20:.1f} MiB, K1 launches "
          f"{launches['distance_transform']} for {post_boot} post-bootstrap "
          f"keyframes, K3 launches {launches['tracker_trip']} for "
          f"{tracks['tracks']} tracks and {tracks['ranks']} rankings, K4 "
          f"launches {launches['trace']} for {traces['k4_expected']} "
          f"expected ({traces['traces']} traces committed), K5 "
          f"launches {launches['activate']}", flush=True)
    print("stage timers (host wall, s):\n" + fs.timer.summary(), flush=True)
    print(json.dumps(dict(
        phase="4 loop_slice", kf_ids=kf_frames, loop_pairs=pairs,
        loops=lc.n_loops_closed, ate_odometry_mm=ate_odo * 1e3,
        ate_loop_mm=ate_loop * 1e3,
        pose_graph_dtype=str(np.asarray(kfs[0].S_cw).dtype))), flush=True)
    if lc.n_loops_closed < 1:
        _fail("loop slice: no loop closed")
    bad = [p for p in pairs if not (p[0] >= half and p[1] < half)]
    if bad:
        _fail(f"loop slice: loop pairs (frames) not return leg -> out leg: "
              f"{bad}")
    if fs.global_map.latest_optimized_kf_id < 0:
        _fail("loop slice: the pose graph never ran")
    if not all(0.5 < sc < 2.0 for sc in scales):
        _fail(f"loop slice: Sim(3) scales out of (0.5, 2): "
              f"[{min(scales)}, {max(scales)}]")
    if not ate_odo < ATE_BOUND_M:
        _fail(f"loop slice: odometry ATE {ate_odo * 1e3:.4f} mm >= "
              f"{ATE_BOUND_M * 1e3} mm")
    if not ate_loop < LOOP_ATE_BOUND_M:
        _fail(f"loop slice: loop-closed ATE {ate_loop * 1e3:.4f} mm >= "
              f"{LOOP_ATE_BOUND_M * 1e3} mm")
    if launches["distance_transform"] < post_boot:
        _fail(f"loop slice: K1 launched {launches['distance_transform']} "
              f"times for {post_boot} post-bootstrap keyframes")
    _k5_check("4 loop slice", launches["activate"], post_boot)
    k67.update(k6_launches=launches["ba_linearize"],
               k7_launches=launches["ba_accumulate"], phase="4 loop slice",
               post_bootstrap_keyframes=post_boot)
    _k67_run_check(k67)
    return launches, post_boot, fs.global_map


K12_F = 8                    # the main path's window slots (max_frames + 1)


def projector_bound_ms(Nn, delta: float):
    """The least time for K12's function on these (S, n, k) bases: one read
    of Nn and one write of the (S, n, n) projectors, against the float32
    operations the function needs, whatever the algorithm: the k x k Gram
    matrix's upper triangle (k (k + 1) n), U_r = Nn V_r S_r^-1 (2 k r n)
    and the upper triangle of U_r U_r^T (r n (n + 1)), with r the rank this
    data keeps (the singular values over delta times the largest). Returns
    (ms, "bytes" or "operations")."""
    import torch
    S, n, k = Nn.shape
    n_bytes = 4 * S * (n * k + n * n)
    sv = torch.linalg.svdvals(Nn.double())
    r = int((sv > delta * sv.amax(-1, keepdim=True)).sum())
    ops = S * k * (k + 1) * n + 2 * k * r * n + r * n * (n + 1)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def ptxas_facts(report: str, kernel: str) -> dict:
    """The registers, shared memory, stack frame and spill bytes of
    `kernel` in nvcc -Xptxas=-v's report."""
    import re
    lines = report.splitlines()
    facts = {}
    pats = dict(registers=r"Used (\d+) registers",
                smem_bytes=r"(\d+) bytes smem",
                stack_bytes=r"(\d+) bytes stack frame",
                spill_store_bytes=r"(\d+) bytes spill stores",
                spill_load_bytes=r"(\d+) bytes spill loads")
    for i, line in enumerate(lines):
        if kernel in line and "Compiling entry function" in line:
            for nxt in lines[i + 1:i + 5]:
                for key, pat in pats.items():
                    m = re.search(pat, nxt)
                    if m and key not in facts:
                        facts[key] = int(m[1])
    return facts


def _projector_errs(kc, bases, delta, names):
    """K12 on each basis against its plain version (projector_err's
    tolerance) and against its own algorithm run on the card in float64
    (kc.projector_emulated: P within PROJ_EMU_ULPS float32 ulps, the sweeps
    and rotations equal); P symmetric bit for bit. A basis with a singular
    value at the gate is reported, not held to the plain version's
    tolerance. Fails on any other fault. Returns the largest errors and
    shares and the names of the bases at the gate."""
    from ldso_tpu_torch.backend.ba_device import nullspace_projector_ref
    from ldso_tpu_torch.ops import cuda_kernels
    res = dict(max_abs_err=0.0, tol_share=0.0, emu_max_abs_err=0.0,
               emu_ulps_share=0.0, at_gate=[])
    for name, Nn in zip(names, bases):
        got = cuda_kernels.ba_projector(Nn, delta)
        want = nullspace_projector_ref(Nn, delta)
        err, sh, at_gate = kc.projector_err(got[None], want[None], Nn[None],
                                            delta)
        emu, sweeps, rotations = kc.projector_emulated(Nn, delta)
        emu_err, emu_sh = kc.projector_emu_err(got, emu)
        work = cuda_kernels.projector_launch(Nn[None], delta)[1][0].tolist()
        for key, x in (("max_abs_err", err), ("tol_share", sh),
                       ("emu_max_abs_err", emu_err),
                       ("emu_ulps_share", emu_sh)):
            res[key] = max(res[key], x)
        if at_gate:
            res["at_gate"].append(name)
        if not (sh <= 1.0 and emu_sh <= 1.0 and work == [sweeps, rotations]
                and _same(got, got.T)):
            _fail(f"K12 {name}: max|kernel - plain| {err} ({sh:.3g} of the "
                  f"tolerance), max|kernel - emulated| {emu_err} ({emu_sh:.3g}"
                  f" of {kc.PROJ_EMU_ULPS} ulps), sweeps and rotations {work} "
                  f"against the emulation's {[sweeps, rotations]}, symmetric "
                  f"{_same(got, got.T)}")
    return res


def phase_projector():
    """K12 (csrc/ba_projector.cu) against its plain version (the SVD) and
    its emulation on the BA windows of 1 to 8 frames in the main path's 8
    slots at 640x480, an empty window and the planted bases of
    torch_kernel_checks.planted_bases (the two at the gate must be reported
    so); 20 launches bitwise equal; its times at the full window and
    ptxas's facts. Returns the kernel record (launches filled in after
    phase 3)."""
    import torch
    from ldso_tpu_torch.backend import ba_device
    from ldso_tpu_torch.backend.window import empty_window
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kernel_checks()
    names, bases = [], []
    for nf in range(1, K12_F + 1):
        W, _, _, _, cfg, _ = kc.ba_window(nf, K12_F, n_pts=64, w=640, h=480,
                                          seed=nf, device="cuda")
        names.append(f"window {nf}")
        bases.append(ba_device.orth_basis(W))
    delta = cfg.solver_mode_delta
    names.append("empty window")
    bases.append(ba_device.orth_basis(empty_window(
        K12_F, 16, (352.0, 352.0, 319.5, 239.5), cfg, "cuda")))
    for name, B in kc.planted_bases(delta).items():
        names.append(name)
        bases.append(torch.from_numpy(B).cuda())
    errs = _projector_errs(kc, bases, delta, names)
    if sorted(errs["at_gate"]) != ["gate_0.99", "gate_1.01"]:
        _fail(f"K12: bases reported at the gate {errs['at_gate']}, not the "
              f"two planted there")
    Nn = bases[K12_F - 1]
    kernel = lambda: cuda_kernels.ba_projector(Nn, delta)  # noqa: E731
    first = kernel()
    for rep in range(1, DET_REPEATS):
        if not _same(kernel(), first):
            _fail(f"K12: launch {rep} differs from launch 0")
    _, work = cuda_kernels.projector_launch(Nn[None], delta)
    bound_ms, bound_by = projector_bound_ms(Nn[None], delta)
    ptx = ptxas_facts(cuda_kernels.ptxas_report("ba_projector.cu"),
                      "ba_projector_kernel")
    rec = dict(name="ba_projector", route="cuda",
               source="ldso_tpu_torch/csrc/ba_projector.cu",
               replaces="ldso_tpu/backend/ba_device.py:94",
               **errs, cases=len(bases),
               ms=_median_event_ms(kernel),
               device_ms=_graph_device_ms(kernel),
               plain_ms=_median_event_ms(
                   lambda: ba_device.nullspace_projector_ref(Nn, delta)),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               sweeps=int(work[0, 0]), rotations=int(work[0, 1]),
               rows=int(Nn.shape[0]), ptxas=ptx)
    print(f"K12 ba_projector: {len(bases)} bases ({K12_F} windows of 1-"
          f"{K12_F} frames in {K12_F} slots, n = {rec['rows']}, an empty one"
          f" and {len(bases) - K12_F - 1} planted): max|kernel - plain| "
          f"{errs['max_abs_err']:.3g}, at most {errs['tol_share']:.3f} of the "
          f"tolerance, at the gate (reported) {errs['at_gate']}; max|kernel "
          f"- emulated| {errs['emu_max_abs_err']:.3g} ("
          f"{errs['emu_ulps_share']:.3f} of {kc.PROJ_EMU_ULPS} float32 ulps),"
          f" sweeps and rotations equal; {DET_REPEATS} launches bitwise "
          f"equal; at the full window {rec['ms']:.4f} ms per single call, "
          f"{rec['device_ms']:.5f} ms of device time per launch (20 in a "
          f"graph), plain (SVD) {rec['plain_ms']:.4f} ms; {rec['sweeps']} "
          f"sweeps (the last rotating nothing), {rec['rotations']} rotations;"
          f" bound {bound_ms * 1e3:.5f} us set by {bound_by}; ptxas {ptx}",
          flush=True)
    return rec


# float operations of K4's function, counted from csrc/immature_trace.cu by
# what each unit of work reaches: an active lane's interval and gates, one
# search tap (a bilinear blend and its Huber term) and one GN tap (three
# channels' blends, its energy, H and b terms)
TRACE_OPS = dict(lane=150, tap=30, gn_tap=70)
# the arena's bytes per lane that the function needs: for every lane
# (valid, host, status) and the 7 fields it writes; for a lane that is not
# active, the 6 float fields it copies through; for an active lane, u, v,
# gradH and the fields its interval and quality start from (idepth_min,
# idepth_max, quality: an active lane's last_u, last_v and last_interval
# are overwritten unread); for a lane that searches, color and energy_th,
# and the weights when the GN runs
TRACE_LANE_BYTES = dict(every=9, written=28, inactive=24, active=36,
                        search=36, gn=32)


def trace_bound_ms(arena, dI, KRKis, Kts, affs, parts, cfg, calib):
    """The least time for K4's function on these inputs, the default
    (packed) search: the arena's bytes (TRACE_LANE_BYTES), the host tables
    once, and the image's 4-byte words that this run's taps read (channel 0
    at the four corners of every live step's 8 taps, all three channels at
    the four corners of every GN tap of a lane still iterating), against
    TRACE_OPS on the same work. Returns (ms, "bytes" or "operations")."""
    import torch
    W, H = calib.w[0], calib.h[0]
    N = arena.host.shape[0]
    active, search = parts["active"], parts["do_search"]
    n_cap = parts["energies"].shape[1]
    dev = dI.device
    steps = torch.arange(n_cap, dtype=torch.float32, device=dev)
    live = search[:, None] & (steps[None] < parts["n_steps"][:, None])
    sx = parts["ptx0"][:, None] + steps[None] * parts["dxn"][:, None]
    sy = parts["pty0"][:, None] + steps[None] * parts["dyn"][:, None]
    from ldso_tpu_torch.config import PATTERN
    patt = torch.as_tensor(PATTERN, dtype=torch.long, device=dev)
    words = []

    def floor_cell(x, hi):
        x = torch.clamp(x, 0.0, hi)
        return torch.nan_to_num(torch.floor(x)).long()
    xi, yi = floor_cell(sx[live], W - 1.001), floor_cell(sy[live], H - 1.001)
    for ox in (0, 1):
        for oy in (0, 1):
            cx = torch.clamp(xi[:, None] + patt[:, 0], 0, W - 1)
            cy = torch.clamp(yi[:, None] + patt[:, 1], 0, H - 1)
            cx = torch.clamp(cx + ox, max=W - 1)
            cy = torch.clamp(cy + oy, max=H - 1)
            words.append(((cy * W + cx) * 3).reshape(-1))
    rot = parts["rot_patt"]
    gn_taps = 0
    for it in parts.get("gn", ()):
        m = it["upd"] & search
        gn_taps += int(m.sum()) * 8
        x = floor_cell(it["bu"][m][:, None] + rot[m][:, :, 0], W - 1.001)
        y = floor_cell(it["bv"][m][:, None] + rot[m][:, :, 1], H - 1.001)
        for ox in (0, 1):
            for oy in (0, 1):
                idx = ((y + oy) * W + x + ox).reshape(-1) * 3
                words += [idx, idx + 1, idx + 2]
    n_words = int(torch.unique(torch.cat(words)).numel())
    n_active, n_search = int(active.sum()), int(search.sum())
    per_search = TRACE_LANE_BYTES["search"] + (
        TRACE_LANE_BYTES["gn"] if cfg.trace_gn_iterations > 0 else 0)
    n_bytes = (N * (TRACE_LANE_BYTES["every"] + TRACE_LANE_BYTES["written"])
               + (N - n_active) * TRACE_LANE_BYTES["inactive"]
               + n_active * TRACE_LANE_BYTES["active"]
               + n_search * per_search
               + sum(t.numel() * t.element_size() for t in (KRKis, Kts, affs))
               + 4 * n_words)
    ops = (n_active * TRACE_OPS["lane"]
           + n_search * n_cap * 8 * TRACE_OPS["tap"]
           + gn_taps * TRACE_OPS["gn_tap"])
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _trace_check(kc, what, inputs, got, calib):
    """K4's output `got` against the plain version on the card on the same
    inputs (arena, dI, KRKis, Kts, affs, cfg): trace_err's report, with the
    lanes not bitwise equal to the plain version's; fails the run on a
    fault or on too many flips."""
    import torch
    arena, dI, KRKis, Kts, affs, cfg = inputs
    want, parts = kc.plain_trace(arena, dI, KRKis, Kts, affs, calib, cfg)
    rep = kc.trace_err(want, got, parts, cfg)
    same = torch.ones_like(parts["active"])
    for f in kc.TRACE_CLOSE + ("quality", "status"):
        same &= kc.bits(getattr(got.pool, f), getattr(want.pool, f))
    rep["not_bitwise"] = int((~same).sum())
    if not rep["ok"]:
        _fail(f"K4 {what}: {rep['faults']} (flips {rep['flips'][:20]} of "
              f"{rep['live']} live lanes, at most "
              f"{kc.TRACE_TIE_SHARE} of them)")
    return rep, want, parts


def phase_trace_kernel(device="cuda"):
    """K4 (csrc/immature_trace.cu) against its plain version
    (frontend/immature.trace_arena_ref) on the card, on the bench scene at
    640x480 (torch_kernel_checks.trace_scene, every one of its 4,096 lanes
    live): each search of TRACE_VARIANTS (the step cap of 100 and 15
    re-score steps among them) on an uninitialised arena and on the arena
    its first trace narrowed, and the planted lanes (at and past the
    border, sticky OOB, skipped, badcondition, idepth_min < 0, steps at
    the cap, uninitialised, a former outlier, dead lanes between live
    ones, NaN pixels in the target), each held by trace_err; 20 launches
    bitwise equal; K4's device time on the bench scene's first trace
    (`bench_4096`) and ptxas's registers of each search's kernel. Returns
    the kernel record (the main times and launches are filled in after
    phase 3, on its last arena)."""
    import torch
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kernel_checks()
    t0 = time.perf_counter()
    scene = kc.trace_scene(640, 480, device)
    calib = scene["calib"]
    cases = kc.trace_cases(scene)
    worst, flips, ties, lanes, not_bitwise = 0.0, 0, 0, 0, 0
    launches = cuda_kernels.LAUNCHES["trace"]
    for name, (arena, dI, KRKis, Kts, affs, cfg) in cases.items():
        got = cuda_kernels.trace_arena(arena, dI, KRKis, Kts, affs, calib,
                                       cfg)
        rep, _, _ = _trace_check(kc, name, (arena, dI, KRKis, Kts, affs, cfg),
                                 got, calib)
        worst = max(worst, rep["max_err"])
        flips += len(rep["flips"])
        ties += rep["ties"]
        lanes += rep["live"]
        not_bitwise += rep["not_bitwise"]
    if device == "cuda" and \
            cuda_kernels.LAUNCHES["trace"] != launches + len(cases):
        _fail(f"K4: {cuda_kernels.LAUNCHES['trace'] - launches} launches for "
              f"{len(cases)} cases")
    arena, dI, KRKis, Kts, affs, cfg = cases["planted"]
    kernel = lambda: cuda_kernels.trace_arena(  # noqa: E731
        arena, dI, KRKis, Kts, affs, calib, cfg)
    first = kernel().pool
    for rep in range(1, DET_REPEATS):
        again = kernel().pool
        if not all(_same(getattr(again, f), getattr(first, f))
                   for f in cuda_kernels.TRACE_OUTPUTS):
            _fail(f"K4: launch {rep} differs from launch 0")
    # the bench scene's 4,096 live lanes in their first trace (the default
    # search), timed in every run beside phase 3's last arena
    arena, dI, KRKis, Kts, affs, cfg = cases["packed uninitialised"]
    kernel = lambda: cuda_kernels.trace_arena(  # noqa: E731
        arena, dI, KRKis, Kts, affs, calib, cfg)
    _, parts = kc.plain_trace(arena, dI, KRKis, Kts, affs, calib, cfg)
    bench = dict(device_ms=_graph_device_ms(kernel),
                 live_lanes=int(parts["active"].sum()),
                 searched_lanes=int(parts["do_search"].sum()))
    bench["bound_ms"], _ = trace_bound_ms(arena, dI, KRKis, Kts, affs, parts,
                                          cfg, calib)
    report = cuda_kernels.ptxas_report("immature_trace.cu")
    ptx = {("nearest " if nearest else "") + ("packed" if packed else
                                                "rotated"):
           ptxas_facts(report, f"immature_trace_kernelILi{k}E")
           for (nearest, packed), k in cuda_kernels.TRACE_SEARCHES.items()}
    print(f"K4 trace: {len(cases)} cases at 640x480 ({len(kc.TRACE_VARIANTS)}"
          f" searches, uninitialised and narrowing, and the planted lanes "
          f"{sorted(kc.TRACE_PLANTS.values())}), {lanes} live lanes: "
          f"max|kernel - plain| {worst:.3g}, {not_bitwise} lanes not "
          f"bitwise the plain version's, {flips} flips at the plain "
          f"version's {ties} tie lanes; {DET_REPEATS} launches bitwise "
          f"equal; the bench scene's {bench['live_lanes']} live lanes "
          f"({bench['searched_lanes']} searched): "
          f"{bench['device_ms'] * 1e3:.2f} us of device time per launch (20 "
          f"in a graph), bound {bench['bound_ms'] * 1e3:.3f} us; ptxas {ptx}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(name="trace", route="cuda",
                source="ldso_tpu_torch/csrc/immature_trace.cu",
                replaces="ldso_tpu/frontend/immature.py:119",
                max_abs_err=worst, cases=len(cases), flips=flips,
                not_bitwise=not_bitwise, library_ms=None,
                bench_4096=bench, ptxas=ptx)


def phase_trace_frame(record, traces):
    """Every trace of phase 3 again through the plain version on the card,
    from its recorded inputs, held to K4's recorded output by trace_err;
    then K4's times on phase 3's last arena and frame: `ms` and `plain_ms`
    (single calls, CUDA events, median of 50), `device_ms` (20 launches in
    one CUDA graph), the bound and its share. Fills in the record."""
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kernel_checks()
    if not traces:
        _fail("phase 3 traced no arena")
    flips, ties, lanes, worst, not_bitwise = [], 0, 0, 0.0, 0
    for k, (inputs, calib, got) in enumerate(traces):
        rep, _, parts = _trace_check(kc, f"phase 3 trace {k}", inputs, got,
                                     calib)
        flips += [(k, i) for i in rep["flips"]]
        ties += rep["ties"]
        lanes += rep["live"]
        worst = max(worst, rep["max_err"])
        not_bitwise += rep["not_bitwise"]
    arena, dI, KRKis, Kts, affs, cfg = inputs
    kernel = lambda: cuda_kernels.trace_arena(  # noqa: E731
        arena, dI, KRKis, Kts, affs, calib, cfg)
    plain = lambda: kc.plain_trace(  # noqa: E731
        arena, dI, KRKis, Kts, affs, calib, cfg)
    rec = dict(ms=_median_event_ms(kernel), device_ms=_graph_device_ms(kernel),
               plain_ms=_median_event_ms(plain))
    rec["bound_ms"], rec["bound_by"] = trace_bound_ms(
        arena, dI, KRKis, Kts, affs, parts, cfg, calib)
    rec.update(phase3_traces=len(traces), phase3_live_lanes=lanes,
               phase3_flips=len(flips), phase3_tie_lanes=ties,
               phase3_not_bitwise=not_bitwise,
               last_live_lanes=int(parts["active"].sum()),
               last_searched_lanes=int(parts["do_search"].sum()))
    record["max_abs_err"] = max(record["max_abs_err"], worst)
    record.update(rec)
    print(f"K4 on phase 3: {len(traces)} traces, {lanes} live lanes, all "
          f"held by trace_err: {len(flips)} flips {flips[:10]} at the plain "
          f"version's {ties} tie lanes, {not_bitwise} lanes not bitwise, "
          f"max|kernel - plain| {worst:.3g}; on the last arena "
          f"({rec['last_live_lanes']} live lanes, "
          f"{rec['last_searched_lanes']} searched, of "
          f"{arena.host.shape[0]}): kernel {rec['ms']:.4f} ms per single "
          f"call, {rec['device_ms'] * 1e3:.2f} us of device time per launch "
          f"(20 in a graph), plain {rec['plain_ms']:.3f} ms; bound "
          f"{rec['bound_ms'] * 1e3:.3f} us set by {rec['bound_by']}, "
          f"{100 * rec['bound_ms'] / rec['device_ms']:.2f}% of it reached "
          f"in device time", flush=True)


def _k4_check(what: str, launches: int, expected: int,
              traces: int) -> None:
    """K4 ran on this path exactly as often as its frame steps, trace calls
    and captures imply (time_modes.counted_traces' `k4_expected`: one
    launch per frame-step replay, whatever its gate, one per
    FullSystem._trace_arena call and one per graph captured), no trace
    went through the plain version, and some trace was committed."""
    if not (launches == expected > 0 and traces > 0):
        _fail(f"{what}: K4 launched {launches} times where the path's frame "
              f"steps, trace calls and captures imply {expected}, "
              f"{traces} traces of the arena committed")


def _k4_run_check(run: dict) -> None:
    _k4_check(f"{run.get('phase', run['mode'])}", run["k4_launches"],
              run["k4_expected"], run["traces"])



# the windows past the main path's 8 slots that phase 2 holds K5 to: a
# group of 8 slots and a partial one, and K5's most (ACTIVATE_MAX_SLOTS)
ACT_WIDE_SLOTS = (23, 32)
# float operations of K5's function, counted from csrc/immature_activate.cu
# by what each unit of work reaches: a live lane's gate (its idm, the
# projection, the pixel, the distance test) and one tap of one evaluation
# against one target (the projection, the reciprocal, the pixel, three
# channels' bilinear blends, the residual, the Huber weight, the energy, H
# and b terms)
ACT_OPS = dict(lane=40, tap=75)
# the arena's bytes per lane that the function needs: for every lane valid,
# host, idepth_min and idepth_max (the depth it writes for every lane) and
# the 11 bytes it writes; for a live lane the gate's status, quality,
# last_interval, u, v and my_type; for a lane the LM runs on, color,
# weights and energy_th
ACT_LANE_BYTES = dict(every=13, written=11, live=24, optimised=68)


def activate_bound_ms(inputs, parts, calib):
    """The least time for K5's function on these inputs: the arena's bytes
    (ACT_LANE_BYTES), the tables once, the distance map's words that the
    gate's lanes read, and the window images' 4-byte words that this run's
    taps read (three channels at the four corners of every tap of every
    evaluation against every target of an optimised lane), against
    ACT_OPS on the same work. Returns (ms, "bytes" or "operations")."""
    import torch
    arena, dist_map = inputs[0], inputs[1]
    W, H = calib.w[0], calib.h[0]
    N = arena.host.shape[0]
    live, to_opt, gate = parts["live"], parts["to_opt"], parts["gate"]
    n_live, n_opt = int(live.sum()), int(to_opt.sum())
    words, taps = [], 0

    def floor_cell(x, hi):
        x = torch.clamp(x, 0.0, hi)
        return torch.nan_to_num(torch.floor(x)).long()
    for k, tlive, Ku, Kv in parts["taps"]:
        m = to_opt & tlive
        taps += int(m.sum()) * 8
        x, y = floor_cell(Ku[m], W - 1.001), floor_cell(Kv[m], H - 1.001)
        for ox in (0, 1):
            for oy in (0, 1):
                idx = (k * H * W + (y + oy) * W + x + ox).reshape(-1) * 3
                words += [idx, idx + 1, idx + 2]
    n_words = int(torch.unique(torch.cat(words)).numel()) if words else 0
    h1, w1 = dist_map.shape
    px, py = parts["pixel"]
    ui = torch.clamp(px.to(torch.int64), 0, w1 - 1)
    vi = torch.clamp(py.to(torch.int64), 0, h1 - 1)
    n_cells = int(torch.unique((vi * w1 + ui)[gate]).numel())
    n_bytes = (N * (ACT_LANE_BYTES["every"] + ACT_LANE_BYTES["written"])
               + n_live * ACT_LANE_BYTES["live"]
               + n_opt * ACT_LANE_BYTES["optimised"]
               + sum(t.numel() * t.element_size() for t in inputs[2:8])
               + inputs[9].numel() * 4 + inputs[10].numel()
               + 4 * n_cells + 4 * n_words)
    ops = n_live * ACT_OPS["lane"] + taps * ACT_OPS["tap"]
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _activate_check(kc, what, inputs, got, calib):
    """K5's outputs `got` against the plain version on the card on the
    same inputs (activate_inputs's tuple): activate_err's report, with the
    lanes not bitwise equal to the plain version's; fails the run on a
    fault or on too many flips."""
    import torch
    want, parts = kc.plain_activate(inputs, calib)
    rep = kc.activate_err(want, got, parts, inputs[13])
    same = torch.ones_like(parts["live"])
    for g, w in zip(got, want):
        same &= (g == w) if g.dtype == torch.bool else (
            g.view(torch.int32) == w.view(torch.int32))
    rep["not_bitwise"] = int((~same).sum())
    if not rep["ok"]:
        _fail(f"K5 {what}: {rep['faults']} (flips {rep['flips'][:20]} of "
              f"{rep['live']} live lanes, at most "
              f"{kc.ACT_TIE_SHARE} of them)")
    return rep, want, parts


def _activation_dispatch(kc, scene, sleep_ms: float = 50.0):
    """FullSystem._activate_points on the card (the scene's window of 8
    frames, an empty point window, the scene's arena) behind ~sleep_ms of
    queued sleep under set_sync_debug_mode("error"): it reads nothing
    back (one K1 and one K5 launch behind one upload that does not wait),
    returns before the card has run the pass (an event after it is not
    done), its HostCopy is not ready, and its results equal a run without
    the sleep bitwise. Returns the host ms of the call."""
    import torch
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.slam_map import FrameShell
    from ldso_tpu_torch.system.full_system import FullSystem
    fs = FullSystem(scene["calib"], scene["cfg"])
    for k in kc.ACT_WINDOW:
        fs.window_frames.append(FrameShell(
            id=k, T_cw=scene["poses"][k], aff=np.zeros(2), exposure=1.0))
    fs.marg_flags = [False] * len(kc.ACT_WINDOW)
    fs.imm_live = [s < 3 for s in range(len(kc.ACT_WINDOW))]
    fs.dIs = torch.stack([scene["dI"][k] for k in kc.ACT_WINDOW])
    W0 = fs.ef.W

    def run():
        fs.ef.W, fs.imm_arena = W0, scene["arena"]
        fs.current_min_act_dist = 2.0
        fs._activate_points()
        return (list(fs.ef.W) + list(fs.imm_arena.pool),
                fs._act_pull[0])
    want, pull = run()
    want = [t.clone() for t in want]
    want_pk = pull.numpy().copy()
    torch.cuda.synchronize()
    before = dict(cuda_kernels.LAUNCHES)
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * sleep_ms))
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = time.perf_counter()
        got, pull = run()
        host_ms = (time.perf_counter() - t) * 1e3
        done = torch.cuda.Event()
        done.record()
        ready, pulled = done.query(), pull.is_ready()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launched = {k: cuda_kernels.LAUNCHES[k] - before[k]
                for k in ("distance_transform", "activate")}
    torch.cuda.synchronize()
    if ready or pulled or launched != {"distance_transform": 1,
                                       "activate": 1}:
        _fail(f"K5 dispatch: the pass was done before the call returned "
              f"({ready}, HostCopy ready {pulled}) or launched {launched}")
    if not all(torch.equal(g.view(torch.uint8), w.view(torch.uint8))
               for g, w in zip(got, want)) or not np.array_equal(
                   pull.numpy(), want_pk):
        _fail("K5 dispatch: the pass behind the sleep differs from the "
              "pass without it")
    return host_ms


def phase_activate_kernel(device="cuda"):
    """K5 (csrc/immature_activate.cu) against its plain version
    (frontend/immature.activate_arena_ref) on the card, on the bench scene
    at 640x480 with the full 4,096-lane arena (torch_kernel_checks.
    activate_scene: one trace's intervals, K1's map of a random occupancy):
    windows of 2, 4 and 8 frames of the 8 slots, windows of ACT_WIDE_SLOTS
    frames in as many slots, and the planted lanes
    (patterns out of bounds at the border, masked targets, NaN pixels, Hdd
    under min_idepth_h_act, a first step that converges, an energy at the
    outlier limit, host == newest and out of range, outliers,
    uninitialised lanes, no idepth_max, wide intervals, dead lanes between
    live ones), each held by activate_err; 20 launches bitwise; the
    FullSystem's activation under set_sync_debug_mode("error") behind a
    sleep (`_activation_dispatch`). Returns the kernel record with K5's
    times on the window of 8 (`ms`, `plain_ms` single calls, `device_ms`
    20 launches in one CUDA graph), its bound and ptxas's registers; phase
    3's activations fill in the rest."""
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kernel_checks()
    t0 = time.perf_counter()
    scene = kc.activate_scene(640, 480, device, slots=max(ACT_WIDE_SLOTS))
    calib = scene["calib"]
    cases = kc.activate_cases(scene)
    for F in ACT_WIDE_SLOTS:
        cases[f"window {F} in {F} slots"] = kc.activate_inputs(scene, F,
                                                               slots=F)
    worst, flips, ties, lanes, opt, not_bitwise = 0.0, 0, 0, 0, 0, 0
    margin_ties, margin_flips = 0, 0
    launches = cuda_kernels.LAUNCHES["activate"]
    for name, inputs in cases.items():
        got = cuda_kernels.activate_arena(*inputs[:13], calib, inputs[13])
        rep, _, _ = _activate_check(kc, name, inputs, got, calib)
        worst = max(worst, rep["max_err"])
        flips += len(rep["flips"])
        ties += rep["ties"]
        margin_ties += rep["margin_ties"]
        margin_flips += len(rep["margin_flips"])
        lanes += rep["live"]
        opt += rep["optimised"]
        not_bitwise += rep["not_bitwise"]
    if cuda_kernels.LAUNCHES["activate"] != launches + len(cases):
        _fail(f"K5: {cuda_kernels.LAUNCHES['activate'] - launches} launches "
              f"for {len(cases)} cases")
    inputs = cases["planted"]
    kernel = lambda: cuda_kernels.activate_arena(  # noqa: E731
        *inputs[:13], calib, inputs[13])
    first = kernel()
    for rep in range(1, DET_REPEATS):
        if not all(_same(a, b) for a, b in zip(kernel(), first)):
            _fail(f"K5: launch {rep} differs from launch 0")
    inputs = cases[f"window {kc.TRACE_SLOTS}"]
    kernel = lambda: cuda_kernels.activate_arena(  # noqa: E731
        *inputs[:13], calib, inputs[13])
    plain = lambda: kc.plain_activate(inputs, calib)  # noqa: E731
    rec = dict(ms=_median_event_ms(kernel), device_ms=_graph_device_ms(kernel),
               plain_ms=_median_event_ms(plain, reps=10, warmup=2))
    _, parts = plain()
    rec["bound_ms"], rec["bound_by"] = activate_bound_ms(inputs, parts, calib)
    rec["ptxas"] = ptxas_facts(cuda_kernels.ptxas_report(
        "immature_activate.cu"), "immature_activate_kernel")
    dispatch_ms = _activation_dispatch(kc, scene)
    print(f"K5 activate: {len(cases)} cases at 640x480 (windows of "
          f"{list(kc.ACT_FRAMES)} frames in 8 slots, of {list(ACT_WIDE_SLOTS)}"
          f" frames in as many slots, and the planted lanes "
          f"{sorted(kc.ACT_PLANTS.values())}), {lanes} live lanes, {opt} "
          f"optimised: max|kernel - plain| {worst:.3g}, {not_bitwise} lanes "
          f"not bitwise the plain version's, {flips} flips at the plain "
          f"version's {ties} tie lanes ({margin_flips} flips at the "
          f"{margin_ties} that only the accept test's margin of "
          f"{kc.ACT_ACCEPT_ULPS:.0f} ulps makes ties); {DET_REPEATS} "
          f"launches bitwise "
          f"equal; window of 8 ({int(parts['live'].sum())} live lanes, "
          f"{int(parts['to_opt'].sum())} optimised): kernel "
          f"{rec['ms']:.4f} ms per single call, "
          f"{rec['device_ms'] * 1e3:.2f} us of device time per launch (20 "
          f"in a graph), plain {rec['plain_ms']:.3f} ms; bound "
          f"{rec['bound_ms'] * 1e3:.3f} us set by {rec['bound_by']}, "
          f"{100 * rec['bound_ms'] / rec['device_ms']:.2f}% of it reached "
          f"in device time; ptxas {rec['ptxas']}; FullSystem's activation "
          f"queued in "
          f"{dispatch_ms:.2f} ms under set_sync_debug_mode('error') behind "
          f"50 ms of sleep; {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(name="activate", route="cuda",
                source="ldso_tpu_torch/csrc/immature_activate.cu",
                replaces="ldso_tpu/frontend/immature.py:654",
                max_abs_err=worst, cases=len(cases), flips=flips,
                margin_ties=margin_ties, margin_flips=margin_flips,
                not_bitwise=not_bitwise, library_ms=None,
                dispatch_host_ms=dispatch_ms, **rec)


@contextlib.contextmanager
def recorded_activations():
    """Yields a list that gets, for each activation pass inside (each
    keyframe's replay of the activation's graph: full_system._program with
    ACTIVATE_GRAPHS), its K5 launch's inputs and output: (activate_inputs's
    tuple, calib, output). A replay runs no Python, so when the block ends
    each recorded pass runs again as its eager program with K5's wrapper
    recording, and the eager program's outputs must be bitwise the
    replay's (so the replay's K5 gave the recorded output). The system
    writes none of the inputs in place."""
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.system import full_system as fsm
    seen, passes = [], []
    program = fsm._program

    def recorded_pass(family, static, fn, inputs):
        out = program(family, static, fn, inputs)
        if family is fsm.ACTIVATE_GRAPHS:
            passes.append((fn, tuple(inputs), out))
        return out
    fsm._program = recorded_pass
    try:
        yield seen
    finally:
        fsm._program = program
    wrapper = cuda_kernels.activate_arena

    def recorded(*args):
        out = wrapper(*args)
        seen.append(((*args[:13], args[14]), args[13], out))
        return out
    cuda_kernels.activate_arena = recorded
    try:
        for k, (fn, inputs, out) in enumerate(passes):
            want = fn(*inputs)
            bad = [i for i, (g, w) in enumerate(zip(out, want))
                   if not _same(g, w)]
            if bad or len(out) != len(want):
                _fail(f"activation pass {k}: the replay differs from its "
                      f"eager program in outputs {bad} of {len(want)}")
    finally:
        cuda_kernels.activate_arena = wrapper


def phase_activate_frame(record, acts):
    """Every activation of phase 3 again through the plain version on the
    card, from its recorded inputs, held to K5's recorded output by
    activate_err; then K5's times on phase 3's last activation (`phase3_ms`,
    `phase3_plain_ms` single calls, `phase3_device_ms` 20 launches in one
    CUDA graph) and its bound there. Fills in the record."""
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kernel_checks()
    if not acts:
        _fail("phase 3 activated no arena")
    flips, ties, lanes, opt, worst, not_bitwise = [], 0, 0, 0, 0.0, 0
    margin_ties, margin_flips = 0, 0
    for k, (inputs, calib, got) in enumerate(acts):
        rep, _, parts = _activate_check(kc, f"phase 3 activation {k}",
                                        inputs, got, calib)
        flips += [(k, i) for i in rep["flips"]]
        ties += rep["ties"]
        margin_ties += rep["margin_ties"]
        margin_flips += len(rep["margin_flips"])
        lanes += rep["live"]
        opt += rep["optimised"]
        worst = max(worst, rep["max_err"])
        not_bitwise += rep["not_bitwise"]
    kernel = lambda: cuda_kernels.activate_arena(  # noqa: E731
        *inputs[:13], calib, inputs[13])
    plain = lambda: kc.plain_activate(inputs, calib)  # noqa: E731
    rec = dict(phase3_ms=_median_event_ms(kernel),
               phase3_device_ms=_graph_device_ms(kernel),
               phase3_plain_ms=_median_event_ms(plain, reps=10, warmup=2))
    rec["phase3_bound_ms"], _ = activate_bound_ms(inputs, parts, calib)
    rec.update(phase3_activations=len(acts), phase3_live_lanes=lanes,
               phase3_optimised_lanes=opt, phase3_flips=len(flips),
               phase3_tie_lanes=ties, phase3_not_bitwise=not_bitwise,
               phase3_margin_ties=margin_ties,
               phase3_margin_flips=margin_flips,
               last_live_lanes=int(parts["live"].sum()),
               last_optimised_lanes=int(parts["to_opt"].sum()),
               last_window_frames=int(inputs[12]))
    record["max_abs_err"] = max(record["max_abs_err"], worst)
    record.update(rec)
    print(f"K5 on phase 3: {len(acts)} activations, {lanes} live lanes, "
          f"{opt} optimised, all held by activate_err: {len(flips)} flips "
          f"{flips[:10]} at the plain version's {ties} tie lanes "
          f"({margin_flips} at the {margin_ties} that only the accept "
          f"test's margin makes ties), "
          f"{not_bitwise} lanes not bitwise, max|kernel - plain| "
          f"{worst:.3g}; on the last ({rec['last_live_lanes']} live lanes, "
          f"{rec['last_optimised_lanes']} optimised, "
          f"{rec['last_window_frames']} frames): kernel "
          f"{rec['phase3_ms']:.4f} ms per single call, "
          f"{rec['phase3_device_ms'] * 1e3:.2f} us of device time per "
          f"launch, plain {rec['phase3_plain_ms']:.3f} ms; bound "
          f"{rec['phase3_bound_ms'] * 1e3:.3f} us", flush=True)


def _k5_check(what: str, launches: int, post_boot: int) -> None:
    """K5 ran once for each post-bootstrap keyframe's activation on this
    path, and no activation went through the plain version."""
    if not launches == post_boot > 0:
        _fail(f"{what}: K5 launched {launches} times for {post_boot} "
              f"post-bootstrap keyframes")


def _k5_run_check(run: dict) -> None:
    what = run.get("phase", run["mode"])
    if run["k5_launches"] != run["activations"]:
        _fail(f"{what}: K5 launched {run['k5_launches']} times for "
              f"{run['activations']} activation passes")
    if run["activate_replays"] != run["activations"]:
        _fail(f"{what}: {run['activate_replays']} replays of the "
              f"activation's graph for {run['activations']} passes")
    _k5_check(what, run["k5_launches"], run["post_bootstrap_keyframes"])


# ---------------------------------------------------------------------------
# K6 and K7: the windowed BA's linearization and accumulation
# (csrc/ba_linearize.cu, csrc/ba_accumulate.cu)
# ---------------------------------------------------------------------------

# float operations of K6's function per linearized residual, counted from
# csrc/ba_linearize.cu: the centre projection and its Jacobians (~90), and
# per tap its projection, bilinear sample of 3 channels and weights (~70)
LIN_OPS = dict(residual=90, tap=70)
# bytes per residual K6 must move: a linearized one reads its state
# (res_exist, res_linearized, res_state, res_energy: 10) and writes its 10
# fields (67 floats and an int: 272); any other reads its 272 bytes of
# fields and writes them; per point 85 bytes (u, v, colour, weights,
# idepths, host, valid)
LIN_BYTES = dict(state=10, fields=272, point=85)
# K7's float operations per residual of its top part (8 taps of 13 rows,
# 2 each, the 91 products of the upper triangle, 2 each) and its Schur part
# (JpJdF's 8 entries from the 2x2 products, ~100), per point and (target,
# target) pair of accD (64 products, 3 each) and per (target) of accE and
# accEB (40 products, 3 each)
ACC_OPS = dict(top_tap=2 * 13 + 2 * 91, sc_residual=100, accD=3 * 64,
               accE=3 * 40)
# bytes per residual K7's parts must read (every residual: its non-finite
# terms count): top JIdx, Jpdc, Jpdxi, JabF, Jpdd, the residual column and
# 3 mask bytes (262); Schur JIdx, JabF, Jpdxi, Jpdd and 2 mask bytes (186)
ACC_BYTES = dict(top=262, sc=186)


def _tap_words(fidx, x, y, H: int, W: int) -> int:
    """The distinct 4-byte image words the bilinear taps at (x, y) of
    frames fidx read (three channels at four corners), as
    backend/ba._bilinear_frames clamps and floors them."""
    import torch

    def cell(v, hi):
        v = torch.clamp(v, 0.0, hi)
        return torch.nan_to_num(torch.floor(v)).long()
    xi, yi = cell(x, W - 1.001), cell(y, H - 1.001)
    base = (fidx * (H * W) + yi * W + xi).reshape(-1)
    idx = torch.cat([base, base + 1, base + W, base + W + 1]) * 3
    return int(torch.unique(torch.cat([idx, idx + 1, idx + 2])).numel())


def lin_bound_ms(W, dIs, cfg, w: int, h: int, tgt=None):
    """The least time for K6's function on these inputs: LIN_BYTES for the
    lattice (the linearized residuals' state and fields, the others'
    fields read and written), the points once, the precalc tables and the
    window images' words this run's taps read (taken from the plain
    version's own samples), against LIN_OPS on the same work. Returns (ms,
    "bytes" or "operations")."""
    import torch
    from ldso_tpu_torch.backend import ba
    seen = []
    sample = ba._bilinear_frames

    def recorded(d, fidx, x, y):
        seen.append((fidx, x, y))
        return sample(d, fidx, x, y)
    ba._bilinear_frames = recorded
    try:
        _kernel_checks().plain_lin(W, dIs, cfg, w, h, tgt)
    finally:
        ba._bilinear_frames = sample
    fidx, x, y = seen[0]
    lin = ba._lin_mask(W)
    if tgt is not None:
        lin = lin & (torch.arange(W.F, device=lin.device) == tgt)
    n_lin = int(lin.sum())
    keep = lin if tgt is None else lin[:, int(tgt)]
    fidx = torch.broadcast_to(fidx, x.shape)[keep]
    words = _tap_words(fidx, x[keep], y[keep], dIs.shape[1], dIs.shape[2])
    n_res = W.P * W.F
    n_bytes = (n_lin * (LIN_BYTES["state"] + LIN_BYTES["fields"])
               + (n_res - n_lin) * 2 * LIN_BYTES["fields"]
               + W.P * LIN_BYTES["point"] + W.F * W.F * 104 + 4 * words)
    ops = n_lin * (LIN_OPS["residual"] + 8 * LIN_OPS["tap"])
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def acc_bound_ms(part: str, W, args):
    """The least time for K7's `part` on these inputs: ACC_BYTES per
    residual of the lattice, the per-point inputs and outputs and the
    blocks written once, against ACC_OPS on this data's work (the masked
    residuals of the top part; the points with `has` of the Schur part).
    Returns (ms, "bytes" or "operations")."""
    from ldso_tpu_torch.backend import ba
    P, F = W.P, W.F
    n_res = P * F
    if part == "top":
        pc, mode, mask = args
        n_inc = int(ba._mode_mask(W, mode, mask).sum())
        n_bytes = (n_res * ACC_BYTES["top"] + P * 17 + P * 24
                   + F * F * 169 * 4 + F * F * 32)
        ops = n_inc * 8 * ACC_OPS["top_tap"]
    else:
        Hdd, bd, Hcd, shift, mask = args
        act = W.res_active & W.res_exist & W.frame_valid[None, :] \
            & mask[:, None]
        n_has = int(((act.sum(1) > 0) & mask).sum())
        n_bytes = (n_res * ACC_BYTES["sc"] + P * 41 + n_res * 32 + P * 32
                   + F * F * 40 * 4 + F ** 3 * 64 * 4 + 80)
        ops = (n_res * ACC_OPS["sc_residual"]
               + n_has * (F * F * ACC_OPS["accD"] + F * ACC_OPS["accE"]))
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _lin_call(W, dIs, cfg, w, h, tgt):
    from ldso_tpu_torch.backend import ba
    from ldso_tpu_torch.ops import cuda_kernels
    pc = ba.make_precalc(W)
    return lambda: cuda_kernels.ba_linearize(W, dIs, pc, cfg, w, h, tgt)


def _vmapped_one_launch(kc, scene, planted):
    """K6 and K7 under torch.func.vmap over two windows (the scene's and
    its planted one): one launch of each for the two, each member bitwise
    its single launch on the same inputs. Returns the launches."""
    import torch
    from ldso_tpu_torch.backend import ba
    from ldso_tpu_torch.backend.window import Window
    from ldso_tpu_torch.ops import cuda_kernels as ck
    Ws = [scene["W"], planted[0]]
    ds = [scene["dIs"], planted[1]]
    cfg, w, h = scene["cfg"], scene["w"], scene["h"]
    pcs = [ba.make_precalc(W) for W in Ws]
    stack = lambda xs: type(xs[0])(*(torch.stack(t) for t in zip(*xs)))  # noqa: E731
    Wst, dst, pcst = stack(Ws), torch.stack(ds), stack(pcs)
    ck.reset_launch_counts()
    got = torch.func.vmap(lambda W, d, pc: ck.ba_linearize(
        W, d, pc, cfg, w, h))(Wst, dst, pcst)
    lin_launches = ck.LAUNCHES["ba_linearize"]
    for i in range(2):
        one = ck.ba_linearize(Ws[i], ds[i], pcs[i], cfg, w, h)
        rep = kc.lin_err(({k: v[i] for k, v in got[0].items()}, got[1][i]),
                         one)
        if not rep["ok"]:
            _fail(f"K6 under vmap: member {i} differs from its single "
                  f"launch: {rep['not_bitwise']}")
    Wl = [scene["W_lin"], kc.linearized(*planted[:3], w, h)]
    Wlst = stack(Wl)
    pcl = [ba.make_precalc(W) for W in Wl]
    ck.reset_launch_counts()
    top = torch.func.vmap(lambda W, pc: ck.ba_accumulate_top(
        W, pc, 1, W.pt_valid))(Wlst, stack(pcl))
    sc = torch.func.vmap(lambda W, a, b, c: ck.ba_accumulate_sc(
        W, a, b, c, True, W.pt_valid))(Wlst, top[1], top[2], top[3])
    acc_launches = ck.LAUNCHES["ba_accumulate"]
    for i in range(2):
        one = ck.ba_accumulate_top(Wl[i], pcl[i], 1, Wl[i].pt_valid)
        one_sc = ck.ba_accumulate_sc(Wl[i], top[1][i], top[2][i], top[3][i],
                                     True, Wl[i].pt_valid)
        if not (all(_same(a[i], b) for a, b in zip(top, one))
                and all(_same(sc[k][i], one_sc[k]) for k in one_sc)):
            _fail(f"K7 under vmap: member {i} differs from its single "
                  f"launches")
    if (lin_launches, acc_launches) != (1, 2):
        _fail(f"K6/K7 under vmap over 2 windows: {lin_launches} K6 and "
              f"{acc_launches} K7 launches (want 1 and 2)")
    return lin_launches, acc_launches


def phase_ba_kernels():
    """K6 (csrc/ba_linearize.cu) and K7 (csrc/ba_accumulate.cu) against
    their plain versions on the card, at the main path's shape (8 frames in
    8 slots, 2,048 points hosted by every frame, 640x480;
    torch_kernel_checks.ba_scene): K6 on the window, its newest column, the
    planted window (BA_PLANTS and a NaN patch, the Huber threshold on one
    tap), its column and with both affine parameters off, every field and
    the energy sum bitwise (lin_err); K7's top part in modes 0, 1 and 2 and
    its Schur part with and without the shifted prior, on the scene's
    linearized window and on the planted one, held by acc_err, and those
    five at 23 and 32 slots, all bitwise their own order (acc_emulated);
    20 launches of each bitwise; both under vmap over two windows, one
    launch each.
    Returns the two kernel records with their times (`ms`, `plain_ms`
    single calls, `device_ms` 20 launches in one CUDA graph; K7's the mean
    over build_system's three calls) and bounds."""
    from ldso_tpu_torch.backend import ba
    from ldso_tpu_torch.ops import cuda_kernels
    kc = _kernel_checks()
    t0 = time.perf_counter()
    scene = kc.ba_scene(kc.BA_SLOTS, kc.BA_SLOTS, kc.BA_POINTS, 640, 480,
                        seed=3, device="cuda")
    w, h = scene["w"], scene["h"]
    cases = kc.lin_cases(scene)
    launches = cuda_kernels.LAUNCHES["ba_linearize"]
    lin_bad = {}
    for name, (W, dIs, cfg, tgt) in cases.items():
        rep = kc.lin_err(_lin_call(W, dIs, cfg, w, h, tgt)(),
                         kc.plain_lin(W, dIs, cfg, w, h, tgt))
        if not rep["ok"]:
            _fail(f"K6 {name}: not bitwise its plain version: "
                  f"{rep['not_bitwise']}, energy bitwise "
                  f"{rep['energy_bitwise']}, max|err| {rep['max_abs_err']}")
        lin_bad[name] = rep["max_abs_err"]
    if cuda_kernels.LAUNCHES["ba_linearize"] != launches + len(cases):
        _fail("K6: not one launch per case")
    W, dIs, cfg, tgt = cases["planted"]
    kernel = _lin_call(W, dIs, cfg, w, h, tgt)
    first = kernel()
    for rep in range(1, DET_REPEATS):
        if not kc.lin_err(kernel(), first)["ok"]:
            _fail(f"K6: launch {rep} differs from launch 0")
    W, dIs, cfg, _ = cases["window"]
    kernel = _lin_call(W, dIs, cfg, w, h, None)
    lin = dict(name="ba_linearize", route="cuda",
               source="ldso_tpu_torch/csrc/ba_linearize.cu",
               replaces="ldso_tpu/backend/ba.py:148",
               max_abs_err=max(lin_bad.values()), cases=len(cases),
               ms=_median_event_ms(kernel),
               device_ms=_graph_device_ms(kernel),
               plain_ms=_median_event_ms(
                   lambda: kc.plain_lin(W, dIs, cfg, w, h), reps=10,
                   warmup=2),
               library_ms=None, residuals=W.P * W.F,
               linearized=int(ba._lin_mask(W).sum()))
    lin["bound_ms"], lin["bound_by"] = lin_bound_ms(W, dIs, cfg, w, h)
    column = _lin_call(W, dIs, cfg, w, h, kc.BA_SLOTS - 1)
    lin["column_device_ms"] = _graph_device_ms(column)

    planted = cases["planted"]
    windows = {"scene": scene["W_lin"],
               "planted": kc.linearized(*planted[:3], w, h)}
    worst, acc_faults, n_acc, acc_abs = {}, [], 0, 0.0
    emu_faults = []
    for tag, Wl in windows.items():
        for name, (part, args) in kc.acc_cases(Wl).items():
            got = kc.kernel_acc(part, Wl, args)
            rep = kc.acc_err(got, kc.plain_acc(part, Wl, args),
                             kc.acc_scale(part, Wl, args))
            n_acc += 1
            acc_abs = max(acc_abs, rep["max_abs_err"])
            if not rep["ok"]:
                acc_faults.append(f"{tag} {name}: {rep['faults']}")
            for k, v in rep["worst"].items():
                worst[k] = max(worst.get(k, 0.0), v)
            emu = kc.acc_emulated_err(got, kc.acc_emulated(part, Wl, args))
            if emu:
                emu_faults.append(f"{tag} {name}: {emu}")
    # wider windows than the main path's (the Schur finisher's shared
    # memory grows with the slots): 23 and 32 slots, 48 points a slot,
    # 96x64, bitwise their own order
    wide = (23, cuda_kernels.BA_MAX_SLOTS)
    for F in wide:
        Wf = kc.ba_scene(F, F, 48 * F, 96, 64, seed=5,
                         device="cuda")["W_lin"]
        for name, (part, args) in kc.acc_cases(Wf).items():
            emu = kc.acc_emulated_err(kc.kernel_acc(part, Wf, args),
                                      kc.acc_emulated(part, Wf, args))
            if emu:
                emu_faults.append(f"{F} slots {name}: {emu}")
    if acc_faults:
        _fail(f"K7: {acc_faults}")
    if emu_faults:
        _fail(f"K7 against its own order written out (acc_emulated), not "
              f"bitwise: {emu_faults}")
    Wl = windows["scene"]
    acc_cases = kc.acc_cases(Wl)
    run = lambda c: lambda: kc.kernel_acc(c[0], Wl, c[1])  # noqa: E731
    first = run(acc_cases["sc build"])()
    for rep in range(1, DET_REPEATS):
        if not all(_same(a, first[k]) for k, a in
                   run(acc_cases["sc build"])().items()):
            _fail(f"K7: launch {rep} differs from launch 0")
    parts = {}
    for name in ("top mode 0", "top mode 1", "sc build"):
        part, args = acc_cases[name]
        t = dict(ms=_median_event_ms(run(acc_cases[name])),
                 device_ms=_graph_device_ms(run(acc_cases[name])),
                 plain_ms=_median_event_ms(
                     lambda p=part, a=args: kc.plain_acc(p, Wl, a), reps=10,
                     warmup=2))
        t["bound_ms"], t["bound_by"] = acc_bound_ms(part, Wl, args)
        parts[name] = t
    mean = lambda k: float(np.mean([t[k] for t in parts.values()]))  # noqa: E731
    by = [t["bound_by"] for t in parts.values()]
    acc = dict(name="ba_accumulate", route="cuda",
               source="ldso_tpu_torch/csrc/ba_accumulate.cu",
               replaces="ldso_tpu/backend/ba.py:519",
               max_abs_err=acc_abs, tol_share=max(worst.values()),
               cases=n_acc,
               ms=mean("ms"), device_ms=mean("device_ms"),
               plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
               bound_by=max(set(by), key=by.count), library_ms=None,
               parts=parts, worst_share=worst)
    lin_v, acc_v = _vmapped_one_launch(kc, scene, planted)
    report = cuda_kernels.ptxas_report("ba_linearize.cu")
    lin["ptxas"] = ptxas_facts(report, "linearize_kernel")
    report = cuda_kernels.ptxas_report("ba_accumulate.cu")
    acc["ptxas"] = {k: ptxas_facts(report, k) for k in (
        "top_points", "top_chunks", "sc_points", "sc_chunks")}
    print(f"K6 ba_linearize: {len(cases)} cases at 640x480 ({kc.BA_POINTS} "
          f"points, {kc.BA_SLOTS} slots, planted {sorted(kc.BA_PLANTS.values())}"
          f" and a NaN patch), every field and the energy sum bitwise its "
          f"plain version; {DET_REPEATS} launches bitwise; the window "
          f"({lin['linearized']} of {lin['residuals']} residuals "
          f"linearized): {lin['ms']:.4f} ms per single call, "
          f"{lin['device_ms'] * 1e3:.2f} us of device time per launch (20 in "
          f"a graph; the column mode {lin['column_device_ms'] * 1e3:.2f} us), "
          f"plain {lin['plain_ms']:.3f} ms; bound "
          f"{lin['bound_ms'] * 1e3:.3f} us set by {lin['bound_by']}, "
          f"{100 * lin['bound_ms'] / lin['device_ms']:.2f}% of it reached; "
          f"under vmap over 2 windows {lin_v} launch", flush=True)
    print(f"K7 ba_accumulate: {n_acc} calls (top modes 0, 1, 2 and Schur "
          f"with and without the prior, on the scene and the planted "
          f"window) within acc_err, at most {acc['tol_share']:.4f} of the "
          f"tolerance ({ {k: round(v, 4) for k, v in worst.items()} }), "
          f"and bitwise their own order written out (acc_emulated), as "
          f"are the five at {wide[0]} and {wide[1]} slots (96x64, 48 points "
          f"a slot); {DET_REPEATS} launches bitwise; per call of build_system's "
          f"three: {acc['ms']:.4f} ms single, "
          f"{acc['device_ms'] * 1e3:.2f} us of device time, plain "
          f"{acc['plain_ms']:.3f} ms, bound {acc['bound_ms'] * 1e3:.3f} us "
          f"({ {k: round(t['device_ms'] * 1e3, 2) for k, t in parts.items()} } "
          f"us by part); under vmap over 2 windows {acc_v} launches; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return lin, acc


@contextlib.contextmanager
def held_to_plain(stats: dict):
    """While inside, every K6 and K7 call on the card also runs its plain
    version on the same inputs: K6 is held to it bitwise (lin_err), K7 by
    acc_err and bitwise to its own order written out (acc_emulated); the
    kernel's result is what the caller gets. Counts and
    faults go into `stats` (k6, k7, faults, worst)."""
    from ldso_tpu_torch.backend import ba
    from ldso_tpu_torch.ops import cuda_kernels as ck
    kc = _kernel_checks()
    lin, top, sc = ck.ba_linearize, ck.ba_accumulate_top, ck.ba_accumulate_sc
    stats.update(k6=0, k7=0, faults=[], worst=0.0, max_abs_err=0.0)

    def lin_held(W, dIs, pc, cfg, w, h, tgt=None):
        got = lin(W, dIs, pc, cfg, w, h, tgt)
        rep = kc.lin_err(got, ba.linearize_ref(W, dIs, pc, cfg, w, h, tgt))
        stats["k6"] += 1
        if not rep["ok"]:
            stats["faults"].append(f"K6 call {stats['k6']}: "
                                   f"{rep['not_bitwise']}")
        return got

    def acc_check(part, W, args, got):
        want = kc.plain_acc(part, W, args)
        rep = kc.acc_err(got, want, kc.acc_scale(part, W, args))
        emu = kc.acc_emulated_err(got, kc.acc_emulated(part, W, args))
        if emu:
            stats["faults"].append(f"K7 {part} call {stats['k7'] + 1} against "
                                   f"acc_emulated: {emu}")
        stats["k7"] += 1
        stats["worst"] = max([stats["worst"]] + list(rep["worst"].values()))
        stats["max_abs_err"] = max(stats["max_abs_err"], rep["max_abs_err"])
        if not rep["ok"]:
            stats["faults"].append(f"K7 {part} call {stats['k7']}: "
                                   f"{rep['faults']}")

    def top_held(W, pc, mode, mask):
        got = top(W, pc, mode, mask)
        acc_check("top", W, (pc, mode, mask), dict(zip(ck.TOP_OUTPUTS, got)))
        return got

    def sc_held(W, Hdd, bd, Hcd, shift, mask):
        got = sc(W, Hdd, bd, Hcd, shift, mask)
        acc_check("sc", W, (Hdd, bd, Hcd, shift, mask), got)
        return got
    ck.ba_linearize, ck.ba_accumulate_top = lin_held, top_held
    ck.ba_accumulate_sc = sc_held
    try:
        yield stats
    finally:
        ck.ba_linearize, ck.ba_accumulate_top = lin, top
        ck.ba_accumulate_sc = sc


@contextlib.contextmanager
def recorded_marg():
    """Yields a list that gets the inputs of every point marginalization
    through its graph inside (energy_functional.replay_marg; a
    FullSystem's placeholder capture included): (W, marg_cand, drop, dIs,
    min_idepth_h, fac, cfg, img_w, img_h). The system writes none of them
    in place."""
    from ldso_tpu_torch.backend import energy_functional as efm
    seen = []
    replay = efm.replay_marg

    def recorded(*args):
        seen.append(args)
        return replay(*args)
    efm.replay_marg = recorded
    try:
        yield seen
    finally:
        efm.replay_marg = replay


def phase_ba_frame(ba_records, marg_records, lin_rec, acc_rec):
    """Every device-LM call and every point marginalization of phase 3
    again, eagerly from its recorded inputs, with each K6 and K7 call held
    to its plain version on the same inputs (`held_to_plain`): K6 bitwise,
    K7 within acc_err. Fills in the records."""
    from ldso_tpu_torch.backend import ba_device, energy_functional as efm
    calls = _ba_calls(ba_records)
    margs = [r for r in marg_records if bool(r[0].frame_valid.any())]
    t0 = time.perf_counter()
    with held_to_plain({}) as stats:
        for c in calls:
            ba_device.optimize_device(*c)
        n6, n7 = stats["k6"], stats["k7"]
        for m in margs:
            efm.marg_points_packed(*m)
    if stats["faults"]:
        _fail(f"phase 3's BA and marginalization calls against the plain "
              f"versions: {stats['faults'][:6]}")
    want6 = sum(c[-1] + 2 for c in calls) + len(margs)
    want7 = sum(3 * c[-1] for c in calls) + 2 * len(margs)
    if (stats["k6"], stats["k7"]) != (want6, want7):
        _fail(f"phase 3's calls again: {stats['k6']} K6 and {stats['k7']} "
              f"K7 calls, want {want6} and {want7}")
    lin_rec.update(phase3_calls=stats["k6"], phase3_bitwise=True)
    acc_rec.update(phase3_calls=stats["k7"],
                   phase3_tol_share=stats["worst"])
    acc_rec["tol_share"] = max(acc_rec["tol_share"], stats["worst"])
    acc_rec["max_abs_err"] = max(acc_rec["max_abs_err"], stats["max_abs_err"])
    print(f"K6/K7 on phase 3: its {len(calls)} BA calls ({n6} K6 and {n7} "
          f"K7 calls) and {len(margs)} point marginalizations "
          f"({stats['k6'] - n6} and {stats['k7'] - n7}) again, eagerly: every "
          f"K6 call bitwise its plain version, every K7 call within acc_err "
          f"(at most {stats['worst']:.4f} of the tolerance) and bitwise "
          f"acc_emulated; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_marg_graph(marg_records, strict: dict):
    """3e: the point marginalization as one graph replay
    (energy_functional.replay_marg) on phase 3's last recorded inputs: the
    replay bitwise the eager program (marg_points_packed), its launches
    (1 K6, 2 K7) per replay, and the replay and its HostCopy under
    torch.cuda.set_sync_debug_mode("error") behind 50 ms of queued sleep
    (it returns inside the sleep, the copy not ready, its result bitwise
    the eager one); phase 3 ran one replay and one pull per keyframe that
    marginalized. Returns the numbers."""
    import torch
    from ldso_tpu_torch.backend import energy_functional as efm
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.utils.device import HostCopy
    margs = [r for r in marg_records if bool(r[0].frame_valid.any())]
    if not margs or strict["marg_replays"] != strict["marg_dispatches"] \
            or strict["marg_replays"] < strict["post_bootstrap_keyframes"]:
        _fail(f"3e: phase 3 ran {strict['marg_replays']} marginalization "
              f"replays for {strict['marg_dispatches']} dispatches and "
              f"{strict['post_bootstrap_keyframes']} post-bootstrap "
              f"keyframes ({len(margs)} recorded)")
    last = margs[-1]
    want = efm.marg_points_packed(*last)
    cuda_kernels.reset_launch_counts()
    got = efm.replay_marg(*last)
    per = (cuda_kernels.LAUNCHES["ba_linearize"],
           cuda_kernels.LAUNCHES["ba_accumulate"])
    if per != (1, 2):
        _fail(f"3e: a marginalization replay launched {per} K6, K7 (want "
              f"1, 2)")
    for name, g, e in zip(efm.Window._fields + ("packed",),
                          tuple(got[0]) + (got[1],),
                          tuple(want[0]) + (want[1],)):
        if not _same(g, e):
            _fail(f"3e: the marginalization graph's {name} differs from the "
                  f"eager program")
    torch.cuda.synchronize()
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * 50.0))
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = time.perf_counter()
        out = efm.replay_marg(*last)
        pull = HostCopy(out[1])
        queued_ms = (time.perf_counter() - t) * 1e3
        pulled = pull.is_ready()
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode(0)
        _fail(f"3e: the marginalization's replay or pull synchronised: {e}")
    torch.cuda.set_sync_debug_mode(0)
    if pulled or not queued_ms < 25.0 or not np.array_equal(
            pull.numpy().view(np.int32),
            want[1].cpu().numpy().view(np.int32)):
        _fail(f"3e: the replay and pull queued in {queued_ms:.2f} ms behind "
              f"50 ms of sleep, copy ready {pulled}, or its result differs")
    res = dict(replays=strict["marg_replays"],
               dispatches=strict["marg_dispatches"],
               launches_per_replay=dict(k6=per[0], k7=per[1]),
               queued_ms_in_sync_check=queued_ms,
               device_ms=_queued_device_ms(lambda: efm.replay_marg(*last),
                                           n=5, reps=5),
               eager_ms=_host_us_per_call(
                   lambda: efm.marg_points_packed(*last), n=3) / 1e3,
               packed_shape=list(want[1].shape),
               captures=efm.MARG_GRAPHS.counts["count"])
    print(f"3e point marginalization: {res['replays']} graph replays and "
          f"pulls for {res['dispatches']} dispatches in phase 3; the last "
          f"replay bitwise the eager program, 1 K6 and 2 K7 launches per "
          f"replay; replay and pull queued in {queued_ms:.2f} ms under "
          f"set_sync_debug_mode('error') behind 50 ms of sleep, the copy "
          f"not ready; {res['device_ms']:.4f} ms of device time per replay, "
          f"{res['eager_ms']:.2f} ms per eager call; packed "
          f"{res['packed_shape']}", flush=True)
    return res


@contextlib.contextmanager
def recorded_kf_programs():
    """Yields a dict that gets, for each of the keyframe's four program
    families (the activation's and the three after the BA), the last call
    inside (full_system._program: family -> [static, program, inputs,
    calls]). The system writes none of the inputs in place."""
    from ldso_tpu_torch.system import full_system as fsm
    fams = (fsm.ACTIVATE_GRAPHS, fsm.POST_BA_GRAPHS, fsm.TRACKER_REF_GRAPHS,
            fsm.NEW_TRACES_GRAPHS)
    seen = {}
    program = fsm._program

    def recorded(family, static, fn, inputs):
        if any(family is f for f in fams):
            calls = seen[family][3] + 1 if family in seen else 1
            seen[family] = [static, fn, tuple(inputs), calls]
        return program(family, static, fn, inputs)
    fsm._program = recorded
    try:
        yield seen
    finally:
        fsm._program = program


def phase_bootstrap_program(calib, images, strict: dict):
    """3h: the bootstrap's frames as one captured program. In phase 3's
    run the bootstrap's graph was captured at the first frame only (none,
    where an earlier system had captured its key) and each bootstrap frame
    was one replay and one pull (_no_capture_inside). Then a bootstrap of
    phase 3's frames on a family of its own: set_first and the graph's
    capture at the first frame, no capture after; each later frame's
    dispatch under set_sync_debug_mode("error") behind INIT_SLEEP_MS of
    queued sleep returns before its pull is ready; each replay's outputs
    are bitwise the eager masked program's on the recorded inputs; the
    early-exit loop (tests/torch_init_parent.py) on each frame's entry
    state gives the live trips per level, which the masked program reports
    too; device ms per replay from replays behind a sleep. Returns the
    numbers."""
    import copy
    import torch
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.frontend import initializer
    from ldso_tpu_torch.ops.preprocess import make_pyramid, upload_image
    from ldso_tpu_torch.utils.graphs import Programs
    _kernel_checks()                      # tests/ on the path
    import torch_init_parent
    t0 = time.perf_counter()
    cfg = dataclasses.replace(Config(), enable_loop_closing=False)
    saved, run = initializer.INIT_GRAPHS, initializer._run
    fam = initializer.INIT_GRAPHS = Programs(capture_on_replay=False)
    calls = []

    def recorded(family, static, fn, inputs):
        out = run(family, static, fn, inputs)
        calls.append((static, fn, tuple(inputs), out))
        return out
    initializer._run = recorded
    cycles = int(_sleep_cycles_per_ms() * INIT_SLEEP_MS)
    rows = []
    try:
        pyr0 = make_pyramid(upload_image(images[0], "cuda"), calib.levels)
        st = initializer.set_first(pyr0, calib, cfg)
        initializer.capture_frame_program(st, pyr0, calib, cfg)
        captured0 = fam.counts["count"]
        for k in range(1, len(images)):
            pyr = make_pyramid(upload_image(images[k], "cuda"), calib.levels)
            entry = copy.deepcopy(st)
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            torch.cuda.set_sync_debug_mode("error")
            try:
                t = time.perf_counter()
                pull = initializer.track_frame_dispatch(st, pyr0, pyr, calib,
                                                        cfg)
                host_ms = (time.perf_counter() - t) * 1e3
                ready = pull.is_ready()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            done = initializer.track_frame_finish(st, pull)
            trips = []
            torch_init_parent.track_frame(entry, pyr0, pyr, calib, cfg,
                                          trips=trips)
            rows.append(dict(frame=k, host_ms=host_ms, ready=ready,
                             trips=list(st.trips), early_exit_trips=trips,
                             snapped=st.snapped))
            if done:
                break
        captured = fam.counts["count"]
        replays = fam.counts["replays"]
        bad = []
        for k, (static, fn, inputs, out) in enumerate(calls):
            want = fn(*inputs)
            if len(out) != len(want) or not all(
                    _same(g, w) for g, w in zip(out, want)):
                bad.append(k)
        static, fn, inputs, _ = calls[-1]
        device_ms = _queued_device_ms(
            lambda: fam.replay(static, fn, inputs), n=5,
            reps=3)
        eager_ms = _host_us_per_call(lambda: fn(*inputs), n=1) / 1e3
    finally:
        initializer.INIT_GRAPHS, initializer._run = saved, run
    live = [sum(r["trips"]) for r in rows]
    full = sum(initializer.MAX_ITERATIONS[:calib.levels]) + calib.levels
    res = dict(phase3_frames=strict["boot_dispatches"],
               phase3_capture_frames=strict["init_capture_frames"],
               frames=len(rows), captured_at_first=captured0,
               captured=captured, replays=replays,
               not_bitwise=bad, device_ms=device_ms, eager_host_ms=eager_ms,
               trips_per_frame=full, rows=rows,
               trips_agree=sum(r["trips"] == r["early_exit_trips"]
                               for r in rows))
    print(f"3h bootstrap program: phase 3's {strict['boot_dispatches']} "
          f"bootstrap frames were as many replays and pulls, the graph "
          f"captured at frames {strict['init_capture_frames']}; a fresh "
          f"bootstrap of {len(rows)} frames: {captured0} graph captured at "
          f"the first frame, {captured} in all, {replays} replays, each "
          f"bitwise its eager program but {bad}; dispatch host ms "
          f"{[round(r['host_ms'], 2) for r in rows]} behind "
          f"{INIT_SLEEP_MS} ms of sleep, pull ready at return "
          f"{sum(r['ready'] for r in rows)}; live trips per frame {live} of "
          f"{full} (per level, coarsest first: "
          f"{[r['trips'] for r in rows]}; the early-exit loop's "
          f"{[r['early_exit_trips'] for r in rows]}); device "
          f"{device_ms:.3f} ms a replay, eager {eager_ms:.1f} host ms; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not (captured0 == captured == 1 and replays == len(rows) > 0):
        _fail(f"3h: {captured0} bootstrap graphs captured at the first "
              f"frame, {captured} in all, {replays} replays for "
              f"{len(rows)} frames")
    if bad or any(r["ready"] for r in rows):
        _fail(f"3h: replays {bad} differ from their eager program, or a "
              f"frame's pull was ready when its dispatch returned")
    if not rows[-1]["snapped"]:
        _fail("3h: the bootstrap did not snap on phase 3's frames")
    return res


def _static_mib(family) -> float:
    """The MiB of a program family's graphs' static inputs and outputs."""
    return sum(x.numel() * x.element_size() for g in family.graphs.values()
               for x in g.static_in + g.static_out) / 2 ** 20


def _device_records(run, reps: int):
    """The card's kernel and copy records of `reps` calls of `run` from
    torch.profiler: (start ns, duration ns, name), sorted by start."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1e3, e.duration_us() * 1e3
        out.append((start, dur, e.name()))
    return sorted(out)


# the parts of a frame step's device time (`_step_split`)
STEP_PARTS = ("copies", "pyramid", "k3", "tracker_rest", "tables", "k4",
              "selects")


def _step_split(records, reps: int) -> dict:
    """A frame step's device time by part from its card records over
    `reps` calls, in launch order: `copies` (every memcpy and memset: a
    replay's inputs copied in, its outputs cloned out, the program's own
    copies), `k3` and `k4` (their kernels), then every other kernel by
    where it ran: `pyramid` before the first K3 launch, `tracker_rest`
    between K3 launches, `tables` after the last K3 launch and before K4
    (the tracker's tail, the gate and the trace's tables) and `selects`
    after K4 (the arena's selects, the packed row); since K2, `pyramid`
    is K2's kernel alone, and the other kernels before the first K3 launch
    count to `tracker_rest`. `before_k3` (not a part: its kernels are in
    `pyramid` and `tracker_rest`) is every kernel before the first K3
    launch, the `pyramid` part as it was measured before K2. Returns
    {part: {ms, kernels}} per call, `before_k3` and the busy ms per
    call."""
    ms = dict.fromkeys(STEP_PARTS + ("before_k3",), 0.0)
    count = dict.fromkeys(STEP_PARTS + ("before_k3",), 0)
    state, pending = "pre", []

    def add(part, dur):
        ms[part] += dur * 1e-6 / reps
        count[part] += 1
        if state == "pre" and part in ("pyramid", "tracker_rest"):
            ms["before_k3"] += dur * 1e-6 / reps
            count["before_k3"] += 1
    for _, dur, name in records:
        if name.startswith(("Memcpy", "Memset")):
            add("copies", dur)
            if state == "selects":
                state = "pre"              # the next call's copies in
        elif "pyramid_kernel" in name:
            add("pyramid", dur)
        elif "tracker_trip_kernel" in name:
            for d in pending:
                add("tracker_rest", d)
            pending = []
            add("k3", dur)
            state = "tracker"
        elif "immature_trace_kernel" in name:
            for d in pending:
                add("tables", d)
            pending = []
            add("k4", dur)
            state = "selects"
        elif state == "tracker":
            pending.append(dur)
        else:
            add("tracker_rest" if state == "pre" else state, dur)
    for d in pending:
        add("tracker_rest", d)
    return dict(parts={p: dict(ms=ms[p], kernels=count[p] / reps)
                       for p in STEP_PARTS},
                before_k3=dict(ms=ms["before_k3"],
                               kernels=count["before_k3"] / reps),
                busy_ms=sum(ms[p] for p in STEP_PARTS))


# K2's arithmetic per output pixel (the mean, the differences, their
# tests, absSquaredGrad and the b_grad weight), for its operations bound
PYR_OPS = 20


def pyramid_bound_ms(H: int, W: int, levels: int, frame_bytes: int,
                     b_grad: bool = False):
    """K2's pyramid bound: the frame read once (and the b_grad table), and
    every level's dI (H, W, 3) and abs_grad (H, W) float32 written once,
    over the card's memory rate, against PYR_OPS operations a pixel over
    its float32 rate. Returns (ms, "bytes" or "operations")."""
    from ldso_tpu_torch.ops.cuda_kernels import pyramid_shapes
    px = sum(h * w for h, w in pyramid_shapes(H, W, levels))
    t_bytes = (frame_bytes + 1024 * b_grad + 16 * px) / PEAK_BYTES_S
    t_ops = PYR_OPS * px / PEAK_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rectify_bound_ms(raw, G, vig, remap_x) -> float:
    """K2's rectify bound: the raw frame, its response table and inverse
    vignette read once, the two remap maps read once and the image written
    once, over the card's memory rate (its 30 operations a pixel take a
    hundredth of that)."""
    n = (raw.numel() * raw.element_size() + 4 * remap_x.numel() * 3
         + sum(4 * t.numel() for t in (G, vig) if t is not None))
    return n / PEAK_BYTES_S * 1e3


def phase_preprocess_kernel(device="cuda"):
    """K2 (csrc/preprocess.cu) against its plain versions
    (ops/preprocess.make_pyramid_ref and rectify_ref) on the card, bitwise:
    the pyramid on the cases of torch_kernel_checks.pyramid_cases (the
    bench scene's 640x480 uint8 frame at the main path's 4 levels with and
    without a b_grad table, a float32 frame with steps of more than 255,
    uint16, levels that end odd, 6 levels, one level), one launch each;
    the rectification on rectify_cases (uint8 and int32 raw with a
    response table, the inverse vignette, invalid and edge-clamped remap
    coordinates, float32 raw), one launch each; 20 launches of each
    bitwise; the times and bounds of the main path's pyramid and of the
    readers' rectification. Returns the two kernel records (their
    launches are filled in from the paths)."""
    import torch
    from ldso_tpu_torch.ops import cuda_kernels, preprocess
    kc = _kernel_checks()
    t0 = time.perf_counter()
    pyr_cases = kc.pyramid_cases(device)
    rect_cases = kc.rectify_cases(device)
    before = dict(cuda_kernels.LAUNCHES)
    worst = dict(pyramid=0.0, rectify=0.0)
    for name, (img, L, b) in pyr_cases.items():
        got = preprocess.make_pyramid(img, L, b)
        want = preprocess.make_pyramid_ref(img, L, b)
        for x, y in zip(got.dI + got.abs_grad, want.dI + want.abs_grad):
            worst["pyramid"] = max(worst["pyramid"], float(
                torch.nan_to_num(torch.abs(x - y)).max()))
        if not kc.pyramid_bitwise(got, want):
            _fail(f"K2 pyramid: case {name!r} not bitwise its plain "
                  f"version (max|kernel - plain| {worst['pyramid']})")
    for name, (raw, G, vig, rx, ry) in rect_cases.items():
        got = preprocess.rectify(raw, G, vig, rx, ry)
        want = preprocess.rectify_ref(raw, G, vig, rx, ry)
        worst["rectify"] = max(worst["rectify"],
                               float(torch.abs(got - want).max()))
        if not (got.shape == want.shape and bool(kc.bits(got, want).all())):
            _fail(f"K2 rectify: case {name!r} not bitwise its plain version "
                  f"(max|kernel - plain| {worst['rectify']})")
    n = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in worst}
    if device == "cuda" and n != dict(pyramid=len(pyr_cases),
                                      rectify=len(rect_cases)):
        _fail(f"K2: launches {n} for {len(pyr_cases)} pyramid and "
              f"{len(rect_cases)} rectify cases")
    for name in ("uint8 640x480", "float32 steps b_grad"):
        img, L, b = pyr_cases[name]
        first = preprocess.make_pyramid(img, L, b)
        for rep in range(1, DET_REPEATS):
            if not kc.pyramid_bitwise(preprocess.make_pyramid(img, L, b),
                                      first):
                _fail(f"K2 pyramid {name!r}: launch {rep} differs from "
                      f"launch 0")
    raw, G, vig, rx, ry = rect_cases["int32 G vignette"]
    first = preprocess.rectify(raw, G, vig, rx, ry)
    for rep in range(1, DET_REPEATS):
        if not bool(kc.bits(preprocess.rectify(raw, G, vig, rx, ry),
                            first).all()):
            _fail(f"K2 rectify: launch {rep} differs from launch 0")

    img, L, _ = pyr_cases["uint8 640x480"]
    kernel = lambda: preprocess.make_pyramid(img, L)  # noqa: E731
    bound, by = pyramid_bound_ms(*img.shape, L, img.numel())
    pyr = dict(name="pyramid", route="cuda",
               source="ldso_tpu_torch/csrc/preprocess.cu",
               replaces="ldso_tpu/ops/preprocess.py:124",
               max_abs_err=worst["pyramid"], cases=len(pyr_cases),
               ms=_median_event_ms(kernel), device_ms=_graph_device_ms(kernel),
               plain_ms=_median_event_ms(
                   lambda: preprocess.make_pyramid_ref(img, L)),
               bound_ms=bound, bound_by=by, library_ms=None,
               plan=cuda_kernels.pyramid_plan(*img.shape, L),
               smem_bytes={})
    for lv in range(1, cuda_kernels.PYRAMID_MAX_LEVELS + 1):
        plan = cuda_kernels.pyramid_plan(*img.shape, lv)
        lib = cuda_kernels.library_pyramid_plan(*img.shape, lv)
        if plan != lib:
            _fail(f"K2 pyramid: the plan {plan} at {lv} levels is not the "
                  f"library's {lib}")
        pyr["smem_bytes"][lv] = lib["smem"]
    img6, L6, b6 = pyr_cases["6 levels"]
    pyr["device_ms_6_levels_float32"] = _graph_device_ms(
        lambda: preprocess.make_pyramid(img6, L6, b6))
    raw, G, vig, rx, ry = rect_cases["uint8 G vignette"]
    kernel = lambda: preprocess.rectify(raw, G, vig, rx, ry)  # noqa: E731
    # the library's bilinear remap (no response table or vignette, a
    # border clamp): torch's grid_sample on the float32 raw case, timed
    # as a yardstick only
    rawf, _, _, _, _ = rect_cases["float32"]
    h_org, w_org = rawf.shape
    grid = torch.stack([torch.clamp(rx, 0.0, w_org - 1.001) / (w_org - 1),
                        torch.clamp(ry, 0.0, h_org - 1.001) / (h_org - 1)],
                       -1)[None] * 2.0 - 1.0
    library = lambda: torch.nn.functional.grid_sample(  # noqa: E731
        rawf[None, None], grid, mode="bilinear", padding_mode="border",
        align_corners=True)
    rect = dict(name="rectify", route="cuda",
                source="ldso_tpu_torch/csrc/preprocess.cu",
                replaces="ldso_tpu/ops/preprocess.py:132",
                max_abs_err=worst["rectify"], cases=len(rect_cases),
                ms=_median_event_ms(kernel),
                device_ms=_graph_device_ms(kernel),
                plain_ms=_median_event_ms(
                    lambda: preprocess.rectify_ref(raw, G, vig, rx, ry)),
                bound_ms=rectify_bound_ms(raw, G, vig, rx),
                bound_by="bytes", library_ms=_median_event_ms(library),
                library_call="torch.nn.functional.grid_sample (float32 "
                             "raw, bilinear, border clamp)")
    report = cuda_kernels.ptxas_report("preprocess.cu")
    # the main path's instantiation: its level count's
    for rec, k in ((pyr, f"pyramid_kernelILi{L}EE"),
                   (rect, "rectify_kernel")):
        rec["ptxas"] = ptxas_facts(report, k)
    print(f"K2 pyramid: {len(pyr_cases)} cases bitwise their plain version "
          f"({sorted(pyr_cases)}), {DET_REPEATS} launches bitwise; at "
          f"640x480 uint8, 4 levels: {pyr['device_ms'] * 1e3:.3f} us of "
          f"device time per launch (20 in a graph), {pyr['ms']:.4f} ms a "
          f"single call, plain {pyr['plain_ms']:.4f} ms, bound "
          f"{pyr['bound_ms'] * 1e3:.3f} us ({pyr['bound_by']}, "
          f"{100 * pyr['bound_ms'] / pyr['device_ms']:.1f}% of the device "
          f"time); 6 levels float32 "
          f"{pyr['device_ms_6_levels_float32'] * 1e3:.3f} us; shared memory "
          f"{pyr['smem_bytes']}, ptxas {pyr['ptxas']}. K2 rectify: "
          f"{len(rect_cases)} cases bitwise ({sorted(rect_cases)}), "
          f"{DET_REPEATS} launches bitwise; 640x480 onto 600x440: "
          f"{rect['device_ms'] * 1e3:.3f} us of device time per launch, "
          f"plain {rect['plain_ms']:.4f} ms, grid_sample "
          f"{rect['library_ms']:.4f} ms, bound "
          f"{rect['bound_ms'] * 1e3:.3f} us, ptxas {rect['ptxas']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return pyr, rect


def _k2_check(what: str, launches: int, expected: int) -> None:
    """K2's pyramid ran on this path exactly as often as its steps'
    replays, their captures and the bootstrap's frames imply
    (time_modes.counted_pyramids' `k2_expected`), so no pyramid went
    through the plain version."""
    if not launches == expected > 0:
        _fail(f"{what}: K2's pyramid launched {launches} times where the "
              f"path's step replays, captures and bootstrap frames imply "
              f"{expected}")


def _k2_run_check(run: dict) -> None:
    _k2_check(f"{run.get('phase', run['mode'])}", run["k2_launches"],
              run["k2_expected"])


def phase_frame_step_program(steps, strict: dict, fs3, images):
    """3i: the frame step as one captured program. Every post-bootstrap
    strict frame of phase 3 was one replay of the frame step's graph
    (FRAME_STEP_GRAPHS, captured when the system was built, none in the
    run; recorded_frame_steps held each replay bitwise its eager program),
    each replay K3 trips_per_track and K4 once; on phase 3's last inputs a
    replay whose gate fails (the last RMSE set under any residual) and
    one with commit 0 leave the arena bitwise as it went in, with the
    trace flag 0; a strict dispatch (`_frame_step_dispatch`) under
    set_sync_debug_mode("error") behind STEP_SLEEP_MS of queued sleep
    returns within STEP_QUEUED_MS with its HostCopy not ready and its
    result bitwise a dispatch without the sleep; the device ms per replay
    (20 replays behind a sleep), the replay's split by part from
    torch.profiler (`_step_split`), K2's bound beside the pyramid's part,
    and the graphs' static buffers and the card memory their capture
    takes. Returns the numbers."""
    import torch
    from ldso_tpu_torch.frontend import immature, tracker
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.system import full_system as fsm
    from ldso_tpu_torch.utils.graphs import Programs
    t0 = time.perf_counter()
    fam = fsm.FRAME_STEP_GRAPHS
    calib, cfg = fs3.calib, fs3.cfg
    L = calib.levels
    trips = tracker.trips_per_track(cfg, L, L - 1)
    recorded = sum(1 for f, *_ in steps if f is fam)
    post_boot = strict["frames"] - strict["boot_dispatches"] - 1
    if not (recorded == strict["frame_steps"] == strict["frame_step_replays"]
            == post_boot > 0) or strict["frame_step_captures"] or \
            strict["chain_step_replays"] or strict["chain_step_captures"]:
        _fail(f"3i: {strict['frame_steps']} frame steps, "
              f"{strict['frame_step_replays']} replays ({recorded} recorded, "
              f"{strict['frame_step_captures']} captured in the run) for "
              f"{post_boot} post-bootstrap frames; chain step "
              f"{strict['chain_step_replays']} replays")
    for g in fam.graphs.values():
        per = {k: n for k, n in g.launches.items() if "." not in k}
        if per != {"tracker_trip": trips, "trace": 1, "pyramid": 1}:
            _fail(f"3i: a frame step's graph launches {per} per replay")
    static, fn, inputs = _last_step(steps, fam)
    na = len(immature.ImmaturePool._fields) + 1
    i_up = 2 * L + 3 + na
    arena_in = inputs[2 * L + 3:i_up]
    flags = {}
    for name, at, value in (("gate_passes", 19, float("inf")),
                            ("gate_fails", 19, 1e-30),
                            ("commit_0", 20, 0.0)):
        up = inputs[i_up].clone()
        up[at] = value
        xs = inputs[:i_up] + (up,) + inputs[i_up + 1:]
        out = fam.replay(static, fn, xs)
        flag = float(out[-1][19])
        same = all(_same(o, x) for o, x in zip(out[2 * L:-1], arena_in))
        flags[name] = dict(flag=flag, arena_unchanged=same,
                           ok=float(out[-1][18]))
        if name != "gate_passes" and not (flag == 0.0 and same):
            _fail(f"3i: a replay with {name}: trace flag {flag}, arena "
                  f"bitwise unchanged {same}")

    # the strict dispatch behind a sleep, from phase 3's end
    ref, ref_shell = fs3._current_tracker_ref()
    k = len(images) - 1
    T0 = fs3.all_frames[k].T_cw @ np.linalg.inv(ref_shell.T_cw)
    args = (images[k], ref, T0, fs3.all_frames[k].aff, 1.0, ref_shell.T_cw,
            True)
    arena0, counts0 = fs3.imm_arena, dict(fam.counts)
    cuda_kernels.reset_launch_counts()
    _, first = fs3._frame_step_dispatch(*args)
    want, want_arena = first.numpy().copy(), fs3.imm_arena
    fs3.imm_arena = arena0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * STEP_SLEEP_MS))
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = time.perf_counter()
        _, packed = fs3._frame_step_dispatch(*args)
        call_ms = (time.perf_counter() - t) * 1e3
        ready = packed.is_ready()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got, got_arena = packed.numpy(), fs3.imm_arena
    fs3.imm_arena = arena0
    torch.cuda.synchronize()
    same = got.tobytes() == want.tobytes() and all(
        _same(a, b) for a, b in zip(fsm._arena_flat(got_arena),
                                    fsm._arena_flat(want_arena)))
    replays = fam.counts["replays"] - counts0["replays"]
    launches = dict(cuda_kernels.LAUNCHES)
    if not (call_ms < STEP_QUEUED_MS and not ready and same and replays == 2
            and fam.counts["count"] == counts0["count"]
            and launches["tracker_trip"] == 2 * trips
            and launches["trace"] == 2 and launches["pyramid"] == 2):
        _fail(f"3i: the strict dispatch behind {STEP_SLEEP_MS} ms of sleep "
              f"returned in {call_ms:.3f} ms, ready {ready}, bitwise {same}, "
              f"{replays} replays, K3 {launches['tracker_trip']}, K4 "
              f"{launches['trace']} and K2 {launches['pyramid']} launches "
              f"for two dispatches")

    device_ms = _queued_device_ms(lambda: fam.replay(static, fn, inputs),
                                  n=20, reps=5)
    replay_ms = _host_us_per_call(lambda: fam.replay(static, fn, inputs),
                                  n=20) / 1e3
    eager_ms = _host_us_per_call(lambda: fn(*inputs), n=3) / 1e3
    try:
        split = _step_split(_device_records(
            lambda: fam.replay(static, fn, inputs), 5), 5)
        split["source"] = "replay"
        if not split["parts"]["k3"]["kernels"]:
            split = _step_split(_device_records(lambda: fn(*inputs), 5), 5)
            split["source"] = "eager program"
    except Exception as e:  # noqa: BLE001 -- the split is reported, not held
        split = dict(source=f"not measured ({type(e).__name__}: {e})")
    frame_bytes = inputs[0].numel() * inputs[0].element_size()
    k2 = dict(bound_ms=pyramid_bound_ms(calib.h[0], calib.w[0], L,
                                        frame_bytes)[0])
    if "parts" in split:
        pyr_ms = split["parts"]["pyramid"]["ms"]
        k2.update(device_ms=pyr_ms, share_of_replay=pyr_ms / device_ms,
                  share_of_busy=pyr_ms / split["busy_ms"],
                  kernels=split["parts"]["pyramid"]["kernels"],
                  before_k3_ms=split["before_k3"]["ms"],
                  before_k3_kernels=split["before_k3"]["kernels"])

    # the card memory (allocated) of capturing both steps again for every
    # frame dtype, into families of their own
    torch.cuda.synchronize()
    fresh = (Programs(capture_on_replay=False),
             Programs(capture_on_replay=False))
    saved = (fsm.FRAME_STEP_GRAPHS, fsm.CHAIN_STEP_GRAPHS)
    alloc0 = torch.cuda.memory_allocated()
    fsm.FRAME_STEP_GRAPHS, fsm.CHAIN_STEP_GRAPHS = fresh
    try:
        fs3._capture_steps()
    finally:
        fsm.FRAME_STEP_GRAPHS, fsm.CHAIN_STEP_GRAPHS = saved
    torch.cuda.synchronize()
    mem = dict(graphs=[len(f.graphs) for f in fresh],
               static_mib=[_static_mib(f) for f in fresh],
               allocated_mib=(torch.cuda.memory_allocated() - alloc0)
               / 2 ** 20, capture_s=sum(f.counts["s"] for f in fresh))
    del fresh
    res = dict(phase3_frame_steps=strict["frame_steps"],
               phase3_replays=strict["frame_step_replays"],
               phase3_traces_committed=strict["traces"],
               captures_in_run=strict["frame_step_captures"], bitwise=True,
               gate_cases=flags, dispatch_ms=call_ms, ready_at_return=ready,
               device_ms=device_ms, replay_host_ms=replay_ms,
               eager_host_ms=eager_ms, split=split, k2=k2,
               wait_s=fam.lock_wait_s(), memory=mem)
    parts = ({p: round(v["ms"], 4) for p, v in split["parts"].items()}
             if "parts" in split else split["source"])
    print(f"3i frame step program: phase 3's {strict['frame_steps']} "
          f"post-bootstrap frames were {strict['frame_step_replays']} "
          f"replays ({strict['frame_step_captures']} captured in the run, "
          f"{strict['traces']} traces committed), K3 {trips} and K4 one "
          f"launch a replay, each bitwise its eager program; gate cases "
          f"{flags}; the strict dispatch behind {STEP_SLEEP_MS:.0f} ms of "
          f"sleep returned in {call_ms:.3f} ms (ready {ready}), bitwise; "
          f"device {device_ms:.4f} ms a replay, host {replay_ms:.3f} ms a "
          f"replay against {eager_ms:.2f} ms eager; split by part "
          f"({split['source']}) {parts}; K2 {k2}; memory {mem}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return res


def phase_activation_program(records, strict: dict, fs3):
    """3g: the activation pass as one captured program. Phase 3 activated
    once per post-bootstrap keyframe, each activation one replay of the
    activation's graph (captured when the system was built, none in the
    run), each replay one K1 and one K5 launch (recorded_activations held
    every replay's outputs bitwise to its eager program). On phase 3's last
    recorded inputs the replay is bitwise the eager program again, and its
    device ms come from 20 replays behind a sleep. The graphs' static
    buffers and the card memory their capture took are reported. Pops the
    activation's record from `records`; returns the numbers."""
    import torch
    from ldso_tpu_torch.system import full_system as fsm
    from ldso_tpu_torch.utils.graphs import Programs
    t0 = time.perf_counter()
    fam = fsm.ACTIVATE_GRAPHS
    if fam not in records:
        _fail("3g: phase 3 made no activation pass")
    static, fn, inputs, calls = records.pop(fam)
    per_replay = {tuple(sorted(g.launches.items()))
                  for g in fam.graphs.values()}
    if per_replay != {(("activate", 1), ("distance_transform", 1))}:
        _fail(f"3g: the activation's graphs launch {per_replay} per replay")
    if not (calls == strict["activations"] == strict["activate_replays"]
            == strict["post_bootstrap_keyframes"] > 0) \
            or strict["activate_captures"]:
        _fail(f"3g: {calls} activation calls, {strict['activations']} "
              f"passes, {strict['activate_replays']} replays and "
              f"{strict['activate_captures']} captures in phase 3 for "
              f"{strict['post_bootstrap_keyframes']} post-bootstrap "
              f"keyframes")
    want = fn(*inputs)
    got = fam.replay(static, fn, inputs)
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if not _same(g, w)]
    if bad or len(got) != len(want):
        _fail(f"3g: the activation's replay differs from its eager program "
              f"in outputs {bad} of {len(want)}")
    device_ms = _queued_device_ms(lambda: fam.replay(static, fn, inputs),
                                  n=20, reps=5)
    eager_ms = _host_us_per_call(lambda: fn(*inputs), n=3) / 1e3
    replay_ms = _host_us_per_call(lambda: fam.replay(static, fn, inputs),
                                  n=20) / 1e3
    # the card memory (allocated) of capturing every window size again,
    # into a family of its own
    torch.cuda.synchronize()
    fresh, alloc0 = Programs(), torch.cuda.memory_allocated()
    fsm.ACTIVATE_GRAPHS = fresh
    try:
        fs3._capture_activation()
    finally:
        fsm.ACTIVATE_GRAPHS = fam
    torch.cuda.synchronize()
    mem = dict(graphs=len(fresh.graphs), static_mib=_static_mib(fresh),
               allocated_mib=(torch.cuda.memory_allocated() - alloc0)
               / 2 ** 20, capture_s=fresh.counts["s"])
    del fresh
    res = dict(phase3_passes=calls, phase3_replays=strict["activate_replays"],
               captures_in_run=strict["activate_captures"], bitwise=True,
               last_window_frames=static[0], device_ms=device_ms,
               eager_host_ms=eager_ms, replay_host_ms=replay_ms,
               wait_s=fam.lock_wait_s(), memory=mem)
    print(f"3g activation program: phase 3's {calls} passes were "
          f"{strict['activate_replays']} replays, "
          f"{strict['activate_captures']} captured in the run, one K1 and "
          f"one K5 launch a replay, each bitwise its eager program; on the "
          f"last ({static[0]} frames) device {device_ms:.4f} ms a replay, "
          f"host {replay_ms:.3f} ms a replay against {eager_ms:.2f} ms "
          f"eager; {mem['graphs']} graphs (one per window size) hold "
          f"{mem['static_mib']:.1f} MiB of static buffers, their capture "
          f"took {mem['allocated_mib']:.1f} MiB of card memory in "
          f"{mem['capture_s']:.2f} s; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return res


def phase_keyframe_programs(records, calib, images, strict: dict, fs3):
    """3f: the keyframe's dispatch with no host read. On phase 3's last
    recorded inputs of each of the three programs (the post-BA flags and
    packed row, the tracker reference, the new candidates) the graph's
    replay is bitwise the eager program on the card, and its device ms
    (20 replays behind a sleep); phase 3 ran one replay of each per
    keyframe dispatch. Then a fresh strict system over phase 3's first
    KF_FRAMES frames, each keyframe's dispatch watched from the activation
    through the new candidates under torch.cuda.set_sync_debug_mode("error")
    behind KF_SLEEP_MS of queued sleep: it returns within KF_QUEUED_MS,
    finish.ready() is false until the sleep ends, no graph is captured,
    and the run's keyframes and tracked poses are bitwise phase 3's.
    Returns the numbers."""
    import torch
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.examples import time_modes
    from ldso_tpu_torch.system import full_system as fsm
    t0 = time.perf_counter()
    names = {id(f): n for n, f in time_modes.KF_FAMILIES.items()}
    if sorted(names.values()) != sorted(KF_PROGRAMS) or len(records) != 3:
        _fail(f"3f: {len(records)} keyframe programs recorded in phase 3")
    res = {}
    for fam, (static, fn, inputs, calls) in records.items():
        name = names[id(fam)]
        want = fn(*inputs)
        got = fam.replay(static, fn, inputs)
        bad = [i for i, (g, w) in enumerate(zip(got, want))
               if not _same(g, w)]
        if bad or len(got) != len(want):
            _fail(f"3f: {name}'s replay differs from its eager program in "
                  f"outputs {bad} of {len(want)}")
        res[name] = dict(
            phase3_calls=calls, phase3_replays=strict[f"{name}_replays"],
            outputs=len(got), bitwise=True,
            device_ms=_queued_device_ms(
                lambda: fam.replay(static, fn, inputs), n=20, reps=5),
            eager_ms=_host_us_per_call(lambda: fn(*inputs), n=3) / 1e3)
        # one call per keyframe dispatch, and the placeholder's when the
        # system was built
        if calls != strict["kf_dispatches"] + 1:
            _fail(f"3f: {calls} {name} calls in phase 3 for "
                  f"{strict['kf_dispatches']} keyframe dispatches")

    cfg = dataclasses.replace(Config(), enable_loop_closing=False)
    fs = fsm.FullSystem(calib, cfg)
    before = time_modes.kf_graph_counts()
    cycles = int(_sleep_cycles_per_ms() * KF_SLEEP_MS)
    try:
        with _kernel_checks().watched_keyframes(fs, cycles) as rows:
            for i, img in enumerate(images[:KF_FRAMES]):
                fs.add_active_frame(img, i, 1.0, i * 0.05)
    except RuntimeError as e:
        _fail(f"3f: a keyframe's dispatch read the card: {e}")
    torch.cuda.synchronize()
    after = time_modes.kf_graph_counts()
    captured = {k: after[k] - before[k] for k in after
                if k.endswith("_captures")}
    kf_ids = [f.id for f in fs.all_frames if f.kf_id >= 0]
    kf3 = [f.id for f in fs3.all_frames if f.kf_id >= 0 and f.id < KF_FRAMES]
    moved = [f.id for f, g in zip(fs.all_frames, fs3.all_frames)
             if f.kf_id < 0 and not np.array_equal(f.T_cw, g.T_cw)]
    ms = [r[0] for r in rows]
    print(f"3f keyframe programs: phase 3's {strict['kf_dispatches']} "
          f"keyframe dispatches replayed "
          f"{[strict[f'{n}_replays'] for n in KF_PROGRAMS]} times "
          f"({', '.join(KF_PROGRAMS)}), each replay bitwise its eager "
          f"program, device ms "
          f"{[round(res[n]['device_ms'], 4) for n in KF_PROGRAMS]}, eager "
          f"host ms {[round(res[n]['eager_ms'], 2) for n in KF_PROGRAMS]}; "
          f"{len(rows)} keyframe dispatches of {KF_FRAMES} frames behind "
          f"{KF_SLEEP_MS} ms of sleep under set_sync_debug_mode('error'): "
          f"activation through new candidates queued in {max(ms):.2f} ms "
          f"at most "
          f"(median {np.median(ms):.2f}), ready at return "
          f"{sum(r[1] for r in rows)}, graphs captured {captured}, "
          f"keyframes {kf_ids} (phase 3's {kf3}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if len(rows) < 3 or not max(ms) < KF_QUEUED_MS or any(r[1] for r in rows):
        _fail(f"3f: the keyframe's dispatch queued in {ms} ms, ready at "
              f"return {[r[1] for r in rows]}")
    if any(captured.values()):
        _fail(f"3f: keyframe programs captured inside the run: {captured}")
    if kf_ids != kf3 or moved:
        _fail(f"3f: behind the sleep the run made keyframes {kf_ids} "
              f"(phase 3: {kf3}), and frames {moved} tracked elsewhere")
    res.update(dispatches=len(rows), queued_ms=ms,
               sleep_ms=KF_SLEEP_MS)
    return res


def _k67_run_check(run: dict, built: int = 0) -> None:
    """K6 and K7 ran on this path, no plain version of either ran on the
    card, every point marginalization was one graph replay (and each of
    the `built` FullSystems built inside the block one more, its
    placeholder), and with the device LM every K6 and K7 launch was one of
    the BA's or the marginalization's graphs (their replays, and the
    eager warm-up of a graph captured inside)."""
    what = run.get("phase", run.get("mode"))
    if run["ba_plain_calls"]:
        _fail(f"{what}: {run['ba_plain_calls']} calls of K6's or K7's plain "
              f"version on the card")
    if not (run["k6_launches"] > 0 and run["k7_launches"] > 0):
        _fail(f"{what}: K6 launched {run['k6_launches']} and K7 "
              f"{run['k7_launches']} times")
    if run["marg_replays"] != run["marg_dispatches"] + built:
        _fail(f"{what}: {run['marg_replays']} marginalization replays for "
              f"{run['marg_dispatches']} dispatches and {built} systems "
              f"built")
    if run["ba_replays"] and (
            run["k6_launches"] != run["k6_in_graphs"]
            or run["k7_launches"] != run["k7_in_graphs"]):
        _fail(f"{what}: K6 launched {run['k6_launches']} and K7 "
              f"{run['k7_launches']} times, {run['k6_in_graphs']} and "
              f"{run['k7_in_graphs']} of them in the BA's and the "
              f"marginalization's graph replays")
    # the keyframe's three programs: one replay of each per keyframe
    # dispatch (and one per system built inside, its placeholder), no
    # graph captured but at a system's construction
    for name in KF_PROGRAMS:
        if run[f"{name}_replays"] != run["kf_dispatches"] + built \
                or run[f"{name}_captures"] > built:
            _fail(f"{what}: {run[f'{name}_replays']} {name} replays and "
                  f"{run[f'{name}_captures']} captures for "
                  f"{run['kf_dispatches']} keyframe dispatches and {built} "
                  f"systems built")
    if run["kf_dispatches"] < run.get("post_bootstrap_keyframes", 0):
        _fail(f"{what}: {run['kf_dispatches']} keyframe dispatches for "
              f"{run['post_bootstrap_keyframes']} post-bootstrap keyframes")


@contextlib.contextmanager
def k67_counted():
    """K6's and K7's counts over a block that resets cuda_kernels.LAUNCHES
    at its start (phases 4 and 6): yields a dict that gets, at exit, the
    graph launches, marginalization replays and dispatches and plain calls
    as run_mode reports them (`_k67_run_check`'s keys but the launches,
    which the caller reads)."""
    from ldso_tpu_torch.backend import energy_functional as efm
    from ldso_tpu_torch.examples import time_modes
    res = {}
    g0 = time_modes.graph_launches()
    m0 = dict(efm.MARG_GRAPHS.counts)
    b0 = efm.BA_GRAPHS.counts["replays"]
    kf0 = time_modes.kf_graph_counts()
    with time_modes.counted_ba() as bas:
        yield res
    g1 = time_modes.graph_launches()
    res.update({k: n - kf0[k] for k, n in time_modes.kf_graph_counts().items()})
    res.update(k6_in_graphs=g1["ba_linearize"] - g0["ba_linearize"],
               k7_in_graphs=g1["ba_accumulate"] - g0["ba_accumulate"],
               marg_replays=efm.MARG_GRAPHS.counts["replays"] - m0["replays"],
               marg_captures=efm.MARG_GRAPHS.counts["count"] - m0["count"],
               ba_replays=efm.BA_GRAPHS.counts["replays"] - b0, **bas)


@contextlib.contextmanager
def recorded_ba():
    """Yields a list that gets the inputs of every device-LM call inside
    (energy_functional.replay_ba, EnergyFunctional.optimize's path on the
    card; a FullSystem's placeholder captures included): (W, dIs, HM, bM,
    newest, cfg, img_w, img_h, trips). The system writes none of them in
    place, so they are kept as given."""
    from ldso_tpu_torch.backend import energy_functional as efm
    seen = []
    replay = efm.replay_ba

    def recorded(*args):
        seen.append(args)
        return replay(*args)
    efm.replay_ba = recorded
    try:
        yield seen
    finally:
        efm.replay_ba = replay


def _ba_calls(records):
    """The recorded device-LM calls of a run (not the placeholders)."""
    return [r for r in records if bool(r[0].frame_valid.any())]


def _live_trips(W, dIs, HM, bM, newest, cfg, w, h, trips) -> int:
    """The LM trips of one device-LM call before its `done`: its loop run
    eagerly with the break test read on the host."""
    from ldso_tpu_torch.backend import ba, ba_device
    W = ba_device._reset_oob_dev(W)
    W, _ = ba.linearize_all(W, dIs, cfg, w, h)
    W = ba_device._commit(ba.set_new_frame_energy_th(W, newest, cfg))
    proj = ba_device.nullspace_projector(W, cfg)
    lam0 = ba_device.lm_lambda(cfg)
    for it in range(trips):
        W, _, _, canbreak = ba_device._trip(
            W, dIs, HM, bM, newest, lam0, proj if it >= 2 else None, cfg, w,
            h)
        if bool(canbreak) and it + 1 >= cfg.min_opt_iterations:
            return it + 1
    return trips


# aten operations per eager device-LM call at the main path's full window
# is not bounded here: the graph replays them all (PERF.md has the count)


def phase_ba_graph(records, ba_ms, k12_device_ms):
    """3d: the device LM (backend/ba_device.optimize_device, one CUDA graph
    per call on the card) on phase 3's BA inputs: the replay of the last
    call against the eager program, bitwise; the prior's pinned uploads and
    the replay under torch.cuda.set_sync_debug_mode("error") behind 50 ms
    of queued sleep (it must return inside the sleep; its stats bitwise the
    eager ones); the device ms per call (replays queued behind a sleep)
    beside phase 3's wall ms per call; the aten operations of one eager
    call; the live trips (before `done`) of every call; K12 against its
    plain version and its emulation on every call's basis, and K12's device
    ms per launch (phase 2's, `k12_device_ms`) as a share of a call's.
    Returns the numbers."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from ldso_tpu_torch.backend import ba_device, energy_functional as efm
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.ops.preprocess import to_device
    kc = _kernel_checks()
    calls = _ba_calls(records)
    W, dIs, HM, bM, newest, cfg, w, h, trips = last = calls[-1]
    got = efm.replay_ba(*last)
    want = ba_device.optimize_device(*last)
    for name, g, e in zip(ba_device.Window._fields + ("stats",),
                          tuple(got[0]) + (got[1],),
                          tuple(want[0]) + (want[1],)):
        if not _same(g, e):
            _fail(f"3d: the BA graph's {name} differs from the eager call")
    dev = dIs.device
    host = (HM.cpu(), bM.cpu(), newest.cpu())
    torch.cuda.synchronize()
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * 50.0))
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = time.perf_counter()
        out = efm.replay_ba(W, dIs, *(to_device(x, dev) for x in host), cfg,
                            w, h, trips)
        queued_ms = (time.perf_counter() - t) * 1e3
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode(0)
        _fail(f"3d: the BA's uploads and replay synchronised: {e}")
    torch.cuda.set_sync_debug_mode(0)
    if not (queued_ms < 25.0 and _same(out[1], want[1])):
        _fail(f"3d: the BA replay took {queued_ms:.2f} ms to queue behind "
              f"50 ms of sleep, stats equal {_same(out[1], want[1])}")
    cuda_kernels.reset_launch_counts()
    efm.replay_ba(*last)
    per_replay = {k: cuda_kernels.LAUNCHES[k] for k in
                  ("ba_linearize", "ba_accumulate", "ba_projector")}
    if per_replay != dict(ba_linearize=trips + 2, ba_accumulate=3 * trips,
                          ba_projector=1):
        _fail(f"3d: a {trips}-trip BA replay launched {per_replay} (K6 "
              f"trips + 2, K7 3 x trips, K12 once)")

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        ba_device.optimize_device(*last)
    live = [_live_trips(*c) for c in calls]
    k12 = _projector_errs(
        kc, [ba_device.orth_basis(c[0]) for c in calls],
        cfg.solver_mode_delta, [f"phase 3 call {i}" for i in
                                range(len(calls))])
    res = dict(
        calls=len(calls), trips=[c[-1] for c in calls], live_trips=live,
        live_trips_mean=float(np.mean(live)),
        wall_ms_median=float(np.median(ba_ms)),
        device_ms=_queued_device_ms(lambda: efm.replay_ba(*last), n=5,
                                    reps=5),
        eager_ms=_host_us_per_call(lambda: ba_device.optimize_device(*last),
                                   n=3) / 1e3,
        queued_ms_in_sync_check=queued_ms, eager_ops=Count.n,
        k12_max_abs_err=k12["max_abs_err"], k12_tol_share=k12["tol_share"],
        k12_emu_max_abs_err=k12["emu_max_abs_err"],
        k12_at_gate=k12["at_gate"], k12_device_ms=k12_device_ms,
        captures=efm.BA_GRAPHS.counts["count"],
        capture_s=efm.BA_GRAPHS.counts["s"], launches_per_replay=per_replay)
    res["k12_share_of_call"] = k12_device_ms / res["device_ms"]
    print(f"3d device LM: {len(calls)} calls in phase 3 (trips {res['trips']}"
          f"), live trips {live} (mean {res['live_trips_mean']:.2f}); the "
          f"last call's graph replay equals the eager call bitwise; its "
          f"uploads and replay ran under set_sync_debug_mode('error') and "
          f"queued in {queued_ms:.2f} ms behind 50 ms of sleep; "
          f"{res['device_ms']:.4f} ms of device time per call ({trips} trips,"
          f" 5 replays queued, median of 5) against phase 3's "
          f"{res['wall_ms_median']:.2f} ms wall per call (median) and "
          f"{res['eager_ms']:.2f} ms per eager call; {Count.n} aten "
          f"operations per eager call; K12 on every call's basis max|kernel "
          f"- plain| {k12['max_abs_err']:.3g} ({k12['tol_share']:.3f} of the "
          f"tolerance), at the gate {k12['at_gate']}, max|kernel - emulated| "
          f"{k12['emu_max_abs_err']:.3g}; K12's {k12_device_ms * 1e3:.3f} us "
          f"per launch are {100 * res['k12_share_of_call']:.4f}% of a call's "
          f"device time; a replay launches {per_replay}; "
          f"{res['captures']} BA graphs captured in "
          f"{res['capture_s']:.2f} s "
          f"(at FullSystem construction)", flush=True)
    return res


BATCH_BA_WINDOWS = 8         # as 7c's sequences, bench.py's S


def phase_batched_ba(records, S: int = BATCH_BA_WINDOWS):
    """7e: phase 3's last S device-LM inputs (one trip count) in one vmapped
    CUDA graph (as bench.py's _bench_batched_ba vmaps the JAX package's),
    against S single replays, within torch_kernel_checks.ba_batch_err's
    tolerance (the batched products sum in another order: each member no
    farther from its window's float64 result, the plain versions in
    float64 on the card, than BA_F64_FACTOR times the farthest single
    replay), the residual bookkeeping equal, and the four faults of
    ba_batch_plants refused (two of them reruns of a member, near the
    tolerance: its last live trip lost, 1 in 256 points masked); K12 launched once for the S; the device ms
    of the batch and of the S singles; K12 alone on the S windows' bases,
    one launch (bitwise the S single launches) against S single launches,
    in device ms. Returns the numbers."""
    import torch
    from ldso_tpu_torch.backend import ba_device, energy_functional as efm
    from ldso_tpu_torch.backend.window import Window
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.utils.graphs import Programs
    kc = _kernel_checks()
    calls = _ba_calls(records)[-S:]
    cfg, w, h, trips = calls[-1][5:]
    if len(calls) < S or any(c[5:] != (cfg, w, h, trips) for c in calls):
        _fail(f"7e: phase 3's last {S} BA calls do not share one trip count: "
              f"{[c[-1] for c in calls]}")
    stacked = tuple(torch.stack([c[0][i] for c in calls])
                    for i in range(len(Window._fields))) + tuple(
        torch.stack([c[k] for c in calls]) for k in (1, 2, 3, 4))
    key = ("vmap", ba_device.graph_key(cfg), w, h, trips)

    def program(*xs):
        W, stats = torch.func.vmap(
            lambda W, d, H, b, n: ba_device.optimize_device(
                W, d, H, b, n, cfg, w, h, trips))(Window(*xs[:-4]), *xs[-4:])
        return tuple(W) + (stats,)
    graphs = Programs()
    graphs.replay(key, program, stacked)
    cuda_kernels.reset_launch_counts()

    def batch():
        return graphs.replay(key, program, stacked)
    out = batch()
    k12 = cuda_kernels.LAUNCHES["ba_projector"]
    k67 = (cuda_kernels.LAUNCHES["ba_linearize"],
           cuda_kernels.LAUNCHES["ba_accumulate"])
    if k67 != (trips + 2, 3 * trips):
        _fail(f"7e: the batch of {S} launched K6 and K7 {k67} times (want "
              f"{trips + 2} and {3 * trips}, once for the {S} windows)")

    def single(W, *rest):
        return efm.replay_ba(W, *rest, cfg, w, h, trips)

    def plain(W, *rest):
        return ba_device.optimize_device(W, *rest, cfg, w, h, trips)
    batched = [(Window(*(x[s] for x in out[:-1])), out[-1][s])
               for s in range(S)]
    singles = [single(*c[:5]) for c in calls]
    reference = [kc.ba_f64(plain, *c[:5]) for c in calls]
    worst, tol, faults = kc.ba_batch_err(batched, singles, reference)
    if faults or k12 != 1:
        _fail(f"7e: batch of {S} against single replays: {faults} "
              f"(largest {worst}, tolerance {tol}), K12 launched {k12} times")
    readings = kc.ba_batch_readings(batched, singles, reference)
    plants = kc.ba_plant_readings(
        batched, singles, reference, calls=[c[:5] for c in calls],
        run=lambda *a: ba_device.optimize_device(*a[:5], cfg, w, h, a[5]),
        trips=trips)
    for name, got in plants.items():
        if not got["faults"]:
            _fail(f"7e: the yardstick accepts a planted fault ({name}: "
                  f"{got['over_tol']} of the tolerance)")
    delta = cfg.solver_mode_delta
    bases = torch.stack([ba_device.orth_basis(c[0]) for c in calls])
    together = cuda_kernels.projector_launch(bases, delta)[0]
    if not all(_same(together[i], cuda_kernels.projector_launch(
            bases[i:i + 1], delta)[0][0]) for i in range(S)):
        _fail(f"7e: K12 on the {S} bases in one launch differs from {S} "
              f"single launches")
    res = dict(phase="7e batched_ba", windows=S, trips=trips, max_err=worst,
               tol=tol, readings=readings,
               batch_over_single_f64={
                   k: max(r["batch_f64"][k] for r in readings)
                   / max(max(r["single_f64"][k] for r in readings), 1e-30)
                   for k in kc.BA_ORDER_FLOORS},
               plants_over_tol={n: p["over_tol"] for n, p in plants.items()},
               k12_launches=k12, k6_launches=k67[0],
               k7_launches=k67[1],
               device_ms=_queued_device_ms(batch, n=3, reps=5),
               single_device_ms=[_queued_device_ms(
                   lambda c=c: efm.replay_ba(*c), n=3, reps=5) for c in calls],
               k12_batch_device_ms=_graph_device_ms(
                   lambda: cuda_kernels.projector_launch(bases, delta)),
               k12_singles_device_ms=_graph_device_ms(
                   lambda: [cuda_kernels.projector_launch(b[None], delta)
                            for b in bases]))
    res["k12_share_of_batch"] = res["k12_batch_device_ms"] / res["device_ms"]
    print(f"7e batched BA: phase 3's last {S} windows ({trips} trips) in one "
          f"vmapped graph against {S} single replays: largest differences "
          f"from float64 {worst} within {tol} (BA_F64_FACTOR x the "
          f"farthest single; the batch's farthest over the singles' "
          f"{res['batch_over_single_f64']}), the planted faults refused "
          f"(farthest over the tolerance: {res['plants_over_tol']}), "
          f"bookkeeping equal; K12 launched once, K6 {k67[0]} and K7 "
          f"{k67[1]} times for the batch; {res['device_ms']:.4f} ms "
          f"of device time per batch against "
          f"{sum(res['single_device_ms']):.4f} ms for the {S} singles "
          f"({[round(x, 4) for x in res['single_device_ms']]}); K12 alone "
          f"on the {S} bases {res['k12_batch_device_ms'] * 1e3:.3f} us in one "
          f"launch ({100 * res['k12_share_of_batch']:.4f}% of the batch's "
          f"device time), bitwise the {S} single launches, which take "
          f"{res['k12_singles_device_ms'] * 1e3:.3f} us", flush=True)
    return res


@contextlib.contextmanager
def ba_times():
    """Wall ms of every EnergyFunctional.optimize call while inside; both
    BA paths end with a host read of their result, so a call's wall time
    covers its device work."""
    from ldso_tpu_torch.backend.energy_functional import EnergyFunctional
    optimize = EnergyFunctional.optimize
    ms = []

    def timed(self, *a, **k):
        t = time.perf_counter()
        out = optimize(self, *a, **k)
        if self.n_frames >= 2:
            ms.append((time.perf_counter() - t) * 1e3)
        return out
    EnergyFunctional.optimize = timed
    try:
        yield ms
    finally:
        EnergyFunctional.optimize = optimize


def phase_variants(calib, images, poses, phase3_ba_ms, device="cuda"):
    """7a: phase 3's 64 frames, strict, through the host-orchestrated BA
    (ba_device_lm=False: the float64 host solve under force-accept), then
    the reference's accept/reject LM (force_accept_step=False); 7b: the
    same frames with the reference's trace search (trace_packed=False,
    bilinear over the rotated pattern). Each: >= 8 keyframes, ATE over all
    tracked frames < 5 mm, K1 launched on every post-bootstrap keyframe;
    prints the median ms of a BA call beside phase 3's. Returns the runs."""
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.examples import time_modes
    base = np.median(phase3_ba_ms)
    runs = {}
    for name, kw in (("7a host_ba", dict(ba_device_lm=False)),
                     ("7a accept_reject", dict(force_accept_step=False)),
                     ("7b reference_trace", dict(trace_packed=False))):
        cfg = dataclasses.replace(Config(), enable_loop_closing=False, **kw)
        with ba_times() as ms:
            run, _ = time_modes.run_mode("strict", calib, poses, images,
                                         cfg=cfg, device=device,
                                         gpu=time_modes.gpu_facts())
        run.update(phase=name, config=kw, ba_ms_median=float(np.median(ms)),
                   ba_calls=len(ms), phase3_ba_ms_median=float(base))
        print(f"{name} {kw}: {run['keyframes']} keyframes {run['kf_ids']}, "
              f"ATE {run['ate_mm']:.4f} mm over all tracked frames "
              f"(sim3-aligned), {run['ms_per_frame_wall']:.2f} ms/frame "
              f"wall, BA median {run['ba_ms_median']:.2f} ms over "
              f"{len(ms)} calls (phase 3's device LM: {base:.2f} ms), K1 "
              f"launches {run['k1_launches']} for "
              f"{run['post_bootstrap_keyframes']} post-bootstrap keyframes",
              flush=True)
        if run["lost"] or run["init_failed"]:
            _fail(f"{name}: lost={run['lost']} "
                  f"init_failed={run['init_failed']}")
        _no_capture_inside(run)
        if device == "cuda":
            _k3_run_check(run)
            _k2_run_check(run)
            _k4_run_check(run)
            _k5_run_check(run)
            _k67_run_check(run)
        if run["keyframes"] < 8:
            _fail(f"{name}: only {run['keyframes']} keyframes (need >= 8)")
        if not run["ate_mm"] < ATE_BOUND_M * 1e3:
            _fail(f"{name}: ATE {run['ate_mm']:.4f} mm >= "
                  f"{ATE_BOUND_M * 1e3} mm")
        if run["k1_launches"] < run["post_bootstrap_keyframes"]:
            _fail(f"{name}: K1 launched {run['k1_launches']} times for "
                  f"{run['post_bootstrap_keyframes']} post-bootstrap "
                  f"keyframes")
        runs[name] = run
    return runs


BATCH_SEQUENCES = 8
BATCH_T_TOL = 1e-4           # the tracker's parity tolerances
BATCH_RES_RTOL = 1e-3


def phase_batched_tracker(S: int = BATCH_SEQUENCES):
    """7c: S sequences of the bench scene at 640x480 (one reference view,
    S distinct motions, as bench.py's _bench_batched_tracking) tracked in
    lockstep by parallel/replay.make_batched_tracker (the vmapped masked
    tracker in one CUDA graph), held against S single track_frame calls:
    T within BATCH_T_TOL, residuals within BATCH_RES_RTOL relative, the
    same ok flags. Device ms per batched replay and per single track from
    replays queued behind a sleeping kernel. Returns the numbers."""
    import torch
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.frontend import tracker
    from ldso_tpu_torch.math import lie_np
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.ops.preprocess import FramePyramid, make_pyramid
    from ldso_tpu_torch.parallel import replay
    from ldso_tpu_torch.synthetic import PlaneScene, default_calib
    calib = default_calib(640, 480)
    cfg = Config()
    L = calib.levels
    scene = PlaneScene(freq_hi=25.0, contrast=80.0)
    img0, idep0 = scene.render(calib, np.eye(4), device="cuda")
    ref = tracker.make_tracker_ref_from_idepth(
        idep0, make_pyramid(img0, L), calib, cfg.tracker_caps[:L], stride=2)
    pyrs = []
    for b in range(S):
        xi = np.array([0.02 + 0.002 * b, -0.01 + 0.002 * b, 0.005,
                       0.002, 0.004 - 0.001 * b, -0.001])
        img, _ = scene.render(calib, lie_np.se3_exp(xi), device="cuda")
        pyrs.append(make_pyramid(img, L))
    refs = replay._tree_map(
        lambda x: x[None].expand((S,) + tuple(x.shape)).contiguous(), ref)
    pyr_b = FramePyramid(dI=tuple(torch.stack([p.dI[lv] for p in pyrs])
                                  for lv in range(L)), abs_grad=())
    f32 = dict(dtype=torch.float32, device="cuda")
    T0 = torch.eye(4, **f32).expand(S, 4, 4).contiguous()
    aff0 = torch.zeros((S, 2), **f32)
    expo = torch.ones(S, **f32)
    noab = torch.full((S, L), 1e9, **f32)
    step = replay.make_batched_tracker(calib, cfg, L - 1)
    t = time.perf_counter()
    out = step(refs, pyr_b, T0, aff0, expo, noab)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t

    def single(b):
        return tracker.track_frame(ref, pyrs[b], T0[b], aff0[b], expo[b],
                                   noab[b], calib, cfg, L - 1)

    # one replay launches K3 once per trip for all S sequences
    trips = tracker.trips_per_track(cfg, L, L - 1)
    cuda_kernels.reset_launch_counts()
    again = step(refs, pyr_b, T0, aff0, expo, noab)
    k3_launches = cuda_kernels.LAUNCHES["tracker_trip"]
    _k3_check("7c batched replay", k3_launches, trips)
    torch.cuda.synchronize()
    if not all(_same(a, b) for a, b in zip(out, again)):
        _fail("7c: a second batched replay differs from the first")
    # the single tracks' graph (batch 1, which no path of the system
    # replays since the frame step tracks inside its own) is captured by
    # its first call, as the batched one was by `out` above
    single(0)
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    singles = [single(b) for b in range(S)]
    _k3_check(f"7c {S} single tracks", cuda_kernels.LAUNCHES["tracker_trip"],
              S * trips)
    t_err = max(float(torch.max(torch.abs(out[0][b] - singles[b][0])))
                for b in range(S))
    r_err = max(float(torch.max(torch.abs(out[3][b] - singles[b][3])
                                / torch.clamp(torch.abs(singles[b][3]),
                                              min=1e-3)))
                for b in range(S))
    ok_same = all(bool(out[2][b] == singles[b][2]) for b in range(S))
    res = dict(phase="7c batched_tracker", sequences=S,
               first_call_s=first_s,
               device_ms_batched=_queued_device_ms(
                   lambda: step(refs, pyr_b, T0, aff0, expo, noab), n=2,
                   reps=5),
               device_ms_single=_queued_device_ms(lambda: single(0), n=4,
                                                  reps=5),
               max_T_err=t_err, max_res_rel_err=r_err,
               k3_launches=k3_launches,
               ok=[bool(o) for o in out[2].cpu()])
    print(f"7c batched tracker: {S} sequences 640x480 in lockstep, first "
          f"call (capture + replay) {first_s:.2f} s; vs {S} single tracks: "
          f"max |T - T_single| {t_err:.3g} (tol {BATCH_T_TOL}), max residual "
          f"rel err {r_err:.3g} (tol {BATCH_RES_RTOL}), ok {res['ok']}; "
          f"device ms per batched replay {res['device_ms_batched']:.2f}, per "
          f"single track {res['device_ms_single']:.2f} (replays queued behind "
          f"a sleep)", flush=True)
    if not (ok_same and all(res["ok"])):
        _fail(f"7c: ok flags {res['ok']} differ from the single tracks or "
              f"a sequence failed")
    if not (t_err <= BATCH_T_TOL and r_err <= BATCH_RES_RTOL):
        _fail(f"7c: batched vs single: T err {t_err}, residual rel err "
              f"{r_err}")
    return res


SHARDED_H_RTOL = 1e-6        # of each block's scale
SHARDED_PCG_ATOL = 1e-8      # float64, every vertex
PCG_ITERS = 5                # Gauss-Newton steps of the 7d comparison


def phase_sharded(W, global_map):
    """7d: the point-sharded build system and the edge-sharded PCG through
    one NCCL process group of world size 1 on a localhost store: the
    sharded build system against ba.build_system on phase 3's final window
    (within SHARDED_H_RTOL of each block's scale, nres exact), the sharded
    PCG against optimize_pose_graph_cg on phase 4's final pose graph
    (PCG_ITERS Gauss-Newton steps of 100 CG steps each, within
    SHARDED_PCG_ATOL). One card, so this shows the NCCL path
    launches and reduces; the multi-rank sums are the CPU tests' (gloo, 2
    and 4 ranks). Returns the numbers."""
    import socket
    import torch
    import torch.distributed as dist
    from ldso_tpu_torch.backend import ba
    from ldso_tpu_torch.loop import posegraph
    from ldso_tpu_torch.parallel import replay
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        t = time.perf_counter()
        got = replay.make_sharded_build_system()(W)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t) * 1e3
        full = ba.build_system(W)
        want = full[:6] + (full[8],)
        h_err = max(float(torch.max(torch.abs(a - b))) / max(
            float(torch.max(torch.abs(b))), 1e-30)
            for a, b in zip(got[:6], want[:6]))
        nres_same = int(got[6]) == int(want[6])
        graph, kfs = posegraph.pose_graph_arrays(global_map)
        args = [torch.as_tensor(a, device="cuda") for a in graph]
        args = [a.to(torch.float64) if a.is_floating_point() else a
                for a in args]
        S_cg = posegraph.optimize_pose_graph_cg(*args, iterations=PCG_ITERS)
        t = time.perf_counter()
        S_sh = posegraph.optimize_pose_graph_cg_sharded(
            *args, iterations=PCG_ITERS)
        torch.cuda.synchronize()
        pcg_ms = (time.perf_counter() - t) * 1e3
        pcg_err = float(torch.max(torch.abs(S_sh - S_cg)))
    finally:
        dist.destroy_process_group()
    res = dict(phase="7d sharded", backend="nccl", world_size=1,
               build_max_rel_err=h_err, nres_equal=nres_same,
               build_ms=build_ms, pcg_vertices=len(kfs),
               pcg_edges=int(graph[6].sum()), pcg_max_abs_err=pcg_err,
               pcg_ms=pcg_ms)
    print(f"7d sharded over NCCL (world size 1): build system vs "
          f"ba.build_system max rel err {h_err:.3g} (tol {SHARDED_H_RTOL}), "
          f"nres equal {nres_same}, {build_ms:.2f} ms; PCG on phase 4's "
          f"graph ({len(kfs)} keyframes, {res['pcg_edges']} edges) vs "
          f"optimize_pose_graph_cg max |dS| {pcg_err:.3g} (tol "
          f"{SHARDED_PCG_ATOL}), {PCG_ITERS} Gauss-Newton steps in "
          f"{pcg_ms:.2f} ms", flush=True)
    if not (h_err <= SHARDED_H_RTOL and nres_same):
        _fail(f"7d: sharded build system: rel err {h_err}, nres equal "
              f"{nres_same}")
    if not pcg_err <= SHARDED_PCG_ATOL:
        _fail(f"7d: sharded PCG: max abs err {pcg_err}")
    return res


# the bench's legs that track frames, and those that run the device LM
BENCH_TRACKING = ("warmup", "lookahead", "strict", "async", "util",
                  "aggregate_8seq", "aggregate_16seq", "batched_tracking")
BENCH_BA = ("warmup", "lookahead", "strict", "util", "aggregate_8seq",
            "aggregate_16seq", "batched_ba")
# and those whose every pyramid is a step's or a bootstrap frame's (util
# and batched tracking build pyramids of their own too)
BENCH_K2_EXACT = ("warmup", "lookahead", "strict", "async", "aggregate_8seq",
                  "aggregate_16seq")
# and those that trace the candidate arena
BENCH_TRACING = ("warmup", "lookahead", "strict", "async", "util",
                 "aggregate_8seq", "aggregate_16seq")
# and those that activate a keyframe's candidates (async's windows may map
# none after their bootstrap, so it is held only to K5 == its passes)
BENCH_ACTIVATING = ("warmup", "lookahead", "strict", "util",
                    "aggregate_8seq", "aggregate_16seq")


def phase_bench():
    """8: the port's benchmark at its defaults, in this process (every
    graph it replays was captured by the phases before, except the
    batched legs' own). Returns its result."""
    from ldso_tpu_torch.examples import bench, time_modes
    t = time.perf_counter()
    with time_modes.counted_ba() as bas:
        res = bench.measure(bench.parse_args([]))
    wall = time.perf_counter() - t
    if "error" in res:
        _fail(f"8 bench: {res['error']}")
    if bas["ba_plain_calls"]:
        _fail(f"8 bench: {bas['ba_plain_calls']} calls of K6's or K7's "
              f"plain version on the card")
    windows = dict(sync=res["sync_fps_windows"],
                   strict=res["strict_fps_windows"],
                   piped=res["piped_fps_windows"],
                   **{k: v["fps_windows"]
                      for k, v in res["aggregate"].items()})
    bad = [k for k, v in windows.items() if len(v) != 3]
    if bad or set(res["aggregate"]) != {"8seq", "16seq"}:
        _fail(f"8 bench: not three windows in {bad} "
              f"(aggregate legs {sorted(res['aggregate'])})")
    if not res["value"] > 0:
        _fail(f"8 bench: value {res['value']}")
    if not res["ate_m_sim_aligned"] < ATE_BOUND_M:
        _fail(f"8 bench: ATE {res['ate_m_sim_aligned']} m")
    util = {k: v["ms"] for k, v in res["util"].items()
            if k in ("frame_step(track)", "ba_lm")
            or k.startswith(("trace(", "activate("))}
    if len(util) != 4 or not all(np.isfinite(ms) and ms > 0
                                 for ms in util.values()):
        _fail(f"8 bench: util device ms {util}")
    for leg, n in res["launches"].items():
        graphs = res["graphs"][leg]
        if leg in BENCH_BA and not (n["ba_linearize"] > 0
                                    and n["ba_accumulate"] > 0):
            _fail(f"8 bench: K6 or K7 not launched in the {leg} leg")
        if leg != "batched_ba" and (
                n["ba_linearize"] != graphs["ba_linearize_in_graphs"]
                or n["ba_accumulate"] != graphs["ba_accumulate_in_graphs"]):
            _fail(f"8 bench: {leg}: K6 launched {n['ba_linearize']} and K7 "
                  f"{n['ba_accumulate']} times, "
                  f"{graphs['ba_linearize_in_graphs']} and "
                  f"{graphs['ba_accumulate_in_graphs']} of them through the "
                  f"BA's and the marginalization's graphs")
        if leg in BENCH_TRACKING and not n["tracker_trip"] > 0:
            _fail(f"8 bench: K3 not launched in the {leg} leg")
        if leg in BENCH_BA and not n["ba_projector"] > 0:
            _fail(f"8 bench: K12 not launched in the {leg} leg")
        if leg in BENCH_K2_EXACT:
            _k2_check(f"8 bench: {leg}", n["pyramid"],
                      res["k2_expected"][leg])
        elif leg in BENCH_TRACKING and not (
                n["pyramid"] > res["k2_expected"][leg]):
            _fail(f"8 bench: {leg}: K2's pyramid launched {n['pyramid']} "
                  f"times, not more than the {res['k2_expected'][leg]} its "
                  f"steps imply beside the leg's own pyramids")
        if leg in BENCH_TRACING:
            _k4_check(f"8 bench: {leg}", n["trace"],
                      res["k4_expected"][leg], res["traces"][leg])
        elif n["trace"] != res["k4_expected"][leg]:
            _fail(f"8 bench: {leg}: K4 launched {n['trace']} times where "
                  f"its frame steps and traces imply "
                  f"{res['k4_expected'][leg]}")
        # each activation graph captured in the leg ran K5 once before its
        # capture
        if n["activate"] != (res["activations"][leg]
                             + graphs["activate_captures"]) or (
                leg in BENCH_ACTIVATING and not n["activate"] > 0):
            _fail(f"8 bench: {leg}: K5 launched {n['activate']} times for "
                  f"{res['activations'][leg]} activation passes and "
                  f"{graphs['activate_captures']} activation graphs "
                  f"captured")
        if leg != "batched_ba" and n["ba_projector"] != (
                graphs["ba_replays"] + graphs["ba_captures"]):
            _fail(f"8 bench: {leg}: K12 launched {n['ba_projector']} times "
                  f"for {graphs['ba_replays']} BA graph replays and "
                  f"{graphs['ba_captures']} captures")
    print(f"8 bench: async {res['value']:.2f} fps "
          f"({res['piped_keyframes_windows']} keyframes), lookahead "
          f"{res['sync_fps']:.2f}, strict {res['strict_fps']:.2f}, ATE "
          f"{res['ate_m_sim_aligned'] * 1e3:.4f} mm, aggregate 8/16 "
          f"{res['aggregate_vo_fps_8seq']:.2f} / "
          f"{res['aggregate_vo_fps_16seq']:.2f}, batched tracking "
          f"{res['batched_tracking_fps_16seq']:.1f}, util device ms "
          f"{util}; in {wall:.1f} s", flush=True)
    return res


def main() -> int:
    import os
    t_start = time.perf_counter()
    phase_device()
    import torch
    record = phase_kernels()
    trip_edges = phase_trip_edges()
    proj_record = phase_projector()
    pyr_record, rect_record = phase_preprocess_kernel()
    trace_record = phase_trace_kernel()
    act_record = phase_activate_kernel()
    lin_record, acc_record = phase_ba_kernels()
    phase_determinism()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    with ba_times() as phase3_ba_ms, recorded_ba() as ba_records, \
            recorded_frame_steps() as steps3, \
            recorded_activations() as acts3, recorded_marg() as margs3, \
            recorded_kf_programs() as kf3:
        launches_vo, calib, images, poses, strict, fs = phase_main_path()
    # every device-LM call of phase 3 went through its graph
    if not strict["ba_replays"] == len(phase3_ba_ms) > 0:
        _fail(f"phase 3: {strict['ba_replays']} BA graph replays for "
              f"{len(phase3_ba_ms)} BA calls")
    trip_record = phase_trip_frame(fs, images, trip_edges,
                                   strict["k3_by_mode"])
    phase_trace_frame(trace_record, steps3.pop("traces"))
    phase_activate_frame(act_record, acts3)
    del acts3
    graph = phase_tracker_graph(fs, images, steps3.pop("tracks"),
                                steps3["steps"])
    ba_graph = phase_ba_graph(ba_records, phase3_ba_ms,
                              proj_record["device_ms"])
    phase_ba_frame(ba_records, margs3, lin_record, acc_record)
    marg_graph = phase_marg_graph(margs3, strict)
    del margs3
    act_program = phase_activation_program(kf3, strict, fs)
    kf_programs = phase_keyframe_programs(kf3, calib, images, strict, fs)
    del kf3
    phase_dispatch_ahead(fs, images)
    phase_checkpoint(fs, root)
    boot_program = phase_bootstrap_program(calib, images, strict)
    step_program = phase_frame_step_program(steps3.pop("steps"), strict, fs,
                                            images)
    del steps3
    window3 = fs.ef.W
    del fs
    launches, post_boot, map4 = phase_loop_slice()
    boxes = phase_boxes()
    look, _, asyn, paced = phase_pipelines(calib, images, poses, strict)
    cli = phase_cli(calib, images, poses, root)
    variants = phase_variants(calib, images, poses, phase3_ba_ms)
    batched = phase_batched_tracker()
    sharded = phase_sharded(window3, map4)
    batched_ba = phase_batched_ba(ba_records)
    del ba_records
    bench = phase_bench()
    bench_launches = {k: sum(leg[k] for leg in bench["launches"].values())
                      for k in ("distance_transform", "tracker_trip",
                                "ba_projector", "trace", "activate",
                                "ba_linearize", "ba_accumulate", "pyramid",
                                "rectify")}
    by_path = dict(vo_strict=launches_vo["distance_transform"],
                   loop=launches["distance_transform"],
                   boxes=boxes["k1_launches"],
                   vo_lookahead=look["k1_launches"],
                   vo_async=asyn["k1_launches"],
                   vo_async_paced=paced["k1_launches"],
                   cli_lookahead=cli["lookahead"], cli_async=cli["async"],
                   **{name.split()[1]: run["k1_launches"]
                      for name, run in variants.items()},
                   bench=bench_launches["distance_transform"])
    print(f"K1 launches per path: {by_path}", flush=True)
    record["launches"] = launches["distance_transform"]
    record["launches_per_keyframe"] = launches["distance_transform"] / post_boot
    record["launches_by_path"] = by_path
    k3_by_path = dict(vo_strict=launches_vo["tracker_trip"],
                      loop=launches["tracker_trip"],
                      boxes=boxes["k3_launches"],
                      vo_lookahead=look["k3_launches"],
                      vo_async=asyn["k3_launches"],
                      vo_async_paced=paced["k3_launches"],
                      cli_lookahead=cli["k3_lookahead"],
                      cli_async=cli["k3_async"],
                      **{name.split()[1]: run["k3_launches"]
                         for name, run in variants.items()},
                      batched_replay=batched["k3_launches"],
                      bench=bench_launches["tracker_trip"])
    print(f"K3 launches per path: {k3_by_path}", flush=True)
    trip_record["launches"] = launches["tracker_trip"]
    trip_record["launches_by_path"] = k3_by_path
    k12_by_path = dict(vo_strict=strict["k12_launches"],
                       loop=launches["ba_projector"],
                       boxes=boxes["k12_launches"],
                       vo_lookahead=look["k12_launches"],
                       vo_async=asyn["k12_launches"],
                       vo_async_paced=paced["k12_launches"],
                       cli_lookahead=cli["k12_lookahead"],
                       cli_async=cli["k12_async"],
                       **{name.split()[1]: run["k12_launches"]
                          for name, run in variants.items()},
                       batched_ba=batched_ba["k12_launches"],
                       bench=bench_launches["ba_projector"])
    print(f"K12 launches per path: {k12_by_path}", flush=True)
    proj_record["launches"] = strict["k12_launches"]
    proj_record["launches_by_path"] = k12_by_path
    k4_by_path = dict(vo_strict=launches_vo["trace"],
                      loop=launches["trace"],
                      boxes=boxes["k4_launches"],
                      vo_lookahead=look["k4_launches"],
                      vo_async=asyn["k4_launches"],
                      vo_async_paced=paced["k4_launches"],
                      cli_lookahead=cli["k4_lookahead"],
                      cli_async=cli["k4_async"],
                      **{name.split()[1]: run["k4_launches"]
                         for name, run in variants.items()},
                      bench=bench_launches["trace"])
    print(f"K4 launches per path: {k4_by_path}", flush=True)
    k2_by_path = dict(vo_strict=launches_vo["pyramid"],
                      loop=launches["pyramid"],
                      boxes=boxes["k2_launches"],
                      vo_lookahead=look["k2_launches"],
                      vo_async=asyn["k2_launches"],
                      vo_async_paced=paced["k2_launches"],
                      cli_lookahead=cli["k2_lookahead"],
                      cli_async=cli["k2_async"],
                      **{name.split()[1]: run["k2_launches"]
                         for name, run in variants.items()},
                      bench=bench_launches["pyramid"])
    print(json.dumps({"k2_by_path": k2_by_path}), flush=True)
    pyr_record["launches"] = launches_vo["pyramid"]
    pyr_record["launches_by_path"] = k2_by_path
    rect_record["launches"] = cli["rectify_lookahead"]
    rect_record["launches_by_path"] = dict(
        cli_lookahead=cli["rectify_lookahead"], cli_async=cli["rectify_async"],
        bench=bench_launches["rectify"])
    trace_record["launches"] = launches_vo["trace"]
    trace_record["launches_by_path"] = k4_by_path
    k5_by_path = dict(vo_strict=launches_vo["activate"],
                      loop=launches["activate"],
                      boxes=boxes["k5_launches"],
                      vo_lookahead=look["k5_launches"],
                      vo_async=asyn["k5_launches"],
                      vo_async_paced=paced["k5_launches"],
                      cli_lookahead=cli["k5_lookahead"],
                      cli_async=cli["k5_async"],
                      **{name.split()[1]: run["k5_launches"]
                         for name, run in variants.items()},
                      bench=bench_launches["activate"])
    print(json.dumps({"k5_by_path": k5_by_path}), flush=True)
    act_record["launches"] = launches_vo["activate"]
    act_record["launches_by_path"] = k5_by_path
    for rec, key, k in ((lin_record, "ba_linearize", "k6"),
                        (acc_record, "ba_accumulate", "k7")):
        by_path = dict(vo_strict=launches_vo[key], loop=launches[key],
                       boxes=boxes[f"{k}_launches"],
                       vo_lookahead=look[f"{k}_launches"],
                       vo_async=asyn[f"{k}_launches"],
                       vo_async_paced=paced[f"{k}_launches"],
                       cli_lookahead=cli[f"{k}_lookahead"],
                       cli_async=cli[f"{k}_async"],
                       **{name.split()[1]: run[f"{k}_launches"]
                          for name, run in variants.items()},
                       batched_ba=batched_ba[f"{k}_launches"],
                       bench=bench_launches[key])
        print(json.dumps({f"{k}_by_path": by_path}), flush=True)
        rec["launches"] = launches_vo[key]
        rec["launches_by_path"] = by_path
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    for name, run in variants.items():
        print(json.dumps({k: run[k] for k in (
            "phase", "config", "keyframes", "kf_ids", "ate_mm",
            "ms_per_frame_wall", "ba_ms_median", "ba_calls",
            "phase3_ba_ms_median", "k1_launches", "gpu")}))
    print(json.dumps(batched))
    print(json.dumps(sharded))
    print(json.dumps(batched_ba))
    print(json.dumps({"tracker_graph": graph}))
    print(json.dumps({"ba_graph": ba_graph}))
    print(json.dumps({"marg_graph": marg_graph}))
    print(json.dumps({"keyframe_programs": kf_programs}))
    print(json.dumps({"activation_program": act_program}))
    print(json.dumps({"bootstrap_program": boot_program}))
    print(json.dumps({"frame_step_program": step_program}))
    print(json.dumps(bench))
    print(json.dumps({"kernels": [record, pyr_record, rect_record,
                                  trip_record, proj_record, trace_record,
                                  act_record, lin_record, acc_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
