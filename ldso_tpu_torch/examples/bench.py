"""The port's benchmark: frames per second of the visual-odometry pipeline
on the card, leg by leg as bench.py measures the JAX package.

    python -m ldso_tpu_torch.examples.bench [--width 640] [--height 480]
        [--warm 56] [--sync-warm 8] [--window 16] [--pipe-warm 16]
        [--pipe-window 48] [--seqs 8 16] [--unique-seqs 8] [--seq-warm 16]
        [--seq-window 8] [--batch 16] [--steps 30] [--ba-batch 8]
        [--device cuda]

The defaults are bench.py's own counts. The scene is bench.py's (a
PlaneScene(freq_hi=25, contrast=80) at 640x480, `Config()` with loop
closing off, the bench trajectory as uint8 frames, rendered before any
clock starts), and the legs run in this order on one FullSystem:

  warmup     the first `warm` frames strict, then the retry and BA graphs
             (`FullSystem.warm_retrack_programs`), outside every window;
  lookahead  bench.py's "sync": a DeterministicPipeline(depth=3), `sync_warm`
             unmeasured frames, then 3 windows of `window` frames;
  strict     3 windows of `window` frames through add_active_frame;
  async      bench.py's "piped": `pipe_warm` frames through an
             AsyncPipeline, then 3 windows of `pipe_window` frames, each
             through a new AsyncPipeline built before its clock starts;
  ate        the similarity-aligned ATE (`bench_ate`) over every frame
             before the async leg with a valid pose;
  util       device ms of four programs at the warm system's state: the
             frame step (the chain step's program: the pyramid and the
             track, one graph replay), the trace of
             the whole arena as the system runs it (labelled with its live
             lane count), the keyframe's activation pass over the whole
             arena (the splat, K1, K5, the insert; same label) and the
             device LM as one graph replay;
then, each on systems of its own:
  aggregate  for each S of `seqs`: S FullSystems on S sequences (at most
             `unique_seqs` of them rendered, the rest repeat them), warmed
             strict on S threads, then 3 windows of `seq_window` frames
             through S AsyncPipelines on S threads;
  batched_tracking  B = `batch` sequences in lockstep through
             parallel/replay.make_batched_tracker, `steps` dependent steps;
  batched_ba the system's final window tiled to S = `ba_batch`, the device
             LM under torch.func.vmap in one CUDA graph.

Every window ends with a drain (block_until_mapping_is_finished) and a
synchronise. It prints one JSON line, the last line of its output:
`metric`, `value` (async's median fps), `unit`, `vs_baseline` (value over
18.5 fps, the reference LDSO built from source and run on the JAX
package's container CPU over the same trajectory, bench.py:9-14),
`sync_fps_windows`, `sync_fps`, `frames_measured`, `strict_fps_windows`,
`strict_fps`, `piped_fps_windows`, `piped_keyframes_windows` (async keeps a
keyframe only when its mapping queue is empty, so its fps goes with this
count), `ate_m_sim_aligned`, `util` ({program: {ms, io_gb, hbm_pct_min}}),
`aggregate_vo_fps_<S>seq` per S (its windows, and the wall seconds of
its strict warm-up on S threads, under `aggregate`),
`batched_tracking_fps_<B>seq`, `batched_ba_<S>seq` ({S, trips, ms,
ms_per_seq_kf, agg_kf_per_sec}), and per leg: `launches` (the change of
`cuda_kernels.LAUNCHES`), `graphs` (the tracker's, the device LM's, the
point marginalization's, the activation's and the bootstrap frame's graph
captures and replays, K6's and K7's launches through the BA's and the
marginalization's, and the host seconds replays waited for a graph's
lock: every FullSystem of the process shares the graphs, so S systems'
replays queue on one lock; the frame and chain steps' too),
`traces` (the arena traces committed: the frame steps' trace flags,
FullSystem._trace_arena's calls and util's timed trace calls),
`k4_expected` (K4's launches on the card that the leg's frame steps,
trace calls and captures imply: time_modes.counted_traces), `k2_expected`
(K2's pyramid launches that the leg's step replays, captures and
bootstrap frames imply: time_modes.counted_pyramids; the util and batched
tracking legs also build pyramids of their own), `activations`
(the activation passes:
FullSystem._activation_pass's calls, and util's timed ones; K5 launches
once for each), `leg_s` (wall seconds) and
`peak_memory_gb`; and `device` (the card's name and power limit, the
torch and CUDA versions).

`util`'s `ms` is device time: CUDA events around 20 chained calls (each
call's output feeds the next) after a warm-up, queued behind the card's
sleep kernel so that they run back to back whatever the host spends.
`io_gb` counts each distinct input and output tensor once (bench.py's rule,
bench.py:397-413) and `hbm_pct_min` is that over the time at 3.35 TB/s.
bench.py's `gflop`, `mxu_pct` and `xla_cost_gb` came from XLA's cost model
of a whole program; PyTorch has none, so they are not counted.

A failure is not retried. Any exception, a lost system, an initializer
that does not finish, an ATE of 5 mm or more, ends the run: the line then
carries what was measured so far and `error`, and the exit code is 1. The
bench runs on the card and fails where there is none; `--device cpu` runs
it on the CPU for the tests, and then every device time is null.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import threading
import time
import traceback
from typing import Callable, List, Optional

import numpy as np
import torch

from ldso_tpu_torch.backend import ba_device
from ldso_tpu_torch.backend import energy_functional as efm
from ldso_tpu_torch.backend.window import Window
from ldso_tpu_torch.config import Config
from ldso_tpu_torch.examples import time_modes
from ldso_tpu_torch.frontend import (immature, initializer, track_graph,
                                     tracker)
from ldso_tpu_torch.math import lie_np
from ldso_tpu_torch.ops import cuda_kernels
from ldso_tpu_torch.ops.preprocess import (FramePyramid, make_pyramid,
                                           upload_image)
from ldso_tpu_torch.parallel import replay
from ldso_tpu_torch.synthetic import PlaneScene
from ldso_tpu_torch.system import full_system as fsm
from ldso_tpu_torch.system.pipeline import (AsyncPipeline,
                                            DeterministicPipeline)
from ldso_tpu_torch.utils.device import DEFAULT_DEVICE, entry_device
from ldso_tpu_torch.utils.graphs import Programs

BASELINE_FPS = 18.5          # the reference on the JAX package's CPU
ATE_BOUND_M = 0.005          # the JAX package's own bound (test_full_system)
HBM_BYTES_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
UTIL_CALLS = 20              # chained calls per device-time reading
UTIL_REPS = 5


class BenchError(RuntimeError):
    """A leg that cannot give a number: a lost system, an initializer that
    did not finish, an ATE over the bound."""


def _positive(text: str) -> int:
    n = int(text)
    if n < 1:
        raise argparse.ArgumentTypeError(f"{n} is not a positive count")
    return n


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=_positive, default=640)
    ap.add_argument("--height", type=_positive, default=480)
    ap.add_argument("--warm", type=_positive, default=56,
                    help="strict frames before every leg (bench.py n_warm)")
    ap.add_argument("--sync-warm", type=_positive, default=8,
                    help="unmeasured lookahead frames (n_sync_warm)")
    ap.add_argument("--window", type=_positive, default=16,
                    help="frames per lookahead and strict window")
    ap.add_argument("--pipe-warm", type=_positive, default=16,
                    help="unmeasured async frames (n_pipe_warm)")
    ap.add_argument("--pipe-window", type=_positive, default=48,
                    help="frames per async window")
    ap.add_argument("--seqs", type=_positive, nargs="+", default=[8, 16],
                    help="sequences S of each aggregate leg")
    ap.add_argument("--unique-seqs", type=_positive, default=8,
                    help="sequences rendered per aggregate leg")
    ap.add_argument("--seq-warm", type=_positive, default=16,
                    help="strict frames per aggregate sequence before it")
    ap.add_argument("--seq-window", type=_positive, default=8,
                    help="frames per sequence per aggregate window")
    ap.add_argument("--batch", type=_positive, default=16,
                    help="sequences B of the batched tracker")
    ap.add_argument("--steps", type=_positive, default=30,
                    help="dependent steps of the batched tracker")
    ap.add_argument("--ba-batch", type=_positive, default=8,
                    help="windows S of the batched BA")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="the card (default); cpu is for the tests")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Run:
    """What the legs share: the arguments, the device, the scene and the
    main system."""
    args: argparse.Namespace
    dev: torch.device
    calib: object = None
    cfg: Config = None
    poses: List[np.ndarray] = None
    images: List[np.ndarray] = None
    fs: Optional[fsm.FullSystem] = None
    # the arena traces (time_modes.counted_traces), util's own among them
    traces: Optional[dict] = None
    # the activation passes: FullSystem._activation_pass's calls and
    # util's own
    activations: Optional[dict] = None

    def ids(self, leg: str) -> range:
        """The frame ids of a leg of the main system, in bench.py's order
        (bench.py:127-133, 197-219) with strict after lookahead."""
        a = self.args
        sizes = {"warmup": a.warm, "lookahead": a.sync_warm + 3 * a.window,
                 "strict": 3 * a.window,
                 "async": a.pipe_warm + 3 * a.pipe_window}
        start = 0
        for name, size in sizes.items():
            if name == leg:
                return range(start, start + size)
            start += size
        raise KeyError(leg)


def bench_ate(est_T_cw, gt_T_cw) -> float:
    """bench.py's ATE (bench.py:255-262), in metres: the RMSE of the camera
    centres after scaling the estimate by the ratio of the centred norms
    and rotating it by the Kabsch rotation."""
    est_c = np.stack([np.linalg.inv(T)[:3, 3] for T in est_T_cw])
    gt_c = np.stack([np.linalg.inv(T)[:3, 3] for T in gt_T_cw])
    ec = est_c - est_c.mean(0)
    gc = gt_c - gt_c.mean(0)
    s = np.sqrt((gc ** 2).sum() / max((ec ** 2).sum(), 1e-12))
    U, _, Vt = np.linalg.svd(ec.T @ gc)
    R = (U @ Vt).T
    return float(np.sqrt(np.mean(np.sum((gc - s * (ec @ R.T)) ** 2, 1))))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median(xs) -> float:
    return float(np.median(xs))


def _feed(target, fs, images, ids):
    """Feed frames `ids` to a FullSystem or a pipeline over `fs`, as
    bench.py does (exposure 1, 20 Hz timestamps); a lost system or a failed
    initializer raises."""
    for i in ids:
        target.add_active_frame(images[i], i, 1.0, i * 0.05)
        if fs.is_lost or fs.init_failed:
            raise BenchError(f"system lost (or its initializer failed) at "
                             f"frame {i}")


def _end_window(target, dev):
    """A window's end: the pipeline's drain, then a synchronise."""
    if hasattr(target, "block_until_mapping_is_finished"):
        target.block_until_mapping_is_finished()
    _sync(dev)


def _windows(run: Run, make_target: Callable, ids: range, size: int):
    """Three windows of `size` frames from ids[0]: each fed to the
    FullSystem or pipeline `make_target()` returns, built before its clock
    starts, and ended.
    Returns the fps of each and the keyframes each made."""
    fs = run.fs
    fps, kfs = [], []
    for k in range(3):
        target = make_target()
        kf0 = fs.global_map.num_frames()
        t0 = time.perf_counter()
        _feed(target, fs, run.images, ids[k * size:(k + 1) * size])
        _end_window(target, run.dev)
        fps.append(size / (time.perf_counter() - t0))
        kfs.append(fs.global_map.num_frames() - kf0)
    return fps, kfs


def _tile(x: torch.Tensor, n: int) -> torch.Tensor:
    """x repeated along a new leading axis of n, contiguous."""
    return x[None].expand((n,) + tuple(x.shape)).contiguous()


def _on_threads(fns):
    """Run each function on a thread of its own; raise the first failure."""
    errors = []

    def guarded(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 -- raised on the caller
            errors.append(e)
    threads = [threading.Thread(target=guarded, args=(fn,)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


# ------------------------------------------------------------------- legs
def leg_warmup(run: Run, result: dict):
    """bench.py:148-159."""
    fs = run.fs = fsm.FullSystem(run.calib, run.cfg, device=run.dev)
    _feed(fs, fs, run.images, run.ids("warmup"))
    if not fs.initialized:
        raise BenchError(f"the initializer had not finished after "
                         f"{run.args.warm} frames")
    fs.warm_retrack_programs()


def leg_lookahead(run: Run, result: dict):
    """bench.py:161-190."""
    a, fs = run.args, run.fs
    pipe = DeterministicPipeline(fs, depth=3)
    ids = run.ids("lookahead")
    _feed(pipe, fs, run.images, ids[:a.sync_warm])
    _end_window(pipe, run.dev)
    measured = ids[a.sync_warm:]
    fps, _ = _windows(run, lambda: pipe, measured, a.window)
    result["sync_fps_windows"] = fps
    result["sync_fps"] = _median(fps)
    result["frames_measured"] = sum(1 for f in fs.all_frames
                                    if f.id in measured)


def leg_strict(run: Run, result: dict):
    """The CLI's third mode beside lookahead, on the same system."""
    fps, _ = _windows(run, lambda: run.fs, run.ids("strict"),
                      run.args.window)
    result["strict_fps_windows"] = fps
    result["strict_fps"] = _median(fps)


def leg_async(run: Run, result: dict):
    """bench.py:192-243."""
    a, fs = run.args, run.fs
    ids = run.ids("async")
    pipe = AsyncPipeline(fs)
    _feed(pipe, fs, run.images, ids[:a.pipe_warm])
    _end_window(pipe, run.dev)
    fps, kfs = _windows(run, lambda: AsyncPipeline(fs), ids[a.pipe_warm:],
                        a.pipe_window)
    result["value"] = _median(fps)
    result["vs_baseline"] = result["value"] / BASELINE_FPS
    result["piped_fps_windows"] = fps
    result["piped_keyframes_windows"] = kfs


def leg_ate(run: Run, result: dict):
    """bench.py:245-265: over the frames before the async leg."""
    end = run.ids("async")[0]
    est = [f for f in run.fs.all_frames if f.pose_valid and f.id < end]
    ate = bench_ate([f.T_cw for f in est], [run.poses[f.id] for f in est])
    result["ate_m_sim_aligned"] = ate
    if not ate < ATE_BOUND_M:
        raise BenchError(f"ATE {ate} m is not under {ATE_BOUND_M} m")


def io_bytes(inputs, outputs) -> int:
    """The bytes of the distinct tensors among a program's inputs and
    outputs: each read or written once (an output that is an input counts
    once)."""
    seen = {(t.data_ptr(), t.nbytes)
            for t in fsm._tensors((inputs, outputs))}
    return sum(n for _, n in seen)


def sleep_cycles_per_ms() -> float:
    """The card's sleep kernel's cycles per millisecond."""
    torch.cuda._sleep(1_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    b.synchronize()
    return 20_000_000 / a.elapsed_time(b)


def device_ms(step: Callable, carry, n: int = UTIL_CALLS,
              reps: int = UTIL_REPS) -> float:
    """Device ms per call of `step` (carry -> carry): n chained calls
    queued behind the card's sleep kernel, which lasts twice the host's
    time to queue them, so that they run back to back; CUDA events around
    the n; the median over reps, after a warm-up call."""
    carry = step(carry)
    torch.cuda.synchronize()
    t = time.perf_counter()
    c = carry
    for _ in range(n):
        c = step(c)
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    cycles = int(sleep_cycles_per_ms() * (2.0 * host_ms + 1.0))
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        c = carry
        for _ in range(n):
            c = step(c)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return _median(times)


def program_util(dev, program: Callable, carry, inputs) -> dict:
    """{ms, io_gb, hbm_pct_min} of `program` (carry -> (carry, outputs)),
    whose other inputs are `inputs`; on the CPU one call for the bytes and
    a null time."""
    n_bytes = io_bytes((carry, inputs), program(carry))
    ms = (device_ms(lambda c: program(c)[0], carry) if dev.type == "cuda"
          else None)
    return dict(ms=ms, io_gb=n_bytes / 1e9,
                hbm_pct_min=(100.0 * n_bytes / (ms * 1e-3) / HBM_BYTES_S
                             if ms else None))


def leg_util(run: Run, result: dict):
    """bench.py:368-486, on the system's last tracked frame."""
    fs, calib, cfg, dev = run.fs, run.calib, run.cfg, run.dev
    util = result.setdefault("util", {})
    shell = [f for f in fs.all_frames if f.pose_valid][-1]
    W0, arena0 = fs.ef.W, fs.imm_arena
    img = upload_image(run.images[shell.id], dev)

    # 1. the frame step: the chain step's program (the chain's hypothesis,
    # the pyramid, the track and the chain's advance), one replay, chained
    fs.chain_reset()
    ref, ref_shell = fs._current_tracker_ref()
    up = fs._f32(np.r_[np.ravel(ref_shell.T_cw), 1.0])

    def frame_step(c):
        pyr, packed, c = fs._chain_step(img, ref, c, up)
        return c, (pyr, packed)
    util["frame_step(track)"] = program_util(dev, frame_step, fs.track_chain,
                                             (img, ref, up))

    # 2. the whole arena's trace against that frame, labelled with its live
    # lane count
    n = immature.arena_watermark(fs.imm_arena)
    if n == 0:
        raise BenchError("no live trace lanes in the warm system")
    pyr = make_pyramid(img, calib.levels, fs.b_grad)
    transforms = fs._trace_transforms(fs._f32(shell.T_cw), fs._f32(shell.aff),
                                      shell.exposure)

    def trace(arena):
        run.traces["traces"] += 1
        run.traces["trace_calls"] += 1
        out = immature.trace_arena(arena, pyr.dI[0], *transforms, calib,
                                   cfg)
        return out, out
    util[f"trace({n} lanes)"] = program_util(dev, trace, fs.imm_arena,
                                             (pyr.dI[0], transforms))

    # 3. the keyframe's activation pass over the whole arena (the splat,
    # K1, K5, the slot allocation and the insert) on the final window, one
    # replay of its graph, its tables uploaded once; each call starts from
    # the same window and arena
    up = fs._activation_upload()
    nf = len(fs.window_frames)

    def activate(arena):
        run.activations["activations"] += 1
        out = fsm._program(*fs._activation_call(W0, arena, fs.dIs, up,
                                                   nf))
        return arena, out
    util[f"activate({n} lanes)"] = program_util(
        dev, activate, arena0, (W0, fs.dIs, up))

    # 4. the device LM of the final window, one graph replay
    W, *rest = fs.ef.device_lm_inputs(fs.dIs, cfg.max_opt_iterations,
                                      calib.w[0], calib.h[0])
    lm = efm.replay_ba if dev.type == "cuda" else ba_device.optimize_device

    def ba_lm(W):
        out = lm(W, *rest)
        return out[0], out
    util["ba_lm"] = program_util(dev, ba_lm, W, rest[:4])


def _graph_counts() -> dict:
    return dict(tracker_captures=track_graph.CAPTURES["count"],
                tracker_replays=track_graph.CAPTURES["replays"],
                tracker_wait_s=track_graph.TRACKER.lock_wait_s(),
                ba_captures=efm.BA_GRAPHS.counts["count"],
                ba_replays=efm.BA_GRAPHS.counts["replays"],
                ba_wait_s=efm.BA_GRAPHS.lock_wait_s(),
                marg_captures=efm.MARG_GRAPHS.counts["count"],
                marg_replays=efm.MARG_GRAPHS.counts["replays"],
                activate_captures=fsm.ACTIVATE_GRAPHS.counts["count"],
                activate_replays=fsm.ACTIVATE_GRAPHS.counts["replays"],
                activate_wait_s=fsm.ACTIVATE_GRAPHS.lock_wait_s(),
                init_captures=initializer.INIT_GRAPHS.counts["count"],
                init_replays=initializer.INIT_GRAPHS.counts["replays"],
                init_wait_s=initializer.INIT_GRAPHS.lock_wait_s(),
                **{f"{name}_{k}": fam.counts[c] for name, fam
                   in time_modes.STEP_FAMILIES.items()
                   for k, c in (("captures", "count"),
                                ("replays", "replays"))},
                **{f"{name}_wait_s": fam.lock_wait_s() for name, fam
                   in time_modes.STEP_FAMILIES.items()},
                **{f"{k}_in_graphs": n
                   for k, n in time_modes.graph_launches().items()})


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gb(dev) -> Optional[float]:
    return (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
            else None)


def leg_aggregate(run: Run, result: dict, S: int):
    """bench.py:489-572: S systems on S sequences, S threads."""
    a, dev = run.args, run.dev
    n = a.seq_warm + 3 * a.seq_window
    uniq = [time_modes.bench_frames(n, a.width, a.height, dev, seq=k)[2]
            for k in range(min(S, a.unique_seqs))]
    seqs = [uniq[k % len(uniq)] for k in range(S)]
    systems = [fsm.FullSystem(run.calib, run.cfg, device=dev)
               for _ in range(S)]
    t_warm = time.perf_counter()
    _on_threads([lambda fs=fs, imgs=imgs: _feed(fs, fs, imgs,
                                                range(a.seq_warm))
                 for fs, imgs in zip(systems, seqs)])
    for fs in systems:
        if not fs.initialized:
            raise BenchError(f"an aggregate system's initializer had not "
                             f"finished after {a.seq_warm} frames")
        fs.warm_retrack_programs()
    warm_s = time.perf_counter() - t_warm
    fps = []
    for k in range(3):
        ids = range(a.seq_warm + k * a.seq_window,
                    a.seq_warm + (k + 1) * a.seq_window)
        pipes = [AsyncPipeline(fs) for fs in systems]

        def window(pipe, imgs):
            _feed(pipe, pipe.fs, imgs, ids)
            _end_window(pipe, dev)
        t0 = time.perf_counter()
        _on_threads([lambda p=p, imgs=imgs: window(p, imgs)
                     for p, imgs in zip(pipes, seqs)])
        _sync(dev)
        fps.append(S * len(ids) / (time.perf_counter() - t0))
    result[f"aggregate_vo_fps_{S}seq"] = _median(fps)
    result.setdefault("aggregate", {})[f"{S}seq"] = dict(
        S=S, unique_seqs=len(uniq), fps_windows=fps, warm_s=warm_s)


def leg_batched_tracking(run: Run, result: dict):
    """bench.py:575-638: B sequences in lockstep, one reference view."""
    B, L, dev = run.args.batch, run.calib.levels, run.dev
    calib, cfg = run.calib, Config()
    scene = PlaneScene(freq_hi=25.0, contrast=80.0)
    img0, id0 = scene.render(calib, np.eye(4), device=dev)
    ref = tracker.make_tracker_ref_from_idepth(
        id0, make_pyramid(img0, L), calib, cfg.tracker_caps[:L], stride=2)
    img1, _ = scene.render(calib, lie_np.se3_exp(
        np.array([0.02, -0.01, 0.005, 0.002, 0.004, -0.001])), device=dev)
    refs = replay._tree_map(lambda x: _tile(x, B), ref)
    pyrs = FramePyramid(dI=tuple(_tile(x, B)
                                 for x in make_pyramid(img1, L).dI),
                        abs_grad=())
    f32 = dict(dtype=torch.float32, device=dev)
    T0 = _tile(torch.eye(4, **f32), B)
    aff0 = torch.zeros((B, 2), **f32)
    expo = torch.ones(B, **f32)
    min_abort = torch.full((B, L), 1e9, **f32)
    step = replay.make_batched_tracker(calib, cfg, L - 1)
    out = step(refs, pyrs, T0, aff0, expo, min_abort)     # the capture
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(run.args.steps):
        out = step(refs, pyrs, out[0], aff0, expo, min_abort)
    _sync(dev)
    dt = time.perf_counter() - t0
    result[f"batched_tracking_fps_{B}seq"] = B * run.args.steps / dt

    def track(T):
        out = step(refs, pyrs, T, aff0, expo, min_abort)
        return out[0], out
    result.setdefault("util", {})[f"batched_track({B} seq)"] = program_util(
        dev, track, T0, (refs, pyrs, aff0, expo, min_abort))


def leg_batched_ba(run: Run, result: dict):
    """bench.py:641-694: the final window tiled to S, one vmapped graph."""
    S, fs, dev = run.args.ba_batch, run.fs, run.dev
    W, dIs, HM, bM, newest, cfg, w, h, trips = fs.ef.device_lm_inputs(
        fs.dIs, run.cfg.max_opt_iterations, run.calib.w[0], run.calib.h[0])
    rest = tuple(_tile(x, S) for x in (dIs, HM, bM, newest))
    lm = torch.func.vmap(lambda W, d, H, b, n: ba_device.optimize_device(
        W, d, H, b, n, cfg, w, h, trips))

    def program(*xs):
        W, stats = lm(Window(*xs[:-4]), *xs[-4:])
        return tuple(W) + (stats,)
    graphs = Programs()
    key = ("vmap", ba_device.graph_key(cfg), w, h, trips)

    def step(Wb):
        out = (graphs.replay(key, program, tuple(Wb) + rest)
               if dev.type == "cuda" else program(*Wb, *rest))
        return Window(*out[:-1])
    Wb = step(Window(*(_tile(x, S) for x in W)))          # the capture
    ms = device_ms(step, Wb) if dev.type == "cuda" else None
    result[f"batched_ba_{S}seq"] = dict(
        S=S, trips=trips, ms=ms, ms_per_seq_kf=ms / S if ms else None,
        agg_kf_per_sec=S / (ms * 1e-3) if ms else None)


def device_facts(dev) -> dict:
    facts = dict(type=dev.type, torch=torch.__version__,
                 cuda=torch.version.cuda)
    if dev.type == "cuda":
        facts.update(time_modes.gpu_facts())
    return facts


def measure(args: argparse.Namespace) -> dict:
    """Run every leg in order; returns the result, with `error` when a leg
    failed (the legs after it do not run)."""
    result = {"metric": f"frames/sec synthetic {args.width}x{args.height} "
                        f"VO (pipelined, preset 0)", "unit": "fps"}
    leg = "device"
    try:
        run = Run(args, entry_device(args.device))
        result["device"] = device_facts(run.dev)
        leg = "frames"
        run.cfg = dataclasses.replace(Config(), enable_loop_closing=False)
        n = run.ids("async")[-1] + 1
        run.calib, run.poses, run.images = time_modes.bench_frames(
            n, args.width, args.height, run.dev)
        legs = [("warmup", leg_warmup), ("lookahead", leg_lookahead),
                ("strict", leg_strict), ("async", leg_async),
                ("ate", leg_ate), ("util", leg_util)]
        legs += [(f"aggregate_{S}seq",
                  lambda run, result, S=S: leg_aggregate(run, result, S))
                 for S in args.seqs]
        legs += [("batched_tracking", leg_batched_tracking),
                 ("batched_ba", leg_batched_ba)]
        for leg, fn in legs:
            launches, graphs = dict(cuda_kernels.LAUNCHES), _graph_counts()
            _reset_peak(run.dev)
            t0 = time.perf_counter()
            try:
                with time_modes.counted_traces() as run.traces, \
                        time_modes.counted_activations() as run.activations, \
                        time_modes.counted_pyramids() as pyramids:
                    fn(run, result)
            finally:
                result.setdefault("k2_expected", {})[leg] = \
                    pyramids["k2_expected"]
                result.setdefault("traces", {})[leg] = run.traces["traces"]
                result.setdefault("k4_expected", {})[leg] = \
                    run.traces["k4_expected"]
                result.setdefault("activations", {})[leg] = \
                    run.activations["activations"]
                result.setdefault("leg_s", {})[leg] = time.perf_counter() - t0
                result.setdefault("peak_memory_gb", {})[leg] = _peak_gb(
                    run.dev)
                result.setdefault("launches", {})[leg] = {
                    k: cuda_kernels.LAUNCHES[k] - v
                    for k, v in launches.items()}
                result.setdefault("graphs", {})[leg] = {
                    k: v - graphs[k] for k, v in _graph_counts().items()}
    except Exception as e:  # noqa: BLE001 -- the line reports the failure
        traceback.print_exc(file=sys.stderr)
        result["error"] = f"{leg}: {type(e).__name__}: {e}"
    return result


def main(argv=None) -> int:
    result = measure(parse_args(argv))
    print(json.dumps(result), flush=True)
    return 1 if "error" in result else 0


if __name__ == "__main__":
    sys.exit(main())
