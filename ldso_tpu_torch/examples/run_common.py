"""The CLI runner shared by run_dso_{tum_mono,kitti,euroc}: the reference's
key=value arguments, presets, frame loop, init-failure reset, fps report
and trajectory output (examples/run_dso_tum_mono.cc:91-471).

Counterpart of examples/run_common.py. The system runs on the CUDA card
unless `build_system`/`run` get another `device`. Not carried over: the
live viewer (`nogui=0` raises) and the JAX profiler hook.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

from ldso_tpu_torch.config import preset as make_preset
from ldso_tpu_torch.io.datasets import ImageFolderReader
from ldso_tpu_torch.io.trajectory import save_ply, write_kitti, write_tum
from ldso_tpu_torch.loop import posegraph
from ldso_tpu_torch.loop.vocab import Vocabulary
from ldso_tpu_torch.system.full_system import FullSystem
from ldso_tpu_torch.system.pipeline import AsyncPipeline, DeterministicPipeline
from ldso_tpu_torch.utils.device import DEFAULT_DEVICE

PIPELINES = ("strict", "lookahead", "async")


def parse_args(argv):
    opts = dict(files=None, calib=None, gamma=None, vignette=None,
                vocab=None, preset=0, mode=0, loopclosing=True,
                start=0, end=100000, output="results.txt", nogui=True,
                point_selection=None, quiet=False, speed=0.0,
                noise=0.0, blur=0.0, pipeline=None)
    for arg in argv:
        if "=" not in arg:
            continue
        k, v = arg.split("=", 1)
        if k in ("files", "calib", "gamma", "vignette", "vocab", "output"):
            opts[k] = v
        elif k in ("preset", "mode", "start", "end"):
            opts[k] = int(v)
        elif k == "loopclosing":
            opts[k] = v not in ("0", "false", "False")
        elif k == "pointSelection":
            opts["point_selection"] = int(v)
        elif k == "speed":
            opts["speed"] = float(v)   # >0: timestamp-paced, skip if behind
        elif k == "pipeline":
            # strict: the per-frame synchronous loop (linearizeOperation);
            # lookahead: deterministic dispatch ahead of the consume (the
            # same decisions in the same order); async: the mapping thread
            # (the reference's threaded mode). Default as the reference:
            # speed == 0 -> strict (run_dso_tum_mono.cc:323), else async.
            if v not in PIPELINES:
                raise ValueError(f"pipeline={v}: one of {PIPELINES}")
            opts["pipeline"] = v
        elif k == "noise":
            opts["noise"] = float(v)   # benchmark_varNoise (px)
        elif k == "blur":
            opts["blur"] = float(v)    # benchmark_varBlurNoise (sigma)
        elif k == "quiet":
            opts["quiet"] = v not in ("0", "false", "False")
        elif k == "nogui":
            opts["nogui"] = v not in ("0", "false", "False")
        elif k in ("viewerport", "nolog", "nomt", "save"):
            pass  # accepted for CLI parity; no-ops here
    return opts


def build_system(opts, dataset_type: str, device=DEFAULT_DEVICE):
    if opts["files"] is None or opts["calib"] is None:
        print("usage: files=<path> calib=<camera.txt> [gamma=] [vignette=] "
              "[vocab=] [preset=0..3] [mode=0|1] [loopclosing=1] "
              "[start=] [end=] [output=results.txt] [noise=px] [blur=sigma] "
              "[pipeline=strict|lookahead|async]")
        sys.exit(1)
    if not opts.get("nogui", True):
        raise NotImplementedError("viewer not ported yet (ROADMAP item 18)")

    cfg = make_preset(opts["preset"])
    # mode=1: photometric calibration absent (run_dso_kitti default)
    if opts["mode"] == 1:
        cfg = dataclasses.replace(cfg, photometric_calibration=0,
                                  affine_opt_mode_a=0.0, affine_opt_mode_b=0.0)
    cfg = dataclasses.replace(cfg, enable_loop_closing=opts["loopclosing"])
    if opts["point_selection"] is not None:
        cfg = dataclasses.replace(cfg, point_selection=opts["point_selection"])

    reader = ImageFolderReader(opts["files"], opts["calib"], opts["gamma"],
                               opts["vignette"], dataset_type=dataset_type,
                               device=device)
    reader.var_noise = opts.get("noise", 0.0)
    reader.var_blur = opts.get("blur", 0.0)
    calib = reader.calibration()

    vocab = None
    if opts["vocab"] and os.path.exists(opts["vocab"]):
        try:
            vocab = Vocabulary.load(opts["vocab"])
            print(f"loaded vocabulary: {vocab.n_words} words")
        except (OSError, ValueError) as e:
            print(f"vocabulary load failed ({e}); training online instead")

    b_grad = None
    pc = reader.undistorter.photometric
    if pc is not None and pc.valid and cfg.gamma_weights_pixel_select:
        B = pc.inverse_response_B()
        b_grad = np.diff(np.concatenate([B, B[-1:]])).astype(np.float32)

    fs = FullSystem(calib, cfg, b_grad_lut=b_grad, vocab=vocab, device=device)
    return fs, reader, calib, cfg


def make_driver(fs, pmode: str):
    """What the frame loop feeds in `pmode`: the FullSystem itself
    (strict) or a pipeline over it."""
    if pmode == "async":
        return AsyncPipeline(fs)
    if pmode == "lookahead":
        return DeterministicPipeline(fs)
    return fs


def run(opts, dataset_type: str, kitti_output: bool = False,
        device=DEFAULT_DEVICE):
    fs, reader, calib, cfg = build_system(opts, dataset_type, device)
    # the reference runs its mapping thread unless playbackSpeed == 0 forces
    # the synchronous linearizeOperation path (run_dso_tum_mono.cc:323)
    pmode = opts.get("pipeline") or (
        "async" if opts.get("speed", 0.0) > 0 else "strict")
    driver = make_driver(fs, pmode)
    n = reader.num_images()
    lo, hi = opts["start"], min(opts["end"], n)
    print(f"dataset: {n} images, running [{lo}, {hi})  "
          f"{calib.w[0]}x{calib.h[0]}, {calib.levels} levels, "
          f"pipeline={pmode}, device={fs.device}")

    t0 = time.time()
    n_run = 0
    n_skipped = 0
    i = lo
    ts0 = None
    speed = opts.get("speed", 0.0)
    stamps = reader.timestamps
    while i < hi:
        # timestamp-paced playback: when running slower than speed x real
        # time, drop frames to catch up (run_dso_tum_mono.cc:363-398)
        if speed > 0 and stamps and n_run > 0:
            if ts0 is None:
                ts0 = stamps[lo]
            behind = (time.time() - t0) - (stamps[i] - ts0) / speed
            if behind > 0 and i + 1 < hi:
                i += 1
                n_skipped += 1
                continue
        img, expo, ts = reader.get_image(i)
        driver.add_active_frame(img, i, expo, ts)
        n_run += 1

        # init-failure auto-reset within the first 250 frames
        # (run_dso_tum_mono.cc:404-417)
        if fs.init_failed and i - lo < 250:
            print(f"init failed at frame {i}; resetting")
            fs, _, calib, cfg = build_system(opts, dataset_type, device)
            driver = make_driver(fs, pmode)
        if fs.is_lost:
            print(f"LOST at frame {i}")
            break
        if n_run % 50 == 0:
            dt = time.time() - t0
            print(f"frame {i}: {n_run / dt:.2f} fps, "
                  f"{fs.global_map.num_frames()} KFs")
        i += 1

    if pmode != "strict" and not fs.is_lost:
        # blockUntilMappingIsFinished (FullSystem.cc:384-409), with the
        # shutdown pose-graph pass
        driver.block_until_mapping_is_finished()
    dt = time.time() - t0
    print(f"processed {n_run} frames in {dt:.1f}s = {n_run / max(dt, 1e-9):.2f} fps"
          + (f" ({n_skipped} skipped for pacing)" if n_skipped else ""))
    if not opts.get("quiet"):
        print(fs.timer.summary())

    if fs.loop_closing is not None:
        print(f"loops closed: {fs.loop_closing.n_loops_closed}")
    if (pmode == "strict" and fs.loop_closing is not None
            and fs.global_map.num_frames() > 4):
        posegraph.run_pose_graph(fs.global_map, device=fs.device)

    out = opts["output"]
    kfs = fs.global_map.get_all_kfs()
    if kitti_output:
        write_kitti(out, [kf.id for kf in kfs], [kf.get_S_cw() for kf in kfs])
        write_kitti(out + ".noloop", [kf.id for kf in kfs],
                    [kf.T_cw for kf in kfs])
    else:
        write_tum(out, [kf.timestamp for kf in kfs],
                  [kf.get_S_cw() for kf in kfs])
        write_tum(out + ".noloop", [kf.timestamp for kf in kfs],
                  [kf.T_cw for kf in kfs])
    fs.flush_active_points()   # live window points join the map
    pc = fs.global_map.point_cloud()
    if len(pc):
        save_ply(os.path.join(os.path.dirname(out) or ".", "pointcloud.ply"), pc)
    print(f"wrote {out} (+.noloop), {len(pc)} map points")
    return fs


def main(argv, dataset_type: str, kitti_output: bool = False,
         default_mode: int = 0):
    """A runner's entry: parse argv, apply the dataset's default mode."""
    opts = parse_args(argv)
    if "mode" not in [a.split("=")[0] for a in argv]:
        opts["mode"] = default_mode
    return run(opts, dataset_type, kitti_output)
