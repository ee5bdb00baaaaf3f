"""A captured graph's first launch, with and without the upload at capture
(utils/graphs.upload): how long the host waits in it when the card is busy.

    python3 tests/tools/graph_first_launch.py [--sleep-ms 150]

On the card, in turns (without, with, without, with): the bootstrap's
frame program (frontend/initializer.capture_frame_program on the bench
scene's first frame, a family of its own) and a toy program of 50
elementwise kernels, each captured afresh; then ~sleep-ms of queued sleep
and the first launch (the bootstrap's dispatch of the next frame, the
toy's replay), the host ms it took and whether its result was ready at
return; then a second launch alike. Prints one JSON line per turn.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sleep-ms", type=float, default=150.0)
    args = ap.parse_args()
    import dataclasses
    import torch
    import chip_smoke as cs
    from ldso_tpu_torch.config import Config
    from ldso_tpu_torch.examples import time_modes
    from ldso_tpu_torch.frontend import initializer
    from ldso_tpu_torch.ops.preprocess import make_pyramid, upload_image
    from ldso_tpu_torch.utils import graphs
    cycles = int(cs._sleep_cycles_per_ms() * args.sleep_ms)
    calib, _, images = time_modes.bench_frames(2)
    cfg = dataclasses.replace(Config(), enable_loop_closing=False)
    pyr0, pyr1 = (make_pyramid(upload_image(im, "cuda"), calib.levels)
                  for im in images[:2])
    x = torch.randn(1 << 20, device="cuda")

    def toy(x):
        y = x
        for _ in range(50):
            y = y * 1.0001 + 0.5
        return (y,)
    upload = graphs.upload
    saved = initializer.INIT_GRAPHS
    try:
        for turn, with_upload in enumerate((False, True, False, True)):
            graphs.upload = upload if with_upload else (
                lambda g, s: None)
            initializer.INIT_GRAPHS = graphs.Programs(capture_on_replay=False)
            toys = graphs.Programs(capture_on_replay=False)
            st = initializer.set_first(pyr0, calib, cfg)
            initializer.capture_frame_program(st, pyr0, calib, cfg)
            toys.capture("toy", toy, (x,))
            row = dict(turn=turn, upload=with_upload)
            for name, launch in (
                    ("bootstrap", lambda: initializer.track_frame_dispatch(
                        copy.deepcopy(st), pyr0, pyr1, calib, cfg)),
                    ("toy", lambda: toys.replay("toy", toy, (x,)))):
                for k in ("first", "second"):
                    torch.cuda.synchronize()
                    torch.cuda._sleep(cycles)
                    t = time.perf_counter()
                    out = launch()
                    host_ms = (time.perf_counter() - t) * 1e3
                    if name == "bootstrap":
                        ready = out.is_ready()
                    else:
                        ev = torch.cuda.Event()
                        ev.record()
                        ready = ev.query()
                    row[f"{name}_{k}"] = dict(host_ms=host_ms, ready=ready)
            torch.cuda.synchronize()
            print(json.dumps(dict(sleep_ms=args.sleep_ms, **row)),
                  flush=True)
    finally:
        graphs.upload = upload
        initializer.INIT_GRAPHS = saved


if __name__ == "__main__":
    main()
