"""chip_smoke.py 7e's batch of 8 device LMs against the orders of a single
call and against float64: does a member of the vmapped batch part from its
single replay by more than the single call does when its points come in
another order, and is it farther from its window's float64 result than
the single replay is?

    python3 tests/tools/batched_ba_orders.py [--perms 6] \
        [--package-root DIR]

On the card: phase 3 of chip_smoke.py (64 bench frames, strict), its last
8 BA inputs in one vmapped graph as 7e runs them, and per member the
differences (torch_kernel_checks.ba_diffs: pose, idepth, stats relative)
of the batch, of the single replay with its points reversed (7e's
yardstick before) and of `--perms` random point orders, each against the
single replay, with the stat that parts most; and the batch's, the single
replay's and the reversed replay's distances from the float64 result
(torch_kernel_checks.ba_f64, 7e's yardstick now). `--package-root` puts another copy
of ldso_tpu_torch first on the path (for instance one with another
rounding of the activation). Prints one JSON line per member and 7e's
verdict on the batch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--perms", type=int, default=6)
    ap.add_argument("--package-root", default=None)
    args = ap.parse_args()
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    sys.path.insert(1 if args.package_root else 0, ROOT)
    import torch
    import chip_smoke as cs
    import ldso_tpu_torch
    from ldso_tpu_torch.backend import ba_device
    from ldso_tpu_torch.backend import energy_functional as efm
    from ldso_tpu_torch.backend.window import Window
    from ldso_tpu_torch.utils.graphs import Programs
    t0 = time.perf_counter()
    print(f"package {os.path.dirname(ldso_tpu_torch.__file__)}", flush=True)
    kc = cs._kernel_checks()
    with cs.ba_times(), cs.recorded_ba() as recs:
        _, _, _, _, strict, _ = cs.phase_main_path()
    S = cs.BATCH_BA_WINDOWS
    calls = cs._ba_calls(recs)[-S:]
    cfg, w, h, trips = calls[-1][5:]
    stacked = tuple(torch.stack([c[0][i] for c in calls])
                    for i in range(len(Window._fields))) + tuple(
        torch.stack([c[k] for c in calls]) for k in (1, 2, 3, 4))

    def program(*xs):
        W, stats = torch.func.vmap(
            lambda W, d, H, b, n: ba_device.optimize_device(
                W, d, H, b, n, cfg, w, h, trips))(Window(*xs[:-4]), *xs[-4:])
        return tuple(W) + (stats,)
    out = Programs().replay(("vmap", ba_device.graph_key(cfg), w, h, trips),
                            program, stacked)
    batched = [(Window(*(x[s] for x in out[:-1])), out[-1][s])
               for s in range(S)]

    def single(W, *rest):
        return efm.replay_ba(W, *rest, cfg, w, h, trips)

    def permuted(W, *rest, seed):
        P = W.pt_valid.shape[0]
        perm = torch.randperm(P, generator=torch.Generator().manual_seed(
            seed)).to(W.pt_valid.device)

        def take(W, idx):
            return Window(*(x[idx] if x.dim() and x.shape[0] == P else x
                            for x in W))
        Wp, stats = single(take(W, perm), *rest)
        return take(Wp, torch.argsort(perm)), stats
    def plain(W, *rest):
        return ba_device.optimize_device(W, *rest, cfg, w, h, trips)
    singles = [single(*c[:5]) for c in calls]
    rev = [kc.reordered_ba(single, *c[:5]) for c in calls]
    reference = [kc.ba_f64(plain, *c[:5]) for c in calls]
    readings = kc.ba_batch_readings(batched, singles, reference)
    for i in range(S):
        perms = [kc.ba_diffs(permuted(*calls[i][:5], seed=k), singles[i])
                 for k in range(args.perms)]
        ss, sb = singles[i][1].flatten(), batched[i][1].flatten()
        rel = torch.abs(sb - ss) / torch.abs(ss).clamp(min=1e-6)
        j = int(torch.argmax(rel))
        print(json.dumps(dict(
            member=i, batched=kc.ba_diffs(batched[i], singles[i]),
            reversed=kc.ba_diffs(rev[i], singles[i]),
            batch_f64=readings[i]["batch_f64"],
            single_f64=readings[i]["single_f64"],
            reversed_f64=kc.ba_diffs(kc.window_f64(*rev[i]), reference[i]),
            perms={k: [d[k] for d in perms]
                   for k in ("pose", "idepth", "stats")},
            worst_stat=j, single=float(ss[j]), batch=float(sb[j]),
            reversed_value=float(rev[i][1].flatten()[j]))), flush=True)
    worst, tol, faults = kc.ba_batch_err(batched, singles, reference)
    ratio = {k: max(r["batch_f64"][k] for r in readings)
             / max(max(r["single_f64"][k] for r in readings), 1e-30)
             for k in kc.BA_ORDER_FLOORS}
    print(json.dumps(dict(phase3_keyframes=strict["keyframes"],
                          phase3_ate_mm=strict["ate_mm"], trips=trips,
                          largest_from_f64=worst, tolerance=tol,
                          faults=faults, batch_over_single_f64=ratio,
                          seconds=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
