"""The activation's accept test against the plain version's own spread:
how far from a tie the LM's accept test e2 < e stands on the lanes that
flip when the plain version sums its taps in the other order, and how many
live lanes each margin in float32 ulps would make ties.

    PYTHONPATH=$PWD python tests/tools/activate_accept_ties.py \
        [--width 640 --height 480] [--margins 16 32 64 128 256]

On every case of torch_kernel_checks.activate_cases (the bench scene's
arena, windows of 2, 4 and 8 frames and the planted lanes), on the CPU:
the plain activation against itself under reordered_taps; for each lane
that differs (a flip), the smallest |e2 - e| over its accept tests in
ulps of the larger energy; for each margin, the live lanes whose accept
test lies within it and which activate_ties does not tie otherwise.
Prints one JSON line per case and one with the totals.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import torch_kernel_checks as kc  # noqa: E402


def accept_ulps(parts) -> torch.Tensor:
    """(N,) the smallest |e2 - e| of a lane's accept tests, in float32 ulps
    of the larger energy (inf where the LM made none)."""
    best = torch.full_like(parts["live"], float("inf"), dtype=torch.float32)
    for it in parts.get("lm", ()):
        a, b = it["e2"], it["e"]
        scale = torch.maximum(torch.abs(a), torch.abs(b))
        d = torch.abs(a - b) / (kc._EPS32 * scale)
        tested = parts["to_opt"] & it["upd"]
        best = torch.minimum(best, torch.where(tested, d,
                                               torch.full_like(d, 1e30)))
    return best


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--margins", type=float, nargs="+",
                    default=[16.0, 32.0, 64.0, 128.0, 256.0])
    args = ap.parse_args()
    from ldso_tpu_torch.frontend import immature
    scene = kc.activate_scene(args.width, args.height, "cpu")
    calib = scene["calib"]
    total = dict(live=0, flips=[], margin_lanes={m: 0 for m in args.margins})
    for name, inputs in kc.activate_cases(scene).items():
        cfg = inputs[13]
        plain, parts = kc.plain_activate(inputs, calib)
        with kc.reordered_taps():
            other = immature.activate_arena_ref(*inputs[:13], calib, cfg)
        # the lanes that differ beyond activate_err's tolerances
        differ = torch.zeros_like(parts["live"])
        for k, (g, w) in enumerate(zip(other, plain)):
            differ |= (kc._differs(g, w, kc.ACT_RTOL, kc.ACT_ATOL) if k == 2
                       else g != w)
        differ &= parts["live"]
        best = accept_ulps(parts)
        base = kc.activate_ties(parts, cfg, accept_ulps=kc.TRACE_TIE_ULPS)
        flips = [dict(lane=int(i), accept_ulps=float(best[i]),
                      tied_at_16_ulps=bool(base[i]))
                 for i in torch.nonzero(differ).flatten()]
        lanes = {m: int((parts["live"] & ~base & (best <= m)).sum())
                 for m in args.margins}
        live = int(parts["live"].sum())
        print(json.dumps(dict(case=name, live=live, flips=flips,
                              margin_lanes=lanes)), flush=True)
        total["live"] += live
        total["flips"] += [dict(case=name, **f) for f in flips]
        for m in args.margins:
            total["margin_lanes"][m] += lanes[m]
    print(json.dumps(dict(total=True, **total)), flush=True)


if __name__ == "__main__":
    main()
