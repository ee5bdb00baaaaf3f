"""K2's pyramid and rectify against an earlier design, in turns, on the
card.

    PYTHONPATH=$PWD python tests/tools/k2_turns.py \\
        --parent-source build/parent/ldso_tpu_torch/csrc/preprocess.cu \\
        [--rounds 2] [--out build/k2_turns.json]

Builds the other design's `preprocess.cu` (with the flags this package
builds it with) into its own library under build/, then times, at the
main path's shapes, the parent's pyramid (640x480 uint8, 4 levels; the
first design took its level count alone, one 32x32 tile a block) against
this package's, and the parent's rectify against this package's (640x480
uint8 raw with a
response table and the vignette onto 600x440): device time per launch
from 20 launches in one CUDA graph (chip_smoke._graph_device_ms), in
turns parent, change, change, parent for `--rounds` rounds. Every
design's output is held bitwise against the plain version first. Also
the 6-level float32 pyramid, and two floors of the card: one PyTorch
launch that writes the pyramid's bytes (a fill) and one that reads the
rectify's maps and writes its image (an add). Prints one JSON line (the card's name and
power limit beside the times) and writes it to `--out`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))



def build_parent(source: str) -> ctypes.CDLL:
    """The other design's preprocess.cu as a library of its own."""
    from ldso_tpu_torch.ops import cuda_kernels as ck
    out = os.path.join(ROOT, "build", "k2_parent")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libk2_parent.so")
    subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "--fmad=false", "-shared",
                    "-o", lib, source], check=True)
    dll = ctypes.CDLL(lib)
    dll.ldso_pyramid.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.c_void_p]
    dll.ldso_pyramid.restype = ctypes.c_int
    dll.ldso_rectify.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_void_p]
    dll.ldso_rectify.restype = ctypes.c_int
    return dll


def parent_pyramid(dll, img, levels, b):
    """The first design's launch (ints: levels, dtype, then H, W a
    level) on the current stream."""
    import torch
    from ldso_tpu_torch.ops import cuda_kernels as ck
    from ldso_tpu_torch.ops.preprocess import FramePyramid
    shapes = ck.pyramid_shapes(*img.shape, levels)
    dIs = [torch.empty((h, w, 3), dtype=torch.float32, device=img.device)
           for h, w in shapes]
    ags = [torch.empty((h, w), dtype=torch.float32, device=img.device)
           for h, w in shapes]
    ptrs = [img.data_ptr(), 0 if b is None else b.data_ptr()]
    for d, g in zip(dIs, ags):
        ptrs += [d.data_ptr(), g.data_ptr()]
    ints = [levels, ck.PYRAMID_DTYPES[img.dtype]]
    for h, w in shapes:
        ints += [h, w]
    ck._launch("parent pyramid", dll.ldso_pyramid, ptrs, ints, None,
               img.device)
    return FramePyramid(dI=tuple(dIs), abs_grad=tuple(ags))


def parent_rectify(dll, raw, G, vig, rx, ry):
    import torch
    from ldso_tpu_torch.ops import cuda_kernels as ck
    h_org, w_org = raw.shape
    out = torch.empty(rx.shape, dtype=torch.float32, device=raw.device)
    ptrs = [raw.data_ptr(), 0 if G is None else G.data_ptr(),
            0 if vig is None else vig.data_ptr(), rx.data_ptr(),
            ry.data_ptr(), out.data_ptr()]
    ints = [ck.RECTIFY_DTYPES[raw.dtype], 0 if G is None else G.numel(),
            h_org, w_org, rx.numel()]
    floats = [float(torch.tensor(w_org - 1.001, dtype=torch.float32)),
              float(torch.tensor(h_org - 1.001, dtype=torch.float32))]
    ck._launch("parent rectify", dll.ldso_rectify, ptrs, ints, floats,
               raw.device)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default="build/k2_turns.json")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(1, os.path.join(ROOT, "tests"))
    import torch
    if not torch.cuda.is_available():
        print("k2_turns: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import torch_kernel_checks as kc
    from ldso_tpu_torch.ops import cuda_kernels as ck
    from ldso_tpu_torch.ops import preprocess
    t0 = time.perf_counter()
    ck.build()
    dll = build_parent(os.path.abspath(args.parent_source))
    pyr = kc.pyramid_cases("cuda")
    rect = kc.rectify_cases("cuda")

    # every design bitwise the plain version on every case first
    faults = []
    for name, (img, L, b) in pyr.items():
        want = preprocess.make_pyramid_ref(img, L, b)
        if not kc.pyramid_bitwise(parent_pyramid(dll, img, L, b), want):
            faults.append(f"parent pyramid {name}")
        if not kc.pyramid_bitwise(ck.pyramid(img, L, b), want):
            faults.append(f"pyramid {name}")
    for name, (raw, G, vig, rx, ry) in rect.items():
        want = preprocess.rectify_ref(raw, G, vig, rx, ry)
        if not bool(kc.bits(parent_rectify(dll, raw, G, vig, rx, ry),
                            want).all()):
            faults.append(f"parent rectify {name}")
        if not bool(kc.bits(ck.rectify(raw, G, vig, rx, ry), want).all()):
            faults.append(f"rectify {name}")
    torch.cuda.synchronize()

    img, L, _ = pyr["uint8 640x480"]
    img6, L6, b6 = pyr["6 levels"]
    raw, G, vig, rx, ry = rect["uint8 G vignette"]
    runs = {
        "pyramid parent": lambda: parent_pyramid(dll, img, L, None),
        "pyramid 6 levels parent": lambda: parent_pyramid(dll, img6, L6, b6),
        "pyramid 6 levels": lambda: ck.pyramid(img6, L6, b6),
        "rectify parent": lambda: parent_rectify(dll, raw, G, vig, rx, ry),
    }
    runs["rectify"] = lambda: ck.rectify(raw, G, vig, rx, ry)
    runs["pyramid"] = lambda: ck.pyramid(img, L, None)
    # floors of this card for the two kernels' bytes, one PyTorch launch
    # each: a fill of the pyramid's 16 bytes a pixel of every level, and an
    # add of the two maps into an image of the rectify's size
    fill = torch.empty(sum(h * w for h, w in ck.pyramid_shapes(
        *img.shape, L)) * 4, dtype=torch.float32, device="cuda")
    runs["floor: fill of the pyramid's bytes"] = lambda: fill.zero_()
    rsum = torch.empty_like(rx)
    runs["floor: add of the rectify's maps"] = (
        lambda: torch.add(rx, ry, out=rsum))
    parents = [k for k in runs if "parent" in k]
    changes = [k for k in runs if "parent" not in k]
    times = {k: [] for k in runs}
    for _ in range(args.rounds):
        for group in (parents, changes, changes, parents):
            for k in group:
                times[k].append(1e3 * cs._graph_device_ms(runs[k]))
    bound_pyr = 1e3 * cs.pyramid_bound_ms(*img.shape, L, img.numel())[0]
    bound_rect = 1e3 * cs.rectify_bound_ms(raw, G, vig, rx)
    ptx = ck.ptxas_report("preprocess.cu")
    res = dict(
        gpu=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip(),
        faults=faults, device_us=times,
        median_us={k: sorted(v)[len(v) // 2] for k, v in times.items()},
        bound_us=dict(pyramid=bound_pyr, rectify=bound_rect),
        plan=ck.pyramid_plan(*img.shape, L),
        ptxas=dict(pyramid=cs.ptxas_facts(
            ptx, f"pyramid_kernelILi{L}EE"),
            rectify=cs.ptxas_facts(ptx, "rectify_kernel")),
        seconds=time.perf_counter() - t0)
    res["share_of_bound"] = {
        k: (bound_rect if k.startswith("rectify") else bound_pyr) / v
        for k, v in res["median_us"].items()
        if "6 levels" not in k and "floor" not in k}
    line = json.dumps(res)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
