"""K12's times on the card, for the checkout it is run from.

    PYTHONPATH=$PWD python tests/tools/projector_turns.py --label change

Builds the checkout's kernels (ldso_tpu_torch/ops/cuda_kernels), makes the
BA windows of 1 to 8 frames in the main path's 8 slots at 640x480
(tests/torch_kernel_checks.ba_window) and prints one JSON line: K12's
device ms per launch at the full window (20 launches in one CUDA graph,
chip_smoke._graph_device_ms), its single-call ms through the wrapper (CUDA
events, chip_smoke._median_event_ms), the 8 windows in one launch and as 8
single launches (device ms, each in a graph), the sweeps and rotations of
the full window, and the card's name and power limit. Both helpers and the
windows come from the checkout's own chip_smoke.py and tests/, so the
script times a parent commit too: unpack it (`git archive`), and run this
file with the parent as the current directory and on PYTHONPATH. Compare
two versions only in one call, in turns (parent, change, change, parent).

With --stamps it also builds a copy of the checkout's csrc/ba_projector.cu
with clock64() stamps (thread 0 of window 0, after each block-wide
barrier: the load, the Gram matrix, the Jacobi and the gate, U', P) into
build/projector_stamps/ and prints the SM cycles of each step at the full
window, with the SM clock. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


STEPS = ("load", "gram", "jacobi_and_gate", "u_prime", "p")


def stamped_source(src: str) -> str:
    """ba_projector.cu with a clock64() stamp at its start, after the
    barriers before steps 2, 3, 4b and 5, and at its end, and a C function
    that copies them out."""
    src = src.replace("namespace {\n", "namespace {\n__device__ long long "
                      "g_stamps[8];\n", 1)
    start = "  const float* src = Nn + static_cast<size_t>(s) * n * k;\n"
    stamp = "  if (tid == 0 && s == 0) g_stamps[{}] = clock64();\n"
    src = src.replace(start, start + stamp.format(0), 1)
    for i, step in enumerate(("2", "3", "4b", "5")):
        mark = f"  __syncthreads();\n\n  // {step}."
        if mark not in src:
            raise RuntimeError(f"no barrier before step {step}")
        src = src.replace(mark, "  __syncthreads();\n" + stamp.format(i + 1)
                          + f"\n  // {step}.", 1)
    end = "\n}\n\n}  // namespace"
    src = src.replace(end, "\n  __syncthreads();\n" + stamp.format(5)
                      + "}\n\n}  // namespace", 1)
    return src.replace('extern "C" {\n', 'extern "C" {\n\nint '
                       'ldso_projector_stamps(long long* h) {\n  return '
                       'static_cast<int>(cudaMemcpyFromSymbol(h, g_stamps, '
                       '6 * sizeof(long long)));\n}\n', 1)


def stamps(root, Nn, delta):
    """SM cycles of each of K12's steps on one window (STEPS)."""
    import ctypes
    import torch
    from ldso_tpu_torch.ops import cuda_kernels
    out_dir = os.path.join(root, "build", "projector_stamps")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(root, "ldso_tpu_torch", "csrc",
                           "ba_projector.cu")) as f:
        src = stamped_source(f.read())
    cu, lib = (os.path.join(out_dir, f"stamped.{e}") for e in ("cu", "so"))
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([cuda_kernels._nvcc(), *cuda_kernels.NVCC_FLAGS,
                    "-shared", "-o", lib, cu], check=True)
    k = ctypes.CDLL(lib)
    k.ldso_projector_stamps.argtypes = [ctypes.c_void_p]
    k.ldso_ba_projector.argtypes = ([ctypes.c_void_p] * 3
                                    + [ctypes.c_int] * 3
                                    + [ctypes.c_float, ctypes.c_void_p])
    out = torch.empty(Nn.shape[0], Nn.shape[0], device="cuda")
    h = (ctypes.c_longlong * 6)()
    for _ in range(3):                    # the last of three launches
        k.ldso_ba_projector(Nn.data_ptr(), out.data_ptr(), None, 1,
                            Nn.shape[0], Nn.shape[1], delta,
                            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        k.ldso_projector_stamps(ctypes.addressof(h))
    return {name: h[i + 1] - h[i] for i, name in enumerate(STEPS)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--stamps", action="store_true",
                    help="also the SM cycles of each step (this checkout's "
                         "source)")
    args = ap.parse_args()
    root = os.getcwd()
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch
    import chip_smoke as cs
    import torch_kernel_checks as kc
    from ldso_tpu_torch.backend import ba_device
    from ldso_tpu_torch.ops import cuda_kernels
    if not torch.cuda.is_available():
        print("projector_turns: needs a CUDA card", file=sys.stderr)
        return 1
    cuda_kernels.build()
    bases = []
    for nf in range(1, 9):
        W, _, _, _, cfg, _ = kc.ba_window(nf, 8, n_pts=64, w=640, h=480,
                                          seed=nf, device="cuda")
        bases.append(ba_device.orth_basis(W))
    delta = cfg.solver_mode_delta
    full = bases[-1]
    stack = torch.stack(bases)
    _, work = cuda_kernels.projector_launch(full[None], delta)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True)
    cycles = stamps(root, full.contiguous(), delta) if args.stamps else None
    print(json.dumps(dict(
        label=args.label, rows=int(full.shape[0]),
        device_ms=cs._graph_device_ms(
            lambda: cuda_kernels.ba_projector(full, delta)),
        single_call_ms=cs._median_event_ms(
            lambda: cuda_kernels.ba_projector(full, delta)),
        batch8_device_ms=cs._graph_device_ms(
            lambda: cuda_kernels.projector_launch(stack, delta)),
        singles8_device_ms=cs._graph_device_ms(
            lambda: [cuda_kernels.projector_launch(b[None], delta)
                     for b in bases]),
        sweeps=int(work[0, 0]), rotations=int(work[0, 1]),
        cycles=cycles, gpu=smi.stdout.strip())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
