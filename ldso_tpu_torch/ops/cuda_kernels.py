"""Hand-written CUDA kernels for Hopper and their ctypes wrappers.

Counterpart of ldso_tpu/ops/pallas_kernels.py. Each kernel's source lives
in ldso_tpu_torch/csrc/, is compiled with nvcc for sm_90a at first use into
build/ldso_tpu_torch/<hash of the sources>/ (so a fresh checkout builds it
on its own), and is bound through a plain C interface with ctypes.

Where a wrapper runs:
  * a CPU tensor takes the kernel's plain PyTorch version;
  * a CUDA tensor launches the kernel on the current stream, or raises.
Nothing here falls back from the card to the plain version or to the CPU.

Every wrapper counts its kernel launches in `LAUNCHES` (a plain dict of
ints), so a run can show that its main path went through the kernels. A
launch recorded into a CUDA graph runs at each replay, not at the capture:
while a thread captures (`recording_launches`), its counts go to the
capture's tally, and the graph adds the tally to `LAUNCHES` at every replay
(frontend/track_graph.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Sequence, Tuple

import torch

from ldso_tpu_torch.config import (SCALE_A, SCALE_B, SCALE_XI_ROT,
                                   SCALE_XI_TRANS)
from ldso_tpu_torch.frontend import affine
from ldso_tpu_torch.ops.distance_map import MAX_K, distance_transform_ref

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_SOURCES = ("distance_map.cu", "tracker_trip.cu")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "ldso_tpu_torch")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# the dynamic shared memory a block may use without opting in to more
SMEM_LIMIT = 48 * 1024

LAUNCHES = {"distance_transform": 0, "tracker_trip": 0}

_lock = threading.Lock()
_count_lock = threading.Lock()
_recording = threading.local()     # .tally: the capture this thread records
_lib = None
_n_sm = {}          # device index -> streaming multiprocessors


def reset_launch_counts():
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    """One launch of `name`'s kernel by its wrapper: into LAUNCHES, or into
    the tally of the graph capture this thread is recording."""
    tally = getattr(_recording, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1
        return
    with _count_lock:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def recording_launches():
    """While inside, this thread's kernel launches are recorded into a CUDA
    graph, not run: yields the tally of them ({name: launches}), which the
    graph adds to LAUNCHES at each replay (`add_launches`). Other threads
    count as usual."""
    outer = getattr(_recording, "tally", None)
    tally: Dict[str, int] = {}
    _recording.tally = tally
    try:
        yield tally
    finally:
        _recording.tally = outer


def add_launches(tally: Dict[str, int]) -> None:
    """A replay of a captured graph: its recorded launches run again."""
    with _count_lock:
        for name, n in tally.items():
            LAUNCHES[name] += n


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of ldso_tpu_torch "
                       "are built from source on the machine with the card")


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_ROOT, _source_hash(), "libldso_tpu_torch.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels (if this source hash has no library yet) and
    return the shared library's path: one nvcc per source, all started
    together, then one link."""
    path = library_path()
    if os.path.exists(path):
        return path
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    temps, jobs = [], []
    try:
        for name in _SOURCES:
            fd, obj = tempfile.mkstemp(suffix=".o", dir=out_dir)
            os.close(fd)
            temps.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                   os.path.join(_CSRC, name)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            jobs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for name, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{err}")
            elif verbose and err:
                print(f"{name}:\n{err.strip()}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        temps.append(tmp)
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                               *temps[:-1]], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, path)   # atomic: concurrent builds race harmlessly
    finally:
        for _, proc in jobs:
            proc.wait()
        for f in temps:
            if os.path.exists(f):
                os.unlink(f)
    return path


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.ldso_distance_transform.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.ldso_distance_transform.restype = ctypes.c_int
            lib.ldso_tracker_trip.argtypes = (
                [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                + [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                   ctypes.c_void_p])
            lib.ldso_tracker_trip.restype = ctypes.c_int
            _lib = lib
        return _lib


def distance_plan(H: int, W: int, max_k: int, n_sm: int):
    """(band rows, dynamic shared memory bytes) of K1's launch on an (H, W)
    map. The band starts as the fewest rows that keep the blocks, one per
    band, within one per SM: a block's work is its band plus max_k - 1
    halo rows on each side. Its state is two bit buffers of those rows (at
    most H, the second with two spare words) and the band's words of max_k
    sets. The band halves until that fits SMEM_LIMIT; ValueError when a
    one-row band does not."""
    band = -(-H // n_sm)
    nw = (W + 31) // 32
    while True:
        smem = 4 * (nw * (2 * min(H, band + 2 * (max_k - 1)) + max_k * band)
                    + 2)
        if smem <= SMEM_LIMIT:
            return band, smem
        if band == 1:
            raise ValueError(
                f"distance_transform: a {W}-wide map at max_k={max_k} needs "
                f"{smem} bytes of shared memory for a one-row band, more "
                f"than the {SMEM_LIMIT} a block gets without opting in")
        band //= 2


def distance_transform(occupied: torch.Tensor,
                       max_k: int = MAX_K) -> torch.Tensor:
    """Chamfer distance map of an (H, W) bool/uint8 occupancy map (see
    ops.distance_map.distance_transform_ref for the function).

    CPU tensor: the plain version. CUDA tensor: the hand-written kernel of
    csrc/distance_map.cu, one block per band of output rows as
    `distance_plan` chooses."""
    if occupied.device.type == "cpu":
        return distance_transform_ref(occupied, max_k)
    if occupied.device.type != "cuda":
        raise ValueError(f"distance_transform: unsupported device "
                         f"{occupied.device}")
    if occupied.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"distance_transform: occupancy must be bool or "
                         f"uint8, got {occupied.dtype}")
    if occupied.dim() != 2 or occupied.numel() == 0:
        raise ValueError(f"distance_transform: expected a non-empty (H, W) "
                         f"map, got {tuple(occupied.shape)}")
    if not occupied.is_contiguous():
        raise ValueError("distance_transform: occupancy must be contiguous")
    if not 1 <= max_k <= 255:
        raise ValueError(f"distance_transform: max_k must be in [1, 255], "
                         f"got {max_k}")
    H, W = occupied.shape
    dev = occupied.device
    if dev.index not in _n_sm:
        _n_sm[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    band, smem = distance_plan(H, W, max_k, _n_sm[dev.index])
    lib = _load()
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ldso_distance_transform(
            occupied.data_ptr(), out.data_ptr(), H, W, int(max_k), band,
            smem, stream)
    if err != 0:
        raise RuntimeError(f"distance_transform kernel launch failed: CUDA "
                           f"error {err}")
    _count("distance_transform")
    return out


# ---------------------------------------------------------------------------
# K3: one trip of the coarse tracker (csrc/tracker_trip.cu)
# ---------------------------------------------------------------------------

TRIP_CHUNK = 512     # points per first-pass block (kChunk in the source)
TRIP_SUMS = 50       # sums per partial slot (kAcc)
_TRIP_SCALE = ((SCALE_XI_ROT,) * 3 + (SCALE_XI_TRANS,) * 3
               + (SCALE_A, SCALE_B))


def trip_params(calib, lvl: int, huber_th: float) -> Tuple[float, ...]:
    """The kernel's launch arguments for pyramid level `lvl`: fx, fy, cx,
    cy, K^-1 (row-major), the Huber threshold and the 8 parameter scales."""
    return tuple(float(v) for v in (
        calib.fx[lvl], calib.fy[lvl], calib.cx[lvl], calib.cy[lvl],
        *calib.Ki(lvl).reshape(-1).tolist(), huber_th, *_TRIP_SCALE))


def tracker_trip(ref, pyr_new, lvl: int, T, aff_new, new_exposure, cutoff,
                 calib, cfg, compute_flow: bool = True):
    """One trip of the coarse tracker at level `lvl` for a batch of poses:
    calcRes then calcGSSSE (frontend/tracker.tracker_trip_ref is the
    function). T (B,4,4), aff_new (B,2), cutoff (B,). Returns (stats (B,6)
    = [E, numTerms, flowT, 0, flowRT, satRatio], H (B,8,8), b (B,8)).

    CPU tensors: the plain version. CUDA tensors: the hand-written kernel
    of csrc/tracker_trip.cu on the current stream, through the operator
    `ldso_tpu_torch::tracker_trip`, whose vmap rule launches it once with
    the vmapped axis as its sequence axis. It reads nothing back and
    allocates with torch.empty only, so a CUDA graph can capture it."""
    if T.device.type == "cpu":
        from ldso_tpu_torch.frontend.tracker import tracker_trip_ref
        return tracker_trip_ref(ref, pyr_new, lvl, T, aff_new, new_exposure,
                                cutoff, calib, cfg, compute_flow)
    if T.device.type != "cuda":
        raise ValueError(f"tracker_trip: unsupported device {T.device}")
    rel = affine.from_to(ref.ref_exposure, new_exposure, ref.ref_aff, aff_new)
    return torch.ops.ldso_tpu_torch.tracker_trip(
        ref.points[lvl], ref.valid[lvl], pyr_new.dI[lvl], T, rel, cutoff,
        ref.ref_aff, trip_params(calib, lvl, cfg.huber_th), compute_flow)


def _trip_launch(points, valid, dI, T, rel, cutoff, ref_aff,
                 params: Sequence[float], compute_flow: bool):
    """Launch K3 on S sequences: points (S,N,4), valid (S,N) bool, dI
    (S,h,w,3), T (S,B,4,4), rel (S,B,2), cutoff (S,B), ref_aff (S,2).
    Returns (stats (S,B,6), H (S,B,8,8), b (S,B,8))."""
    S, N = points.shape[0], points.shape[1]
    B = T.shape[1]
    h, w = dI.shape[1], dI.shape[2]
    want = (("points", points, (S, N, 4), torch.float32),
            ("valid", valid, (S, N), torch.bool),
            ("dI", dI, (S, h, w, 3), torch.float32),
            ("T", T, (S, B, 4, 4), torch.float32),
            ("rel", rel, (S, B, 2), torch.float32),
            ("cutoff", cutoff, (S, B), torch.float32),
            ("ref_aff", ref_aff, (S, 2), torch.float32))
    dev = points.device
    for name, x, shape, dtype in want:
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"tracker_trip: {name} on {x.device}; every "
                             f"input must be on one CUDA device")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"tracker_trip: {name} is {tuple(x.shape)} "
                             f"{x.dtype}, expected {shape} {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"tracker_trip: {name} must be contiguous")
    if N < 1 or min(h, w) < 7 or len(params) != 22:
        raise ValueError(f"tracker_trip: {N} points on a {h}x{w} level with "
                         f"{len(params)} parameters (need >= 1 point, a "
                         f"level of at least 7x7 and 22 parameters)")
    lib = _load()
    n_chunks = -(-N // TRIP_CHUNK)
    f32 = dict(dtype=torch.float32, device=dev)
    partial = torch.empty(S * B * n_chunks * TRIP_SUMS, **f32)
    stats = torch.empty((S, B, 6), **f32)
    H = torch.empty((S, B, 8, 8), **f32)
    b = torch.empty((S, B, 8), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ldso_tracker_trip(
            points.data_ptr(), valid.data_ptr(), dI.data_ptr(), T.data_ptr(),
            rel.data_ptr(), cutoff.data_ptr(), ref_aff.data_ptr(),
            partial.data_ptr(), stats.data_ptr(), H.data_ptr(), b.data_ptr(),
            S, B, N, w, h, n_chunks, (ctypes.c_float * 22)(*params),
            int(bool(compute_flow)), stream)
    if err != 0:
        raise RuntimeError(f"tracker_trip kernel launch failed: CUDA error "
                           f"{err}")
    _count("tracker_trip")
    return stats, H, b


@torch.library.custom_op("ldso_tpu_torch::tracker_trip", mutates_args=())
def _trip_op(points: torch.Tensor, valid: torch.Tensor, dI: torch.Tensor,
             T: torch.Tensor, rel: torch.Tensor, cutoff: torch.Tensor,
             ref_aff: torch.Tensor, params: Sequence[float],
             compute_flow: bool
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 on one sequence (points (N,4), T (B,4,4), ...): a sequence axis
    of 1. An operator so that vmap reaches the kernel through its rule."""
    stats, H, b = _trip_launch(
        points[None], valid[None], dI[None], T[None], rel[None],
        cutoff[None], ref_aff[None], params, compute_flow)
    return stats[0], H[0], b[0]


def _trip_vmap(info, in_dims, points, valid, dI, T, rel, cutoff, ref_aff,
               params, compute_flow):
    """vmap over K3 (parallel/replay.make_batched_tracker): the vmapped
    axis becomes the kernel's sequence axis, one launch for all of it. An
    input without that axis is repeated along it."""
    S = info.batch_size

    def lead(x, d):
        x = x.expand((S,) + tuple(x.shape)) if d is None else x.movedim(d, 0)
        return x.contiguous()
    args = [lead(x, d) for x, d in
            zip((points, valid, dI, T, rel, cutoff, ref_aff), in_dims[:7])]
    return _trip_launch(*args, params, compute_flow), (0, 0, 0)


torch.library.register_vmap("ldso_tpu_torch::tracker_trip", _trip_vmap)
