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
(utils/graphs.py). K3's launches are also counted by mode in
`TRIP_LAUNCHES`, the same way.

The kernels: K1 `distance_transform` (csrc/distance_map.cu), K3
`tracker_trip` and its modes (csrc/tracker_trip.cu), K12 `ba_projector`
(csrc/ba_projector.cu), K4 `trace_arena` (csrc/immature_trace.cu), K5
`activate_arena` (csrc/immature_activate.cu), K6 `ba_linearize`
(csrc/ba_linearize.cu) and K7 `ba_accumulate_top` / `ba_accumulate_sc`
(csrc/ba_accumulate.cu; one count in LAUNCHES["ba_accumulate"] per call,
each call queues its two stages), and K2 `pyramid` and `rectify`
(csrc/preprocess.cu).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
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
from ldso_tpu_torch.ops.distance_map import MAX_K, distance_transform_ref
from ldso_tpu_torch.utils.static import device_const

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_SOURCES = ("distance_map.cu", "tracker_trip.cu", "ba_projector.cu",
            "immature_trace.cu", "immature_activate.cu", "ba_linearize.cu",
            "ba_accumulate.cu", "preprocess.cu")
# flags of one source beside NVCC_FLAGS: K2, K4, K5 and K6 round every
# multiply and add on their own, as their plain versions' separate aten
# operations do (contracting only where they say __fmaf_rn); K7 too, so
# that its order of sums written out in plain PyTorch
# (tests/torch_kernel_checks.acc_emulated) gives its bits
_SOURCE_FLAGS = {"immature_trace.cu": ("--fmad=false",),
                 "immature_activate.cu": ("--fmad=false",),
                 "ba_linearize.cu": ("--fmad=false",),
                 "ba_accumulate.cu": ("--fmad=false",),
                 "preprocess.cu": ("--fmad=false",)}
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "ldso_tpu_torch")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# the dynamic shared memory a block may use without opting in to more
SMEM_LIMIT = 48 * 1024

LAUNCHES = {"distance_transform": 0, "tracker_trip": 0, "ba_projector": 0,
            "trace": 0, "activate": 0, "ba_linearize": 0, "ba_accumulate": 0,
            "pyramid": 0, "rectify": 0}
# K3's launches by mode (TRIP_MODES); each is also one of LAUNCHES's
TRIP_LAUNCHES = {"trip": 0, "cutoff": 0, "lm": 0}

_lock = threading.Lock()
_count_lock = threading.Lock()
_recording = threading.local()     # .tally: the capture this thread records
_lib = None
_n_sm = {}          # device index -> streaming multiprocessors


def reset_launch_counts():
    with _count_lock:
        for counts in (LAUNCHES, TRIP_LAUNCHES):
            for k in counts:
                counts[k] = 0


def _add(key: str, n: int) -> None:
    """n launches under `key`: a kernel's name, or "tracker_trip.<mode>"
    for K3's count by mode."""
    name, _, mode = key.partition(".")
    if mode:
        TRIP_LAUNCHES[mode] += n
    else:
        LAUNCHES[name] += n


def _count(name: str, mode: str = "") -> None:
    """One launch of `name`'s kernel (in `mode`, for K3) by its wrapper:
    into LAUNCHES (and TRIP_LAUNCHES), or into the tally of the graph
    capture this thread is recording."""
    keys = (name, f"{name}.{mode}") if mode else (name,)
    tally = getattr(_recording, "tally", None)
    if tally is not None:
        for key in keys:
            tally[key] = tally.get(key, 0) + 1
        return
    with _count_lock:
        for key in keys:
            _add(key, 1)


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
        for key, n in tally.items():
            _add(key, n)


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
            h.update(" ".join(_SOURCE_FLAGS.get(name, ())).encode())
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
            cmd = [nvcc, *NVCC_FLAGS, *_SOURCE_FLAGS.get(name, ()), "-c",
                   "-o", obj, os.path.join(_CSRC, name)]
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


def ptxas_report(name: str) -> str:
    """nvcc -Xptxas=-v's report (registers, shared memory, spills) of one
    source, e.g. "ba_projector.cu", compiled alone with the build's flags."""
    os.makedirs(BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        proc = subprocess.run(
            [_nvcc(), "-Xptxas=-v", *NVCC_FLAGS, *_SOURCE_FLAGS.get(name, ()),
             "-c", "-o", os.path.join(tmp, "k.o"), os.path.join(_CSRC, name)],
            capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return proc.stderr


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
                [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
                + [ctypes.c_int] * 5
                + [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                   ctypes.c_void_p])
            lib.ldso_tracker_trip.restype = ctypes.c_int
            lib.ldso_ba_projector.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                + [ctypes.c_float, ctypes.c_void_p])
            lib.ldso_ba_projector.restype = ctypes.c_int
            lib.ldso_immature_trace.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
            lib.ldso_immature_trace.restype = ctypes.c_int
            lib.ldso_immature_activate.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
            lib.ldso_immature_activate.restype = ctypes.c_int
            lib.ldso_ba_accumulate_scratch.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_longlong)]
            lib.ldso_ba_accumulate_scratch.restype = ctypes.c_int
            lib.ldso_pyramid_plan.argtypes = [ctypes.c_int] * 3 + [
                ctypes.POINTER(ctypes.c_int)]
            lib.ldso_pyramid_plan.restype = ctypes.c_int
            lib.ldso_pyramid.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.c_void_p]
            lib.ldso_pyramid.restype = ctypes.c_int
            lib.ldso_rectify.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_float),
                                         ctypes.c_void_p]
            lib.ldso_rectify.restype = ctypes.c_int
            for name in ("ldso_ba_linearize", "ldso_ba_accumulate"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_float),
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _on_card(what: str, name: str, t, dtype=None, shape=None, dev=None,
             contiguous: bool = True):
    """One input of a launch: on a CUDA device (`dev` where given), of
    `dtype` and `shape` where given, contiguous unless told otherwise."""
    if t.device.type != "cuda" or (dev is not None and t.device != dev):
        raise ValueError(f"{what}: {name} on {t.device}; every input must "
                         f"be on one CUDA device")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{what}: {name} is {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} is {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def _launch(what: str, fn, ptrs, ints, floats, dev) -> None:
    """fn(ptrs, ints[, floats], stream) on `dev`'s current stream, the C
    interface of every kernel launched here but K1, K3 and K12; `floats`
    None for a kernel that takes none. Raises on a CUDA error."""
    arrays = [(ctypes.c_void_p * len(ptrs))(*ptrs),
              (ctypes.c_int * len(ints))(*ints)]
    if floats is not None:
        arrays.append((ctypes.c_float * max(len(floats), 1))(*floats))
    with torch.cuda.device(dev):
        err = fn(*arrays, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


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
# K3: one trip of the coarse tracker with its LM control
# (csrc/tracker_trip.cu)
# ---------------------------------------------------------------------------

# the kernel's modes: a plain trip, a trip of the cutoff adaptation, an LM
# iteration (frontend/tracker.tracker_trip_ref, cutoff_trip_ref, lm_trip_ref)
TRIP_MODES = ("trip", "cutoff", "lm")
_TRIP_SCALE = ((SCALE_XI_ROT,) * 3 + (SCALE_XI_TRANS,) * 3
               + (SCALE_A, SCALE_B))
_TRIP_PARAMS = 31
# the operators' tensor arguments, in order: those of every mode, then the
# mode's state; and each mode's outputs
_TRIP_COMMON = ("points", "valid", "dI", "T", "aff", "ref_aff",
                "ref_exposure", "new_exposure")
_TRIP_STATE = {"trip": ("cutoff",),
               "cutoff": ("stats", "H", "b", "cutoff_rep", "run"),
               "lm": ("stats", "H", "b", "lam", "done", "cutoff")}
TRIP_OUTPUTS = {"trip": ("stats", "H", "b"),
                "cutoff": ("stats", "H", "b", "cutoff_rep"),
                "lm": ("T", "aff", "stats", "H", "b", "lam", "done")}
# the kernel's pointer slots (Args in the source)
_TRIP_SLOTS = ("points", "valid", "dI", "T", "aff", "ref_aff",
               "ref_exposure", "new_exposure", "cutoff", "stats", "H", "b",
               "scalar", "flag", "out_stats", "out_H", "out_b", "out_scalar",
               "out_T", "out_aff", "out_done")
_TRIP_BOOL = ("valid", "run", "done")
TRIP_OPS = {"trip": "tracker_trip", "cutoff": "cutoff_trip", "lm": "lm_trip"}


@functools.lru_cache(maxsize=None)
def _params(calib, lvl: int, huber_th: float, cutoff_th: float, opt_a: bool,
            opt_b: bool) -> Tuple[float, ...]:
    return tuple(float(v) for v in (
        calib.fx[lvl], calib.fy[lvl], calib.cx[lvl], calib.cy[lvl],
        *calib.Ki(lvl).reshape(-1).tolist(), huber_th, *_TRIP_SCALE,
        cutoff_th, *(1.0,) * 6, float(opt_a), float(opt_b)))


def trip_params(calib, lvl: int, cfg) -> Tuple[float, ...]:
    """The kernel's launch arguments for pyramid level `lvl`: fx, fy, cx,
    cy, K^-1 (row-major), the Huber threshold, the 8 parameter scales,
    coarse_cutoff_th and the 8 flags of the parameters the LM solves for
    (a and b by affine_opt_mode_a/b >= 0, as `_solve_inc`)."""
    return _params(calib, lvl, float(cfg.huber_th),
                   float(cfg.coarse_cutoff_th), cfg.affine_opt_mode_a >= 0,
                   cfg.affine_opt_mode_b >= 0)


def _level(ref, pyr_new, lvl: int, T, aff, new_exposure):
    """The operators' leading arguments for one level."""
    if T.device.type != "cuda":
        raise ValueError(f"tracker trip: unsupported device {T.device}")
    return (ref.points[lvl], ref.valid[lvl], pyr_new.dI[lvl], T, aff,
            ref.ref_aff, ref.ref_exposure, new_exposure)


def tracker_trip(ref, pyr_new, lvl: int, T, aff_new, new_exposure, cutoff,
                 calib, cfg, compute_flow: bool = True):
    """One trip of the coarse tracker at level `lvl` for a batch of poses:
    calcRes then calcGSSSE (frontend/tracker.tracker_trip_ref is the
    function). T (B,4,4), aff_new (B,2), cutoff (B,). Returns (stats (B,6)
    = [E, numTerms, flowT, 0, flowRT, satRatio], H (B,8,8), b (B,8)).

    CPU tensors: the plain version. CUDA tensors: K3 (csrc/tracker_trip.cu)
    in its trip mode on the current stream, through the operator
    `ldso_tpu_torch::tracker_trip`, whose vmap rule launches it once with
    the vmapped axis as its sequence axis. It reads nothing back and
    allocates with torch.empty only, so a CUDA graph can capture it."""
    if T.device.type == "cpu":
        from ldso_tpu_torch.frontend.tracker import tracker_trip_ref
        return tracker_trip_ref(ref, pyr_new, lvl, T, aff_new, new_exposure,
                                cutoff, calib, cfg, compute_flow)
    return torch.ops.ldso_tpu_torch.tracker_trip(
        *_level(ref, pyr_new, lvl, T, aff_new, new_exposure), cutoff,
        trip_params(calib, lvl, cfg), compute_flow)


def cutoff_trip(ref, pyr_new, lvl: int, T, aff, new_exposure, stats, H, b,
                cutoff_rep, run, calib, cfg, compute_flow: bool = True):
    """One trip of `_level_block`'s cutoff adaptation
    (frontend/tracker.cutoff_trip_ref is the function): a member that is
    `run`, more than 60% saturated and under the cutoff limit doubles
    cutoff_rep and takes the trip's stats, H and b at coarse_cutoff_th
    times it; the others keep theirs. Returns (stats, H, b, cutoff_rep).

    CPU tensors: the plain version. CUDA tensors: K3 in its cutoff mode,
    one launch, through the operator `ldso_tpu_torch::cutoff_trip` (a vmap
    rule as tracker_trip's)."""
    if T.device.type == "cpu":
        from ldso_tpu_torch.frontend.tracker import cutoff_trip_ref
        return cutoff_trip_ref(ref, pyr_new, lvl, T, aff, new_exposure, stats,
                               H, b, cutoff_rep, run, calib, cfg,
                               compute_flow)
    return torch.ops.ldso_tpu_torch.cutoff_trip(
        *_level(ref, pyr_new, lvl, T, aff, new_exposure), stats, H, b,
        cutoff_rep, run, trip_params(calib, lvl, cfg), compute_flow)


def lm_trip(ref, pyr_new, lvl: int, T, aff, new_exposure, stats, H, b, lam,
            done, cutoff, calib, cfg, compute_flow: bool = True):
    """One LM iteration of `_level_block` (frontend/tracker.lm_trip_ref is
    the function): for a member that is not done, the damped step from H,
    b and lam, the trip at the new pose and the accept test; a done member
    keeps its state. Returns (T, aff, stats, H, b, lam, done).

    CPU tensors: the plain version. CUDA tensors: K3 in its lm mode, one
    launch, through the operator `ldso_tpu_torch::lm_trip` (a vmap rule as
    tracker_trip's)."""
    if T.device.type == "cpu":
        from ldso_tpu_torch.frontend.tracker import lm_trip_ref
        return lm_trip_ref(ref, pyr_new, lvl, T, aff, new_exposure, stats, H,
                           b, lam, done, cutoff, calib, cfg, compute_flow)
    return torch.ops.ldso_tpu_torch.lm_trip(
        *_level(ref, pyr_new, lvl, T, aff, new_exposure), stats, H, b, lam,
        done, cutoff, trip_params(calib, lvl, cfg), compute_flow)


def _trip_launch(mode: str, x: Dict[str, torch.Tensor],
                 params: Sequence[float], compute_flow: bool):
    """Launch K3 in `mode` on S sequences. x holds the mode's tensors by
    name (_TRIP_COMMON, then _TRIP_STATE[mode]), each with a leading
    sequence axis: points (S,N,4), valid (S,N) bool, dI (S,h,w,3), T
    (S,B,4,4), aff (S,B,2), ref_aff (S,2), ref_exposure and new_exposure
    (S,), cutoff, cutoff_rep, lam (S,B), run, done (S,B) bool, stats
    (S,B,6), H (S,B,8,8), b (S,B,8). Returns TRIP_OUTPUTS[mode], new
    tensors with the same leading axes."""
    S, N = x["points"].shape[0], x["points"].shape[1]
    B = x["T"].shape[1]
    h, w = x["dI"].shape[1], x["dI"].shape[2]
    shapes = dict(points=(S, N, 4), valid=(S, N), dI=(S, h, w, 3),
                  T=(S, B, 4, 4), aff=(S, B, 2), ref_aff=(S, 2),
                  ref_exposure=(S,), new_exposure=(S,), cutoff=(S, B),
                  stats=(S, B, 6), H=(S, B, 8, 8), b=(S, B, 8),
                  cutoff_rep=(S, B), lam=(S, B), run=(S, B), done=(S, B))
    dev = x["points"].device
    for name in _TRIP_COMMON + _TRIP_STATE[mode]:
        t = x[name]
        dtype = torch.bool if name in _TRIP_BOOL else torch.float32
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"tracker trip ({mode}): {name} on {t.device}; "
                             f"every input must be on one CUDA device")
        if tuple(t.shape) != shapes[name] or t.dtype != dtype:
            raise ValueError(f"tracker trip ({mode}): {name} is "
                             f"{tuple(t.shape)} {t.dtype}, expected "
                             f"{shapes[name]} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"tracker trip ({mode}): {name} must be "
                             f"contiguous")
    if N < 1 or min(h, w) < 7 or len(params) != _TRIP_PARAMS:
        raise ValueError(f"tracker trip: {N} points on a {h}x{w} level with "
                         f"{len(params)} parameters (need >= 1 point, a "
                         f"level of at least 7x7 and {_TRIP_PARAMS} "
                         f"parameters)")
    if x["points"].data_ptr() % 16:
        raise ValueError("tracker trip: points must be 16-byte aligned")
    lib = _load()
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(stats=torch.empty((S, B, 6), **f32),
               H=torch.empty((S, B, 8, 8), **f32),
               b=torch.empty((S, B, 8), **f32))
    if mode == "cutoff":
        out["cutoff_rep"] = torch.empty((S, B), **f32)
    elif mode == "lm":
        out.update(T=torch.empty((S, B, 4, 4), **f32),
                   aff=torch.empty((S, B, 2), **f32),
                   lam=torch.empty((S, B), **f32),
                   done=torch.empty((S, B), dtype=torch.bool, device=dev))
    slot = dict(x)
    slot["scalar"] = x.get("cutoff_rep", x.get("lam"))
    slot["flag"] = x.get("run", x.get("done"))
    for name, t in out.items():
        key = {"cutoff_rep": "scalar", "lam": "scalar"}.get(name, name)
        slot["out_" + key] = t
    ptrs = (ctypes.c_void_p * len(_TRIP_SLOTS))(
        *(slot[k].data_ptr() if slot.get(k) is not None else None
          for k in _TRIP_SLOTS))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ldso_tracker_trip(
            TRIP_MODES.index(mode), ptrs, S, B, N, w, h,
            (ctypes.c_float * _TRIP_PARAMS)(*params), int(bool(compute_flow)),
            stream)
    if err != 0:
        raise RuntimeError(f"tracker trip ({mode}) kernel launch failed: "
                           f"CUDA error {err}")
    _count("tracker_trip", mode)
    return tuple(out[name] for name in TRIP_OUTPUTS[mode])


def _one_sequence(mode: str, tensors, params, compute_flow):
    """An operator's call on one sequence: a sequence axis of 1."""
    names = _TRIP_COMMON + _TRIP_STATE[mode]
    x = {n: t.contiguous()[None] for n, t in zip(names, tensors)}
    return tuple(o[0] for o in _trip_launch(mode, x, params, compute_flow))


def _vmap_rule(mode: str):
    """vmap over a K3 operator (parallel/replay.make_batched_tracker): the
    vmapped axis becomes the kernel's sequence axis, one launch for all of
    it. An input without that axis is repeated along it."""
    names = _TRIP_COMMON + _TRIP_STATE[mode]

    def rule(info, in_dims, *args):
        S = info.batch_size
        x = {}
        for name, t, d in zip(names, args, in_dims):
            t = (t.expand((S,) + tuple(t.shape)) if d is None
                 else t.movedim(d, 0))
            x[name] = t.contiguous()
        params, compute_flow = args[len(names):]
        out = _trip_launch(mode, x, params, compute_flow)
        return out, (0,) * len(out)
    return rule


_T = torch.Tensor


@torch.library.custom_op("ldso_tpu_torch::tracker_trip", mutates_args=())
def _trip_op(points: _T, valid: _T, dI: _T, T: _T, aff: _T, ref_aff: _T,
             ref_exposure: _T, new_exposure: _T, cutoff: _T,
             params: Sequence[float], compute_flow: bool
             ) -> Tuple[_T, _T, _T]:
    """K3's trip mode on one sequence (points (N,4), T (B,4,4), ...). An
    operator so that vmap reaches the kernel through its rule."""
    return _one_sequence("trip", (points, valid, dI, T, aff, ref_aff,
                                  ref_exposure, new_exposure, cutoff),
                         params, compute_flow)


@torch.library.custom_op("ldso_tpu_torch::cutoff_trip", mutates_args=())
def _cutoff_op(points: _T, valid: _T, dI: _T, T: _T, aff: _T, ref_aff: _T,
               ref_exposure: _T, new_exposure: _T, stats: _T, H: _T, b: _T,
               cutoff_rep: _T, run: _T, params: Sequence[float],
               compute_flow: bool) -> Tuple[_T, _T, _T, _T]:
    """K3's cutoff mode on one sequence."""
    return _one_sequence("cutoff", (points, valid, dI, T, aff, ref_aff,
                                    ref_exposure, new_exposure, stats, H, b,
                                    cutoff_rep, run), params, compute_flow)


@torch.library.custom_op("ldso_tpu_torch::lm_trip", mutates_args=())
def _lm_op(points: _T, valid: _T, dI: _T, T: _T, aff: _T, ref_aff: _T,
           ref_exposure: _T, new_exposure: _T, stats: _T, H: _T, b: _T,
           lam: _T, done: _T, cutoff: _T, params: Sequence[float],
           compute_flow: bool) -> Tuple[_T, _T, _T, _T, _T, _T, _T]:
    """K3's lm mode on one sequence."""
    return _one_sequence("lm", (points, valid, dI, T, aff, ref_aff,
                                ref_exposure, new_exposure, stats, H, b, lam,
                                done, cutoff), params, compute_flow)


for _mode, _name in TRIP_OPS.items():
    torch.library.register_vmap(f"ldso_tpu_torch::{_name}", _vmap_rule(_mode))


# ---------------------------------------------------------------------------
# K12: the nullspace projector of the windowed BA (csrc/ba_projector.cu)
# ---------------------------------------------------------------------------

PROJECTOR_MAX_ROWS = 256
PROJECTOR_MAX_COLS = 8


def projector_launch(Nn: torch.Tensor, delta: float):
    """Launch K12 on S windows: Nn (S, n, k) float32 -> (the projectors
    (S, n, n), (S, 2) int32: the Jacobi sweeps each window took and the
    rotations it made)."""
    if Nn.device.type != "cuda" or Nn.dtype != torch.float32 \
            or Nn.dim() != 3:
        raise ValueError(f"ba_projector: expected an (S, n, k) float32 CUDA "
                         f"tensor, got {tuple(Nn.shape)} {Nn.dtype} on "
                         f"{Nn.device}")
    S, n, k = Nn.shape
    if not (1 <= n <= PROJECTOR_MAX_ROWS and 1 <= k <= PROJECTOR_MAX_COLS):
        raise ValueError(f"ba_projector: n = {n} rows (1..{PROJECTOR_MAX_ROWS})"
                         f" and k = {k} columns (1..{PROJECTOR_MAX_COLS})")
    Nn = Nn.contiguous()
    lib = _load()
    out = torch.empty((S, n, n), dtype=torch.float32, device=Nn.device)
    work = torch.empty((S, 2), dtype=torch.int32, device=Nn.device)
    with torch.cuda.device(Nn.device):
        stream = torch.cuda.current_stream(Nn.device).cuda_stream
        err = lib.ldso_ba_projector(Nn.data_ptr(), out.data_ptr(),
                                    work.data_ptr(), S, n, k, float(delta),
                                    stream)
    if err != 0:
        raise RuntimeError(f"ba_projector kernel launch failed: CUDA error "
                           f"{err}")
    _count("ba_projector")
    return out, work


def ba_projector(Nn: torch.Tensor, delta: float) -> torch.Tensor:
    """The symmetric (n, n) projector onto the span of the (n, k)
    column-normalised nullspace basis Nn, over its singular values above
    delta times the largest (backend/ba_device.nullspace_projector_ref is
    the function).

    CPU tensor: the plain version (an SVD). CUDA tensor: K12
    (csrc/ba_projector.cu) on the current stream through the operator
    `ldso_tpu_torch::ba_projector`, whose vmap rule launches it once for
    all S windows. It reads nothing back and allocates with torch.empty
    only, so a CUDA graph can capture it."""
    if Nn.device.type == "cpu":
        from ldso_tpu_torch.backend.ba_device import nullspace_projector_ref
        return nullspace_projector_ref(Nn, delta)
    return torch.ops.ldso_tpu_torch.ba_projector(Nn, float(delta))


@torch.library.custom_op("ldso_tpu_torch::ba_projector", mutates_args=())
def _projector_op(Nn: _T, delta: float) -> _T:
    """K12 on one window (Nn (n, k))."""
    return projector_launch(Nn[None], delta)[0][0]


def _projector_vmap(info, in_dims, Nn, delta):
    """vmap over K12: the vmapped axis is the kernel's window axis."""
    Nn = Nn.movedim(in_dims[0], 0) if in_dims[0] is not None else \
        Nn.expand((info.batch_size,) + tuple(Nn.shape))
    return projector_launch(Nn, delta)[0], 0


torch.library.register_vmap("ldso_tpu_torch::ba_projector", _projector_vmap)


# ---------------------------------------------------------------------------
# K4: the epipolar trace of the candidate arena (csrc/immature_trace.cu)
# ---------------------------------------------------------------------------

# the discrete search's samplings, by (trace_search_nearest, trace_packed)
TRACE_SEARCHES = {(False, True): 0, (False, False): 1, (True, True): 2,
                  (True, False): 3}
TRACE_MAX_REFINE = 15
# the arena's fields in the kernel's pointer order, then the outputs
_TRACE_FIELDS = ("u", "v", "valid", "color", "weights", "gradH",
                 "idepth_min", "idepth_max", "quality", "energy_th", "status",
                 "last_u", "last_v", "last_interval")
TRACE_OUTPUTS = ("idepth_min", "idepth_max", "quality", "status", "last_u",
                 "last_v", "last_interval")


def trace_params(calib, cfg) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    """K4's integer and float launch arguments but the lane and host
    counts: (w, h, the step cap, the search, refine steps, GN iterations,
    the pattern's 16 offsets), and the plain version's Python scalars as
    float32 (max_pix_search, stepsize, slack interval, min improvement
    factor, Huber threshold, GN threshold, extra slack, and the bilinear
    clamps W - 1.001 and H - 1.001)."""
    import numpy as np
    from ldso_tpu_torch.config import PATTERN
    from ldso_tpu_torch.frontend.immature import _steps_cap
    W, H = calib.w[0], calib.h[0]
    nearest = bool(cfg.trace_search_nearest)
    refine = cfg.trace_refine_steps if nearest else 0
    if not (0 <= refine <= TRACE_MAX_REFINE and cfg.trace_gn_iterations >= 0):
        raise ValueError(f"trace: {refine} refine steps (0.."
                         f"{TRACE_MAX_REFINE}) and {cfg.trace_gn_iterations}"
                         f" GN iterations")
    ints = (W, H, _steps_cap(W, H, cfg),
            TRACE_SEARCHES[(nearest, bool(cfg.trace_packed))], refine,
            cfg.trace_gn_iterations,
            *(int(c) for c in np.asarray(PATTERN).reshape(-1)))
    floats = tuple(float(np.float32(x)) for x in (
        (W + H) * cfg.max_pix_search, cfg.trace_stepsize,
        cfg.trace_slack_interval, cfg.trace_min_improvement_factor,
        cfg.huber_th, cfg.trace_gn_threshold, cfg.trace_extra_slack_on_th,
        W - 1.001, H - 1.001))
    return ints, floats


def trace_arena(arena, dI_target, KRKis, Kts, affs, calib, cfg):
    """The epipolar trace of every lane of the candidate arena against a
    new frame (frontend/immature.trace_arena_ref is the function): lanes
    with a host slot >= 0, valid and not OOB search for their best match
    along the epipolar line and get a new interval and status; the others
    pass through. arena: an ImmatureArena of N lanes; dI_target (H, W, 3);
    KRKis (F, 3, 3), Kts (F, 3), affs (F, 2) per host slot. Returns the
    arena with new tensors for the 7 fields the trace updates
    (TRACE_OUTPUTS) and every other field shared.

    CPU tensors: the plain version. CUDA tensors: K4 (csrc/immature_trace.cu)
    in one launch over all N lanes on the current stream. It reads nothing
    back and allocates with torch.empty only."""
    pool = arena.pool
    if pool.u.device.type == "cpu":
        from ldso_tpu_torch.frontend.immature import trace_arena_ref
        return trace_arena_ref(arena, dI_target, KRKis, Kts, affs, calib,
                               cfg)
    N = pool.u.shape[0]
    W, H = calib.w[0], calib.h[0]
    F = KRKis.shape[0]
    dev = pool.u.device
    shapes = dict(color=(N, 8), weights=(N, 8), gradH=(N, 2, 2))
    tensors = [(f, getattr(pool, f), shapes.get(f, (N,)),
                {"valid": torch.bool, "status": torch.int32}.get(
                    f, torch.float32)) for f in _TRACE_FIELDS]
    tensors += [("host", arena.host, (N,), torch.int32),
                ("dI_target", dI_target, (H, W, 3), torch.float32),
                ("KRKis", KRKis, (F, 3, 3), torch.float32),
                ("Kts", Kts, (F, 3), torch.float32),
                ("affs", affs, (F, 2), torch.float32)]
    for name, t, shape, dtype in tensors:
        _on_card("trace", name, t, dtype, shape, dev)
    if N < 1 or F < 1:
        raise ValueError(f"trace: {N} lanes and {F} host slots (need >= 1)")
    ints, floats = trace_params(calib, cfg)
    out = {f: torch.empty(N, dtype=torch.int32 if f == "status"
                          else torch.float32, device=dev)
           for f in TRACE_OUTPUTS}
    ptrs = [t.data_ptr() for _, t, _, _ in tensors]
    ptrs += [out[f].data_ptr() for f in TRACE_OUTPUTS]
    _launch("trace", _load().ldso_immature_trace, ptrs, (N, F, *ints), floats,
            dev)
    _count("trace")
    return arena._replace(pool=pool._replace(**out))


# ---------------------------------------------------------------------------
# K5: the keyframe's activation of the candidate arena
# (csrc/immature_activate.cu)
# ---------------------------------------------------------------------------

# the most window slots K5 takes: four groups of 8 slots, 4 threads a slot
ACTIVATE_MAX_SLOTS = 32
# the arena's fields the activation reads, in the kernel's pointer order
_ACTIVATE_FIELDS = ("u", "v", "valid", "color", "weights", "idepth_min",
                    "idepth_max", "quality", "energy_th", "status",
                    "last_interval", "my_type")
ACTIVATE_OUTPUTS = ("to_opt", "remove", "idepth", "ok", "n_good")


def activate_params(calib, cfg) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    """K5's integer and float launch arguments but the lane, slot, map
    and window counts: (GN iterations, the pattern's 16 offsets), and
    (fx, fy, cx, cy, the bilinear clamps W - 1.001 and H - 1.001,
    min_trace_quality, huber_th, min_idepth_h_act) as float32, as the
    plain version's Python scalars round."""
    import numpy as np
    from ldso_tpu_torch.config import PATTERN
    W, H = calib.w[0], calib.h[0]
    ints = (cfg.gn_its_on_point_activation,
            *(int(c) for c in np.asarray(PATTERN).reshape(-1)))
    floats = tuple(float(np.float32(x)) for x in (
        calib.fx[0], calib.fy[0], calib.cx[0], calib.cy[0], W - 1.001,
        H - 1.001, cfg.min_trace_quality, cfg.huber_th,
        cfg.min_idepth_h_act))
    return ints, floats


def activate_arena(arena, dist_map, KRKis, Kts, Rs, ts, affs, masks, dIs,
                   min_act_dist, marg_flags, newest: int, nf: int, calib,
                   cfg):
    """The keyframe's activation of every lane of the candidate arena
    (frontend/immature.activate_arena_ref is the function): the gate
    against the newest keyframe with K1's distance map, then the
    depth-only LM against every window slot for the lanes it passes.
    arena: an ImmatureArena of N lanes; dist_map (h1, w1); KRKis (F, 3, 3),
    Kts (F, 3), marg_flags (F,) bool per host slot; Rs (F, F, 3, 3), ts
    (F, F, 3), affs (F, F, 2), masks (F, F) bool per (host, target); dIs
    (F, H, W, 3); min_act_dist a one-element float32 tensor (a float on
    the CPU too); newest and nf ints. Returns (to_opt, remove, idepth, ok,
    n_good) per lane (bool, bool, float32, bool, int32).

    CPU tensors: the plain version. CUDA tensors: K5 in one launch over
    all N lanes on the current stream, F <= ACTIVATE_MAX_SLOTS (else
    ValueError). It reads nothing back and allocates with torch.empty
    only."""
    pool = arena.pool
    if pool.u.device.type == "cpu":
        from ldso_tpu_torch.frontend.immature import activate_arena_ref
        return activate_arena_ref(arena, dist_map, KRKis, Kts, Rs, ts, affs,
                                  masks, dIs, min_act_dist, marg_flags,
                                  newest, nf, calib, cfg)
    N = pool.u.shape[0]
    F = KRKis.shape[0]
    W, H = calib.w[0], calib.h[0]
    if not 1 <= F <= ACTIVATE_MAX_SLOTS:
        raise ValueError(f"activate: {F} window slots; K5 takes 1.."
                         f"{ACTIVATE_MAX_SLOTS}")
    if N < 1 or dist_map.dim() != 2:
        raise ValueError(f"activate: {N} lanes and a "
                         f"{tuple(dist_map.shape)} distance map")
    dev = pool.u.device
    shapes = dict(color=(N, 8), weights=(N, 8))
    dtypes = dict(valid=torch.bool, status=torch.int32, my_type=torch.int32)
    tensors = [(f, getattr(pool, f), shapes.get(f, (N,)),
                dtypes.get(f, torch.float32)) for f in _ACTIVATE_FIELDS]
    f32, b8 = torch.float32, torch.bool
    tensors += [("host", arena.host, (N,), torch.int32),
                ("dist_map", dist_map, tuple(dist_map.shape), f32),
                ("KRKis", KRKis, (F, 3, 3), f32), ("Kts", Kts, (F, 3), f32),
                ("marg_flags", marg_flags, (F,), b8),
                ("Rs", Rs, (F, F, 3, 3), f32), ("ts", ts, (F, F, 3), f32),
                ("affs", affs, (F, F, 2), f32), ("masks", masks, (F, F), b8),
                ("dIs", dIs, (F, H, W, 3), f32)]
    if not torch.is_tensor(min_act_dist) or min_act_dist.numel() != 1:
        raise ValueError("activate: min_act_dist must be a one-element "
                         "tensor on the card")
    tensors.append(("min_act_dist", min_act_dist,
                    tuple(min_act_dist.shape), f32))
    for name, t, shape, dtype in tensors:
        _on_card("activate", name, t, dtype, shape, dev)
    ints, floats = activate_params(calib, cfg)
    h1, w1 = dist_map.shape
    out = dict(to_opt=torch.empty(N, dtype=b8, device=dev),
               remove=torch.empty(N, dtype=b8, device=dev),
               idepth=torch.empty(N, dtype=f32, device=dev),
               ok=torch.empty(N, dtype=b8, device=dev),
               n_good=torch.empty(N, dtype=torch.int32, device=dev))
    ptrs = [t.data_ptr() for _, t, _, _ in tensors]
    ptrs += [out[f].data_ptr() for f in ACTIVATE_OUTPUTS]
    _launch("activate", _load().ldso_immature_activate, ptrs,
            (N, F, W, H, w1, h1, int(newest), int(nf), *ints), floats, dev)
    _count("activate")
    return tuple(out[f] for f in ACTIVATE_OUTPUTS)


# ---------------------------------------------------------------------------
# K6 and K7: the windowed BA's linearization (csrc/ba_linearize.cu) and
# accumulation (csrc/ba_accumulate.cu)
# ---------------------------------------------------------------------------

_F32, _I32, _I64, _B8 = torch.float32, torch.int32, torch.int64, torch.bool
# the fields K6 writes, in its output order
LIN_FIELDS = ("Jpdxi", "Jpdc", "Jpdd", "JIdx", "JabF", "resF", "center_proj",
              "res_new_state", "res_new_energy", "res_new_energy_wo")
_LIN_WINDOW = ("pt_u", "pt_v", "pt_color", "pt_weights", "idepth",
               "idepth_zero", "pt_host", "pt_valid", "res_exist",
               "res_linearized", "res_state", "res_energy", "frame_valid",
               "frame_energy_th")
_LIN_PRECALC = ("R0", "t0", "KRKi", "Kt", "aff", "b0", "fxycxy")
# K6's tensor arguments, in its pointer order: the window's, the
# precalc's, the images, the fields it copies through and the target
_LIN_INPUTS = _LIN_WINDOW + _LIN_PRECALC + ("dIs",) + LIN_FIELDS + ("tgt",)
# the precalc's views (slices of the relative poses, a permuted product, a
# column) that K6 reads by their strides instead of copying them
_LIN_STRIDED = ("R0", "t0", "KRKi", "b0")
# K6's residuals a block: one 32-residual warp tree of the energy sum
# (backend/ba.ordered_energy_sum), eight lanes a residual
LIN_UNIT = 32
# K7's parts: the top accumulation (modes 0, 1, 2) and the Schur part
_TOP_INPUTS = ("JIdx", "Jpdc", "Jpdxi", "JabF", "Jpdd", "resF", "res_toZero",
               "res_active", "res_exist", "res_linearized", "frame_valid",
               "pt_mask", "pt_host", "adHTdelta", "c_delta", "idepth",
               "idepth_zero")
TOP_OUTPUTS = ("acc", "Hdd", "bd", "Hcd", "nres")
_SC_INPUTS = ("JIdx", "JabF", "Jpdxi", "Jpdd", "res_active", "res_exist",
              "frame_valid", "pt_mask", "pt_host", "pt_prior", "idepth",
              "idepth_zero", "Hdd_tot", "bd_tot", "Hcd_tot")
SC_OUTPUTS = ("HdiF", "bdSum", "Hcd", "JpJdF", "ngood", "Hcc_sc", "bc_sc",
              "accE", "accEB", "accD")
# the most window slots K7 takes (its per-target flags are bytes)
BA_MAX_SLOTS = 32


def _ba_shapes(P: int, F: int, H: int = 0, W: int = 0):
    """The (shape, dtype) of every tensor K6 and K7 take or give for one
    window of P points, F slots and (H, W) images."""
    s = dict(
        pt_u=((P,), _F32), pt_v=((P,), _F32), pt_color=((P, 8), _F32),
        pt_weights=((P, 8), _F32), idepth=((P,), _F32),
        idepth_zero=((P,), _F32), pt_host=((P,), _I64),
        pt_valid=((P,), _B8), pt_mask=((P,), _B8), pt_prior=((P,), _F32),
        res_exist=((P, F), _B8), res_linearized=((P, F), _B8),
        res_active=((P, F), _B8), res_state=((P, F), _I32),
        res_energy=((P, F), _F32), frame_valid=((F,), _B8),
        frame_energy_th=((F,), _F32), R0=((F, F, 3, 3), _F32),
        t0=((F, F, 3), _F32), KRKi=((F, F, 3, 3), _F32),
        Kt=((F, F, 3), _F32), aff=((F, F, 2), _F32), b0=((F,), _F32),
        fxycxy=((4,), _F32), dIs=((F, H, W, 3), _F32),
        Jpdxi=((P, F, 2, 6), _F32), Jpdc=((P, F, 2, 4), _F32),
        Jpdd=((P, F, 2), _F32), JIdx=((P, F, 2, 8), _F32),
        JabF=((P, F, 2, 8), _F32), resF=((P, F, 8), _F32),
        res_toZero=((P, F, 8), _F32), center_proj=((P, F, 3), _F32),
        res_new_state=((P, F), _I32), res_new_energy=((P, F), _F32),
        res_new_energy_wo=((P, F), _F32), tgt=((), _I64),
        energy=((), _F32), adHTdelta=((F, F, 8), _F32),
        c_delta=((4,), _F32), Hdd_tot=((P,), _F32), bd_tot=((P,), _F32),
        Hcd_tot=((P, 4), _F32), acc=((F, F, 13, 13), _F32),
        Hdd=((P,), _F32), bd=((P,), _F32), Hcd=((P, 4), _F32),
        nres=((), _I64), HdiF=((P,), _F32), bdSum=((P,), _F32),
        JpJdF=((P, F, 8), _F32), ngood=((P,), _I64),
        Hcc_sc=((4, 4), _F32), bc_sc=((4,), _F32),
        accE=((F, F, 8, 4), _F32), accEB=((F, F, 8), _F32),
        accD=((F, F, F, 8, 8), _F32))
    return s


def lin_params(cfg, img_w: int, img_h: int, dIs_hw) -> Tuple[Tuple[int, ...],
                                                              Tuple[float, ...]]:
    """K6's integer and float launch arguments but the counts: (the
    affine flags a and b off, the pattern's 16 offsets), and the plain
    version's Python scalars as float32: img_w - 3, img_h - 3, the
    bilinear clamps W - 1.001 and H - 1.001 of the images, the outlier
    and Huber thresholds, SCALE_IDEPTH, SCALE_F and SCALE_C."""
    import numpy as np
    from ldso_tpu_torch.config import PATTERN, SCALE_C, SCALE_F, SCALE_IDEPTH
    H, W = dIs_hw
    ints = (int(cfg.affine_opt_mode_a < 0), int(cfg.affine_opt_mode_b < 0),
            *(int(c) for c in np.asarray(PATTERN).reshape(-1)))
    floats = tuple(float(np.float32(x)) for x in (
        img_w - 3.0, img_h - 3.0, W - 1.001, H - 1.001,
        cfg.outlier_th_sum_component, cfg.huber_th, SCALE_IDEPTH, SCALE_F,
        SCALE_C))
    return ints, floats


def _ba_check(what: str, x: Dict[str, torch.Tensor], names, shapes, S: int,
              strided=()):
    """Every input on one CUDA device, of its shape (with the leading
    window axis S) and dtype, contiguous but those in `strided`."""
    dev = x[names[0]].device
    for name in names:
        shape, dtype = shapes[name]
        _on_card(what, name, x[name], dtype, (S,) + shape, dev,
                 name not in strided)
    return dev


def lin_launch(x: Dict[str, torch.Tensor], mode: int, floats, ints):
    """Launch K6 on S windows: x holds _LIN_INPUTS by name, each with a
    leading window axis (tgt (S,) int64, read in mode 1). Returns the 10
    LIN_FIELDS (S, P, F, ...) and the energy sums (S,)."""
    S, P = x["pt_u"].shape
    F = x["frame_valid"].shape[1]
    H, W = x["dIs"].shape[2], x["dIs"].shape[3]
    if not 1 <= F <= BA_MAX_SLOTS or P < 1 or min(H, W) < 4:
        raise ValueError(f"ba_linearize: {P} points, {F} slots (1.."
                         f"{BA_MAX_SLOTS}), {H}x{W} images")
    shapes = _ba_shapes(P, F, H, W)
    dev = _ba_check("ba_linearize", x, _LIN_INPUTS, shapes, S, _LIN_STRIDED)
    out = {f: torch.empty((S,) + shapes[f][0], dtype=shapes[f][1],
                          device=dev) for f in LIN_FIELDS + ("energy",)}
    partial = torch.empty((S, -(-(P * F) // LIN_UNIT)), dtype=_F32,
                          device=dev)
    arrived = torch.zeros(S, dtype=_I32, device=dev)
    ptrs = ([x[n].data_ptr() for n in _LIN_INPUTS]
            + [out[f].data_ptr() for f in LIN_FIELDS + ("energy",)]
            + [partial.data_ptr(), arrived.data_ptr()])
    strides = [d for n in _LIN_STRIDED for d in x[n].stride()]
    _launch("ba_linearize", _load().ldso_ba_linearize, ptrs,
            (S, P, F, H, W, int(mode), *ints, *strides), floats, dev)
    _count("ba_linearize")
    return tuple(out[f] for f in LIN_FIELDS + ("energy",))


def _acc_scratch(part: int, S: int, P: int, F: int, dev):
    """K7's scratch for one call of `part` on S windows, the sizes from
    csrc/ba_accumulate.cu's own layout: its point lists and chunk partials
    with torch.empty (the point stage writes them before the chunk stage
    reads them), and its arrival counters and flag and count words with
    torch.zeros."""
    sizes = (ctypes.c_longlong * 3)()
    _load().ldso_ba_accumulate_scratch(part, P, F, sizes)
    return (torch.empty((S, sizes[0]), dtype=_I32, device=dev),
            torch.empty((S, max(sizes[1], 1)), dtype=_F32, device=dev),
            torch.zeros((S, sizes[2]), dtype=_I32, device=dev))


def top_launch(x: Dict[str, torch.Tensor], mode: int):
    """Launch K7's top part on S windows (x holds _TOP_INPUTS by name with
    a leading window axis). Returns TOP_OUTPUTS."""
    S, P = x["idepth"].shape
    F = x["frame_valid"].shape[1]
    if not 1 <= F <= BA_MAX_SLOTS or P < 1 or mode not in (0, 1, 2):
        raise ValueError(f"ba_accumulate_top: {P} points, {F} slots (1.."
                         f"{BA_MAX_SLOTS}), mode {mode}")
    shapes = _ba_shapes(P, F)
    dev = _ba_check("ba_accumulate_top", x, _TOP_INPUTS, shapes, S)
    out = {f: torch.empty((S,) + shapes[f][0], dtype=shapes[f][1],
                          device=dev) for f in TOP_OUTPUTS}
    ptrs = ([x[n].data_ptr() for n in _TOP_INPUTS]
            + [out[f].data_ptr() for f in TOP_OUTPUTS]
            + [t.data_ptr() for t in _acc_scratch(0, S, P, F, dev)])
    _launch("ba_accumulate_top", _load().ldso_ba_accumulate, ptrs,
            (0, S, P, F, int(mode)), (), dev)
    _count("ba_accumulate")
    return tuple(out[f] for f in TOP_OUTPUTS)


def sc_launch(x: Dict[str, torch.Tensor], shift_prior: bool):
    """Launch K7's Schur part on S windows (x holds _SC_INPUTS by name with
    a leading window axis). Returns SC_OUTPUTS."""
    S, P = x["idepth"].shape
    F = x["frame_valid"].shape[1]
    if not 1 <= F <= BA_MAX_SLOTS or P < 1:
        raise ValueError(f"ba_accumulate_sc: {P} points, {F} slots (1.."
                         f"{BA_MAX_SLOTS})")
    shapes = _ba_shapes(P, F)
    dev = _ba_check("ba_accumulate_sc", x, _SC_INPUTS, shapes, S)
    out = {f: torch.empty((S,) + shapes[f][0], dtype=shapes[f][1],
                          device=dev) for f in SC_OUTPUTS}
    pflags = torch.empty((S, P), dtype=_I32, device=dev)
    ptrs = ([x[n].data_ptr() for n in _SC_INPUTS]
            + [out[f].data_ptr() for f in SC_OUTPUTS] + [pflags.data_ptr()]
            + [t.data_ptr() for t in _acc_scratch(1, S, P, F, dev)])
    _launch("ba_accumulate_sc", _load().ldso_ba_accumulate, ptrs,
            (1, S, P, F, int(bool(shift_prior))), (), dev)
    _count("ba_accumulate")
    return tuple(out[f] for f in SC_OUTPUTS)


def _window_op(names, launch, strided=()):
    """An operator's body on one window (a window axis of 1) and its vmap
    rule (the vmapped axis is the kernel's window axis, one launch for all
    of it; an input without that axis is repeated along it). Inputs are
    made contiguous, but those in `strided`, which the kernel reads in
    place by their strides."""
    n = len(names)

    def dense(k, t):
        return t if k in strided else t.contiguous()

    def one(*args):
        x = {k: dense(k, t)[None] for k, t in zip(names, args[:n])}
        return tuple(o[0] for o in launch(x, *args[n:]))

    def rule(info, in_dims, *args):
        S = info.batch_size
        x = {k: dense(k, t.expand((S,) + tuple(t.shape)) if d is None
                      else t.movedim(d, 0))
             for k, t, d in zip(names, args[:n], in_dims[:n])}
        out = launch(x, *args[n:])
        return out, (0,) * len(out)
    return one, rule


def _register(name: str, names, extra: str, n_out: int, launch,
              strided=()) -> None:
    one, rule = _window_op(names, launch, strided)
    schema = ("(" + ", ".join(f"Tensor {k}" for k in names) + extra + ") -> ("
              + ", ".join(["Tensor"] * n_out) + ")")
    torch.library.custom_op(f"ldso_tpu_torch::{name}", one, mutates_args=(),
                            schema=schema)
    torch.library.register_vmap(f"ldso_tpu_torch::{name}", rule)


_register("ba_linearize", _LIN_INPUTS, ", int mode, float[] floats, "
          "int[] ints", len(LIN_FIELDS) + 1, lin_launch, _LIN_STRIDED)
_register("ba_accumulate_top", _TOP_INPUTS, ", int mode", len(TOP_OUTPUTS),
          top_launch)
_register("ba_accumulate_sc", _SC_INPUTS, ", bool shift_prior",
          len(SC_OUTPUTS), sc_launch)


def _card(what: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")


def ba_linearize(W, dIs, pc, cfg, img_w: int, img_h: int, tgt=None):
    """PointFrameResidual::linearize over the window's whole (P, F)
    residual lattice, or (tgt an int or a 0-d integer tensor) over the
    column of that target with the sticky OOB (backend/ba.linearize_ref is
    the function): the 10 fields LIN_FIELDS of the residuals in
    `_lin_mask`, every other residual copied through, and the energy sum
    over the lattice's `_lin_mask` in a fixed order. W: a Window; dIs
    (F, H, W, 3); pc: its precalc (ba.make_precalc). Returns ({field:
    tensor}, energy_sum).

    CPU tensors: the plain version. CUDA tensors: K6 (csrc/ba_linearize.cu)
    in one launch over the lattice on the current stream, through the
    operator `ldso_tpu_torch::ba_linearize`, whose vmap rule launches it
    once for all S windows; the precalc's views R0, t0, KRKi and b0 are
    read in place by their strides. It reads nothing back and allocates
    with torch.empty (and one torch.zeros of S counters) only, so a CUDA
    graph can capture it."""
    if W.state.device.type == "cpu":
        from ldso_tpu_torch.backend.ba import linearize_ref
        return linearize_ref(W, dIs, pc, cfg, img_w, img_h, tgt)
    _card("ba_linearize", W.state)
    dev = W.state.device
    if tgt is None:
        tgt_t = device_const(0, dev, _I64)        # not read in mode 0
    elif torch.is_tensor(tgt):
        tgt_t = tgt.to(_I64)
    else:
        tgt_t = torch.full((), int(tgt), dtype=_I64, device=dev)
    ints, floats = lin_params(cfg, img_w, img_h, tuple(dIs.shape[-3:-1]))
    x = ([getattr(W, f) for f in _LIN_WINDOW]
         + [getattr(pc, f) for f in _LIN_PRECALC] + [dIs]
         + [getattr(W, f) for f in LIN_FIELDS] + [tgt_t])
    out = torch.ops.ldso_tpu_torch.ba_linearize(
        *x, 0 if tgt is None else 1, floats, ints)
    return dict(zip(LIN_FIELDS, out[:-1])), out[-1]


def ba_accumulate_top(W, pc, mode: int, pt_mask):
    """AccumulatedTopHessianSSE for one mode (0: the active residuals not
    yet linearized with resF; 1: the linearized ones with res_toZero +
    J delta; 2: every active residual of the points in pt_mask with
    res_toZero) over the points in pt_mask (backend/ba._accumulate_top_ref
    is the function): the 13x13 outer products of each residual's 8 rows
    summed per (host, target), per point Hdd, bd and Hcd over its targets,
    and the residual count. Returns (acc (F, F, 13, 13), Hdd, bd (P,), Hcd
    (P, 4), nres).

    CPU tensors: the plain version. CUDA tensors: K7's top part
    (csrc/ba_accumulate.cu, one launch: the point stage and the chunk
    stage, its sums over a host's points in chunks, the chunks in order),
    through the operator `ldso_tpu_torch::ba_accumulate_top` with a vmap
    rule as ba_linearize's."""
    if W.state.device.type == "cpu":
        from ldso_tpu_torch.backend.ba import _accumulate_top_ref
        return _accumulate_top_ref(W, pc, mode, pt_mask)
    _card("ba_accumulate_top", W.state)
    x = dict((f, getattr(W, f)) for f in _TOP_INPUTS
             if f in W._fields)
    x.update(pt_mask=pt_mask, adHTdelta=pc.adHTdelta, c_delta=pc.c_delta)
    return torch.ops.ldso_tpu_torch.ba_accumulate_top(
        *(x[f] for f in _TOP_INPUTS), int(mode))


def ba_accumulate_sc(W, Hdd_tot, bd_tot, Hcd_tot, shift_prior: bool,
                     pt_mask):
    """AccumulatedSCHessianSSE's sums over the points in pt_mask
    (backend/ba._sc_sums_ref is the function): per point HdiF, bdSum, the
    gated Hcd, JpJdF (P, F, 8) and ngood, and summed over the points
    Hcc_sc (4, 4), bc_sc (4) and per host accE (F, F, 8, 4), accEB
    (F, F, 8) and accD (h, t1, t2, 8, 8). Returns them as a dict.

    CPU tensors: the plain version. CUDA tensors: K7's Schur part (one
    launch: the point stage and the chunk stage), through the operator
    `ldso_tpu_torch::ba_accumulate_sc` with a vmap rule as
    ba_linearize's."""
    if W.state.device.type == "cpu":
        from ldso_tpu_torch.backend.ba import _sc_sums_ref
        return _sc_sums_ref(W, Hdd_tot, bd_tot, Hcd_tot, shift_prior,
                            pt_mask)
    _card("ba_accumulate_sc", W.state)
    x = dict((f, getattr(W, f)) for f in _SC_INPUTS if f in W._fields)
    x.update(pt_mask=pt_mask, Hdd_tot=Hdd_tot, bd_tot=bd_tot,
             Hcd_tot=Hcd_tot)
    out = torch.ops.ldso_tpu_torch.ba_accumulate_sc(
        *(x[f] for f in _SC_INPUTS), bool(shift_prior))
    return dict(zip(SC_OUTPUTS, out))


# ---------------------------------------------------------------------------
# K2: the frame's pyramid and the readers' rectification (csrc/preprocess.cu)
# ---------------------------------------------------------------------------

# the frame types the pyramid kernel reads (its dtype codes), and the most
# levels one launch builds (a level-0 tile with a 2^(L-1) halo)
PYRAMID_DTYPES = {torch.uint8: 0, torch.float32: 1, torch.uint16: 2}
PYRAMID_MAX_LEVELS = 6
# the coarse blocks' level-0 tile (width, height; every side a multiple
# of 2^(L-1) up to PYRAMID_MAX_LEVELS) and a block's threads
PYRAMID_TILE = (64, 32)
PYRAMID_THREADS = 256
# the raw frame types the rectify kernel reads: uint8 and int32 (with or
# without a response table) and float32 (without)
RECTIFY_DTYPES = {torch.uint8: 0, torch.float32: 1, torch.int32: 3}


def pyramid_shapes(H: int, W: int, levels: int):
    """(H, W) of each level: the frame's, each next one halved (floor)."""
    return [(H >> lvl, W >> lvl) for lvl in range(levels)]


def pyramid_plan(H: int, W: int, levels: int) -> dict:
    """K2's pyramid launch on an (H, W) frame with `levels` levels: one
    1-D grid of PYRAMID_THREADS-thread blocks, first the coarse blocks
    (one per PYRAMID_TILE of level 0: levels 1 .. L-1 of the tile, none
    for one level), then the level-0 blocks (a quad of four pixels of a
    row a thread); the dynamic shared memory of a coarse block (the coarse
    levels' regions: the tile and its 2^(L-1) halo, halved per level, as
    float32). ValueError for a level count the library has no kernel
    for. The launch itself takes the library's own plan
    (`library_pyramid_plan`), which the card tests hold equal to this."""
    if not 1 <= levels <= PYRAMID_MAX_LEVELS:
        raise ValueError(f"pyramid_plan: {levels} levels "
                         f"(1..{PYRAMID_MAX_LEVELS})")
    halo = 1 << (levels - 1)
    tx, ty = PYRAMID_TILE
    smem = 4 * sum(((tx + 2 * halo) >> lvl) * ((ty + 2 * halo) >> lvl)
                   for lvl in range(1, levels))
    coarse = (-(-W // tx)) * (-(-H // ty)) if levels > 1 else 0
    fine = -(-(H * (-(-W // 4))) // PYRAMID_THREADS)
    return dict(tile=(tx, ty), coarse_blocks=coarse, level0_blocks=fine,
                grid=coarse + fine, threads=PYRAMID_THREADS, smem=smem)


def pyramid(img: torch.Tensor, levels: int, b_grad_lut=None):
    """The frame's pyramid (ops/preprocess.make_pyramid_ref is the
    function): per level (I, dx, dy) and absSquaredGrad, times b_grad^2
    with a (256,) table. Returns a FramePyramid.

    CPU tensor: the plain version. CUDA tensor: K2's pyramid kernel, one
    launch for every level on the current stream (uint8, uint16 or float32
    frames; another type is made float32 first, as the plain version
    decodes it; 1..PYRAMID_MAX_LEVELS levels; the launch is
    the library's, `library_pyramid_plan`); it reads nothing back and
    allocates with torch.empty only."""
    from ldso_tpu_torch.ops.preprocess import FramePyramid, make_pyramid_ref
    if img.device.type == "cpu":
        return make_pyramid_ref(img, levels, b_grad_lut)
    _on_card("pyramid", "the frame", img)
    if img.dtype not in PYRAMID_DTYPES:
        # the plain version's decoding of any other frame type
        img = img.to(torch.float32)
    if img.dim() != 2:
        raise ValueError(f"pyramid: expected an (H, W) frame, got "
                         f"{tuple(img.shape)}")
    H, W = img.shape
    if not 1 <= levels <= PYRAMID_MAX_LEVELS or min(H, W) >> (levels - 1) < 1:
        raise ValueError(f"pyramid: {levels} levels of a {H}x{W} frame "
                         f"(1..{PYRAMID_MAX_LEVELS}, every level non-empty)")
    dev = img.device
    if b_grad_lut is not None:
        _on_card("pyramid", "b_grad", b_grad_lut, torch.float32, (256,), dev)
    shapes = pyramid_shapes(H, W, levels)
    dIs = [torch.empty((h, w, 3), dtype=torch.float32, device=dev)
           for h, w in shapes]
    ags = [torch.empty((h, w), dtype=torch.float32, device=dev)
           for h, w in shapes]
    ptrs = [img.data_ptr(), 0 if b_grad_lut is None else b_grad_lut.data_ptr()]
    for d, g in zip(dIs, ags):
        ptrs += [d.data_ptr(), g.data_ptr()]
    ints = [levels, PYRAMID_DTYPES[img.dtype]]
    for h, w in shapes:
        ints += [h, w]
    _launch("pyramid", _load().ldso_pyramid, ptrs, ints, None, dev)
    _count("pyramid")
    return FramePyramid(dI=tuple(dIs), abs_grad=tuple(ags))


def library_pyramid_plan(H: int, W: int, levels: int):
    """The pyramid launch's plan as the card's library makes it
    (ldso_pyramid_plan), in pyramid_plan's form; None for a level count it
    has no kernel for."""
    out = (ctypes.c_int * 6)()
    if _load().ldso_pyramid_plan(levels, H, W, out) != 0:
        return None
    tx, ty, coarse, fine, threads, smem = out
    return dict(tile=(tx, ty), coarse_blocks=coarse, level0_blocks=fine,
                grid=coarse + fine, threads=threads, smem=smem)


def rectify(raw: torch.Tensor, G_lut, vignette_inv, remap_x: torch.Tensor,
            remap_y: torch.Tensor) -> torch.Tensor:
    """A raw (h_org, w_org) frame through the response table (integer raw
    only), the inverse vignette and the bilinear remap onto (h, w), 0
    where remap_x < 0 (ops/preprocess.rectify_ref is the function).

    CPU tensor: the plain version. CUDA tensor: K2's rectify kernel, one
    thread per output pixel on the current stream (uint8 and int32 raw
    with or without the table, float32 raw without it)."""
    if raw.device.type == "cpu":
        from ldso_tpu_torch.ops.preprocess import rectify_ref
        return rectify_ref(raw, G_lut, vignette_inv, remap_x, remap_y)
    _on_card("rectify", "raw", raw)
    if raw.dtype not in RECTIFY_DTYPES or raw.dim() != 2:
        raise ValueError(f"rectify: a {raw.dtype} {tuple(raw.shape)} raw "
                         f"frame (the kernel takes (h, w) "
                         f"{sorted(map(str, RECTIFY_DTYPES))})")
    dev = raw.device
    h_org, w_org = raw.shape
    h, w = remap_x.shape
    if h_org < 2 or w_org < 2 or h * w < 1:
        raise ValueError(f"rectify: a {h_org}x{w_org} raw frame onto "
                         f"{h}x{w}")
    _on_card("rectify", "remap_x", remap_x, torch.float32, (h, w), dev)
    _on_card("rectify", "remap_y", remap_y, torch.float32, (h, w), dev)
    table = G_lut if raw.dtype != torch.float32 else None
    if table is not None:
        _on_card("rectify", "G", table, torch.float32, None, dev)
        if table.dim() != 1 or table.numel() < 1:
            raise ValueError(f"rectify: G is {tuple(table.shape)}, expected "
                             f"a non-empty table")
    if vignette_inv is not None:
        _on_card("rectify", "the vignette", vignette_inv, torch.float32,
                 (h_org, w_org), dev)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    ptrs = [raw.data_ptr(), 0 if table is None else table.data_ptr(),
            0 if vignette_inv is None else vignette_inv.data_ptr(),
            remap_x.data_ptr(), remap_y.data_ptr(), out.data_ptr()]
    ints = [RECTIFY_DTYPES[raw.dtype], 0 if table is None else table.numel(),
            h_org, w_org, h * w]
    floats = [float(torch.tensor(w_org - 1.001, dtype=torch.float32)),
              float(torch.tensor(h_org - 1.001, dtype=torch.float32))]
    _launch("rectify", _load().ldso_rectify, ptrs, ints, floats, dev)
    _count("rectify")
    return out
