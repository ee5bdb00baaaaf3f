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
ints), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from ldso_tpu_torch.ops.distance_map import MAX_K, distance_transform_ref

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_SOURCES = ("distance_map.cu",)
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "ldso_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"distance_transform": 0}

_lock = threading.Lock()
_lib = None


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    return the shared library's path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[os.path.join(_CSRC, s) for s in _SOURCES]]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr.strip())
    os.replace(tmp, path)   # atomic: concurrent builders race harmlessly
    return path


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.ldso_distance_transform.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            lib.ldso_distance_transform.restype = ctypes.c_int
            lib.ldso_distance_transform_max_smem.argtypes = [ctypes.c_int]
            lib.ldso_distance_transform_max_smem.restype = ctypes.c_int
            _lib = lib
        return _lib


def distance_transform(occupied: torch.Tensor, max_k: int = MAX_K) -> torch.Tensor:
    """Chamfer distance map of an (H, W) bool/uint8 occupancy map (see
    ops.distance_map.distance_transform_ref for the function).

    CPU tensor: the plain version. CUDA tensor: the hand-written kernel of
    csrc/distance_map.cu, which keeps the map in one block's shared memory
    as bytes; a map that does not fit raises ValueError."""
    if occupied.device.type == "cpu":
        return distance_transform_ref(occupied, max_k)
    if occupied.device.type != "cuda":
        raise ValueError(f"distance_transform: unsupported device "
                         f"{occupied.device}")
    if occupied.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"distance_transform: occupancy must be bool or "
                         f"uint8, got {occupied.dtype}")
    if occupied.dim() != 2:
        raise ValueError(f"distance_transform: expected (H, W), got "
                         f"{tuple(occupied.shape)}")
    if not occupied.is_contiguous():
        raise ValueError("distance_transform: occupancy must be contiguous")
    if not 1 <= max_k <= 255:
        raise ValueError(f"distance_transform: max_k must be in [1, 255] "
                         f"(uint8 distances), got {max_k}")
    H, W = occupied.shape
    lib = _load()
    limit = lib.ldso_distance_transform_max_smem(occupied.device.index or 0)
    if limit < 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: error {-limit}")
    if H * W > limit:
        raise ValueError(
            f"distance_transform: a {H}x{W} map needs {H * W} bytes of shared "
            f"memory, more than the {limit} bytes one block may use on "
            f"{torch.cuda.get_device_name(occupied.device)}")
    out = torch.empty((H, W), dtype=torch.float32, device=occupied.device)
    with torch.cuda.device(occupied.device):
        stream = torch.cuda.current_stream(occupied.device).cuda_stream
        err = lib.ldso_distance_transform(
            occupied.data_ptr(), out.data_ptr(), H, W, int(max_k), stream)
    if err != 0:
        raise RuntimeError(f"distance_transform kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["distance_transform"] += 1
    return out
