"""The native C++ host runtime of the loop-closing paths.

The vocabulary transform, inverted-index database, bucketed popcount
matching and radius NMS live in ldso_tpu_torch/csrc/native.cpp, a plain C
ABI with no JAX in it: the port's own copy of the JAX package's
ldso_tpu/native/native.cpp, byte for byte (tests/test_torch_host.py pins
the two together). This loader compiles it with g++ (the flags of
ldso_tpu/native) into build/ldso_tpu_torch/native-<hash>/ at first use
and binds it with ctypes. The hash covers the source, the flags and the
host CPU's feature flags (`-march=native`), so a library built on one
machine is never loaded on another.

There is no pure-Python fallback: when the library cannot be built or
loaded, every entry point raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "csrc", "native.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "ldso_tpu_torch")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def library_path() -> str:
    h = hashlib.sha256()
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_flags())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, f"native-{h.hexdigest()[:16]}",
                        "libldso_native.so")


def build() -> str:
    """Compile native.cpp (if this hash has no library yet); return the
    library's path. Raises RuntimeError when g++ fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE} failed: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)      # atomic: concurrent builds race harmlessly
    return path


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        c_int, c_float, c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        lib.bow_transform.argtypes = [u32p, c_int, u32p, i32p, c_int, c_int,
                                      c_int, i32p, i32p]
        lib.bow_bucketed_match.argtypes = [u32p, i32p, c_int, u32p, i32p,
                                           c_int, c_float, c_int, i32p, i32p]
        lib.db_create.restype = c_void_p
        lib.db_destroy.argtypes = [c_void_p]
        lib.db_add.argtypes = [c_void_p, ctypes.c_int32, i32p, f32p, c_int]
        lib.db_query.argtypes = [c_void_p, i32p, f32p, c_int, i32p, c_int,
                                 i32p, f32p, c_int]
        lib.db_query.restype = c_int
        lib.radius_nms.argtypes = [f32p, f32p, f32p, c_int, c_float, u8p]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def bow_transform(desc: np.ndarray, node_desc: np.ndarray,
                  children: np.ndarray, word_id: np.ndarray,
                  k: int, L: int) -> np.ndarray:
    """(n, 8) uint32 descriptors -> (n,) int32 word ids (tree descent by
    Hamming argmin, ties to the lowest child)."""
    lib = get_lib()
    desc = np.ascontiguousarray(desc, np.uint32)
    node_desc = np.ascontiguousarray(node_desc, np.uint32)
    children = np.ascontiguousarray(children, np.int32)
    word_id = np.ascontiguousarray(word_id, np.int32)
    out = np.empty(len(desc), np.int32)
    lib.bow_transform(_ptr(desc, ctypes.c_uint32), len(desc),
                      _ptr(node_desc, ctypes.c_uint32),
                      _ptr(children, ctypes.c_int32), len(node_desc),
                      k, L, _ptr(word_id, ctypes.c_int32),
                      _ptr(out, ctypes.c_int32))
    return out


def bow_bucketed_match(da: np.ndarray, nodes_a: np.ndarray,
                       db: np.ndarray, nodes_b: np.ndarray,
                       nn_ratio: float = 0.75, th_low: int = 50):
    """SearchByBoW (FeatureMatcher.cc:66-124): match only within shared
    vocabulary-tree nodes, NN-ratio per bucket. Returns (match, dist)."""
    lib = get_lib()
    da = np.ascontiguousarray(da, np.uint32)
    db = np.ascontiguousarray(db, np.uint32)
    nodes_a = np.ascontiguousarray(nodes_a, np.int32)
    nodes_b = np.ascontiguousarray(nodes_b, np.int32)
    match = np.empty(len(da), np.int32)
    dist = np.empty(len(da), np.int32)
    lib.bow_bucketed_match(_ptr(da, ctypes.c_uint32),
                           _ptr(nodes_a, ctypes.c_int32), len(da),
                           _ptr(db, ctypes.c_uint32),
                           _ptr(nodes_b, ctypes.c_int32), len(db),
                           nn_ratio, th_low, _ptr(match, ctypes.c_int32),
                           _ptr(dist, ctypes.c_int32))
    return match, dist


def radius_nms(u: np.ndarray, v: np.ndarray, score: np.ndarray,
               radius: float) -> np.ndarray:
    """Greedy radius NMS in descending score order: (n,) bool keep."""
    lib = get_lib()
    u = np.ascontiguousarray(u, np.float32)
    v = np.ascontiguousarray(v, np.float32)
    score = np.ascontiguousarray(score, np.float32)
    keep = np.empty(len(u), np.uint8)
    lib.radius_nms(_ptr(u, ctypes.c_float), _ptr(v, ctypes.c_float),
                   _ptr(score, ctypes.c_float), len(u), radius,
                   _ptr(keep, ctypes.c_uint8))
    return keep.astype(bool)


class NativeDatabase:
    """Inverted-index BoW database (L1 score, exclusion query)."""

    def __init__(self):
        self._lib = get_lib()
        self._h = self._lib.db_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.db_destroy(self._h)
            self._h = None

    def add(self, kf_id: int, words: np.ndarray, weights: np.ndarray):
        words = np.ascontiguousarray(words, np.int32)
        weights = np.ascontiguousarray(weights, np.float32)
        self._lib.db_add(self._h, kf_id, _ptr(words, ctypes.c_int32),
                         _ptr(weights, ctypes.c_float), len(words))

    def query(self, words: np.ndarray, weights: np.ndarray,
              exclude: np.ndarray, max_results: int = 5):
        words = np.ascontiguousarray(words, np.int32)
        weights = np.ascontiguousarray(weights, np.float32)
        exclude = np.ascontiguousarray(exclude, np.int32)
        out_ids = np.empty(max_results, np.int32)
        out_scores = np.empty(max_results, np.float32)
        m = self._lib.db_query(self._h, _ptr(words, ctypes.c_int32),
                               _ptr(weights, ctypes.c_float), len(words),
                               _ptr(exclude, ctypes.c_int32), len(exclude),
                               _ptr(out_ids, ctypes.c_int32),
                               _ptr(out_scores, ctypes.c_float), max_results)
        return [(int(out_ids[i]), float(out_scores[i])) for i in range(m)]
