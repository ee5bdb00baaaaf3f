"""Programs captured once as CUDA graphs and replayed, shared by streams.

A program that reads nothing back from the card is, for given input
shapes, one fixed sequence of kernels; recorded once into a
`torch.cuda.CUDAGraph`, it costs the host one graph launch per call. A
`Programs` is one family of such programs: a graph per key (the device,
the hashable arguments the program closes over, the inputs' shapes and
dtypes), shared by every stream, with the family's own lock and counts.
The tracker's family is frontend/track_graph.TRACKER, the windowed BA's
backend/energy_functional.BA_GRAPHS, the point marginalization's
backend/energy_functional.MARG_GRAPHS; the keyframe's activation pass,
its post-BA flags and packed row, its tracker reference and its new
candidates are system/full_system.ACTIVATE_GRAPHS, POST_BA_GRAPHS,
TRACKER_REF_GRAPHS and NEW_TRACES_GRAPHS; the frame step (the pyramid,
hypothesis 0's track, the retrack gate and the arena's trace) and the
pipelines' chain step are system/full_system.FRAME_STEP_GRAPHS and
CHAIN_STEP_GRAPHS; the bootstrap's frame (every level's LM and the
propagation) is frontend/initializer.INIT_GRAPHS.

A replay runs under the graph's lock on the caller's current stream: wait
for the graph's previous replay (an event, whatever stream it ran on),
copy the inputs into the graph's static buffers, replay, clone the outputs
out of its static buffers and record the event. So two streams (a
pipeline's tracking stream and its mapping stream) never use the buffers
at once, and each result is a fresh tensor that the next replay cannot
overwrite.

A capture begins with `torch.cuda.graph`'s device synchronise and ends
with the graph's upload to the card (`upload`), so that no replay pays
for it; it happens at a key's first call, which
`FullSystem.warm_retrack_programs` makes before a run starts
(`Programs.capture` captures without a replay: the activation's graph
for every window size, the frame and chain steps' for each image dtype,
and the bootstrap's at its first frame). The
families built with `capture_on_replay=False` (the frame and chain
steps', the bootstrap's) refuse a replay of a key with no graph. A
capture that fails raises.

The hand-written kernels in a program count their launches in Python,
which a replay does not run: the capture records each kernel's launches
(`cuda_kernels.recording_launches`) and every replay adds them to
`cuda_kernels.LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Callable, Dict, Tuple

import torch

from ldso_tpu_torch.ops import cuda_kernels


_driver = None


def upload(graph: torch.cuda.CUDAGraph, stream: torch.cuda.Stream) -> None:
    """Upload a captured graph to the card on `stream` without running it
    (the CUDA driver's cuGraphUpload) and wait for that. A graph's first
    launch would upload it, and that launch may hold the host until the
    card is idle (the bootstrap's frame program did: 202.67 host ms behind
    150 ms of queued sleep on an H100)."""
    global _driver
    if _driver is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuGraphUpload.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.cuGraphUpload.restype = ctypes.c_int
        _driver = lib
    err = _driver.cuGraphUpload(graph.raw_cuda_graph_exec(),
                                stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"cuGraphUpload failed: CUDA driver error {err}")
    stream.synchronize()


class Captured:
    """One program captured on static inputs, replayed with new values."""

    def __init__(self, program: Callable, inputs: Tuple[torch.Tensor, ...]):
        dev = inputs[0].device
        caller = torch.cuda.current_stream(dev)
        self.static_in = tuple(x.clone() for x in inputs)
        side = torch.cuda.Stream(dev)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            # eager warm-up on the capture stream: library handles and
            # workspaces, the tracker's device constants
            program(*self.static_in)
        self.graph = torch.cuda.CUDAGraph()
        with cuda_kernels.recording_launches() as launches, \
                torch.cuda.graph(self.graph, stream=side,
                                 capture_error_mode="thread_local"):
            self.static_out = tuple(program(*self.static_in))
        upload(self.graph, side)
        self.launches = launches       # kernel launches of one replay
        caller.wait_stream(side)
        # an output that is an input (a field the program did not write)
        # is returned as the caller's own tensor, as the eager call does
        self.passthrough = {i: j for i, o in enumerate(self.static_out)
                            for j, x in enumerate(self.static_in) if o is x}
        self.lock = threading.Lock()
        self.done = None
        self.wait_s = 0.0       # host seconds replays waited for the lock
        self.replays = 0

    def replay(self, inputs) -> Tuple[torch.Tensor, ...]:
        t = time.perf_counter()
        with self.lock:
            self.wait_s += time.perf_counter() - t
            stream = torch.cuda.current_stream(self.static_in[0].device)
            if self.done is not None:
                stream.wait_event(self.done)
            for s, x in zip(self.static_in, inputs):
                s.copy_(x)
            self.graph.replay()
            self.replays += 1
            cuda_kernels.add_launches(self.launches)
            out = tuple(inputs[self.passthrough[i]] if i in self.passthrough
                        else o.clone() for i, o in enumerate(self.static_out))
            self.done = torch.cuda.Event()
            self.done.record(stream)
            return out


def _key(static, inputs) -> tuple:
    return (inputs[0].device.index, static,
            tuple((tuple(x.shape), x.dtype) for x in inputs))


class Programs:
    """One family of captured programs: a graph per key, shared by every
    stream, and the family's counts (`counts`: graphs captured, their host
    seconds, replays)."""

    def __init__(self, capture_on_replay: bool = True):
        self.graphs: Dict[tuple, Captured] = {}
        # whether a replay of a key with no graph captures it (else raises)
        self.capture_on_replay = capture_on_replay
        self.lock = threading.Lock()
        self.counts = {"count": 0, "s": 0.0, "replays": 0}
        self._count_lock = threading.Lock()

    def capture(self, static, program: Callable,
                inputs: Tuple[torch.Tensor, ...]) -> Captured:
        """The graph of program(*inputs) for this key, captured now if it
        has none (a capture that fails raises); `static` holds the
        hashable arguments the program closes over. The inputs are CUDA
        tensors of one device."""
        key = _key(static, inputs)
        g = self.graphs.get(key)
        if g is None:
            with self.lock:
                g = self.graphs.get(key)
                if g is None:
                    t = time.perf_counter()
                    g = self.graphs[key] = Captured(program, inputs)
                    self.counts["count"] += 1
                    self.counts["s"] += time.perf_counter() - t
        return g

    def replay(self, static, program: Callable,
               inputs: Tuple[torch.Tensor, ...]):
        """program(*inputs) through its graph for this key: captured now
        if it has none and the family captures on replay, else a key with
        no graph raises."""
        if self.capture_on_replay:
            g = self.capture(static, program, inputs)
        else:
            g = self.graphs.get(_key(static, inputs))
            if g is None:
                raise RuntimeError("no graph was captured for this program's "
                                   "key before its first replay")
        out = g.replay(inputs)
        with self._count_lock:
            self.counts["replays"] += 1
        return out

    def launches(self, name: str) -> int:
        """The launches of kernel `name` (a key of cuda_kernels.LAUNCHES)
        this family's graphs have made: each graph's eager warm-up at its
        capture and each replay, times the launches the capture recorded."""
        return sum((g.replays + 1) * g.launches.get(name, 0)
                   for g in list(self.graphs.values()))

    def lock_wait_s(self) -> float:
        """The host seconds this family's replays have waited for a graph's
        lock while another replay held it."""
        return sum(g.wait_s for g in list(self.graphs.values()))
