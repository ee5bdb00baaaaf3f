"""The tracker on the card as one captured program per shape.

The coarse tracker (frontend/tracker._track_batch) runs its loops to their
full trip counts with per-member masks and reads nothing back from the
card, so for given input shapes a whole coarse-to-fine track is one fixed
sequence of kernels: about 10-15k small launches per frame at 640x480.
Launched one by one from Python, the host would be the bottleneck again.
Here it is recorded once into a `torch.cuda.CUDAGraph` and replayed, so
the host pays one graph launch per track and the caller returns before
the card has tracked the frame (the JAX package's one device program per
`track_frame`, `ldso_tpu/frontend/tracker.py:406`).

One graph per key (the device, the tracker's static arguments, the Config
fields it reads, and the inputs' shapes and dtypes), shared by every
FullSystem of the process and by every stream. A replay runs under the
graph's lock on the caller's current stream: wait for the graph's
previous replay (an event, whatever stream it ran on), copy the inputs
into the graph's static buffers, replay, clone the outputs out of its
static buffers and record the event.
So two streams (a pipeline's tracking stream and its mapping stream) never
use the buffers at once, and each result is a fresh tensor that the next
replay cannot overwrite.

A capture begins with `torch.cuda.graph`'s device synchronise; it happens
at a key's first call, which `FullSystem.warm_retrack_programs` makes
before a run starts.

The hand-written kernels in the program (K3, the tracker trip) count their
launches in Python, which a replay does not run: the capture records each
kernel's launches (`cuda_kernels.recording_launches`) and every replay
adds them to `cuda_kernels.LAUNCHES`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Tuple

import torch

from ldso_tpu_torch.ops import cuda_kernels

_lock = threading.Lock()
_graphs: Dict[tuple, "_Captured"] = {}
CAPTURES = {"count": 0, "s": 0.0}      # graphs captured, their host time


class _Captured:
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
        self.launches = launches       # kernel launches of one replay
        caller.wait_stream(side)
        self.lock = threading.Lock()
        self.done = None

    def replay(self, inputs) -> Tuple[torch.Tensor, ...]:
        with self.lock:
            stream = torch.cuda.current_stream(self.static_in[0].device)
            if self.done is not None:
                stream.wait_event(self.done)
            for s, x in zip(self.static_in, inputs):
                s.copy_(x)
            self.graph.replay()
            cuda_kernels.add_launches(self.launches)
            out = tuple(o.clone() for o in self.static_out)
            self.done = torch.cuda.Event()
            self.done.record(stream)
            return out


def _key(static, inputs) -> tuple:
    return (inputs[0].device.index, static,
            tuple((tuple(x.shape), x.dtype) for x in inputs))


def replay(static, program: Callable, inputs: Tuple[torch.Tensor, ...]):
    """program(*inputs) through its graph for this key (captured now if it
    has none); `static` holds the hashable arguments the program closes
    over. The inputs are CUDA tensors of one device."""
    key = _key(static, inputs)
    g = _graphs.get(key)
    if g is None:
        with _lock:
            g = _graphs.get(key)
            if g is None:
                t = time.perf_counter()
                g = _graphs[key] = _Captured(program, inputs)
                CAPTURES["count"] += 1
                CAPTURES["s"] += time.perf_counter() - t
    return g.replay(inputs)
