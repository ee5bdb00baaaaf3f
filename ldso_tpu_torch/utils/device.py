"""Where the port's entry points run.

`FullSystem`, `LoopClosing` and `posegraph.run_pose_graph` take
`device="cuda"` by default and hand their device down to every
constructor they build on, none of which has a default of its own. With no
card present the default raises: nothing moves to the CPU unless the
caller passes `device="cpu"`, as the CPU tests do.

`HostCopy` brings a device result home without a wait: every layer that
defers a read (the BA's stats, the keyframe's packed rows, the tracking
chain's result) hands one back, and the caller reads it later.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def entry_device(device) -> torch.device:
    """The torch.device of an entry point; a CUDA device raises when torch
    sees no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch sees no CUDA card; "
            f"pass device='cpu' to run on the CPU")
    return dev


def record_event(device) -> Optional[torch.cuda.Event]:
    """An event recorded on `device`'s current stream (None on the CPU)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class HostCopy:
    """A device result on its way to the host: copied with non_blocking=True
    into pinned memory and an event recorded after the copy. `is_ready()`
    queries the event; `numpy()` waits on it. On the CPU both are
    immediate."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = record_event(t.device)
        else:
            self._host = t
            self._event = None

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
