"""Where the port's entry points run.

`FullSystem`, `LoopClosing` and `posegraph.run_pose_graph` take
`device="cuda"` by default and hand their device down to every
constructor they build on, none of which has a default of its own. With no
card present the default raises: nothing moves to the CPU unless the
caller passes `device="cpu"`, as the CPU tests do.
"""

from __future__ import annotations

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
