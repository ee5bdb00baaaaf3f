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
FullSystem of the process and by every stream, in the tracker's own family
of captured programs (`TRACKER`; utils/graphs.py says how a replay is
shared between streams and how the hand-written kernels in it, K3, count
their launches).
"""

from __future__ import annotations

from ldso_tpu_torch.utils.graphs import Programs

TRACKER = Programs()
CAPTURES = TRACKER.counts      # the tracker's graphs captured, host seconds
replay = TRACKER.replay
