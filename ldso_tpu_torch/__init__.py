"""ldso_tpu_torch: the PyTorch + CUDA port of ldso_tpu (direct sparse
monocular visual odometry, LDSO-class) for one NVIDIA H100.

The JAX package `ldso_tpu` is the reference; this package mirrors its
module tree and function names, so each counterpart sits at the same path.
It imports torch and numpy and never jax or ldso_tpu: the host helpers it
needs (config, camera calibration, lie_np, slam_map, synthetic scenes, the
native C++ source) are carried as its own copies, pinned to their
originals by the tests.

Device placement: `FullSystem(calib, cfg)` runs on the CUDA card by default
and raises where there is none; `device="cpu"` runs it on the CPU. The
device is passed down to every constructor, none of which has a default of
its own; nothing here sets a global default device.
"""

import torch

# Full-precision float32 matmuls and convolutions, the counterpart of
# ldso_tpu/__init__.py's jax_default_matmul_precision="highest": TF32 keeps
# about three decimal digits, which costs accuracy on 4x4 pose chains and
# the small Hessian algebra.
torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
