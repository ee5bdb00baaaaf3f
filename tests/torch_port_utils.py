"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

Both packages get the same inputs, made from a numpy seed: JAX inputs are
cast to float32 explicitly (tests/conftest.py turns JAX's x64 mode on), and
the port gets the same float32 values as CPU tensors. torch runs on one
thread because tier-1 runs several xdist workers side by side.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)


def j32(a):
    """numpy/JAX -> float32 JAX array."""
    return jnp.asarray(np.asarray(a, np.float32))


def t32(a):
    """numpy/JAX -> float32 CPU tensor."""
    return torch.from_numpy(np.array(a, np.float32))


def tt(a):
    """numpy/JAX -> CPU tensor keeping the dtype (bool, int32, float32)."""
    return torch.from_numpy(np.array(a))


def npy(x):
    """tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def close(port, ref, rtol, atol, what=""):
    """Port vs JAX within the stated tolerance (NaN/inf must match)."""
    np.testing.assert_allclose(npy(port), npy(ref), rtol=rtol, atol=atol,
                               equal_nan=True, err_msg=what)


def equal(port, ref, what=""):
    np.testing.assert_array_equal(npy(port), npy(ref), err_msg=what)


def plane_frames(n, w, h, freq_hi=25.0, contrast=80.0, step=1.0):
    """JAX-rendered PlaneScene frames (float32 numpy) and poses along the
    tests/test_full_system.py trajectory."""
    from ldso_tpu.math import lie
    from ldso_tpu.synthetic import PlaneScene, default_calib
    calib = default_calib(w, h)
    scene = PlaneScene(freq_hi=freq_hi, contrast=contrast)
    poses, imgs, ideps = [], [], []
    for k in range(n):
        i = k * step
        t = np.array([0.035 * i, 0.012 * np.sin(0.2 * i), 0.004 * i])
        wv = np.array([0.0, 0.002 * i, 0.0005 * i])
        T = np.linalg.inv(np.asarray(lie.se3_exp(jnp.asarray(
            np.concatenate([t, wv])))))
        img, idep = scene.render(calib, jnp.asarray(T, jnp.float32))
        poses.append(T)
        imgs.append(np.asarray(img, np.float32))
        ideps.append(np.asarray(idep, np.float32))
    return calib, poses, imgs, ideps
