"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

Both packages get the same inputs, made from a numpy seed: JAX inputs are
cast to float32 explicitly (tests/conftest.py turns JAX's x64 mode on), and
the port gets the same float32 values as CPU tensors. torch runs on one
thread because tier-1 runs several xdist workers side by side.
"""

from __future__ import annotations

import contextlib

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


def jax_picks(valid, n_hyp, k, key):
    """The hypothesis draws of the JAX pnp_ransac / umeyama_ransac
    (pnp.py:57-60, sim3_solver.py:58-61) for a (padded) valid mask."""
    import jax
    probs = jnp.asarray(np.asarray(valid)).astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1e-9)
    return npy(jax.random.categorical(
        key, jnp.log(probs + 1e-12)[None, :].repeat(n_hyp * k, 0))
        .reshape(n_hyp, k)).astype(np.int64)


class JaxDraws:
    """The RANSAC draws of a JAX LoopClosing, call by call: each call
    splits the key as `_seed_pnp` / `_seed_umeyama` do
    (loopclosing.py:311,348), pads the valid mask to the JAX arrays' power
    of two (invalid rows at the end, :305-309) and draws over the padded
    mask. The indices must land below the unpadded length, where the
    port's rows are the JAX package's rows; a draw into the padding
    raises. `calls` keeps (n, nb, k, picks) per call."""

    def __init__(self, key):
        self.key = key
        self.calls = []

    def __call__(self, valid, n_hyp, k, generator=None):
        import jax
        from ldso_tpu.loop.loopclosing import LoopClosing
        v = npy(valid).astype(bool)
        n = len(v)
        nb = LoopClosing._pad_pow2(n)
        vp = np.zeros(nb, bool)
        vp[:n] = v
        self.key, sub = jax.random.split(self.key)
        picks = jax_picks(vp, n_hyp, k, sub)
        if picks.max(initial=-1) >= n or not v[picks].all():
            raise AssertionError(f"a JAX draw left the valid rows of {n}")
        self.calls.append((n, nb, k, picks))
        return torch.from_numpy(picks).to(valid.device)


@contextlib.contextmanager
def shared_draws(key=None, seed=None):
    """While inside, the port's RANSAC (loop/pnp.draw_picks, as pnp_ransac
    and umeyama_ransac call it) draws exactly the picks a JAX LoopClosing
    draws at the same call: from `key` (a JAX LoopClosing's current
    `key`, to continue its sequence) or from PRNGKey(seed), a fresh
    LoopClosing's key. Yields the JaxDraws. Neither package changes."""
    import jax
    from ldso_tpu_torch.loop import pnp, sim3_solver
    draws = JaxDraws(jax.random.PRNGKey(seed) if key is None else key)
    orig = pnp.draw_picks, sim3_solver.draw_picks
    pnp.draw_picks = sim3_solver.draw_picks = draws
    try:
        yield draws
    finally:
        pnp.draw_picks, sim3_solver.draw_picks = orig
