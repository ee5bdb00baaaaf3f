"""The repair of fault 3a (ROADMAP §3): the tracker's LM step takes its
se3_exp with the square root, sine and cosine of a float32 angle rounded
once from float64 (`lie.se3_exp_exact(xi)`, `math/rounding.rounded`), as
XLA:CPU's float32 cosine is the correctly rounded one on the angles the
tracker takes. torch's float32 cosine is not on 4-8% of them and rounds
toward 1 more often than away; (1 - cos) / theta^2, the coefficient of
the rotation (so3_exp) and of the left Jacobian's coupling of rotation
into translation (se3_exp's V), amplifies that into a bias with one sign,
which the bench's 160 frames turned into a drift in scale (the port's
tracker swapped into the JAX system: 1.36 mm against the JAX package's
0.50). Held here against the JAX package's jitted functions on angles
drawn from a seed in the bands the tracker's LM steps take."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu.math import lie as jlie
from ldso_tpu_torch.math import lie
from ldso_tpu_torch.math.rounding import rounded

jax.config.update("jax_platforms", "cpu")

BANDS = [(1e-4, 1e-3), (1e-3, 1e-2), (1e-2, 3e-2), (3e-2, 1e-1)]


def _angles(lo, hi, n=50000, seed=5):
    rng = np.random.RandomState(seed)
    th = 10 ** rng.uniform(np.log10(lo), np.log10(hi), n)
    w = rng.randn(n, 3)
    w = w / np.linalg.norm(w, axis=1, keepdims=True) * th[:, None]
    return w.astype(np.float32)


@pytest.mark.parametrize("band", BANDS)
def test_cos_and_sin_are_xla_s(band):
    """On float32 angles of the band, the exact cosine (`rounded`)
    gives the JAX package's jitted jnp.cos bit for bit on all but 1 in
    1,000 at most (torch's float32 cosine, the default, on 2-9% fewer),
    the exact sine its jnp.sin on all but 1 in 100 (the sine has no
    cancellation to amplify it)."""
    x = np.linalg.norm(_angles(*band), axis=1).astype(np.float32)
    t = torch.from_numpy(x)
    cj = np.asarray(jax.jit(jnp.cos)(jnp.asarray(x)))
    sj = np.asarray(jax.jit(jnp.sin)(jnp.asarray(x)))
    sin_e, cos_e = rounded(torch.sin, t), rounded(torch.cos, t)
    same = np.mean(cos_e.numpy() == cj)
    assert same >= 0.999
    assert same - np.mean(torch.cos(t).numpy() == cj) >= 0.015
    assert np.mean(sin_e.numpy() == sj) >= 0.99
    assert rounded(torch.cos, t.double()).dtype == torch.float64


@pytest.mark.parametrize("band", BANDS)
def test_left_jacobian_coefficient_has_no_sign(band):
    """The left Jacobian's a = (1 - cos) / theta^2 against float64: the
    port's rounding errors fall above float64 as often as the JAX
    package's do (their shares within 0.05; under 1e-3 both sit low, where
    float32's steps near 1 quantize 1 - cos), and its mean signed error is
    the JAX package's within a tenth of its mean |error|; with torch's
    own float32 cosine (the formula before the repair) the share above
    sits well under a half from 1e-3 to 1e-2."""
    w = _angles(*band)
    _, a_t, _ = lie._rodrigues(torch.from_numpy(w), rounded)
    a_j, _ = jax.jit(jlie._so3_left_jacobian_coeffs)(jnp.asarray(w))
    th = np.linalg.norm(w.astype(np.float64), axis=1)
    a64 = (1.0 - np.cos(th)) / th ** 2
    e_t = a_t.numpy().astype(np.float64) - a64
    e_j = np.asarray(a_j, np.float64) - a64
    up_t, up_j = np.mean(e_t > 0), np.mean(e_j > 0)
    assert abs(up_t - up_j) < 0.05, (up_t, up_j)
    assert abs(e_t.mean() - e_j.mean()) < 0.1 * np.abs(e_t).mean()
    th32 = torch.from_numpy(np.linalg.norm(w, axis=1).astype(np.float32))
    old = ((1.0 - torch.cos(th32)) / (th32 * th32)).numpy().astype(np.float64)
    if band[0] >= 1e-3 and band[1] <= 1e-2:
        assert np.mean(old - a64 > 0) < 0.45


@pytest.mark.parametrize("band", BANDS)
def test_se3_exp_against_jax(band):
    """se3_exp of steps whose rotation lies in the band (translations of
    1e-3): the port's translation against the JAX package's jitted one
    differs by rounding only, with no sign along the coupling w x v (the
    mean signed difference under a tenth of the mean |difference|, or
    exactly 0)."""
    w = _angles(*band, n=20000, seed=6)
    rng = np.random.RandomState(7)
    v = (rng.randn(len(w), 3) * 1e-3).astype(np.float32)
    xi = np.concatenate([v, w], 1)
    Tt = lie.se3_exp_exact(torch.from_numpy(xi)).numpy().astype(np.float64)
    Tj = np.asarray(jax.jit(jlie.se3_exp)(jnp.asarray(xi)), np.float64)
    c = np.cross(w.astype(np.float64), v.astype(np.float64))
    c = c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-300)
    d = np.sum((Tt[:, :3, 3] - Tj[:, :3, 3]) * c, axis=1)
    assert np.abs(Tt - Tj).max() < 1e-6
    assert d.mean() == 0.0 or abs(d.mean()) < 0.1 * np.abs(d).mean()
