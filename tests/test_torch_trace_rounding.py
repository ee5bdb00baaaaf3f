"""The trace's float32 rounding against the JAX package's (ROADMAP §3, 3a).

The fixture (tests/data/trace_rounding_lanes.npz, written by
`tests/tools/trace_rounding.py --build`) holds the trace lanes of the
bench scene's parity bisect where the port's plain trace, before it took
the JAX package's rounding, left the 2e-3 quality tolerance against the
JAX package's jitted trace: their pool fields, host slots, the host
tables and the frame index; the target frame is rendered again here.
"""

import os
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu_torch.frontend import immature as tim
from ldso_tpu_torch.math.rounding import fma

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))
import trace_rounding as tr  # noqa: E402

jax.config.update("jax_platforms", "cpu")

FIX = dict(np.load(tr.FIXTURE))
FRAMES = [int(f) for f in FIX["frames"]]


def _rounded(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda y: (abs(Fraction(float(y)) - x),
                                     int(np.float32(y).view(np.uint32)) & 1))


def test_fma_rounds_once():
    """math/rounding.fma is a * b + c correctly rounded to float32, on
    random operands and on sums that land on or beside a float32 tie,
    where a float64 sum rounded again would miss."""
    rng = np.random.RandomState(5)
    n = 3000
    a = (rng.randn(n) * 10.0 ** rng.randint(-4, 4, n)).astype(np.float32)
    b = (rng.randn(n) * 10.0 ** rng.randint(-4, 4, n)).astype(np.float32)
    c = (rng.randn(n) * 10.0 ** rng.randint(-8, 8, n)).astype(np.float32)
    c[:1000] = -(a[:1000].astype(np.float64) * b[:1000]).astype(np.float32)
    # just under a float32 tie, which the float64 sum rounds onto (and
    # ties to even would then take the wrong way): (1 + 2^-23) + 2^-24 -
    # 2^-70, and its negative
    a[1000] = a[1001] = 1.0 + 2.0 ** -23
    b[1000] = b[1001] = (1.0 - 2.0 ** -23) * 2.0 ** -24
    c[1000], c[1001] = 1.0 + 2.0 ** -23, -(1.0 + 2.0 ** -23)
    b[1001] = -b[1001]
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert naive[1000] == np.float32(1.0 + 2.0 ** -22)
    got = fma(torch.from_numpy(a), torch.from_numpy(b),
              torch.from_numpy(c)).numpy()
    for i in range(n):
        want = _rounded(Fraction(float(a[i])) * Fraction(float(b[i]))
                        + Fraction(float(c[i])))
        assert got[i] == want, (i, a[i], b[i], c[i], got[i], want)


@pytest.mark.parametrize("frame", FRAMES)
def test_fixture_lanes_agree_with_jax(frame):
    """The lanes where the port's earlier order left the 2e-3 quality
    tolerance: the port's plain trace now gives the JAX package's quality and status on
    each, and its interval and positions within 1e-4."""
    from ldso_tpu.frontend import immature as jim
    from ldso_tpu.synthetic import default_calib
    calib = default_calib(640, 480)
    jc, tc = tr.configs()
    arena, dI, KRKis, Kts, affs = tr.fixture_inputs(FIX, frame)
    assert arena.host.numel() > 0
    pt = tim.trace_arena_ref(arena, dI, KRKis, Kts, affs, calib, tc).pool
    ja = jim.ImmatureArena(
        pool=jim.ImmaturePool(**{f: jnp.asarray(getattr(arena.pool,
                                                        f).numpy())
                                 for f in tr.POOL_FIELDS}),
        host=jnp.asarray(arena.host.numpy()))
    pj = jim.trace_arena(ja, jnp.asarray(dI.numpy()),
                         jnp.asarray(KRKis.numpy()),
                         jnp.asarray(Kts.numpy()),
                         jnp.asarray(affs.numpy()), calib, jc).pool
    np.testing.assert_array_equal(pt.status.numpy(), np.asarray(pj.status))
    np.testing.assert_allclose(pt.quality.numpy(), np.asarray(pj.quality),
                               rtol=tr.QUALITY_RTOL, atol=tr.QUALITY_ATOL)
    for f in ("idepth_min", "idepth_max", "last_u", "last_v",
              "last_interval"):
        np.testing.assert_allclose(getattr(pt, f).numpy(),
                                   np.asarray(getattr(pj, f)), rtol=1e-4,
                                   atol=1e-4, err_msg=f)


@pytest.mark.parametrize("frame", FRAMES)
def test_search_energies_are_the_xla_order(frame):
    """The search's energies the port's trace computes on the fixture's
    lanes are, bit for bit, those of the XLA order term by term
    (tools/trace_rounding.search_terms: its samples, residuals, Huber
    weights and left-to-right tap sums)."""
    from ldso_tpu.synthetic import default_calib
    parts = {}
    arena, dI, KRKis, Kts, affs = tr.fixture_inputs(FIX, frame)
    tim.trace_arena_ref(arena, dI, KRKis, Kts, affs,
                        default_calib(640, 480), tr.configs()[1], parts)
    xla = tr.search_terms(FIX, frame, "xla", torch.float32)
    assert tr._bits_equal(xla["energy"], parts["energies"])


def test_xla_order_is_no_farther_from_float64():
    """Term by term over the fixture's lanes and live steps: against the
    same formula in float64, the XLA order the port's trace now takes is
    no farther than the order of separate operations it had before, in
    the median of every term of the search (the samples, the residuals,
    the Huber weights, the terms, the energies, the best and second
    minima and their ratio)."""
    errs = {}
    for frame in FRAMES:
        ref = tr.search_terms(FIX, frame, "xla", torch.float64)
        for order in ("xla", "separate"):
            got = tr.search_terms(FIX, frame, order, torch.float32)
            for k in tr.TERMS:
                errs.setdefault((k, order), []).append(
                    tr.term_errors(got, ref, k))
    for k in tr.TERMS:
        med = {o: np.median(np.concatenate(errs[(k, o)]))
               for o in ("xla", "separate")}
        assert med["xla"] <= med["separate"], (k, med)
