"""frontend/immature: pools, the flat arena, the epipolar trace and the
depth-only activation against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_utils import close, equal, j32, npy, plane_frames, t32, tt

from ldso_tpu.config import Config as JC, PATTERN
from ldso_tpu.frontend import detector as jdet
from ldso_tpu.frontend import immature as jim
from ldso_tpu.ops.preprocess import make_pyramid as jmp
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.frontend import immature as tim
from ldso_tpu_torch.ops.preprocess import make_pyramid as tmp
from ldso_tpu_torch.utils import convert

CAP = 512


@pytest.fixture(scope="module")
def seq():
    calib, poses, imgs, ideps = plane_frames(4, 256, 192)
    pj = [jmp(jnp.asarray(im), calib.levels) for im in imgs]
    pt = [tmp(t32(im), calib.levels) for im in imgs]
    gp = jdet.detect_grid_params(192, 256, 400)
    status = np.asarray(jdet.detect_status_map(pj[0].dI[0], pj[0].abs_grad[0], *gp))
    return calib, poses, pj, pt, ideps, status


def _transforms(calib, poses, host, tgt, lvl=0):
    T = poses[tgt] @ np.linalg.inv(poses[host])
    K, Ki = calib.K(lvl), calib.Ki(0)
    return ((K @ T[:3, :3] @ Ki).astype(np.float32),
            (K @ T[:3, 3]).astype(np.float32), T)


def test_make_pool(seq):
    """Positions from the padded nonzero exact; bilinear colours and
    weights bit-equal (same factorization)."""
    calib, poses, pj, pt, ideps, status = seq
    qj = jim.make_pool(jnp.asarray(status), pj[0].dI[0], CAP, JC())
    qt = tim.make_pool(tt(status), pt[0].dI[0], CAP, TC())
    for f in jim.ImmaturePool._fields:
        close(getattr(qt, f), getattr(qj, f), 1e-6, 1e-5, f)
    equal(qt.valid, qj.valid)


def test_search_samples_match_packed_pattern():
    """The trace search's unrotated integer-pattern bilinear samples equal
    the JAX packed implementation exactly, border clamps included."""
    from ldso_tpu.ops.interp import (bilinear_packed_pattern,
                                     pack_pattern_bilinear)
    rng = np.random.RandomState(0)
    img = (rng.rand(40, 50) * 255).astype(np.float32)
    x = rng.uniform(-2, 52, (30, 20)).astype(np.float32)
    y = rng.uniform(-2, 42, (30, 20)).astype(np.float32)
    ref = bilinear_packed_pattern(pack_pattern_bilinear(j32(img), PATTERN),
                                  j32(x), j32(y), 8)
    got = tim._search_samples(t32(img), t32(x), t32(y),
                              torch.tensor(PATTERN, dtype=torch.int64))
    close(got, ref, 0, 0, "search samples")


def test_nearest_samples_match_packed_pattern():
    """The nearest search's unrotated integer-pattern taps equal the JAX
    packed implementation exactly: half-to-even rounding, the centre clamp
    and each tap's border clamp (pack_pattern's edge repeat)."""
    from ldso_tpu.ops.interp import nearest_packed_pattern, pack_pattern
    rng = np.random.RandomState(1)
    img = (rng.rand(40, 50) * 255).astype(np.float32)
    x = rng.uniform(-2, 52, (30, 20)).astype(np.float32)
    y = rng.uniform(-2, 42, (30, 20)).astype(np.float32)
    x[0, :4] = [2.5, 3.5, -0.5, 48.5]          # ties round to even
    y[0, :4] = [2.5, 3.5, 39.5, 0.5]
    ref = nearest_packed_pattern(pack_pattern(j32(img), PATTERN), j32(x), j32(y))
    got = tim._nearest_samples(t32(img), t32(x), t32(y),
                               torch.tensor(PATTERN, dtype=torch.int64))
    close(got, ref, 0, 0, "nearest samples")


def _pools(seq):
    calib, poses, pj, pt, ideps, status = seq
    qj = jim.make_pool(jnp.asarray(status), pj[0].dI[0], CAP, JC())
    return qj, convert.pool_to_torch(qj)


def test_trace_twice(seq):
    """Two traces (uninitialized -> interval, then a narrowing one), each
    started from the same JAX state: the SSD argmin (first minimum, as
    jnp.argmin), the GN refinement and the status precedence agree;
    intervals within 1e-4 relative (float32 projections)."""
    calib, poses, pj, pt, ideps, status = seq
    qj, qt = _pools(seq)
    for tgt in (1, 3):
        KRKi, Kt, _ = _transforms(calib, poses, 0, tgt)
        aff = np.array([1.0, 0.0], np.float32)
        qt = convert.pool_to_torch(qj)       # each trace from one state
        qj = jim.trace(qj, pj[tgt].dI[0], j32(KRKi), j32(Kt), j32(aff), calib, JC())
        qt = tim.trace(qt, pt[tgt].dI[0], t32(KRKi), t32(Kt), t32(aff), calib, TC())
        equal(qt.status, qj.status, f"status after frame {tgt}")
        for f in ("idepth_min", "idepth_max", "last_u", "last_v",
                  "last_interval"):
            close(getattr(qt, f), getattr(qj, f), 1e-4, 1e-4, f"{f} frame {tgt}")
        # quality is a ratio of two SSD minima; each sum carries ~1e-5
        # relative rounding (XLA contracts the Huber terms into FMAs) and
        # near-equal minima amplify it
        close(qt.quality, qj.quality, 2e-3, 1e-4, f"quality frame {tgt}")
    assert (npy(qt.status) == jim.IPS_GOOD).sum() > 50


@pytest.mark.parametrize("packed,nearest,refine", [
    (False, False, 0), (True, True, 0), (True, True, 2), (False, True, 0),
    (False, True, 2)])
def test_trace_searches(seq, packed, nearest, refine):
    """The trace's other discrete searches (the reference's bilinear search
    over the rotated pattern; nearest over the unrotated or the rotated
    pattern, with and without the bilinear re-score of +-refine steps),
    each trace started from the same JAX state: statuses equal, intervals
    within 1e-4 relative, quality within 2e-3, as test_trace_twice."""
    import dataclasses
    calib, poses, pj, pt, ideps, status = seq
    kw = dict(trace_packed=packed, trace_search_nearest=nearest,
              trace_refine_steps=refine)
    jc, tc = dataclasses.replace(JC(), **kw), dataclasses.replace(TC(), **kw)
    qj, _ = _pools(seq)
    for tgt in (1, 3):
        KRKi, Kt, _ = _transforms(calib, poses, 0, tgt)
        aff = np.array([1.0, 0.0], np.float32)
        qt = convert.pool_to_torch(qj)
        qj = jim.trace(qj, pj[tgt].dI[0], j32(KRKi), j32(Kt), j32(aff), calib, jc)
        qt = tim.trace(qt, pt[tgt].dI[0], t32(KRKi), t32(Kt), t32(aff), calib, tc)
        equal(qt.status, qj.status, f"status after frame {tgt}")
        for f in ("idepth_min", "idepth_max", "last_u", "last_v",
                  "last_interval"):
            close(getattr(qt, f), getattr(qj, f), 1e-4, 1e-4, f"{f} frame {tgt}")
        close(qt.quality, qj.quality, 2e-3, 1e-4, f"quality frame {tgt}")
    assert (npy(qt.status) == jim.IPS_GOOD).sum() > 50


def test_arena_ops(seq):
    """Slot allocation, compaction (stable), counts/watermark, the host
    shift and masking: exact; the pattern weights and gradH carry
    make_pool's float32 rounding (XLA contracts their sums into FMAs), so
    float fields compare within 1e-4 relative."""
    calib, poses, pj, pt, ideps, status = seq
    aj = jim.empty_arena(2 * CAP, JC())
    at = tim.empty_arena(2 * CAP, TC(), "cpu")
    rng = np.random.RandomState(1)
    for host in (0, 1, 2):
        st = status * (rng.rand(*status.shape) < 0.7)
        aj = jim.arena_add_from_status(aj, jnp.asarray(st), pj[host].dI[0],
                                       jnp.int32(host), CAP, JC())
        at = tim.arena_add_from_status(at, tt(st), pt[host].dI[0], host, CAP, TC())
        kill = rng.rand(2 * CAP) < 0.3
        aj = jim.arena_mask(aj, jnp.asarray(kill))
        at = tim.arena_mask(at, torch.from_numpy(kill))
        aj = jim.arena_compact(aj)
        at = tim.arena_compact(at)
    for f in jim.ImmaturePool._fields:
        close(getattr(at.pool, f), getattr(aj.pool, f), 1e-4, 0, f)
    equal(at.pool.valid, aj.pool.valid)
    equal(at.pool.u, aj.pool.u)
    equal(at.host, aj.host)
    equal(tim.arena_counts_and_watermark(at, 8), jim.arena_counts_and_watermark(aj, 8))
    assert tim.arena_watermark(at) == int(np.asarray(
        jim.arena_counts_and_watermark(aj, 8))[-1])
    aj = jim.arena_marg_shift(aj, jnp.int32(1))
    at = tim.arena_marg_shift(at, 1)
    equal(at.host, aj.host)
    equal(at.pool.valid, aj.pool.valid)
    back = convert.arena_to_numpy(convert.arena_to_torch(aj))
    equal(back["host"], aj.host)


def test_trace_arena_prefix(seq):
    """Per-candidate transforms gathered by host slot; tracing only the
    live prefix leaves the dead lanes as they were."""
    calib, poses, pj, pt, ideps, status = seq
    aj = jim.empty_arena(2 * CAP, JC())
    aj = jim.arena_add_from_status(aj, jnp.asarray(status), pj[0].dI[0],
                                   jnp.int32(0), CAP, JC())
    aj = jim.arena_add_from_status(aj, jnp.asarray(status), pj[1].dI[0],
                                   jnp.int32(1), CAP, JC())
    at = convert.arena_to_torch(aj)
    F = 8
    KRKis = np.tile(np.eye(3, dtype=np.float32), (F, 1, 1))
    Kts = np.zeros((F, 3), np.float32)
    affs = np.tile(np.array([1.0, 0.0], np.float32), (F, 1))
    for h in (0, 1):
        KRKis[h], Kts[h], _ = _transforms(calib, poses, h, 2)
    n = tim.arena_watermark(at)
    oj = jim.trace_arena_prefix(aj, pj[2].dI[0], j32(KRKis), j32(Kts), j32(affs),
                                calib, JC(), 1024)
    ot = tim.trace_arena_prefix(at, pt[2].dI[0], t32(KRKis), t32(Kts), t32(affs),
                                calib, TC(), n)
    equal(ot.pool.status, oj.pool.status)
    close(ot.pool.idepth_max, oj.pool.idepth_max, 1e-4, 1e-4, "idepth_max")


def test_activate(seq):
    """Depth-only LM against the window: idepths within 1e-4 relative,
    accept flags and good-residual counts equal."""
    calib, poses, pj, pt, ideps, status = seq
    qj, qt = _pools(seq)
    rng = np.random.RandomState(2)
    n = CAP
    u, v = np.asarray(qj.u).astype(int), np.asarray(qj.v).astype(int)
    idep0 = (ideps[0][v, u] * (1.0 + 0.05 * rng.randn(n))).astype(np.float32)
    T = 4
    Rs = np.tile(np.eye(3, dtype=np.float32), (T, 1, 1))
    ts = np.zeros((T, 3), np.float32)
    affs = np.tile(np.array([1.0, 0.0], np.float32), (T, 1))
    mask = np.array([False, True, True, True])
    for k in range(1, T):
        Tr = poses[k] @ np.linalg.inv(poses[0])
        Rs[k], ts[k] = Tr[:3, :3], Tr[:3, 3]
    dIs_j = jnp.stack([p.dI[0] for p in pj])
    dIs_t = torch.stack([p.dI[0] for p in pt])
    valid = np.array(qj.valid)
    oj = jim.activate(qj.u, qj.v, qj.color, qj.weights, qj.energy_th, j32(idep0),
                      jnp.asarray(valid), j32(Rs), j32(ts), j32(affs),
                      jnp.asarray(mask), dIs_j, calib, JC())
    ot = tim.activate(qt.u, qt.v, qt.color, qt.weights, qt.energy_th, t32(idep0),
                      torch.from_numpy(valid), t32(Rs), t32(ts), t32(affs),
                      torch.from_numpy(mask), dIs_t, calib, TC())
    close(ot[0], oj[0], 1e-4, 1e-6, "idepth")
    equal(ot[1], oj[1], "ok")
    equal(ot[2], oj[2], "n_good")
    equal(ot[3], oj[3], "states")
    assert npy(ot[1]).sum() > 100


def test_overflow_drops_and_cap_truncation(seq):
    """Pins two traps: make_pool's padded nonzero truncates at `cap` in
    index order, and arena_add drops candidates beyond the free slots
    (JAX scatters them to an out-of-range slot with mode="drop")."""
    calib, poses, pj, pt, ideps, status = seq
    qj = jim.make_pool(jnp.asarray(status), pj[0].dI[0], 128, JC())
    qt = tim.make_pool(tt(status), pt[0].dI[0], 128, TC())
    equal(qt.u, qj.u)
    equal(qt.v, qj.v)
    aj = jim.empty_arena(200, JC())
    at = tim.empty_arena(200, TC(), "cpu")
    for host in (0, 1):
        aj = jim.arena_add_from_status(aj, jnp.asarray(status), pj[host].dI[0],
                                       jnp.int32(host), CAP, JC())
        at = tim.arena_add_from_status(at, tt(status), pt[host].dI[0], host,
                                       CAP, TC())
    assert npy(at.pool.valid).all() and (npy(at.host) == 0).all()
    equal(at.host, aj.host)
    equal(at.pool.u, aj.pool.u)
