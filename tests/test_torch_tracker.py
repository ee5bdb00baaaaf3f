"""frontend/tracker: the port against the JAX coarse tracker on the same
reference keyframe and frames."""

import contextlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_kernel_checks as kernel_checks
from torch_port_utils import close, equal, j32, npy, plane_frames, t32

from ldso_tpu.config import Config as JC
from ldso_tpu.frontend import tracker as jtr
from ldso_tpu.ops.preprocess import make_pyramid as jmp
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.frontend import tracker as ttr
from ldso_tpu_torch.ops.preprocess import make_pyramid as tmp
from ldso_tpu_torch.utils import convert

CAPS = (4096, 2048, 1024)


@pytest.fixture(scope="module")
def scene():
    calib, poses, imgs, ideps = plane_frames(4, 256, 192)
    pj = [jmp(jnp.asarray(im), calib.levels) for im in imgs]
    pt = [tmp(t32(im), calib.levels) for im in imgs]
    return calib, poses, pj, pt, ideps


def _refs(scene, caps=CAPS):
    calib, poses, pj, pt, ideps = scene
    rj = jtr.make_tracker_ref_from_idepth(j32(ideps[0]), pj[0], calib, caps,
                                          stride=2)
    rt = ttr.make_tracker_ref_from_idepth(t32(ideps[0]), pt[0], calib, caps,
                                          stride=2)
    return rj, rt


@pytest.mark.parametrize("caps", [CAPS, (1000, 300, 100)])
def test_make_tracker_ref(scene, caps):
    """Point lists: positions, validity and colours exact (the padded
    nonzero truncates at the cap in the same order); idepths within 1e-6
    relative (the splat adds in another order)."""
    rj, rt = _refs(scene, caps)
    for lvl in range(len(caps)):
        equal(rt.valid[lvl], rj.valid[lvl], f"valid {lvl}")
        equal(rt.points[lvl][:, [0, 1, 3]], np.asarray(rj.points[lvl])[:, [0, 1, 3]],
              f"u,v,color {lvl}")
        close(rt.points[lvl][:, 2], rj.points[lvl][:, 2], 1e-6, 0, f"idepth {lvl}")


def test_splat_with_shared_pixels():
    """Random projections with many points per pixel: the scatter-add sums
    in another order, compared within 1e-5 relative."""
    from ldso_tpu.synthetic import default_calib
    calib = default_calib(128, 96)
    rng = np.random.RandomState(0)
    n = 3000
    u = rng.uniform(-2, 130, n).astype(np.float32)
    v = rng.uniform(-2, 98, n).astype(np.float32)
    u[:1000] = np.round(u[:1000] / 4) * 4
    idep = rng.uniform(0.2, 1.0, n).astype(np.float32)
    w = rng.uniform(0.1, 2.0, n).astype(np.float32)
    ok = rng.rand(n) > 0.2
    img = rng.rand(96, 128).astype(np.float32) * 255
    pj = jmp(j32(img), calib.levels)
    pt = tmp(t32(img), calib.levels)
    caps = (4096, 2048)
    rj = jtr.make_tracker_ref(j32(u), j32(v), j32(idep), j32(w), jnp.asarray(ok),
                              pj.dI, jnp.float32(1.0), j32([0.1, 2.0]), calib, caps)
    rt = ttr.make_tracker_ref(t32(u), t32(v), t32(idep), t32(w),
                              torch.from_numpy(ok), pt.dI, 1.0, t32([0.1, 2.0]),
                              calib, caps)
    for lvl in range(calib.levels):
        equal(rt.valid[lvl], rj.valid[lvl])
        close(rt.points[lvl], rj.points[lvl], 1e-5, 1e-6, f"level {lvl}")


def test_calc_res_and_gs(scene):
    """One warp pass: energies within 1e-4 relative (float32 sums of
    ~1e3 terms in another order), counts exact; H, b within 1e-3."""
    calib, poses, pj, pt, ideps = scene
    rj, rt = _refs(scene)
    T = (poses[1] @ np.linalg.inv(poses[0])).astype(np.float32)
    aff = np.array([0.02, 1.5], np.float32)
    cfg_j, cfg_t = JC(), TC()
    for lvl in (0, 2):
        bj, sj = jtr._calc_res(rj, pj[1], lvl, j32(T), j32(aff), jnp.float32(1.0),
                               jnp.float32(20.0), calib, cfg_j)
        bt, st = ttr._calc_res(rt, pt[1], lvl, t32(T)[None], t32(aff)[None],
                               1.0, t32([20.0]), calib, cfg_t)
        close(st[0], sj, 1e-4, 1e-4, f"stats {lvl}")
        equal(st[0, 1], np.asarray(sj)[1])
        Hj, gj, _ = jtr._calc_gs(bj, lvl, rj, j32(aff), jnp.float32(1.0), calib)
        Ht, gt, _ = ttr._calc_gs(bt, lvl, rt, t32(aff)[None], 1.0, calib)
        scale = np.abs(np.asarray(Hj)).max()
        close(Ht[0], Hj, 1e-3, 1e-5 * scale, f"H {lvl}")
        close(gt[0], gj, 1e-3, 1e-5 * np.abs(np.asarray(gj)).max(), f"b {lvl}")
        lam = np.float32(0.01)
        close(ttr._solve_inc(Ht, gt, t32([lam]), cfg_t)[0],
              jtr._solve_inc(Hj, gj, jnp.float32(lam), cfg_j), 1e-3, 1e-6, "inc")


def test_track_frame(scene):
    """The full coarse-to-fine LM from the identity: the LM amplifies
    float32 rounding, so poses agree to 1e-4 and residuals to 1e-3."""
    calib, poses, pj, pt, ideps = scene
    rj, rt = _refs(scene)
    no_abort = np.full(calib.levels, 1e9, np.float32)
    for k in (1, 3):
        oj = jtr.track_frame(rj, pj[k], jnp.eye(4, dtype=jnp.float32),
                             j32([0, 0]), jnp.float32(1.0), j32(no_abort),
                             calib, JC(), calib.levels - 1)
        ot = ttr.track_frame(rt, pt[k], torch.eye(4), t32([0, 0]), 1.0,
                             t32(no_abort), calib, TC(), calib.levels - 1)
        close(ot[0], oj[0], 0, 1e-4, f"T frame {k}")
        close(ot[1], oj[1], 0, 1e-3, "aff")
        equal(ot[2], oj[2], "ok")
        close(ot[3], oj[3], 1e-3, 1e-4, "residuals")
        close(ot[4], oj[4], 1e-3, 1e-4, "flow")
        # and it tracked: within 1e-3 of the ground-truth motion
        T_gt = poses[k] @ np.linalg.inv(poses[0])
        assert np.abs(npy(ot[0]) - T_gt).max() < 2e-3


def test_hypotheses_rank_and_batch(scene):
    """rank_hypotheses and the batched LM over a leading hypothesis axis
    match the JAX vmapped programs."""
    from ldso_tpu.math import lie_np
    calib, poses, pj, pt, ideps = scene
    rj, rt = _refs(scene)
    rng = np.random.RandomState(1)
    T_gt = poses[2] @ np.linalg.inv(poses[0])
    Ts = np.stack([lie_np.se3_exp(rng.randn(6) * 0.01) @ T_gt
                   for _ in range(6)]).astype(np.float32)
    Ts[5] = np.eye(4)
    cj = calib.levels - 1
    sj = jtr.rank_hypotheses(rj, pj[2], j32(Ts), j32([0, 0]), jnp.float32(1.0),
                             calib, JC(), cj)
    st = ttr.rank_hypotheses(rt, pt[2], t32(Ts), t32([0, 0]), 1.0, calib, TC(), cj)
    close(st, sj, 1e-4, 1e-4, "rank scores")
    abort = np.full(calib.levels, 1e9, np.float32)
    oj = jtr.track_frame_hypotheses(rj, pj[2], j32(Ts[:3]), j32([0, 0]),
                                    jnp.float32(1.0), j32(abort), calib, JC(), cj)
    ot = ttr.track_frame_hypotheses(rt, pt[2], t32(Ts[:3]), t32([0, 0]), 1.0,
                                    t32(abort), calib, TC(), cj)
    close(ot[0], oj[0], 0, 1e-4, "batched T")
    equal(ot[2], oj[2], "batched ok")
    close(ot[3], oj[3], 1e-3, 1e-4, "batched residuals")


def test_convert_tracker_ref_roundtrip(scene):
    rj, rt = _refs(scene)
    back = convert.tracker_ref_to_torch(rj)
    for lvl in range(len(CAPS)):
        equal(back.points[lvl], rj.points[lvl])
        equal(back.valid[lvl], rj.valid[lvl])
    d = convert.tracker_ref_to_numpy(back)
    equal(d["ref_aff"], rj.ref_aff)


_HOST_READS = ("__bool__", "item", "tolist", "cpu", "numpy")


def test_tracker_reads_only_its_graph_key_fields(scene):
    """The tracker's CUDA graphs are keyed on tracker.CONFIG_FIELDS, not
    the whole Config, so a FullSystem with another BA or trace knob shares
    them: the whole tracker path (full track, batch, ranking) reads no
    other Config field."""
    calib, poses, pj, pt, ideps = scene
    _, rt = _refs(scene)

    class Recorded:
        seen = set()

        def __getattr__(self, name):
            Recorded.seen.add(name)
            return getattr(TC(), name)

    cfg = Recorded()
    Ts = t32(np.stack([np.eye(4)] * 2))
    args = (t32([0, 0]), t32(1.0), t32(np.full(calib.levels, 1e9)))
    ttr.track_frame_hypotheses(rt, pt[1], Ts, *args, calib, cfg,
                               calib.levels - 1)
    ttr.rank_hypotheses(rt, pt[1], Ts, args[0], args[1], calib, cfg,
                        calib.levels - 1)
    assert Recorded.seen and Recorded.seen <= set(ttr.CONFIG_FIELDS), \
        Recorded.seen


def test_tracker_never_reads_the_host(scene, monkeypatch):
    """track_frame, track_frame_hypotheses and rank_hypotheses with every
    tensor method that reads a value to the host patched to raise, and
    torch.tensor and torch.as_tensor of a value that is not a tensor too
    (after a first call has made the tracker's constants): on the card the same calls are one graph replay
    that returns before the frame is tracked. The results equal an
    unpatched run bitwise."""
    calib, poses, pj, pt, ideps = scene
    _, rt = _refs(scene)
    cj = calib.levels - 1
    Ts = t32(np.stack([np.eye(4)] * 3))
    Ts[1, 0, 3] = 0.02
    args = (t32([0, 0]), t32(1.0), t32(np.full(calib.levels, 1e9)))

    def run():
        one = ttr.track_frame(rt, pt[1], torch.eye(4), *args, calib, TC(), cj)
        many = ttr.track_frame_hypotheses(rt, pt[2], Ts, *args, calib, TC(), cj)
        rank = ttr.rank_hypotheses(rt, pt[2], Ts, args[0], args[1], calib,
                                   TC(), cj)
        return list(one) + list(many) + [rank]

    want = run()

    def refuse(*a, **k):
        raise AssertionError("the tracker read a value to the host")
    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse)
    as_tensor = torch.as_tensor

    def tensors_only(x, *a, **k):
        if not isinstance(x, torch.Tensor):
            refuse()
        return as_tensor(x, *a, **k)
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", tensors_only)
    got = run()
    monkeypatch.undo()
    for g, w in zip(got, want):
        equal(g, w)


def _track_both(scene, k, T0, jc, tc):
    calib, poses, pj, pt, ideps = scene
    rj, rt = _refs(scene)
    no_abort = np.full(calib.levels, 1e9, np.float32)
    oj = jtr.track_frame(rj, pj[k], j32(T0), j32([0, 0]), jnp.float32(1.0),
                         j32(no_abort), calib, jc, calib.levels - 1)
    ot = ttr.track_frame(rt, pt[k], t32(T0), t32([0, 0]), t32(1.0),
                         t32(no_abort), calib, tc, calib.levels - 1)
    return oj, ot


def _repeats(monkeypatch):
    """Record each _level_block call's repeat flags and running members."""
    seen = []
    block = ttr._level_block

    def recorded(*a, **k):
        state, repeat = block(*a, **k)
        seen.append((bool(a[4].any()), bool(repeat.any())))
        return state, repeat
    monkeypatch.setattr(ttr, "_level_block", recorded)
    return seen


@pytest.mark.parametrize("case", ["lm_trip_limit", "cutoff_and_repeat"])
def test_track_frame_masked_trips_match_jax(scene, monkeypatch, case):
    """The fixed-trip loops against JAX's while loops where they stop on
    their limits: an LM that runs out of iterations (3 per level from a
    pose 2 cm off), and a cutoff of 5 that has to double from a pose 5 cm
    off (so the level repeats). The existing tolerances of
    test_track_frame."""
    calib, poses, pj, pt, ideps = scene
    T0 = (poses[1] @ np.linalg.inv(poses[0])).astype(np.float32)
    if case == "lm_trip_limit":
        T0[0, 3] += 0.02
        kw = dict(coarse_lm_iterations=(3,) * 6)
    else:
        T0[0, 3] += 0.05
        kw = dict(coarse_cutoff_th=5.0)
    seen = _repeats(monkeypatch)
    oj, ot = _track_both(scene, 1, T0, JC(**kw), TC(**kw))
    close(ot[0], oj[0], 0, 1e-4, "T")
    close(ot[1], oj[1], 0, 1e-3, "aff")
    equal(ot[2], oj[2], "ok")
    close(ot[3], oj[3], 1e-3, 1e-4, "residuals")
    close(ot[4], oj[4], 1e-3, 1e-4, "flow")
    # every level ran, then its repeat block (masked off unless wanted)
    assert len(seen) == 2 * calib.levels
    if case == "cutoff_and_repeat":
        assert any(rep for _, rep in seen[0::2])
        assert any(ran for ran, _ in seen[1::2])
        assert bool(ot[2])
    else:
        # the iteration cap binds: more iterations land elsewhere
        free = ttr.track_frame(*_refs(scene)[1:], pt[1], t32(T0), t32([0, 0]),
                               t32(1.0), t32(np.full(calib.levels, 1e9)),
                               calib, TC(), calib.levels - 1)
        assert not torch.equal(free[0], ot[0])


# ---------------------------------------------------------------------------
# K3, the tracker trip: its plain version against the JAX package, its
# wrapper on the CPU, and the launch bookkeeping of the captured tracker
# ---------------------------------------------------------------------------

CAPS4 = (4096, 2048, 1024, 512)
TRIP_CASES = ("out_of_bounds", "saturating", "nan_patch")


@pytest.fixture(scope="module")
def scene4():
    """640x480, the size whose pyramid has 4 levels, as the main path's."""
    calib, poses, imgs, ideps = plane_frames(2, 640, 480)
    assert calib.levels == 4
    pj = [jmp(jnp.asarray(im), calib.levels) for im in imgs]
    pt = [tmp(t32(im), calib.levels) for im in imgs]
    rj = jtr.make_tracker_ref_from_idepth(j32(ideps[0]), pj[0], calib, CAPS4,
                                          stride=2)
    rt = ttr.make_tracker_ref_from_idepth(t32(ideps[0]), pt[0], calib, CAPS4,
                                          stride=2)
    return calib, poses, pj[1], pt[1], rj, rt


def _trip_inputs(poses, batch, case=None):
    """(T, aff, cutoff) as numpy float32: `batch` poses about the true
    motion (member m a few mm off), affines per member and the production
    cutoff; the edge cases as kernel_checks.trip_case makes them."""
    rng = np.random.RandomState(11)
    T_gt = poses[1] @ np.linalg.inv(poses[0])
    T = np.stack([T_gt] * batch).astype(np.float32)
    T[1:, :3, 3] += rng.randn(batch - 1, 3).astype(np.float32) * 0.005
    aff = np.stack([[0.02 * m, 1.5 - 0.3 * m] for m in range(batch)])
    cut = np.full(batch, TC().coarse_cutoff_th)
    if case == "out_of_bounds":      # off the image, or behind the camera
        T[0::2, 0, 3] += 100.0
        T[1::2, 2, 3] -= 100.0
    elif case == "saturating":       # most residuals beyond the cutoff
        aff[:, 1] += 40.0
    return T, aff.astype(np.float32), cut.astype(np.float32)


def _nan_patch(pj, pt, lvl):
    """Both pyramids with a NaN patch in all three channels of level lvl."""
    h, w = pt.dI[lvl].shape[:2]
    sl = (slice(0, h // 2), slice(w // 4, w // 2))      # as trip_case's
    dj = np.array(pj.dI[lvl])
    dj[sl] = np.nan
    dt = pt.dI[lvl].clone()
    dt[sl] = float("nan")
    pj = pj._replace(dI=tuple(jnp.asarray(dj) if i == lvl else d
                              for i, d in enumerate(pj.dI)))
    pt = pt._replace(dI=tuple(dt if i == lvl else d
                              for i, d in enumerate(pt.dI)))
    return pj, pt


def _jax_trip(rj, pj, lvl, T, aff, cut, calib, flow):
    """The JAX package's _calc_res then _calc_gs, member by member."""
    out = [[], [], []]
    for m in range(T.shape[0]):
        bj, sj = jtr._calc_res(rj, pj, lvl, j32(T[m]), j32(aff[m]),
                               jnp.float32(1.0), jnp.float32(cut[m]), calib,
                               JC(), compute_flow=flow)
        Hj, gj, _ = jtr._calc_gs(bj, lvl, rj, j32(aff[m]), jnp.float32(1.0),
                                 calib)
        for o, x in zip(out, (sj, Hj, gj)):
            o.append(np.asarray(x))
    return [np.stack(o) for o in out]


def _close_trip(port, jax_out, what, allowance=None):
    """Within torch_kernel_checks' tolerances (stats 1e-4 with numTerms
    exact; H 1e-3 relative or 1e-5 of its largest entry, as
    test_calc_res_and_gs holds it; b 1e-3 relative or 1e-4 of its largest
    entry) plus the allowance for points at the cutoff."""
    err, share, same_n = kernel_checks.trip_err(
        port, [torch.from_numpy(x) for x in jax_out], allowance)
    assert same_n and share <= 1.0, (what, err, share, same_n)


@pytest.mark.parametrize("flow", [True, False])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_tracker_trip_ref_matches_jax(scene4, lvl, batch, flow):
    """tracker_trip_ref (the plain version of K3) against the JAX package's
    _calc_res followed by _calc_gs, at every level of the 4-level pyramid,
    at batch 1 and 8, with the flow sums on and off."""
    calib, poses, pj, pt, rj, rt = scene4
    T, aff, cut = _trip_inputs(poses, batch)
    got = ttr.tracker_trip_ref(rt, pt, lvl, t32(T), t32(aff), t32(1.0),
                               t32(cut), calib, TC(), compute_flow=flow)
    _close_trip(got, _jax_trip(rj, pj, lvl, T, aff, cut, calib, flow),
                f"level {lvl} batch {batch} flow {flow}")
    assert float(got[0][0, 1]) > 0
    if not flow:
        assert not npy(got[0][:, [2, 4]]).any()


@pytest.mark.parametrize("case", TRIP_CASES)
def test_tracker_trip_ref_edge_cases_match_jax(scene4, case):
    """The edge cases at every level, batch 8: a pose that puts every point
    out of bounds (numTerms 0), a brightness offset that saturates most
    terms at the production cutoff, and a NaN patch in the level (both
    packages' H and b turn NaN there; the stats, which select with
    `where`, stay finite and agree)."""
    calib, poses, pj0, pt0, rj, rt = scene4
    T, aff, cut = _trip_inputs(poses, 8, case)
    for lvl in range(calib.levels):
        pj, pt = (_nan_patch(pj0, pt0, lvl) if case == "nan_patch"
                  else (pj0, pt0))
        args = (rt, pt, lvl, t32(T), t32(aff), t32(1.0), t32(cut), calib,
                TC(), lvl == 0)
        got = ttr.tracker_trip_ref(*args)
        _close_trip(got, _jax_trip(rj, pj, lvl, T, aff, cut, calib, lvl == 0),
                    f"{case} level {lvl}", kernel_checks.trip_allowance(*args))
        n = npy(got[0][:, 1])
        if case == "out_of_bounds":
            assert not n.any()
        elif case == "saturating":
            assert (npy(got[0][:, 5]) > 0.5).all()
        else:
            assert np.isfinite(npy(got[0])).all() and n.all()


def test_tracker_trip_wrapper_is_the_plain_version_on_the_cpu(scene4):
    """On CPU tensors ops/cuda_kernels.tracker_trip returns the plain
    version's result bitwise (NaN payloads included) and launches
    nothing."""
    from ldso_tpu_torch.ops import cuda_kernels
    calib, poses, pj, pt, rj, rt = scene4
    before = dict(cuda_kernels.LAUNCHES)
    for case in (None,) + TRIP_CASES:
        T, aff, cut = _trip_inputs(poses, 8, case)
        p = _nan_patch(pj, pt, 0)[1] if case == "nan_patch" else pt
        for lvl in (0, 3):
            args = (rt, p, lvl, t32(T), t32(aff), t32(1.0), t32(cut), calib,
                    TC(), lvl == 0)
            for g, w in zip(cuda_kernels.tracker_trip(*args),
                            ttr.tracker_trip_ref(*args)):
                assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert cuda_kernels.LAUNCHES == before


def test_tracker_trip_members_are_independent(scene4):
    """Each member's stats, H and b come from its own rows alone: member m
    of a batch of 8 has the same bits whatever the other members' poses
    and cutoffs. So the cutoff loop may select H and b per member (as
    `_level_block` does) instead of recomputing them from the selected
    residuals."""
    calib, poses, pj, pt, rj, rt = scene4
    T, aff, cut = _trip_inputs(poses, 8)
    T2, cut2 = T.copy(), cut * 2.0
    T2[:, 0, 3] += 0.01
    for lvl in range(calib.levels):
        a = ttr.tracker_trip_ref(rt, pt, lvl, t32(T), t32(aff), t32(1.0),
                                 t32(cut), calib, TC(), lvl == 0)
        for m in (0, 5):
            Tm, cm = T2.copy(), cut2.copy()
            Tm[m], cm[m] = T[m], cut[m]
            b = ttr.tracker_trip_ref(rt, pt, lvl, t32(Tm), t32(aff),
                                     t32(1.0), t32(cm), calib, TC(), lvl == 0)
            for x, y in zip(a, b):
                equal(x[m], y[m], f"level {lvl} member {m}")
                assert not torch.equal(x[m - 1], y[m - 1])


def test_track_batch_runs_every_trip_through_the_wrapper(scene4, monkeypatch):
    """_track_batch calls the K3 wrappers trips_per_track times (316 at
    640x480: per level 1 trip, 6 cutoff trips and coarse_lm_iterations LM
    trips, twice with the level repeat: 8 tracker_trip, 48 cutoff_trip and
    260 lm_trip calls, each one launch on the card) and rank_hypotheses
    calls tracker_trip once, and on the CPU its results are those of the
    plain versions called directly, bit for bit."""
    from ldso_tpu_torch.ops import cuda_kernels
    calib, poses, pj, pt, rj, rt = scene4
    T, aff, _ = _trip_inputs(poses, 2)
    L = calib.levels
    args = (rt, pt, t32(T), t32([0, 0]), t32(1.0), t32(np.full(L, 1e9)),
            calib, TC(), L - 1)
    calls = []
    names = ("tracker_trip", "cutoff_trip", "lm_trip")
    wrappers = {n: getattr(cuda_kernels, n) for n in names}

    def counted(name):
        def call(*a, **k):
            calls.append((name, a[2]))
            return wrappers[name](*a, **k)
        return call
    for n in names:
        monkeypatch.setattr(cuda_kernels, n, counted(n))
    got = ttr._track_batch(*args)
    rank = ttr.rank_hypotheses(rt, pt, t32(T), t32([0, 0]), t32(1.0), calib,
                               TC(), L - 1)
    assert ttr.trips_per_track(TC(), L, L - 1) == 316
    by_mode = {n: sum(1 for c in calls if c[0] == n) for n in names}
    assert by_mode == {"tracker_trip": 8 + 1, "cutoff_trip": 48,
                       "lm_trip": 260}
    assert len(calls) == 316 + 1 and calls[-1] == ("tracker_trip", L - 1)
    assert sorted({lvl for _, lvl in calls}) == list(range(L))
    monkeypatch.setattr(cuda_kernels, "tracker_trip", ttr.tracker_trip_ref)
    monkeypatch.setattr(cuda_kernels, "cutoff_trip", ttr.cutoff_trip_ref)
    monkeypatch.setattr(cuda_kernels, "lm_trip", ttr.lm_trip_ref)
    for g, w in zip(list(got) + [rank], list(ttr._track_batch(*args))
                    + [ttr.rank_hypotheses(rt, pt, t32(T), t32([0, 0]),
                                           t32(1.0), calib, TC(), L - 1)]):
        assert _bits(g, w)


def _bits(a, b):
    """Bitwise equality of two tensors, NaN payloads included."""
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


class _FakeGraph:
    uploaded = False

    def replay(self):
        assert self.uploaded, "a graph replayed before its upload"


def _fake_upload(graph, stream):
    graph.uploaded = True


@contextlib.contextmanager
def _fake_capture(graph, stream=None, **kw):
    yield


class _FakeStream:
    def __init__(self, *a, **k):
        pass

    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        pass


class _FakeEvent:
    def record(self, stream=None):
        pass


def _fake_cuda(monkeypatch):
    """The CUDA pieces utils.graphs uses, faked on the CPU."""
    from ldso_tpu_torch.utils import graphs
    monkeypatch.setattr(graphs, "upload", _fake_upload)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)


def test_captured_graph_counts_kernel_launches_at_each_replay(monkeypatch):
    """utils.graphs.Captured with the CUDA pieces faked on the CPU and a
    program that counts launches as a kernel wrapper does: the eager
    warm-up counts as launches, the capture only into the graph's tally,
    and each replay adds the tally to LAUNCHES; a launch on another thread
    during a capture counts as usual."""
    from ldso_tpu_torch.ops import cuda_kernels
    from ldso_tpu_torch.utils import graphs
    _fake_cuda(monkeypatch)
    seen_elsewhere = []

    def program(x):
        for _ in range(3):
            cuda_kernels._count("tracker_trip")
        cuda_kernels._count("distance_transform")
        if not seen_elsewhere:
            t = threading.Thread(
                target=lambda: cuda_kernels._count("distance_transform"))
            t.start()
            t.join()
            seen_elsewhere.append(True)
        return (x + 1,)

    cuda_kernels.reset_launch_counts()
    g = graphs.Captured(program, (torch.zeros(2),))
    # warm-up: 3 + 1 launches; the thread's launch during the warm-up: 1
    assert cuda_kernels.LAUNCHES == {"distance_transform": 2,
                                     "tracker_trip": 3, "ba_projector": 0,
                                     "trace": 0, "activate": 0,
                                     "ba_linearize": 0, "ba_accumulate": 0,
                                     "pyramid": 0, "rectify": 0}
    assert g.launches == {"tracker_trip": 3, "distance_transform": 1}
    for k in range(1, 3):
        out = g.replay((torch.ones(2),))
        assert cuda_kernels.LAUNCHES == {"distance_transform": 2 + k,
                                         "tracker_trip": 3 + 3 * k,
                                         "ba_projector": 0, "trace": 0,
                                         "activate": 0, "ba_linearize": 0,
                                         "ba_accumulate": 0, "pyramid": 0,
                                         "rectify": 0}
    assert torch.equal(out[0], torch.full((2,), 1.0))
    # a family's launches: each graph's warm-up and replays times its tally
    family = graphs.Programs()
    family.graphs["key"] = g
    assert g.replays == 2
    assert family.launches("tracker_trip") == 3 * 3
    assert family.launches("ba_linearize") == 0
    cuda_kernels.reset_launch_counts()
    with cuda_kernels.recording_launches() as tally:
        cuda_kernels._count("tracker_trip")
        t = threading.Thread(target=lambda: cuda_kernels._count("tracker_trip"))
        t.start()
        t.join()
    assert tally == {"tracker_trip": 1}
    assert cuda_kernels.LAUNCHES["tracker_trip"] == 1


def test_programs_count_the_wait_for_a_graph_lock(monkeypatch):
    """A replay that finds its graph's lock held waits, and the family's
    lock_wait_s counts that wait (the bench reads it per leg)."""
    import threading
    import time
    from ldso_tpu_torch.utils import graphs
    _fake_cuda(monkeypatch)
    fam = graphs.Programs()
    x = (torch.zeros(2),)
    fam.replay("k", lambda x: (x + 1,), x)
    assert fam.lock_wait_s() < 0.05
    g = fam.graphs[graphs._key("k", x)]
    started = threading.Event()

    def hold():
        with g.lock:
            started.set()
            time.sleep(0.2)
    t = threading.Thread(target=hold)
    t.start()
    started.wait(5)
    out = fam.replay("k", lambda x: (x + 1,), x)
    t.join(5)
    assert not t.is_alive()
    assert torch.equal(out[0], torch.ones(2))
    assert 0.1 < fam.lock_wait_s() < 5
    assert fam.counts["replays"] == 2 and fam.counts["count"] == 1


def test_trip_launches_are_counted_by_mode():
    """A K3 launch in a mode counts once in LAUNCHES["tracker_trip"] and
    once in TRIP_LAUNCHES[mode], directly and through a graph's tally at
    each replay."""
    from ldso_tpu_torch.ops import cuda_kernels
    cuda_kernels.reset_launch_counts()
    cuda_kernels._count("tracker_trip", "lm")
    with cuda_kernels.recording_launches() as tally:
        cuda_kernels._count("tracker_trip", "cutoff")
        cuda_kernels._count("tracker_trip", "trip")
    assert tally == {"tracker_trip": 2, "tracker_trip.cutoff": 1,
                     "tracker_trip.trip": 1}
    assert cuda_kernels.LAUNCHES["tracker_trip"] == 1
    assert cuda_kernels.TRIP_LAUNCHES == {"trip": 0, "cutoff": 0, "lm": 1}
    for _ in range(2):
        cuda_kernels.add_launches(tally)
    assert cuda_kernels.LAUNCHES["tracker_trip"] == 5
    assert cuda_kernels.TRIP_LAUNCHES == {"trip": 2, "cutoff": 2, "lm": 1}
    cuda_kernels.reset_launch_counts()
    assert cuda_kernels.TRIP_LAUNCHES == {"trip": 0, "cutoff": 0, "lm": 0}


@pytest.mark.parametrize("mode", ["trip", "cutoff", "lm"])
def test_tracker_trip_vmap_rule_launches_once_for_the_vmapped_axis(
        monkeypatch, mode):
    """torch.func.vmap over each K3 operator (as parallel/replay's batched
    tracker runs them) reaches one launch with the vmapped axis as the
    sequence axis, inputs without that axis repeated along it. The
    launcher is faked on the CPU by one that computes, per sequence and
    member, outputs that depend on every input."""
    from ldso_tpu_torch.ops import cuda_kernels
    launched = []

    def fake(mode_, x, params, flow):
        launched.append((mode_, x["points"].shape[0]))
        S, B = x["T"].shape[:2]
        e = ((x["points"].sum((1, 2)) * x["valid"].sum(1)
              + x["dI"].sum((1, 2, 3)) + x["ref_aff"][:, 1]
              + x["ref_exposure"] + 2.0 * x["new_exposure"])[:, None]
             + x["T"].sum((2, 3)) + x["aff"].sum(2) + params[0] + flow)
        for name, t in x.items():
            if name in ("cutoff", "cutoff_rep", "lam", "run", "done"):
                e = e + t
            elif name in ("stats", "H", "b"):
                e = e + t.reshape(S, B, -1).sum(2)
        shapes = dict(T=(4, 4), aff=(2,), stats=(6,), H=(8, 8), b=(8,),
                      cutoff_rep=(), lam=(), done=())
        out = []
        for k, name in enumerate(cuda_kernels.TRIP_OUTPUTS[mode_]):
            v = (e + k).reshape((S, B) + (1,) * len(shapes[name]))
            v = v.expand((S, B) + shapes[name]).clone()
            out.append(v > 20.0 if name == "done" else v)
        return tuple(out)
    monkeypatch.setattr(cuda_kernels, "_trip_launch", fake)
    rng = np.random.RandomState(3)
    S, N, B = 3, 10, 2
    pts, dI = t32(rng.rand(S, N, 4)), t32(rng.rand(S, 9, 8, 3))
    valid = torch.from_numpy(rng.rand(S, N) > 0.3)
    T, aff = t32(rng.rand(S, B, 4, 4)), t32(rng.rand(S, B, 2))
    ref_aff, expo = t32(rng.rand(S, 2)), t32(rng.rand(S))
    stats, H, b = t32(rng.rand(S, B, 6)), t32(rng.rand(S, B, 8, 8)), \
        t32(rng.rand(S, B, 8))
    scal, flag = t32(rng.rand(S, B)), torch.from_numpy(rng.rand(S, B) > 0.5)
    cut = t32(rng.rand(B))                  # no sequence axis
    params = [2.0] + [0.0] * 30
    op = getattr(torch.ops.ldso_tpu_torch, cuda_kernels.TRIP_OPS[mode])
    ref_expo = t32(0.7)                     # no sequence axis

    def one(p, v, d, t, a, ra, e, st, h, bb, sc, fl):
        state = {"trip": (cut,), "cutoff": (st, h, bb, sc, fl),
                 "lm": (st, h, bb, sc, fl, cut)}[mode]
        return op(p, v, d, t, a, ra, ref_expo, e, *state, params, True)
    seq = (pts, valid, dI, T, aff, ref_aff, expo, stats, H, b, scal, flag)
    got = torch.func.vmap(one)(*seq)
    assert launched == [(mode, S)]
    for s_ in range(S):
        want = one(*(x[s_] for x in seq))
        for g, w in zip(got, want):
            equal(g[s_], w)
    # an axis other than the first, and an unbatched level
    moved = (pts.transpose(0, 1), valid.t().contiguous(), dI[0]) + seq[3:]
    got = torch.func.vmap(one, in_dims=(1, 1, None) + (0,) * 9)(*moved)
    for s_ in range(S):
        want = one(pts[s_], valid[s_], dI[0], *(x[s_] for x in seq[3:]))
        for g, w in zip(got, want):
            equal(g[s_], w)


def test_tracker_trip_float32_against_float64(scene4, monkeypatch):
    """What float32 costs the trip at 640x480: the port's plain version and
    the JAX package's, both in float32, against the port's plain version
    in float64 on the same inputs, at every level. H agrees to 1e-6 of
    its largest entry; b's pose entries are off by up to 5e-5 of max|b|
    in either package, which sets _close_trip's tolerance for b."""
    from ldso_tpu_torch.ops.preprocess import FramePyramid
    calib, poses, pj, pt, rj, rt = scene4
    T, aff, cut = _trip_inputs(poses, 1)
    d = torch.float64
    rt64 = ttr.TrackerRef(points=tuple(p.to(d) for p in rt.points),
                          valid=rt.valid, ref_exposure=rt.ref_exposure.to(d),
                          ref_aff=rt.ref_aff.to(d))
    pt64 = FramePyramid(dI=tuple(x.to(d) for x in pt.dI), abs_grad=())
    const = ttr.device_const
    for lvl in range(calib.levels):
        args = (lvl, t32(T), t32(aff), t32(1.0), t32(cut), calib, TC(),
                lvl == 0)
        s32, H32, b32 = ttr.tracker_trip_ref(rt, pt, *args)
        monkeypatch.setattr(ttr, "device_const", lambda v, dev, dtype=d: const(
            v, dev, d if dtype == torch.float32 else dtype))
        s64, H64, b64 = ttr.tracker_trip_ref(
            rt64, pt64, lvl, *(a.to(d) for a in args[1:5]), *args[5:])
        monkeypatch.setattr(ttr, "device_const", const)
        _, Hj, bj = _jax_trip(rj, pj, lvl, T, aff, cut, calib, lvl == 0)
        H64, b64 = npy(H64), npy(b64)
        for H, b, who in ((npy(H32), npy(b32), "port"), (Hj, bj, "jax")):
            assert np.abs(H - H64).max() <= 1e-6 * np.abs(H64).max(), who
            assert np.abs(b - b64).max() <= 5e-5 * np.abs(b64).max(), who
        close(s32, npy(s64), 1e-5, 1e-5, f"stats level {lvl}")


# ---------------------------------------------------------------------------
# K3's cutoff and lm modes: their plain versions against the JAX package's
# loop bodies, the level block against JAX's, idle members, and the checks
# that hold the kernel to the plain versions
# ---------------------------------------------------------------------------

AFFINE_MODES = [dict(), dict(affine_opt_mode_a=-1),
                dict(affine_opt_mode_b=-1),
                dict(affine_opt_mode_a=-1, affine_opt_mode_b=-1)]


def _jax_lm_iteration(rj, pj, lvl, T, aff, stats, H, b, lam, cut, calib,
                      jc, flow):
    """One iteration of the JAX package's lm_body for one member, from its
    _solve_inc, lie.se3_exp, _calc_res and _calc_gs: (inc, T_new, aff_new,
    stats_new, H_new, b_new, accept)."""
    from ldso_tpu.math import lie as jlie
    inc = np.asarray(jtr._solve_inc(j32(H), j32(b), jnp.float32(lam), jc))
    lim = np.float32(1e-3)
    extrap = (np.sqrt(np.sqrt(lim / np.maximum(np.float32(lam), 1e-12)))
              if lam < lim else np.float32(1.0))
    inc = (inc * extrap).astype(np.float32)
    scale = npy(ttr._scale_vec("cpu"))
    xi = inc * scale
    xi = np.where(np.isfinite(xi), xi, 0.0).astype(np.float32)
    T_new = np.asarray(jlie.se3_exp(j32(xi[:6]))) @ np.asarray(T, np.float32)
    aff_new = (np.asarray(aff, np.float32) + xi[6:8]).astype(np.float32)
    bufs, st = jtr._calc_res(rj, pj, lvl, j32(T_new), j32(aff_new),
                             jnp.float32(1.0), jnp.float32(cut), calib, jc,
                             compute_flow=flow)
    Hn, bn, _ = jtr._calc_gs(bufs, lvl, rj, j32(aff_new), jnp.float32(1.0),
                             calib)
    st, Hn, bn = np.asarray(st), np.asarray(Hn), np.asarray(bn)
    stats = np.asarray(stats)
    accept = (st[0] / max(st[1], 1.0)) < (stats[0] / max(stats[1], 1.0))
    return inc, T_new.astype(np.float32), aff_new, st, Hn, bn, accept


@pytest.mark.parametrize("affine", range(len(AFFINE_MODES)))
@pytest.mark.parametrize("lvl", [0, 2])
def test_lm_trip_ref_matches_jax(scene4, lvl, affine):
    """lm_trip_ref (the plain version of K3's lm mode) against one
    iteration composed from the JAX package's _solve_inc, se3_exp,
    _calc_res and _calc_gs, member by member, for every set of affine
    parameters the LM solves for, batch 8 with two members done: the
    step (T, aff) within the solve's rounding (torch_kernel_checks'
    _step_tol), the new stats, H and b within the trip's tolerances at the
    port's new pose, the same accept decisions unless the energies are
    within ACCEPT_RTOL, lam exactly, done equal, done members unchanged."""
    calib, poses, pj, pt, rj, rt = scene4
    kc = kernel_checks
    kw = AFFINE_MODES[affine]
    cfg, jc = TC(**kw), JC(**kw)
    T, aff, cut = _trip_inputs(poses, 8)
    T[:, :3, 3] += 0.004            # off the optimum, so the steps are real
    flow = lvl == 0
    Tt, afft, cutt = t32(T), t32(aff), t32(cut)
    stats, H, b, _, _, lam, done = kc.mode_state(
        ttr.tracker_trip_ref, rt, pt, lvl, Tt, afft, t32(1.0), cutt, calib,
        cfg, flow)
    got = ttr.lm_trip_ref(rt, pt, lvl, Tt, afft, t32(1.0), stats, H, b, lam,
                          done, cutt, calib, cfg, flow)
    inc, T_new, aff_n = ttr.lm_step_ref(Tt, afft, H, b, lam, cfg)
    tol = kc._step_tol(H, b, lam, cfg, inc)
    for m in range(8):
        if done[m]:
            for g, x in zip(got[:6], (Tt, afft, stats, H, b, lam)):
                assert _bits(g[m:m + 1], x[m:m + 1])
            assert bool(got[6][m])
            continue
        j_inc, j_T, j_aff, j_st, j_H, j_b, j_acc = _jax_lm_iteration(
            rj, pj, lvl, T[m], aff[m], npy(stats[m]), npy(H[m]), npy(b[m]),
            float(lam[m]), float(cut[m]), calib, jc, flow)
        assert np.abs(npy(T_new[m]) - j_T).max() <= float(tol[m]) + \
            kc.STEP_ATOL, m
        assert np.abs(npy(aff_n[m]) - j_aff).max() <= 1e3 * float(tol[m]) \
            + kc.STEP_ATOL * (1 + np.abs(j_aff).max()), m
        # the JAX trip at the port's new pose
        args = (rt, pt, lvl, T_new[m:m + 1], aff_n[m:m + 1], t32(1.0),
                cutt[m:m + 1], calib, cfg, flow)
        port_new = ttr.tracker_trip_ref(*args)
        jax_new = _jax_trip(rj, pj, lvl, npy(T_new[m:m + 1]),
                            npy(aff_n[m:m + 1]), cut[m:m + 1], calib, flow)
        err, share, same_n = kc.trip_err(
            port_new, [torch.from_numpy(x) for x in jax_new],
            kc.trip_allowance(*args), kc.trip_floor(*args[:-1]))
        assert same_n and share <= 1.0, (m, err, share)
        acc = bool(got[5][m] < lam[m])
        mean_old = float(stats[m, 0] / max(float(stats[m, 1]), 1.0))
        if acc != bool(j_acc):
            mean_new = j_st[0] / max(j_st[1], 1.0)
            assert abs(mean_new - mean_old) <= kc.ACCEPT_RTOL * mean_old
        want_lam = lam[m] * 0.5 if acc else torch.clamp(lam[m] * 4.0,
                                                        min=1e-3)
        assert _bits(got[5][m:m + 1], want_lam.reshape(1))
        assert bool(got[6][m]) == bool(np.linalg.norm(j_inc) <= 1e-3)


@pytest.mark.parametrize("case", [None, "saturating"])
def test_cutoff_trip_ref_matches_jax(scene4, case):
    """cutoff_trip_ref (the plain version of K3's cutoff mode) against the
    JAX package's cutoff_body at every level, batch 8: a running member
    over 60% saturated and under the limit doubles its cutoff multiplier
    and takes stats, H and b at the new cutoff (within the trip's
    tolerances of JAX's _calc_res and _calc_gs); the others keep theirs
    bit for bit."""
    calib, poses, pj, pt, rj, rt = scene4
    T, aff, cut = _trip_inputs(poses, 8, case)
    Tt, afft = t32(T), t32(aff)
    for lvl in range(calib.levels):
        flow = lvl == 0
        stats, H, b = ttr.tracker_trip_ref(rt, pt, lvl, Tt, afft, t32(1.0),
                                           t32(cut), calib, TC(), flow)
        rep = t32([1, 2, 64, 1, 4, 1, 32, 1])
        run = torch.tensor([True, True, True, False, True, True, True, True])
        got = ttr.cutoff_trip_ref(rt, pt, lvl, Tt, afft, t32(1.0), stats, H,
                                  b, rep, run, calib, TC(), flow)
        more = (npy(stats[:, 5]) > 0.6) & (npy(rep) < 50) & npy(run)
        if case == "saturating":
            assert more.sum() == 6
        equal(got[3], np.where(more, 2 * npy(rep), npy(rep)))
        for m in range(8):
            if not more[m]:
                for g, x in zip(got[:3], (stats, H, b)):
                    assert _bits(g[m:m + 1], x[m:m + 1])
                continue
            new_cut = np.float32(20.0) * np.float32(2 * rep[m])
            want = _jax_trip(rj, pj, lvl, T[m:m + 1], aff[m:m + 1],
                             np.array([new_cut], np.float32), calib, flow)
            args = (rt, pt, lvl, Tt[m:m + 1], afft[m:m + 1], t32(1.0),
                    t32([new_cut]), calib, TC(), flow)
            _close_trip([g[m:m + 1] for g in got[:3]], want,
                        f"level {lvl} member {m}",
                        kernel_checks.trip_allowance(*args))


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_level_block_matches_jax(scene, lvl):
    """The port's _level_block (every trip through the K3 wrappers, their
    plain versions on the CPU) against the JAX package's, at each level of
    the 256x192 scene from a pose 1.5 cm off: test_track_frame's
    tolerances (the LM amplifies float32 rounding), the same ok flag and
    repeat flag."""
    calib, poses, pj, pt, ideps = scene
    rj, rt = _refs(scene)
    T0 = (poses[1] @ np.linalg.inv(poses[0])).astype(np.float32)
    T0[0, 3] += 0.015
    L = calib.levels
    last = np.full(L, np.nan, np.float32)
    abort = np.full(L, 1e9, np.float32)
    jstate = (j32(T0), j32([0.0, 0.0]), jnp.asarray(True), j32(last),
              j32([1000.0] * 3))
    (jT, jaff, jok, jres, jflow), jrep = jtr._level_block(
        rj, pj[1], lvl, jstate, jnp.float32(1.0), j32(abort), calib, JC(),
        JC().coarse_lm_iterations[lvl])
    tstate = (t32(T0)[None], t32([[0.0, 0.0]]), torch.tensor([True]),
              t32(last)[None], t32([[1000.0] * 3]))
    (tT, taff, tok, tres, tflow), trep = ttr._level_block(
        rt, pt[1], lvl, tstate, torch.tensor([True]), t32(1.0), t32(abort),
        calib, TC(), TC().coarse_lm_iterations[lvl])
    close(tT[0], jT, 0, 1e-4, "T")
    close(taff[0], jaff, 0, 1e-3, "aff")
    equal(tok[0], jok, "ok")
    close(tres[0], jres, 1e-3, 1e-4, "residuals")
    close(tflow[0], jflow, 1e-3, 1e-4, "flow")
    equal(trep[0], jrep, "repeat")


def test_idle_members_keep_their_state(scene4):
    """A member with nothing to do keeps its state bit for bit in both
    plain modes, and the wrappers on CPU tensors are the plain versions
    bit for bit (NaN payloads included) and launch nothing: cutoff
    members that are not run, at most 60% saturated or at the cutoff
    limit; LM members that are done (their H, b and stats NaN here, which
    a live member's selects would not keep)."""
    from ldso_tpu_torch.ops import cuda_kernels
    calib, poses, pj, pt, rj, rt = scene4
    T, aff, cut = _trip_inputs(poses, 8)
    Tt, afft, cutt = t32(T), t32(aff), t32(cut)
    before = dict(cuda_kernels.LAUNCHES)
    for lvl in (0, 3):
        stats, H, b = ttr.tracker_trip_ref(rt, pt, lvl, Tt, afft, t32(1.0),
                                           cutt, calib, TC(), lvl == 0)
        stats = stats.clone()
        stats[:, 5] = t32([0.9, 0.5, 0.9, 0.9, 0.61, 0.6, 0.9, 0.95])
        rep = t32([1, 1, 64, 50, 1, 1, 1, 1])
        run = torch.tensor([False, True, True, True, True, True, True, True])
        c_args = (rt, pt, lvl, Tt, afft, t32(1.0), stats, H, b, rep, run,
                  calib, TC(), lvl == 0)
        got = ttr.cutoff_trip_ref(*c_args)
        idle = [0, 1, 2, 3, 5]
        for g, x in zip(got, (stats, H, b, rep)):
            assert _bits(g[idle], x[idle])
        assert not _bits(got[1][[4]], H[[4]])
        for g, w in zip(cuda_kernels.cutoff_trip(*c_args), got):
            assert _bits(g, w)
        nan = torch.full_like(H, float("nan"))
        done = torch.ones(8, dtype=torch.bool)
        lam = t32([0.01] * 8)
        l_args = (rt, pt, lvl, Tt, afft, t32(1.0), stats, nan, b, lam, done,
                  cutt, calib, TC(), lvl == 0)
        got = ttr.lm_trip_ref(*l_args)
        for g, x in zip(got, (Tt, afft, stats, nan, b, lam, done)):
            assert _bits(g, x)
        for g, w in zip(cuda_kernels.lm_trip(*l_args), got):
            assert _bits(g, w)
    assert cuda_kernels.LAUNCHES == before


def test_lm_step_float32_against_float64(scene4):
    """What float32 costs the step: torch's solve_ex (the plain version)
    and K3's elimination (emulated, torch_kernel_checks.solve_like_k3),
    both in float32, against the float64 solve of the same system, at
    every level, poses off the optimum and near it, lam from 1e-5 to 10:
    each within half of STEP_COND_FACTOR kappa 2^-23 |inc|_inf, so two
    float32 solves stay within the lm mode's step tolerance."""
    calib, poses, pj, pt, rj, rt = scene4
    kc = kernel_checks
    for off in (0.01, 0.0003):
        T, aff, cut = _trip_inputs(poses, 8)
        T[:, :3, 3] += np.random.RandomState(7).randn(8, 3).astype(
            np.float32) * off
        for lvl in range(calib.levels):
            _, H, b = ttr.tracker_trip_ref(rt, pt, lvl, t32(T), t32(aff),
                                           t32(1.0), t32(cut), calib, TC(),
                                           lvl == 0)
            for lam_v in (1e-5, 1e-3, 0.01, 0.1, 10.0):
                lam = torch.full((8,), lam_v)
                inc64 = ttr._solve_inc(H.double(), b.double(), lam.double(),
                                       TC())
                tol = kc._step_tol(H, b, lam, TC(), inc64).double()
                for inc in (ttr._solve_inc(H, b, lam, TC()),
                            kc.solve_like_k3(H, b, lam, TC())):
                    err = (inc.double() - inc64).abs().amax(1)
                    assert bool((err <= 0.5 * tol).all()), (
                        off, lvl, lam_v, (err / tol).max())


def test_converged_trip_float32_against_float64(scene4, monkeypatch):
    """E and b at converged poses (12 LM iterations from 5 mm off, every
    level, batch 8), float32 against float64: within a quarter of
    torch_kernel_checks.trip_floor, the floors that the lm mode's check
    adds (relative tolerances fail there: the residuals are a fraction of
    a grey level, and b cancels)."""
    from ldso_tpu_torch.ops.preprocess import FramePyramid
    calib, poses, pj, pt, rj, rt = scene4
    kc = kernel_checks
    d = torch.float64
    rt64 = ttr.TrackerRef(points=tuple(p.to(d) for p in rt.points),
                          valid=rt.valid, ref_exposure=rt.ref_exposure.to(d),
                          ref_aff=rt.ref_aff.to(d))
    pt64 = FramePyramid(dI=tuple(x.to(d) for x in pt.dI), abs_grad=())
    const = ttr.device_const
    T, aff, cut = _trip_inputs(poses, 8)
    T[1:, :3, 3] += np.random.RandomState(3).randn(7, 3).astype(
        np.float32) * 0.005
    for lvl in range(calib.levels):
        flow = lvl == 0
        Tc, ac, cutt = t32(T), t32(aff), t32(cut)
        st, H, b = ttr.tracker_trip_ref(rt, pt, lvl, Tc, ac, t32(1.0), cutt,
                                        calib, TC(), flow)
        lam = torch.full((8,), 0.01)
        live = torch.zeros(8, dtype=torch.bool)
        for _ in range(12):
            Tc, ac, st, H, b, lam, _ = ttr.lm_trip_ref(
                rt, pt, lvl, Tc, ac, t32(1.0), st, H, b, lam, live, cutt,
                calib, TC(), flow)
        s32, _, b32 = ttr.tracker_trip_ref(rt, pt, lvl, Tc, ac, t32(1.0),
                                           cutt, calib, TC(), flow)
        monkeypatch.setattr(ttr, "device_const", lambda v, dev, dtype=d: const(
            v, dev, d if dtype == torch.float32 else dtype))
        s64, _, b64 = ttr.tracker_trip_ref(rt64, pt64, lvl, Tc.to(d),
                                           ac.to(d), t32(1.0).to(d),
                                           cutt.to(d), calib, TC(), flow)
        monkeypatch.setattr(ttr, "device_const", const)
        f_stats, f_b = kc.trip_floor(rt, pt, lvl, Tc, ac, t32(1.0), cutt,
                                     calib, TC())
        e_ratio = ((s32[:, 0].double() - s64[:, 0]).abs()
                   / f_stats[:, 0].double()).max()
        b_ratio = ((b32.double() - b64).abs() / f_b.double()).max()
        assert float(e_ratio) <= 0.25 and float(b_ratio) <= 0.25, (
            lvl, float(e_ratio), float(b_ratio))


# what a faulty lm mode gets wrong in its candidate trip (the trip at the
# stepped pose): the trip taken at the un-stepped aff, E too large by 1e-3
# of itself, and b's first pose entry off by CAND_B_FAULT of the member's
# largest |b| (the affine entries set it)
CAND_E_FAULT = 1e-3
CAND_B_FAULT = 1e-3


def _emulated_modes(monkeypatch, fault=None):
    """K3's cutoff and lm modes emulated on the CPU as another float32
    evaluation: the points in reverse order (the sums in another order)
    and the step by K3's elimination (solve_like_k3); `fault` breaks one
    thing, as a faulty kernel would."""
    kc = kernel_checks
    plain_trip = ttr.tracker_trip_ref

    def trip(ref, pyr, lvl, *a, **k):
        flip = ttr.TrackerRef(points=tuple(p.flip(0) for p in ref.points),
                              valid=tuple(v.flip(0) for v in ref.valid),
                              ref_exposure=ref.ref_exposure,
                              ref_aff=ref.ref_aff)
        if fault != "drop_masked":
            return plain_trip(flip, pyr, lvl, *a, **k)
        # K3 before it flagged masked points' non-finite terms: the rows
        # that are not good dropped before the 8x8 reduce
        bufs, stats = ttr._calc_res(flip, pyr, lvl, *a, **k)
        keep = bufs["good"] > 0
        bufs = {n: torch.where(keep, v, torch.zeros_like(v))
                if v.dim() == 2 else v for n, v in bufs.items()}
        H, b, _ = ttr._calc_gs(bufs, lvl, flip, a[1], a[2], a[4])
        return stats, H, b

    def cutoff(*a, **k):
        with kc.plain_trip(trip):
            out = ttr.cutoff_trip_ref(*a, **k)
        if fault == "cutoff_rep":
            out = out[:3] + (out[3] * 1.5,)
        return out

    def lm(*a, **k):
        old_aff = a[4]

        def candidate_trip(ref, pyr, lvl, T, aff, *r, **kw):
            if fault == "cand_aff":
                aff = old_aff
            stats, H, b = trip(ref, pyr, lvl, T, aff, *r, **kw)
            if fault == "cand_E":
                stats = stats.clone()
                stats[:, 0] *= 1.0 + CAND_E_FAULT
            elif fault == "cand_b":
                b = b.clone()
                b[:, 0] += CAND_B_FAULT * torch.abs(b).amax(1)
            return stats, H, b
        with monkeypatch.context() as mp:
            mp.setattr(ttr, "_solve_inc", kc.solve_like_k3)
            with kc.plain_trip(candidate_trip):
                out = list(ttr.lm_trip_ref(*a, **k))
        if fault == "step":
            out[0] = out[0] * 1.001
        elif fault == "idle":
            out[5] = out[5] * 2.0
        elif fault == "done":
            out[6] = ~out[6]
        return tuple(out)
    return cutoff, lm


@pytest.mark.parametrize("lvl", [0, 3])
def test_mode_checks_hold_an_emulated_kernel(scene4, monkeypatch, lvl):
    """torch_kernel_checks.mode_errs, which phase 2 of chip_smoke.py and
    the card tests hold K3's cutoff and lm modes to, passes another float32
    evaluation of the same functions (_emulated_modes) on the scene and
    the saturating case at batch 1 and 8, with live, done and not-run
    members, and reports each fault that a broken kernel would have, the
    candidate trip's among them (CAND_E_FAULT, CAND_B_FAULT: above the
    rounding floors of E and b at these poses, 3 mm and more off the
    truth)."""
    calib, poses, pj, pt, rj, rt = scene4
    kc = kernel_checks
    cutoff, lm = _emulated_modes(monkeypatch)
    for case in (None, "saturating"):
        for B in (1, 8):
            T, aff, cut = _trip_inputs(poses, B, case)
            T[:, :3, 3] += 0.003
            err, share, faults, _ = kc.mode_errs(
                cutoff, lm, ttr.tracker_trip_ref, rt, pt, lvl, t32(T),
                t32(aff), t32(1.0), t32(cut), calib, TC(), lvl == 0)
            assert not faults and share <= 1.0, (case, B, faults, share)
            assert err > 0.0                 # it is another evaluation
    T, aff, cut = _trip_inputs(poses, 8)
    T[:, :3, 3] += 0.003
    for fault, what in (("cutoff_rep", "cutoff cutoff_rep"),
                        ("step", "lm step"), ("idle", "lm idle lam"),
                        ("done", "lm idle done"),
                        ("cand_aff", "lm candidate trip"),
                        ("cand_E", "lm candidate trip"),
                        ("cand_b", "lm candidate trip")):
        cutoff, lm = _emulated_modes(monkeypatch, fault)
        _, _, faults, _ = kc.mode_errs(
            cutoff, lm, ttr.tracker_trip_ref, rt, pt, lvl, t32(T), t32(aff),
            t32(1.0), t32(cut), calib, TC(), lvl == 0)
        assert any(f.startswith(what) for f in faults), (fault, faults)


@pytest.mark.parametrize("lvl", [0, 3])
def test_mode_checks_hold_an_emulated_kernel_on_a_nan_level(scene4,
                                                           monkeypatch, lvl):
    """On trip_case's NaN patch, where tracker_trip_ref's H and b turn NaN
    for the members whose masked points sample it, mode_errs (which phase 2
    and the card tests hold K3's cutoff and lm modes to there) passes the
    emulated kernel, NaN where the plain version is NaN and a NaN step
    frozen in both; and it reports K3's behaviour before its NaN repair
    (the masked rows dropped, so H and b stay finite) and a member that
    moves on a NaN step."""
    calib, poses, pj, pt, rj, rt = scene4
    kc = kernel_checks
    T, aff, _ = _trip_inputs(poses, 8)
    T[:, :3, 3] += 0.003
    pyr, Tc, ac, cut = kc.trip_case("nan_patch", pt, lvl, t32(T), t32(aff),
                                    TC())
    args = (rt, pyr, lvl, Tc, ac, t32(1.0), cut, calib, TC(), lvl == 0)
    _, H, b = ttr.tracker_trip_ref(*args)
    assert bool(torch.isnan(H).any()) and bool(torch.isnan(b).any())
    cutoff, lm = _emulated_modes(monkeypatch)
    err, share, faults, _ = kc.mode_errs(cutoff, lm, ttr.tracker_trip_ref,
                                         *args)
    assert not faults and share <= 1.0, (faults, share)
    for fault, what in (("drop_masked", "cutoff live trips"),
                        ("step", "lm kernel moved on a non-finite step")):
        cutoff, lm = _emulated_modes(monkeypatch, fault)
        _, _, faults, _ = kc.mode_errs(cutoff, lm, ttr.tracker_trip_ref,
                                       *args)
        assert any(f.startswith(what) for f in faults), (fault, faults)
