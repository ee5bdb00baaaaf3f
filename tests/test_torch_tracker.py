"""frontend/tracker: the port against the JAX coarse tracker on the same
reference keyframe and frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
