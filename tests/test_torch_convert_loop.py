"""Carrying a loop-closing system from the JAX package into the port
(utils/convert.loop_closing_to_torch and full_system_to_torch with loop
closing on): the carried state equals the JAX state, and on the JAX
package's RANSAC draws (torch_port_utils.shared_draws) the carried port
closes the next loop as the JAX package does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_utils import equal, jax_picks, shared_draws
from test_torch_loop_closing import _jax_kf, _sim3_err, two_visits  # noqa: F401
from test_torch_loop_slice import LOOP_KW, exposure_gains, out_and_back

from ldso_tpu.config import Config as JC
from ldso_tpu.loop import loopclosing as jlc
from ldso_tpu.loop import pnp as jpnp
from ldso_tpu.loop.loopclosing import LoopClosing as JLC
from ldso_tpu.slam_map import GlobalMap as JMap
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.utils import convert

SHELL_FIELDS = ("id", "kf_id", "T_cw", "S_cw", "feat_uv", "feat_desc",
                "feat_angle", "feat_idepth", "feat_word", "feat_node")


def assert_loop_state_equal(tlc, jlc):
    """The carried LoopClosing holds the JAX one's state: database order
    and index, counters, loop pairs, vocabulary tables and every shell."""
    assert tlc._db_order == jlc._db_order
    assert tlc._db_ids == jlc._db_ids
    assert tlc.n_loops_closed == jlc.n_loops_closed
    assert tlc.loop_pairs == [tuple(p) for p in jlc.loop_pairs]
    assert tlc.need_pose_graph == jlc.need_pose_graph
    assert len(tlc._pending_train) == len(jlc._pending_train)
    assert (tlc.vocab is None) == (jlc.vocab is None)
    if jlc.vocab is not None:
        for f in ("node_desc", "children", "is_leaf", "word_id",
                  "word_weight"):
            equal(getattr(tlc.vocab, f), getattr(jlc.vocab, f), f)
        assert tlc.db.bows == jlc.db.bows
    tkfs = tlc.global_map.keyframes
    assert sorted(tkfs) == sorted(jlc.global_map.keyframes)
    for k, js in jlc.global_map.keyframes.items():
        ts = tkfs[k]
        for f in SHELL_FIELDS:
            a, b = getattr(ts, f, None), getattr(js, f, None)
            assert (a is None) == (b is None), (k, f)
            if b is not None:
                equal(a, b, f"kf {k} {f}")
        assert ts.bow_vector == js.bow_vector, k
        assert sorted(ts.pose_rel) == sorted(js.pose_rel), k
        for o, (S, info, is_loop) in js.pose_rel.items():
            equal(ts.pose_rel[o][0], S, f"kf {k} -> {o}")
            equal(ts.pose_rel[o][1], info, f"kf {k} -> {o} info")
            assert ts.pose_rel[o][2] == is_loop


@pytest.fixture
def jax_ransac_picks(monkeypatch):
    """Every JAX RANSAC call's hypotheses, computed from its key and its
    padded valid mask: pnp_ransac (the module attribute _seed_pnp
    imports) and umeyama_ransac (loopclosing's name for it)."""
    picks = []
    pnp, ume = jpnp.pnp_ransac, jlc.umeyama_ransac

    def pnp_ransac(X, uv, valid, K, key, *a, **k):
        picks.append(jax_picks(valid, 256, 6, key))
        return pnp(X, uv, valid, K, key, *a, **k)

    def umeyama_ransac(P, Q, valid, key, *a, **k):
        picks.append(jax_picks(valid, 256, 3, key))
        return ume(P, Q, valid, key, *a, **k)
    monkeypatch.setattr(jpnp, "pnp_ransac", pnp_ransac)
    monkeypatch.setattr(jlc, "umeyama_ransac", umeyama_ransac)
    return picks


def test_loop_closing_carried_closes_the_same_pair(two_visits,
                                                   jax_ransac_picks):
    """The two-visit tour (test_torch_loop_closing.py): a JAX LoopClosing
    after ten keyframes, carried with its map; the revisit keyframe then
    closes the same pair in both, on the JAX draws, with edges within
    1e-3; every RANSAC draw is the JAX package's, row for row over the
    unpadded arrays."""
    calib, views, T_loop, frames = two_visits
    gm = JMap()
    lc = JLC(calib, JC(loop_kf_gap=3), gm)
    for k, (T, img, idep) in enumerate(frames[:-1]):
        kf = _jax_kf(calib, k, T, img, idep)
        gm.add_keyframe(kf)
        lc.insert_keyframe(kf, window_kf_ids=[k])
    assert lc.vocab is not None and lc._db_order
    tlc = convert.loop_closing_to_torch(
        lc, convert.global_map_to_torch(gm), TC(loop_kf_gap=3), "cpu")
    assert_loop_state_equal(tlc, lc)
    kj = _jax_kf(calib, 10, *frames[-1])
    kt = convert.frame_shell_to_torch(kj)
    with shared_draws(key=lc.key) as draws:
        for g, kf, l in ((tlc.global_map, kt, tlc), (gm, kj, lc)):
            g.add_keyframe(kf)
            assert l.insert_keyframe(kf, window_kf_ids=[10])
    assert tlc.loop_pairs == lc.loop_pairs == [(10, 0)]
    assert len(draws.calls) == len(jax_ransac_picks) >= 1
    for (n, nb, k, p), pj in zip(draws.calls, jax_ransac_picks):
        assert nb > n and pj.shape == p.shape == (256, k) and pj.max() < n
        equal(p, pj, "picks")
    assert np.asarray(draws.key).tolist() == np.asarray(lc.key).tolist()
    assert _sim3_err(kj.pose_rel[0][0], kt.pose_rel[0][0]) < 1e-3
    assert tlc._db_order == lc._db_order


N_CARRY = 14


def test_full_system_carried_with_loop_closing():
    """full_system_to_torch on a JAX FullSystem with loop closing on (the
    out-and-back of test_torch_loop_slice.py at 256x192, a vocabulary
    given): the carried port holds the JAX LoopClosing's state, and both
    then step on alike: the same keyframes and the same database."""
    from ldso_tpu.frontend import detector
    from ldso_tpu.loop.vocab import Vocabulary
    from ldso_tpu.ops.preprocess import make_pyramid
    from ldso_tpu.synthetic import PlaneScene, default_calib
    from ldso_tpu.system.full_system import FullSystem as JFS
    calib = default_calib(256, 192)
    scene = PlaneScene(freq_hi=30.0, contrast=80.0, n_waves=32)
    poses = out_and_back(40)[:N_CARRY + 3]
    gains = exposure_gains(40)
    imgs = [np.asarray(scene.render(calib, jnp.asarray(T, jnp.float32))[0],
                       np.float32) * np.float32(gains[i])
            for i, T in enumerate(poses)]
    descs = []
    for img in imgs[::4]:
        pyr = make_pyramid(jnp.asarray(img), calib.levels)
        f = detector.detect_corners(pyr.dI[0], pyr.abs_grad[0], 400)
        descs.append(np.asarray(f["desc"])[np.asarray(f["valid"]
                                                      & f["is_corner"])])
    vocab = Vocabulary.train(np.concatenate(descs), k=8, L=3, seed=7)
    kw = dict(LOOP_KW, loop_kf_gap=2)
    fj = JFS(calib, JC(**kw), vocab=vocab)
    for i in range(N_CARRY):
        fj.add_active_frame(imgs[i], i, 1.0, i * 0.05)
    assert fj.loop_closing._db_order
    with pytest.raises(ValueError):
        convert.full_system_to_torch(
            fj, dataclasses.replace(TC(**kw), enable_loop_closing=False),
            "cpu")
    fp = convert.full_system_to_torch(fj, TC(**kw), "cpu")
    assert fp.loop_closing.global_map is fp.global_map
    assert_loop_state_equal(fp.loop_closing, fj.loop_closing)
    for i in range(N_CARRY, len(imgs)):
        sj = fj.add_active_frame(imgs[i], i, 1.0, i * 0.05)
        st = fp.add_active_frame(imgs[i], i, 1.0, i * 0.05)
        assert (sj.kf_id >= 0) == (st.kf_id >= 0), i
    assert fp.loop_closing._db_order == fj.loop_closing._db_order
    assert fp.loop_closing.loop_pairs == fj.loop_closing.loop_pairs
