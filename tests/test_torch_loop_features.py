"""The port's ORB features, vocabulary, database and matcher against the
JAX package, on a 256x192 plane frame and on seeded descriptors."""

import copy
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_utils import close, equal, npy

from ldso_tpu.frontend import detector as jdet
from ldso_tpu.loop import matcher as jmatch
from ldso_tpu.loop.database import KeyframeDatabase as JDB
from ldso_tpu.loop.vocab import Vocabulary as JVoc
from ldso_tpu.loop.vocab import _transform_batch as j_transform_batch
from ldso_tpu.ops.preprocess import make_pyramid as jpyr
from ldso_tpu_torch.frontend import detector as tdet
from ldso_tpu_torch.loop import matcher as tmatch
from ldso_tpu_torch.loop.database import KeyframeDatabase as TDB
from ldso_tpu_torch.loop.vocab import Vocabulary as TVoc
from ldso_tpu_torch.loop.vocab import _transform_batch as t_transform_batch
from ldso_tpu_torch.ops.preprocess import make_pyramid as tpyr
from ldso_tpu_torch.utils.convert import vocabulary_to_torch


def _frame(shift=(0.1, 0.02), w=256, h=192, seed=7):
    """A JAX-rendered plane frame (float32) and both packages' pyramids."""
    from ldso_tpu.synthetic import PlaneScene, default_calib
    calib = default_calib(w, h)
    T = np.eye(4)
    T[:2, 3] = shift
    img, _ = PlaneScene(freq_hi=30.0, contrast=80.0, n_waves=32,
                        seed=seed).render(calib, jnp.asarray(T, jnp.float32))
    img = np.asarray(img, np.float32)
    return (jpyr(jnp.asarray(img), calib.levels),
            tpyr(torch.from_numpy(img), calib.levels))


@pytest.fixture(scope="module")
def feats():
    pj, pt = _frame()
    fj = jdet.detect_corners(pj.dI[0], pj.abs_grad[0], 400)
    ft = tdet.detect_corners(pt.dI[0], pt.abs_grad[0], 400)
    return pj, pt, fj, ft


def test_shi_tomasi_bitwise_close(feats):
    """The blocked cumsum and the contracted multiply-adds reproduce the
    JAX map to the last bit on all but a few pixels (rtol 1e-6)."""
    pj, pt, _, _ = feats
    sj = npy(jdet.shi_tomasi_map(pj.dI[0]))
    st = npy(tdet.shi_tomasi_map(pt.dI[0]))
    close(st, sj, rtol=1e-6, atol=1e-4, what="shi_tomasi")
    assert (st != sj).mean() < 0.01


@pytest.mark.parametrize("n", [1, 15, 16, 17, 250, 480])
def test_blocked_cumsum_matches_jnp(n):
    import jax
    a = np.random.RandomState(n).rand(n, 5).astype(np.float32) * 1000
    for ax in (0, 1):
        want = npy(jax.jit(lambda x: jnp.cumsum(x, ax))(jnp.asarray(a)))
        equal(tdet._blocked_cumsum(torch.from_numpy(a), ax), want, f"ax {ax}")


def test_detect_corners_matches(feats):
    """u, v, valid, is_corner exact; score rtol 1e-5; angle atol 1e-5 rad;
    descriptors exact."""
    _, _, fj, ft = feats
    for k in ("u", "v", "valid", "is_corner"):
        equal(ft[k], fj[k], k)
    assert int(npy(fj["is_corner"]).sum()) > 50
    close(ft["score"], fj["score"], rtol=1e-5, atol=0, what="score")
    close(ft["angle"], fj["angle"], rtol=0, atol=1e-5, what="angle")
    equal(tdet.desc_to_numpy(ft["desc"]), npy(fj["desc"]), "desc")


def test_ic_angle_and_descriptors_given_jax_angles(feats):
    pj, pt, fj, _ = feats
    u, v = npy(fj["u"]), npy(fj["v"])
    close(tdet.ic_angle(pt.dI[0], torch.from_numpy(u), torch.from_numpy(v)),
          jdet.ic_angle(pj.dI[0], fj["u"], fj["v"]), rtol=0, atol=1e-5,
          what="ic_angle")
    # descriptors given JAX's angles, including angles that put rotated
    # offsets on exact integers (0, +-pi/2, pi)
    ang = npy(fj["angle"]).copy()
    ang[:4] = [0.0, np.pi / 2, -np.pi / 2, np.pi]
    dj = npy(jdet.compute_descriptors(pj.dI[0], fj["u"], fj["v"],
                                      jnp.asarray(ang)))
    dt = tdet.compute_descriptors(pt.dI[0], torch.from_numpy(u),
                                  torch.from_numpy(v), torch.from_numpy(ang))
    equal(tdet.desc_to_numpy(dt), dj, "descriptors")
    equal(tdet.desc_to_torch(dj), dt.cpu(), "uint32 -> int64 words")


def _rand_desc(rng, n):
    return rng.randint(0, 2 ** 32, size=(n, 8), dtype=np.uint32)


def test_hamming_and_match_descriptors():
    rng = np.random.RandomState(0)
    a, b = _rand_desc(rng, 60), _rand_desc(rng, 70)
    b[:20] = a[:20] ^ np.uint32(1 << 3)               # near matches
    b[30] = b[31]                                     # exact argmin tie
    a[40] = b[30]
    va = rng.rand(60) < 0.9
    vb = rng.rand(70) < 0.9
    ta, tb = tdet.desc_to_torch(a), tdet.desc_to_torch(b)
    equal(tdet.hamming_matrix(ta, tb), jdet.hamming_matrix(jnp.asarray(a),
                                                           jnp.asarray(b)))
    equal(tmatch.hamming_matrix_np(a, b), jmatch.hamming_matrix_np(a, b))
    for ratio, th in ((0.9, 50), (0.75, 120)):
        mt, dt = tdet.match_descriptors(ta, torch.from_numpy(va), tb,
                                        torch.from_numpy(vb), ratio, th)
        mj, dj = jdet.match_descriptors(jnp.asarray(a), jnp.asarray(va),
                                        jnp.asarray(b), jnp.asarray(vb),
                                        nn_ratio=ratio, th_low=th)
        equal(mt, mj, "match")
        equal(dt, dj, "best distance")


def _corpus(seed=0, n_clusters=12, per=30):
    rng = np.random.RandomState(seed)
    bases = _rand_desc(rng, n_clusters)
    out = []
    for c in range(n_clusters):
        for _ in range(per):
            d = bases[c].copy()
            for _ in range(rng.randint(0, 6)):
                d[rng.randint(0, 8)] ^= np.uint32(1 << rng.randint(0, 32))
            out.append(d)
    return np.stack(out)


@pytest.fixture(scope="module")
def vocabs():
    corpus = _corpus()
    vj = JVoc.train(corpus, k=4, L=3, seed=3)
    vt = TVoc.train(corpus, k=4, L=3, seed=3)
    return corpus, vj, vt


def test_vocab_train_identical(vocabs):
    _, vj, vt = vocabs
    for name in ("node_desc", "children", "is_leaf", "word_id",
                 "word_weight"):
        equal(getattr(vt, name), getattr(vj, name), name)
    assert (vt.k, vt.L, vt.n_words) == (vj.k, vj.L, vj.n_words)


def _idf_query(corpus):
    """The descriptors whose words set the idf weights below."""
    rng = np.random.RandomState(1)
    q = np.concatenate([corpus[::7], _rand_desc(rng, 40)])
    return q, rng.rand(len(q)) < 0.9


def _with_idf(vocabs):
    """Copies of the fixture's vocabularies with tf-idf weights from three
    documents (the fixture's own stay uniform for every test)."""
    corpus, vj, vt = vocabs
    vj, vt = copy.deepcopy(vj), copy.deepcopy(vt)
    q, valid = _idf_query(corpus)
    wj = vj.transform(jnp.asarray(q), jnp.asarray(valid))
    wt = vt.transform(q, valid)
    vj.set_idf_weights([wj[:40], wj[40:90], wj[90:]])
    vt.set_idf_weights([wt[:40], wt[40:90], wt[90:]])
    return vj, vt, wj, wt


def test_vocab_transform_nodes_bow(vocabs):
    """transform exact against JAX's (native) transform and its
    _transform_batch, the torch twin exact too; node_ids, bow_vector and
    scores exact (same dict order)."""
    corpus, vj, vt = vocabs
    q, valid = _idf_query(corpus)
    wj = vj.transform(jnp.asarray(q), jnp.asarray(valid))
    wt = vt.transform(q, valid)
    equal(wt, wj, "transform")
    wb = npy(j_transform_batch(jnp.asarray(q), *[jnp.asarray(x) for x in (
        vj.node_desc, vj.children, vj.is_leaf, vj.word_id)], vj.L, vj.k))
    twin = t_transform_batch(tdet.desc_to_torch(q), *vt.device_tables("cpu"),
                             vt.L, vt.k)
    equal(np.where(valid, npy(twin), -1), wt, "torch twin vs native")
    equal(npy(twin), wb, "torch twin vs JAX _transform_batch")
    for lv in (1, 2, 4):
        equal(vt.node_ids(wt, levelsup=lv), vj.node_ids(wj, levelsup=lv))
    vj, vt, wj2, wt2 = _with_idf(vocabs)
    equal(wt2, wt)
    equal(vt.word_weight, vj.word_weight, "idf")
    bj, bt = vj.bow_vector(wj), vt.bow_vector(wt)
    assert list(bt.items()) == list(bj.items())
    b2 = vt.bow_vector(wt[:50])
    assert TVoc.score(bt, b2) == JVoc.score(bj, vj.bow_vector(wj[:50]))


def test_vocab_binary_cross_load(vocabs, tmp_path):
    """save_binary / load_binary in both directions with byte-identical
    files, and convert.vocabulary_to_torch."""
    _, vj, vt = vocabs
    pj, pt = str(tmp_path / "j.dbow3"), str(tmp_path / "t.dbow3")
    vj.save_binary(pj)
    vt.save_binary(pt)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    for a, b in ((TVoc.load(pj), JVoc.load(pt)),
                 (vocabulary_to_torch(vj), vj)):
        for name in ("node_desc", "children", "is_leaf", "word_id",
                     "word_weight"):
            equal(getattr(a, name), getattr(b, name), name)


def test_database_and_matchers_match(vocabs):
    """Database query ids identical and scores within 1e-9 (the native
    index's float32 scores and the float64 Python query); SearchByBoW and
    search_by_projection give identical match arrays. Under tf-idf weights:
    with the uniform weights of an untrained vocabulary many keyframes tie
    exactly in float64, and the Python query's tie order (set order) is not
    the native float32 query's."""
    corpus = vocabs[0]
    vj, vt, _, _ = _with_idf(vocabs)
    dbj, dbt = JDB(vj), TDB(vt)
    rng = np.random.RandomState(2)
    words = []
    for kf in range(9):
        sel = rng.choice(len(corpus), 60, replace=False)
        w = vt.transform(corpus[sel], np.ones(60, bool))
        words.append((sel, w))
        dbj.add(kf, vj.bow_vector(w))
        dbt.add(kf, vt.bow_vector(w))
    for kf in range(9):
        q = vt.bow_vector(words[kf][1])
        for exclude in ({kf}, {kf, (kf + 1) % 9}, set()):
            rj, rt = dbj.query(q, exclude), dbt.query(q, exclude)
            assert [i for i, _ in rt] == [i for i, _ in rj]
            close([s for _, s in rt], [s for _, s in rj], rtol=0, atol=1e-9)
            rp = dbt.query_python(q, exclude)
            assert [i for i, _ in rp] == [i for i, _ in rj]
            close([s for _, s in rp], [s for _, s in rj], rtol=0, atol=1e-6)
    (sa, wa), (sb, wb) = words[0], words[1]
    na, nb = vt.node_ids(wa, 1), vt.node_ids(wb, 1)
    equal(tmatch.search_by_bow(corpus[sa], na, corpus[sb], nb),
          jmatch.search_by_bow(corpus[sa], na, corpus[sb], nb), "by_bow")
    P = (rng.randn(60, 3) + np.array([0, 0, 4.0]))
    S = np.eye(4)
    S[:3, 3] = [0.05, -0.02, 0.1]
    uv = rng.rand(60, 2) * 200
    ang = rng.rand(60) * 0.3
    idep = np.where(rng.rand(60) < 0.8, 0.3, -1.0)
    args = (P, corpus[sa], ang, S, uv, corpus[sb], ang[::-1].copy(), idep,
            (150.0, 150.0, 100.0, 100.0))
    equal(tmatch.search_by_projection(*args, window_size=40.0, th_high=120),
          jmatch.search_by_projection(*args, window_size=40.0, th_high=120),
          "by_projection")


def test_database_and_matchers_match_alone():
    """The test above, run on its own in a fresh process: it used to pass
    only after test_vocab_transform_nodes_bow had set idf weights on the
    shared fixture."""
    here = os.path.abspath(__file__)
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         f"{here}::test_database_and_matchers_match"],
        cwd=os.path.dirname(os.path.dirname(here)), capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "1 passed" in out.stdout
