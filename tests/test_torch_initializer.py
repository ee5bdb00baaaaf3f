"""frontend/initializer: set_first and the bootstrap LM against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_utils import close, equal, npy, plane_frames, t32

from ldso_tpu.config import Config as JC
from ldso_tpu.frontend import initializer as jin
from ldso_tpu.ops.preprocess import make_pyramid as jmp
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.frontend import initializer as tin
from ldso_tpu_torch.ops.preprocess import make_pyramid as tmp
from ldso_tpu_torch.utils import convert


@pytest.fixture(scope="module")
def seq():
    calib, poses, imgs, _ = plane_frames(5, 256, 192)
    pj = [jmp(jnp.asarray(im), calib.levels) for im in imgs]
    pt = [tmp(t32(im), calib.levels) for im in imgs]
    return calib, poses, pj, pt


def test_set_first_pools_and_graph(seq):
    """Selected points, the brute-force 10-NN graph and the parents are
    exact (ties keep the lower index, like lax.top_k)."""
    calib, _, pj, pt = seq
    sj = jin.set_first(pj[0], calib, JC())
    st = tin.set_first(pt[0], calib, TC())
    assert len(sj.levels) == len(st.levels)
    for lvl, (Lj, Lt) in enumerate(zip(sj.levels, st.levels)):
        for f in ("u", "v", "valid", "neighbours", "parent", "outlier_th"):
            equal(getattr(Lt, f), getattr(Lj, f), f"{f} level {lvl}")


def test_knn_distances():
    rng = np.random.RandomState(0)
    u = np.round(rng.uniform(0, 40, 300)).astype(np.float32) + 0.1
    v = np.round(rng.uniform(0, 30, 300)).astype(np.float32) + 0.1
    valid = rng.rand(300) > 0.1
    ij, dj = jin._knn(jnp.asarray(u), jnp.asarray(v), jnp.asarray(valid), 10,
                      chunk=128)
    it, dt = tin._knn(t32(u), t32(v), t32(valid).bool(), 10, chunk=128)
    equal(it, ij)
    close(dt, dj, 0, 0)


def test_track_frames_from_same_state(seq):
    """Both bootstrap LMs start from one JAX set_first state (carried
    through utils/convert) and track the same frames: the LM and its
    per-point Schur complement amplify float32 rounding, so poses agree to
    1e-4 and level-0 idepths to 1e-3 relative; the snap flags are equal."""
    calib, _, pj, pt = seq
    sj = jin.set_first(pj[0], calib, JC())
    st = convert.init_state_to_torch(sj)
    for k in range(1, 5):
        dj = jin.track_frame(sj, pj[0], pj[k], calib, JC())
        dt = tin.track_frame(st, pt[0], pt[k], calib, TC())
        assert dj == dt and sj.snapped == st.snapped, f"frame {k}"
        close(st.T, sj.T, 0, 1e-4, f"T frame {k}")
        close(st.aff, sj.aff, 0, 1e-5, "aff")
        good = npy(sj.levels[0].valid)
        close(npy(st.levels[0].iR)[good], np.asarray(sj.levels[0].iR)[good],
              1e-3, 1e-5, f"iR frame {k}")
        equal(st.levels[0].is_good, sj.levels[0].is_good, "is_good")
    back = convert.init_state_to_numpy(st)
    assert back["snapped"] == sj.snapped and len(back["levels"]) == calib.levels
