"""frontend/initializer: set_first and the bootstrap LM against JAX, and
the masked LM of the bootstrap's one program against the early-exit loop
it replaced (tests/torch_init_parent.py), bit for bit."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_init_parent as parent
from test_torch_keyframe_programs import host_reads
from torch_port_utils import close, equal, npy, plane_frames, t32

from ldso_tpu.config import Config as JC
from ldso_tpu.frontend import initializer as jin
from ldso_tpu.ops.preprocess import make_pyramid as jmp
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.frontend import initializer as tin
from ldso_tpu_torch.ops.preprocess import make_pyramid as tmp
from ldso_tpu_torch.utils import convert, graphs


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


# ---------------------------------------------------------------------------
# the bootstrap as one program: the masked LM against the early-exit loop
# ---------------------------------------------------------------------------

def _levels_equal(got, want, what):
    for lvl, (Lg, Lw) in enumerate(zip(got, want)):
        for f in tin.InitLevel._fields:
            equal(getattr(Lg, f), getattr(Lw, f), f"{what}: {f} level {lvl}")


def test_masked_bootstrap_is_the_early_exit_loop(seq):
    """Bootstrap frames through the masked program (every level's LM to
    its full trip count under a device quit flag, one read per frame)
    and through the early-exit loop as it ran before
    (tests/torch_init_parent.py) from one set_first state: bitwise equal
    levels, T, aff and snap flags, the same live trips on every level,
    from an un-snapped frame and from snapped ones."""
    calib, _, _, pt = seq
    sa = tin.set_first(pt[0], calib, TC())
    sb = copy.deepcopy(sa)
    entry = []
    for k in range(1, 5):
        entry.append(sb.snapped)
        trips = []
        da = parent.track_frame(sa, pt[0], pt[k], calib, TC(), trips=trips)
        db = tin.track_frame(sb, pt[0], pt[k], calib, TC())
        assert (da, sa.snapped, sa.frame_id) == (db, sb.snapped, sb.frame_id)
        assert list(sb.trips) == trips and len(trips) == calib.levels, k
        equal(sb.T, sa.T, f"T frame {k}")
        equal(sb.aff, sa.aff, f"aff frame {k}")
        _levels_equal(sb.levels, sa.levels, f"frame {k}")
    assert False in entry and True in entry


@pytest.mark.parametrize("snapped,fix_affine", [
    (False, True), (True, True), (False, False), (True, False)])
def test_masked_level_opt_is_the_early_exit_loop(seq, snapped, fix_affine):
    """The masked `_level_opt` on every level of a bootstrap state (after
    one frame), entered snapped or not, with the affine fixed or free:
    bitwise the early-exit loop's L, T, aff, snap flag and res, and its
    trip count the early-exit loop's."""
    calib, _, _, pt = seq
    st = tin.set_first(pt[0], calib, TC())
    tin.track_frame(st, pt[0], pt[1], calib, TC())
    T = torch.tensor(st.T, dtype=torch.float32)
    aff = torch.tensor(st.aff, dtype=torch.float32)
    for lvl in range(calib.levels):
        L = st.levels[lvl]
        trips = []
        want = parent._level_opt(L, pt[0].dI[lvl], pt[2].dI[lvl], T, aff,
                                 snapped, lvl, calib, TC(), fix_affine,
                                 trips=trips)
        got = tin._level_opt(L, pt[0].dI[lvl], pt[2].dI[lvl], T, aff,
                             torch.tensor(snapped), lvl, calib, TC(),
                             fix_affine)
        _levels_equal([got[0]], [want[0]], f"level {lvl}")
        for i, what in ((1, "T"), (2, "aff"), (4, "res")):
            equal(got[i], want[i], f"{what} level {lvl}")
        assert bool(got[3]) == want[3] and int(got[5]) == trips[0], lvl
        assert 1 <= trips[0] <= tin.MAX_ITERATIONS[lvl] + 1


def test_masked_level_opt_matches_jax(seq):
    """The masked `_level_opt` against the JAX package's jitted
    while_loop on every level of one JAX bootstrap state (carried through
    utils/convert), at test_track_frames_from_same_state's tolerances:
    T 1e-4, aff 1e-5, valid points' iR 1e-3 relative (1e-5 absolute), the
    good flags and the snap flag equal."""
    calib, _, pj, pt = seq
    sj = jin.set_first(pj[0], calib, JC())
    jin.track_frame(sj, pj[0], pj[1], calib, JC())
    st = convert.init_state_to_torch(sj)
    T = jnp.asarray(sj.T, jnp.float32)
    aff = jnp.asarray(sj.aff, jnp.float32)
    for lvl in range(calib.levels):
        Lj, Tj, affj, snj, _ = jin._level_opt(
            sj.levels[lvl], pj[0].dI[lvl], pj[2].dI[lvl], T, aff,
            jnp.asarray(sj.snapped), lvl, calib, JC())
        Lt, Tt, afft, snt, _, _ = tin._level_opt(
            st.levels[lvl], pt[0].dI[lvl], pt[2].dI[lvl], t32(np.asarray(T)),
            t32(np.asarray(aff)), torch.tensor(sj.snapped), lvl, calib, TC())
        close(Tt, Tj, 0, 1e-4, f"T level {lvl}")
        close(afft, affj, 0, 1e-5, f"aff level {lvl}")
        assert bool(snt) == bool(snj), lvl
        good = npy(Lj.valid)
        close(npy(Lt.iR)[good], np.asarray(Lj.iR)[good], 1e-3, 1e-5,
              f"iR level {lvl}")
        equal(Lt.is_good, Lj.is_good, f"is_good level {lvl}")


def test_bootstrap_program_reads_nothing_back(seq):
    """A bootstrap frame's program calls no operator that reads the device
    from the host or uploads host values, after one frame has made the
    device constants: what lets a CUDA graph capture it. Its dispatch
    adds only the one upload (pinned on the card) and the HostCopy; its
    one read is track_frame_finish's."""
    calib, _, _, pt = seq
    st = tin.set_first(pt[0], calib, TC())
    tin.track_frame(st, pt[0], pt[1], calib, TC())
    up = torch.zeros(19)
    up[:16] = torch.from_numpy(st.T.astype(np.float32)).reshape(-1)
    up[18] = float(st.snapped)
    _, _, program, inputs = tin._frame_call(st, pt[0].dI, pt[2].dI, up,
                                            calib, TC())
    with host_reads() as seen:
        program(*inputs)
    assert not seen, dict(seen)
    with host_reads(uploads=False) as seen:
        pull = tin.track_frame_dispatch(st, pt[0], pt[2], calib, TC())
    assert not seen, dict(seen)
    tin.track_frame_finish(st, pull)
    assert st.frame_id == 2 and len(st.trips) == calib.levels


def test_bootstrap_key_holds_config_and_caps(seq):
    """The bootstrap frame's graph key (utils/graphs._key of its static
    part and inputs) changes with a Config field the program reads (the
    Huber threshold) and with the levels' capacities, and not for an
    equal Config."""
    calib, _, _, pt = seq
    st = tin.set_first(pt[0], calib, TC())
    up = torch.zeros(19)

    def key(state, cfg):
        _, static, _, inputs = tin._frame_call(state, pt[0].dI, pt[1].dI, up,
                                               calib, cfg)
        return graphs._key(static, inputs)
    k0 = key(st, TC())
    assert key(st, TC()) == k0
    assert key(st, dataclasses.replace(TC(), huber_th=2 * TC().huber_th)) \
        != k0
    wide = copy.copy(st)
    wide.levels = (st.levels[0]._replace(**{
        f: torch.cat([t, t]) for f, t in st.levels[0]._asdict().items()}),
    ) + st.levels[1:]
    assert key(wide, TC()) != k0
