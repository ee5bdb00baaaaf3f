"""The frame step and the chain step as one program each
(system/full_system.frame_step and chain_step, the programs of
FRAME_STEP_GRAPHS and CHAIN_STEP_GRAPHS on the card).

The inputs come from a JAX FullSystem stopped after SNAP frames of
tests/test_pipeline.py's plane trajectory at 192x144 (the reduced config
of tests/test_torch_pipeline.py), carried to the port by utils/convert:
the next frame, the tracking reference, the candidate arena and the
window's tables. On the CPU each program runs eagerly, the code a CUDA
graph captures on the card. The strict program is held against the JAX
package's `_frame_step` with its trace, the gate passing, failing on the
residual, failing on `ok`, with no last RMSE, and with the trace not
committed: the packed row at the chain test's tolerances
(tests/test_torch_pipeline.py::test_chain_frame_step_matches), the traced
fields where the trace was committed at test_trace_twice's
(tests/test_torch_immature.py), and the arena bitwise as it went in where
it was not. It is held bitwise against the eager sequence it replaced (the
pyramid, track_frame, the gate on the host, the trace); the chain program
against JAX's `_frame_step_chain` followed by `_chain_update`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_utils import close, equal, npy, t32

from ldso_tpu.config import Config as JC
from ldso_tpu.math import lie
from ldso_tpu.system import full_system as jfs
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.frontend import immature as tim
from ldso_tpu_torch.frontend import tracker as ttr
from ldso_tpu_torch.ops.preprocess import make_pyramid, upload_image
from ldso_tpu_torch.system import full_system as tfs
from ldso_tpu_torch.utils import convert, graphs

KW = dict(max_points=512, max_immature=512,
          tracker_caps=(4096, 2048, 1024, 512, 256, 128),
          desired_point_density=300, desired_immature_density=250,
          enable_loop_closing=False)
SNAP = 14           # frames before the snapshot; frame SNAP is stepped

# the packed row's tolerances (test_chain_frame_step_matches): pose 1e-4,
# affine 1e-3, the two flags exact, residuals and flow 1e-3 relative plus
# 1e-4
def _row_tols(L):
    atol = np.r_[np.full(16, 1e-4), np.full(2, 1e-3), 0, 0,
                 np.full(L + 3, 1e-4)]
    rtol = np.r_[np.zeros(20), np.full(L + 3, 1e-3)]
    return atol, rtol


# the cases of the gate: (last RMSE at level 0: None keeps the snapshot's,
# the frame's exposure, commit, the trace flag expected, ok expected)
CASES = {
    "gate_passes": (None, 1.0, True, 1.0, 1.0),
    "fails_on_residual": (1e-6, 1.0, True, 0.0, 1.0),
    # an exposure e^2 times the reference's: the tracker's affine a
    # goes to about -2, past the sanity gate's 1.2
    "fails_on_ok": (None, float(np.exp(2.0)), True, 0.0, 0.0),
    "last_rmse_inf": (np.inf, 1.0, True, 1.0, 1.0),
    "commit_0": (None, 1.0, False, 0.0, 1.0),
}


@pytest.fixture(scope="module")
def snap():
    """A JAX FullSystem after SNAP frames of the plane trajectory (uint8
    frames rendered by the JAX package), the port FullSystem carried from
    it, and the frames."""
    from ldso_tpu.synthetic import PlaneScene, default_calib
    calib = default_calib(192, 144)
    scene = PlaneScene(freq_hi=25.0, contrast=80.0)
    images = []
    for i in range(SNAP + 1):
        t = np.array([0.035 * i, 0.01 * np.sin(0.2 * i), 0.003 * i,
                      0.0, 0.0015 * i, 0.0])
        T = np.linalg.inv(np.asarray(lie.se3_exp(jnp.asarray(t))))
        img, _ = scene.render(calib, jnp.asarray(T, jnp.float32))
        images.append(np.clip(np.round(np.asarray(img)), 0,
                              255).astype(np.uint8))
    fj = jfs.FullSystem(calib, JC(**KW))
    for i in range(SNAP):
        fj.add_active_frame(images[i], i, 1.0, i * 0.05)
    assert fj.initialized and not (fj.is_lost or fj.init_failed)
    fp = convert.full_system_to_torch(fj, TC(**KW), "cpu")
    live = np.asarray(fj.imm_arena.pool.valid) & (
        np.asarray(fj.imm_arena.host) >= 0)
    assert live.sum() > 100
    return calib, fj, fp, images


def _hypothesis0(fs):
    """Hypothesis 0 of the next frame as _track_new_coarse forms it, with
    the previous frame's affine, and the reference shell."""
    ref_shell = fs.tracker_ref_shell
    slast, sprelast = fs.all_frames[-1], fs.all_frames[-2]
    tries = tfs._motion_hypotheses(
        slast.T_cw @ np.linalg.inv(ref_shell.T_cw),
        sprelast.T_cw @ np.linalg.inv(slast.T_cw))
    return tries[0], slast.aff.copy(), ref_shell


def _f32(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _jax_tables(fj):
    """The JAX FullSystem's window tables as its _track_new_coarse uploads
    them: T_hosts (F, 4, 4), host_affs (F, 2), host_expos (F,)."""
    F = fj.ef.F
    T_hosts = np.tile(np.eye(4), (F, 1, 1))
    host_affs = np.zeros((F, 2))
    host_expos = np.ones(F)
    for i, fr in enumerate(fj.window_frames):
        T_hosts[i] = fr.T_cw
        host_affs[i] = fr.aff
        host_expos[i] = fr.exposure or 1.0
    return _f32(T_hosts), _f32(host_affs), _f32(host_expos)


def _jax_step(fj, image, T0, aff0, expo, last, enable_trace):
    calib, cfg = fj.calib, fj.cfg
    ref, ref_shell = fj._tracker_ref_pair
    return jfs._frame_step(
        jnp.asarray(image), fj.imm_arena, ref, _f32(T0), _f32(aff0),
        jnp.float32(expo), _f32(last), _f32(ref_shell.T_cw),
        *_jax_tables(fj), None, enable_trace, calib, cfg,
        calib.levels - 1)


def _jax_trace_tables(fj, T, aff, expo):
    """The trace's tables at the tracked pose T and affine aff, formed as
    JAX's `_frame_step` forms them (full_system.py:72-82)."""
    T_hosts, host_affs, host_expos = _jax_tables(fj)
    K = _f32(fj.calib.K(0))
    Ki = jnp.linalg.inv(K)
    T_rel = jnp.einsum("ij,fjk->fik",
                       _f32(T) @ _f32(fj._tracker_ref_pair[1].T_cw),
                       jnp.linalg.inv(T_hosts))
    KRKis = jnp.einsum("ij,fjk,kl->fil", K, T_rel[:, :3, :3], Ki)
    Kts = jnp.einsum("ij,fj->fi", K, T_rel[:, :3, 3])
    aff = _f32(aff)
    ra = jnp.exp(aff[0] - host_affs[:, 0]) * jnp.float32(expo) / host_expos
    return KRKis, Kts, jnp.stack([ra, aff[1] - ra * host_affs[:, 1]], -1)


def _port_step(fp, image, T0, aff0, expo, commit, T_ref_cw):
    """The strict program through full_system._program (eagerly on the
    CPU): (pyr, arena', packed)."""
    ref, _ = fp._current_tracker_ref()
    up = fp._frame_upload(T0, aff0, expo, commit, T_ref_cw)
    out = tfs._program(*fp._frame_step_call(
        tfs.frame_image(image, "cpu"), ref, fp.imm_arena, up))
    L = fp.calib.levels
    return (out[:L], out[L:2 * L]), tfs._arena_of(out[2 * L:-1]), out[-1]


def _last_rmse(fj, last):
    lr = np.array(fj.last_coarse_rmse[:fj.calib.levels], np.float64)
    if last is not None:
        lr[0] = last
    return lr


@pytest.mark.parametrize("case", list(CASES))
def test_frame_step_matches_jax(snap, case):
    """The strict program against JAX's `_frame_step` (its trace on, off
    for commit 0) on the snapshot's next frame, reference, arena and
    window: the packed row within _row_tols, the ok and trace flags
    exact; where the trace was committed, the traced fields as
    test_trace_twice holds them (statuses exact, intervals and positions
    1e-4 relative, quality 2e-3) against JAX's trace of the same arena on
    the tables the program formed from its tracked pose, which are held
    within 1e-5 relative plus 5e-5 of the tables JAX's `_frame_step` forms
    of that pose (a short baseline amplifies their float32 rounding past the
    trace's tolerances in a few lanes); where it was not, the port's arena
    bitwise its input."""
    calib, fj, fp, images = snap
    last, expo, commit, flag, ok = CASES[case]
    L = calib.levels
    T0, aff0, ref_shell = _hypothesis0(fp)
    lr = _last_rmse(fj, last)
    arena_j, pyr_j, pk_j = _jax_step(fj, images[SNAP], T0, aff0, expo, lr,
                                     commit)
    fp.last_coarse_rmse = lr
    (dI, _), arena_t, pk_t = _port_step(fp, images[SNAP], T0, aff0, expo,
                                        commit, ref_shell.T_cw)
    pk_j, pk_t = npy(pk_j), npy(pk_t)
    assert pk_t.shape == pk_j.shape == (23 + L,)
    atol, rtol = _row_tols(L)
    assert np.isclose(pk_t, pk_j, rtol=rtol, atol=atol).all(), (pk_t, pk_j)
    assert pk_t[19] == pk_j[19] == flag and pk_t[18] == pk_j[18] == ok
    close(dI[0], pyr_j.dI[0], 0, 1e-5, "pyramid")
    if flag:
        # the tables the program formed from its tracked pose, and JAX's
        # of the same pose; then JAX's trace on the program's tables
        T, aff = pk_t[:16].reshape(4, 4), pk_t[16:18]
        tables = tfs.trace_tables(
            t32(T) @ t32(ref_shell.T_cw), t32(aff), expo,
            *(t32(x) for x in _jax_tables(fj)), calib)
        # K R K^-1 and K t sum products of terms up to some hundreds
        # (fx, cx times R and t): float32 keeps them to a few 1e-5
        for got, w in zip(tables, _jax_trace_tables(fj, T, aff, expo)):
            close(got, w, 1e-5, 5e-5, "tables")
        from ldso_tpu.frontend import immature as jim
        want = convert.arena_to_torch(jim.trace_arena(
            fj.imm_arena, pyr_j.dI[0], *(_f32(npy(t)) for t in tables),
            calib, fj.cfg))
        equal(arena_t.pool.status, want.pool.status, "status")
        for f in ("idepth_min", "idepth_max", "last_u", "last_v",
                  "last_interval"):
            close(getattr(arena_t.pool, f), getattr(want.pool, f), 1e-4,
                  1e-4, f)
        close(arena_t.pool.quality, want.pool.quality, 2e-3, 1e-4,
              "quality")
        moved = npy(arena_t.pool.status) != npy(fp.imm_arena.pool.status)
        assert moved.any()
    else:
        for a, b in zip(tfs._arena_flat(arena_t),
                        tfs._arena_flat(fp.imm_arena)):
            assert torch.equal(a, b)


def _old_frame_step(fp, image, T0, aff0, expo, commit, T_ref_cw):
    """The eager sequence the strict program replaced: the pyramid,
    track_frame, the retrack gate on the host in float32, then
    _trace_transforms and _trace_arena where it passed. Returns (pyr, the
    row without the trace flag, the gate, the arena)."""
    calib, cfg = fp.calib, fp.cfg
    L = calib.levels
    ref, _ = fp._current_tracker_ref()
    pyr = make_pyramid(upload_image(image, "cpu"), L, fp.b_grad)
    T, aff, ok, res, flow = ttr.track_frame(
        ref, pyr, t32(T0), t32(aff0), fp._f32(expo),
        torch.full((L,), 1e9), calib, cfg, L - 1)
    row = torch.cat([T.reshape(-1), aff, ok.to(torch.float32)[None], res,
                     flow]).numpy()
    last0 = np.float32(fp.last_coarse_rmse[0])
    gate = commit and bool(row[18] > 0.5 and np.isfinite(row[19]) and (
        not np.isfinite(last0)
        or row[19] < last0 * np.float32(cfg.re_track_threshold)))
    arena = fp.imm_arena
    if gate:
        fp._trace_arena(pyr, *fp._trace_transforms(T @ t32(T_ref_cw), aff,
                                                   expo))
    arena, fp.imm_arena = fp.imm_arena, arena
    return pyr, row, gate, arena


@pytest.mark.parametrize("case", list(CASES))
def test_frame_step_is_the_eager_sequence(snap, case):
    """The strict program gives bitwise what the eager sequence it
    replaced gave on the CPU: the pyramid, the row, the gate (its trace
    flag) and the arena."""
    calib, fj, fp, images = snap
    last, expo, commit, flag, _ = CASES[case]
    T0, aff0, ref_shell = _hypothesis0(fp)
    fp.last_coarse_rmse = _last_rmse(fj, last)
    pyr, row, gate, arena = _old_frame_step(fp, images[SNAP], T0, aff0,
                                            expo, commit, ref_shell.T_cw)
    (dI, ag), arena_t, pk = _port_step(fp, images[SNAP], T0, aff0, expo,
                                       commit, ref_shell.T_cw)
    pk = pk.numpy()
    assert gate == bool(pk[19] > 0.5) == bool(flag)
    assert np.r_[pk[:19], pk[20:]].tobytes() == row.tobytes()
    for a, b in zip(dI + ag, pyr.dI + pyr.abs_grad):
        assert torch.equal(a, b)
    for a, b in zip(tfs._arena_flat(arena_t), tfs._arena_flat(arena)):
        assert torch.equal(a, b)


def test_frame_step_dispatch_commits_only_its_own(snap):
    """FullSystem._frame_step: with commit_trace the arena takes the
    program's (bitwise the eager sequence's), and the packed row's trace
    flag is the gate; without it the arena is left as it was (the mapping
    side's) and the flag is 0."""
    calib, fj, fp, images = snap
    T0, aff0, ref_shell = _hypothesis0(fp)
    fp.last_coarse_rmse = _last_rmse(fj, None)
    ref, _ = fp._current_tracker_ref()
    arena0 = fp.imm_arena
    _, _, gate, want = _old_frame_step(fp, images[SNAP], T0, aff0, 1.0, True,
                                       ref_shell.T_cw)
    try:
        _, pk = fp._frame_step(images[SNAP], ref, T0, aff0, 1.0,
                               ref_shell.T_cw, commit_trace=True)
        assert gate and pk[19] == 1.0 and pk.dtype == np.float64
        for a, b in zip(tfs._arena_flat(fp.imm_arena),
                        tfs._arena_flat(want)):
            assert torch.equal(a, b)
        fp.imm_arena = arena0
        _, pk0 = fp._frame_step(images[SNAP], ref, T0, aff0, 1.0,
                                ref_shell.T_cw, commit_trace=False)
        assert pk0[19] == 0.0 and fp.imm_arena is arena0
        assert np.r_[pk0[:19], pk0[20:]].tobytes() == \
            np.r_[pk[:19], pk[20:]].tobytes()
    finally:
        fp.imm_arena = arena0


def test_chain_step_matches_jax(snap):
    """The chain program against JAX's `_chain_prep`, `_frame_step_chain`
    and `_chain_update` from the snapshot's chain (its last two frames,
    affine and residuals) against its reference: the packed row within
    _row_tols with a zero trace flag, the new chain's poses within 1e-4,
    its affine within 1e-3, its residuals 1e-3 relative plus 1e-4."""
    calib, fj, fp, images = snap
    L = calib.levels
    fp.last_coarse_rmse = np.array(fj.last_coarse_rmse, np.float64)
    fj.chain_reset()
    fp.chain_reset()
    ref_j, ref_shell = fj._tracker_ref_pair
    T_ref = np.asarray(ref_shell.T_cw, np.float32)
    T0, aff0, rmse = jfs._chain_prep(fj.track_chain, jnp.asarray(T_ref))
    _, pk_j = jfs._frame_step_chain(
        jnp.asarray(images[SNAP]), ref_j, T0, aff0, jnp.float32(1.0), rmse,
        None, calib, fj.cfg, L - 1)
    chain_j = jfs._chain_update(fj.track_chain, pk_j, T0, jnp.asarray(T_ref))
    ref_t, _ = fp._current_tracker_ref()
    pyr, pk_t, chain_t = fp._chain_step(
        tfs.frame_image(images[SNAP], "cpu"), ref_t, fp.track_chain,
        t32(np.r_[np.ravel(ref_shell.T_cw), 1.0]))
    pk_j, pk_t = npy(pk_j), npy(pk_t)
    atol, rtol = _row_tols(L)
    assert np.isclose(pk_t, pk_j, rtol=rtol, atol=atol).all(), (pk_t, pk_j)
    assert pk_t[18] == pk_j[18] == 1.0 and pk_t[19] == pk_j[19] == 0.0
    for name, tol in (("T_slast", 1e-4), ("T_sprelast", 1e-4),
                      ("aff", 1e-3)):
        close(getattr(chain_t, name), getattr(chain_j, name), 0, tol, name)
    close(chain_t.rmse, chain_j.rmse, 1e-3, 1e-4, "rmse")


def test_a_trace_knob_keys_its_own_graph(snap):
    """The strict program closes over the whole Config: a Config that
    differs in one trace knob keys a graph of its own; the chain program
    reads the tracker's fields alone and shares its graph."""
    calib, fj, fp, images = snap
    other = tfs.FullSystem(calib, dataclasses.replace(
        TC(**KW), trace_refine_steps=fp.cfg.trace_refine_steps + 1),
        device="cpu")
    ref, _ = fp._current_tracker_ref()
    img = tfs.frame_image(images[SNAP], "cpu")
    up = fp._frame_upload(np.eye(4), np.zeros(2), 1.0, True, np.eye(4))
    chain_up = t32(np.r_[np.eye(4).ravel(), 1.0])
    fp.chain_reset()
    keys = {}
    for name, fs in (("fp", fp), ("other", other)):
        _, static, _, inputs = fs._frame_step_call(img, ref, fs.imm_arena, up)
        keys[name, "strict"] = graphs._key(static, inputs)
        _, static, _, inputs = fs._chain_step_call(img, ref, fp.track_chain,
                                                   chain_up)
        keys[name, "chain"] = graphs._key(static, inputs)
    assert keys["fp", "strict"] != keys["other", "strict"]
    assert keys["fp", "chain"] == keys["other", "chain"]
    # and the frame's dtype: each of FRAME_DTYPES keys its own
    _, static, _, inputs = fp._frame_step_call(img.to(torch.float32), ref,
                                               fp.imm_arena, up)
    assert graphs._key(static, inputs) != keys["fp", "strict"]


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32",
                                   "float64"])
def test_frame_image_is_what_the_pyramid_reads(dtype):
    """frame_image hands the step a frame in one of FRAME_DTYPES whose
    pyramid is bitwise the one make_pyramid builds of the frame as given."""
    rng = np.random.RandomState(4)
    img = (rng.rand(48, 64) * 250).astype(dtype)
    if dtype == "uint16":
        img = (img.astype(np.uint16) * 256 + 7).astype(np.uint16)
    got = tfs.frame_image(img, "cpu")
    assert got.dtype in tfs.FRAME_DTYPES
    want = make_pyramid(upload_image(img, "cpu"), 3)
    for a, b in zip(make_pyramid(got, 3).dI, want.dI):
        assert torch.equal(a, b)
