"""The keyframe's dispatch with no host read: its four captured programs
(the activation pass, the post-BA flags and packed row, the tracker
reference, the new candidates), the BA's deferred stats and the staged
arena counts.

Each program is held against the JAX function on the same inputs, taken
from a JAX FullSystem stopped after SNAP frames of the reduced slice scene
(tests/test_torch_full_system.py's config at 256x192) and carried to the
port by utils/convert: masks, states, counts and indices exactly, floats at
the tolerance the earlier tests hold these functions to (poses and the
tracker reference's points 1e-5 relative and 1e-6 absolute, as
test_keyframe_helpers_from_snapshot; make_pool's float fields 1e-4
relative, as test_torch_immature.test_arena_ops). On the CPU each program
runs eagerly, the code a CUDA graph captures on the card. A
TorchDispatchMode then shows that no program, and no part of a keyframe's
dispatch from the BA through the new candidates, reads the device from the
host.
"""

import collections
import contextlib
import copy
import dataclasses
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree
from torch.utils._python_dispatch import TorchDispatchMode

from torch_port_utils import close, equal, npy, plane_frames, tt

from ldso_tpu.config import Config as JC
from ldso_tpu.frontend import detector as jdet
from ldso_tpu.frontend import immature as jim
from ldso_tpu.system import full_system as jfs
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.examples import time_modes
from ldso_tpu_torch.frontend import detector as tdet
from ldso_tpu_torch.frontend import immature as tim
from ldso_tpu_torch.ops import cuda_kernels
from ldso_tpu_torch.ops.scatter import segment_sum
from ldso_tpu_torch.system import full_system as tfs
from ldso_tpu_torch.utils import convert, graphs
from ldso_tpu_torch.utils.device import HostCopy

KW = dict(max_points=1024, max_immature=1024,
          tracker_caps=(8192, 4096, 2048, 1024, 512, 256),
          desired_point_density=500, desired_immature_density=400,
          enable_loop_closing=False)
SNAP = 20                   # frames before the snapshot (5-6 keyframes)
RUN = 24                    # the port-only run's frames


@pytest.fixture(scope="module")
def snap():
    """A JAX FullSystem after SNAP frames and the port FullSystem carried
    from it (utils/convert.full_system_to_torch)."""
    calib, poses, imgs, _ = plane_frames(SNAP + 1, 256, 192)
    fj = jfs.FullSystem(calib, JC(**KW))
    for i in range(SNAP):
        fj.add_active_frame(imgs[i], i, 1.0, i * 0.05)
    assert not (fj.is_lost or fj.init_failed)
    assert len(fj.window_frames) >= 4
    fp = convert.full_system_to_torch(fj, TC(**KW), "cpu")
    return calib, fj, fp


def _upload(F, flags, newest, exposure=1.0):
    """The keyframe's upload (FullSystem._kf_upload's layout)."""
    row = np.zeros(F + 3, np.float32)
    row[:F] = flags
    row[F:] = (newest, newest - 1, exposure)
    return torch.from_numpy(row)


def _planted_window(W_j, rng):
    """W_j with a few valid points stripped of every residual (the dead
    points the post-BA program drops) and a few newest-frame residuals
    set out of bounds or outlier (removal decisions)."""
    pv = np.asarray(W_j.pt_valid)
    ids = np.nonzero(pv)[0]
    ex = np.array(W_j.res_exist)
    ex[rng.choice(ids, 5, replace=False)] = False
    st = np.array(W_j.res_state)
    for s in (1, 2):
        st[rng.choice(ids, 7, replace=False), :] = s
    return W_j._replace(res_exist=jnp.asarray(ex), res_state=jnp.asarray(st))


# ------------------------------------------------------------ segment_sum
def _segment_sum_old(values, index, n):
    """segment_sum before it took its offsets from a search: a bincount
    of the destinations as the segments' lengths."""
    index = index.to(torch.int64)
    _, perm = torch.sort(index, stable=True)
    lengths = torch.bincount(index, minlength=n)
    rest = values.shape[1:]
    width = int(np.prod(rest)) if rest else 1
    out = torch.segment_reduce(values[perm].reshape(values.shape[0], width),
                               "sum", lengths=lengths, axis=0, unsafe=True)
    return out.reshape((n,) + rest)


@pytest.mark.parametrize("N,n,trailing,seed", [
    (5000, 1000, (), 0), (3000, 49152, (), 1), (700, 40, (3,), 2),
    (64, 300, (2, 2), 3), (0, 4, (), 4)])
def test_segment_sum_keeps_its_bits(N, n, trailing, seed):
    """The search of the sorted destinations gives segment_reduce the
    same segments as the bincount did: bitwise the old sums, with heavy
    pile-ups, empty destinations and no source at all."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, n, N)
    idx[:N // 3] = rng.randint(0, 8, N // 3)
    v = torch.from_numpy((rng.standard_normal((N,) + trailing)
                          * 10.0 ** rng.randint(-3, 4, (N,) + trailing))
                         .astype(np.float32))
    got = segment_sum(v, torch.from_numpy(idx), n)
    equal(got, _segment_sum_old(v, torch.from_numpy(idx), n))
    if N:
        want = torch.zeros((n,) + trailing).index_add_(0, torch.from_numpy(
            idx), v)
        equal(got, want)


# ---------------------------------------------------------- the programs
@pytest.mark.parametrize("flagged", [(), (0,), (1, 2)])
def test_post_ba_program_matches_jax(snap, flagged):
    """FullSystem._post_ba (post_ba_packed on the keyframe's upload)
    against the JAX package's _post_ba_dev on a planted window: the
    packed row's dead, drop and marg masks, priors and deltas and the
    window's masks exactly, poses and affines within 1e-5 relative."""
    calib, fj, fp = snap
    nf = len(fj.window_frames)
    F, P = fj.ef.F, fj.ef.P
    W_j = _planted_window(fj.ef.W, np.random.RandomState(len(flagged)))
    flags = np.zeros(F, bool)
    flags[list(flagged)] = True
    W2, pk_j, drop_j, marg_j = jfs._post_ba_dev(
        W_j, jnp.asarray(flags), jnp.asarray(flags), jnp.int32(nf - 1),
        jnp.int32(nf - 2))
    pk_j = np.asarray(pk_j)
    W0 = fp.ef.W
    fp.ef.W = convert.window_to_torch(W_j)
    fp.marg_flags = list(flags[:nf])
    try:
        post, drop, marg = fp._post_ba(fp._kf_upload())
        W_t = fp.ef.W
    finally:
        fp.ef.W = W0
    pk = post.numpy()
    assert pk.shape == pk_j.shape == (F * 34 + 3 * P,)
    equal(pk[F * 18:], pk_j[F * 18:], "dead, drop, marg, priors, deltas")
    close(pk[:F * 18], pk_j[:F * 18], 1e-5, 1e-6, "poses and affines")
    equal(drop, drop_j, "drop")
    equal(marg, marg_j, "marg")
    for f in ("pt_valid", "res_exist", "res_active"):
        equal(getattr(W_t, f), getattr(W2, f), f)
    T, A, dead, priors, deltas = tfs.unpack_post_ba(pk.astype(np.float64),
                                                    F, P)
    assert dead.sum() == 5 and npy(drop | marg).sum() > 0
    equal(priors, np.asarray(W_j.prior))
    equal(deltas, np.asarray(W_j.state)[:, :8])


@pytest.mark.parametrize("back,exposure", [(1, 1.0), (2, 0.8)])
def test_tracker_ref_program_matches_jax(snap, back, exposure):
    """The tracker reference's program (tracker_ref_fused on the
    keyframe's upload, newest a device integer) against the JAX package's
    _make_tracker_ref_fused: valid masks exactly, points within 1e-5
    relative (test_keyframe_helpers_from_snapshot's), the affine and
    exposure within float32 rounding."""
    calib, fj, fp = snap
    F = fj.ef.F
    newest = len(fj.window_frames) - back
    caps = tuple(fp.cfg.tracker_caps[:calib.levels])
    rj = jfs._make_tracker_ref_fused(
        fj.ef.W, jnp.int32(newest), fj.window_pyrs[newest].dI,
        jnp.float32(exposure), calib, caps)
    up = _upload(F, np.zeros(F), newest, exposure)
    out = tfs._program(*fp._tracker_ref_call(fp.ef.W, up,
                                              fp.window_pyrs[newest].dI))
    L = calib.levels
    for lvl in range(L):
        equal(out[L + lvl], rj.valid[lvl], f"valid {lvl}")
        close(out[lvl], rj.points[lvl], 1e-5, 1e-6, f"points {lvl}")
        assert npy(out[L + lvl]).sum() > 0
    close(out[2 * L], rj.ref_exposure, 0, 0, "exposure")
    close(out[2 * L + 1], rj.ref_aff, 1e-6, 1e-7, "affine")
    if back == 1:
        # and the FullSystem's own dispatch gives the same reference
        ref, shell, _ = fp._dispatch_tracker_ref(fp._kf_upload())
        assert shell is fp.window_frames[-1]
        for lvl in range(L):
            equal(ref.points[lvl], out[lvl])
            equal(ref.valid[lvl], out[L + lvl])


def _arena_equal(at, aj, what):
    for f in jim.ImmaturePool._fields:
        close(getattr(at.pool, f), getattr(aj.pool, f), 1e-4, 0,
              f"{what}: {f}")
    for f in ("valid", "u", "v", "status", "my_type"):
        equal(getattr(at.pool, f), getattr(aj.pool, f), f"{what}: {f}")
    equal(at.host, aj.host, f"{what}: host")
    equal(tim.arena_counts_and_watermark(at, 8),
          jim.arena_counts_and_watermark(aj, 8), f"{what}: counts")


@pytest.mark.parametrize("host", [-1, 0])
def test_new_candidates_match_jax(snap, host):
    """The pure-VO new candidates (detect_status_map, arena_compact and
    arena_add_from_status as one program, the host a device integer)
    against the JAX package's three jitted functions on the snapshot's
    arena: lanes, states, hosts and counts exactly, float fields within
    1e-4 relative."""
    calib, fj, fp = snap
    F = fj.ef.F
    h = len(fj.window_frames) - 1 if host < 0 else host
    pj = fj.window_pyrs[-1]
    cfg_j = fj.cfg
    gp = jdet.detect_grid_params(calib.h[0], calib.w[0],
                                 int(cfg_j.desired_immature_density))
    status = jdet.detect_status_map(pj.dI[0], pj.abs_grad[0], *gp)
    aj = jim.arena_add_from_status(jim.arena_compact(fj.imm_arena), status,
                                   pj.dI[0], jnp.int32(h), fp._imm_cap,
                                   cfg_j)
    pt = fp.window_pyrs[-1]
    up = _upload(F, np.zeros(F), h)
    a0 = fp.imm_arena
    if host < 0:
        fp.imm_live[h] = False
        fp._make_new_traces(pt, up)
        assert fp.imm_live[h]
        at, fp.imm_arena = fp.imm_arena, a0
    else:
        at = tfs._arena_of(tfs._program(*fp._candidates_call(
            a0, pt.dI[0], pt.abs_grad[0], up)))
    equal(tdet.detect_status_map(pt.dI[0], pt.abs_grad[0], *gp), status,
          "status map")
    _arena_equal(at, aj, f"host {h}")
    assert npy(at.host == h).sum() > 50


def test_arena_half_matches_jax(snap):
    """The arena half that takes another selection's status map (a random
    map here, as point_selection 2 makes) against the JAX package's
    arena_compact and arena_add_from_status."""
    calib, fj, fp = snap
    F = fj.ef.F
    rng = np.random.RandomState(5)
    st = (rng.rand(calib.h[0], calib.w[0]) < 0.01).astype(np.int32)
    st *= rng.randint(1, 5, st.shape).astype(np.int32)
    h = len(fj.window_frames) - 1
    pj, pt = fj.window_pyrs[-1], fp.window_pyrs[-1]
    aj = jim.arena_add_from_status(jim.arena_compact(fj.imm_arena),
                                   jnp.asarray(st), pj.dI[0], jnp.int32(h),
                                   fp._imm_cap, fj.cfg)
    at = tfs._arena_of(tfs._program(
        tfs.NEW_TRACES_GRAPHS, (), tfs._candidates_program(
            None, fp._imm_cap, fp.cfg),
        tfs._arena_flat(fp.imm_arena) + (pt.dI[0], tt(st),
                                         _upload(F, np.zeros(F), h))))
    _arena_equal(at, aj, "status map of another selection")


@pytest.mark.parametrize("field", ["outlier_th_sum_component", "outlier_th",
                                   "overall_energy_th_weight"])
def test_new_candidates_key_holds_the_config(snap, field):
    """A system whose Config differs in a field the new candidates read
    (immature.make_pool's thresholds) keys a graph of its own, so it never
    replays another system's graph with that system's constants."""
    calib, _, fp = snap
    other = copy.copy(fp)
    other.cfg = dataclasses.replace(fp.cfg,
                                    **{field: 2.0 * getattr(fp.cfg, field)})
    dI0 = fp.window_pyrs[-1].dI[0]
    grad = fp.window_pyrs[-1].abs_grad[0]
    up = _upload(fp.ef.F, np.zeros(fp.ef.F), 0)
    key = fp._candidates_call(fp.imm_arena, dI0, grad, up)[1]
    key2 = other._candidates_call(fp.imm_arena, dI0, grad, up)[1]
    assert key != key2
    assert key == copy.copy(fp)._candidates_call(fp.imm_arena, dI0, grad,
                                                 up)[1]


def test_selection_status_maps_read_nothing():
    """The corner path's status map from detect_corners' features (the
    unpicked ones to a spare cell) equals the indexed assignment it
    replaces."""
    rng = np.random.RandomState(3)
    H, W, n = 96, 128, 300
    u = torch.from_numpy(rng.uniform(-5, W + 5, n).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-5, H + 5, n).astype(np.float32))
    valid = torch.from_numpy(rng.rand(n) < 0.6)
    ui = torch.clamp(u.to(torch.int64), 3, W - 4)
    vi = torch.clamp(v.to(torch.int64), 3, H - 4)
    want = torch.zeros(H * W, dtype=torch.int32)
    want[(vi * W + ui)[valid]] = 1
    cell = torch.where(valid, vi * W + ui, torch.full_like(ui, H * W))
    got = torch.zeros(H * W + 1, dtype=torch.int32).index_fill_(0, cell, 1)
    equal(got[:H * W], want)


# ------------------------------------------------------ the activation
def test_activation_program_is_the_fused_pass(port_run):
    """Every activation of the port's run again through the activation
    program (on the window's ACT_FIELDS, the arena, the images and the
    one upload; a window of nf frames, the newest nf - 1), run eagerly as
    the card's graph captures it: bitwise `_activate_fused` called as the
    FullSystem called it before (the window and arena whole, the tables
    from the upload), every window field it leaves alone untouched, and
    FullSystem._activation_pass left that window, arena and packed rows
    in the run."""
    fs, acts = port_run[0], port_run[3]
    calib = fs.calib
    assert len(acts) >= 3 and len({a[4] for a in acts}) >= 2
    inserted = removed = 0
    for W0, a0, dIs, up, nf, W1, a1, pull in acts:
        out = tfs._program(*fs._activation_call(W0, a0, dIs, up, nf))
        Wf, af, pf = tfs._activate_fused(
            W0, a0, dIs, *tfs.activation_tables(up, fs.ef.F), nf - 1, nf,
            fs.cfg, calib, calib.w[1], calib.h[1])
        nw = len(tfs.ACT_FIELDS)
        for f, t in zip(tfs.ACT_FIELDS, out[:nw]):
            equal(t, getattr(Wf, f), f)
        for f in W0._fields:
            if f not in tfs.ACT_FIELDS:
                assert getattr(Wf, f) is getattr(W0, f), f
            equal(getattr(W1, f), getattr(Wf, f), f)
        for a, b, c in zip(out[nw:-1], tfs._arena_flat(af),
                           tfs._arena_flat(a1)):
            equal(a, b)
            equal(c, b)
        equal(out[-1], pf, "packed")
        equal(pull.numpy(), pf, "pulled rows")
        inserted += int(npy(pf[:, 2]).sum())
        removed += int(npy(pf[:, 3]).sum())
    assert inserted > 0 and removed > 0


def test_activation_key_holds_the_window_and_config(snap):
    """The activation's graph key changes with the window's frame count
    (a graph per nf, newest nf - 1) and with a Config field the program
    reads (K1's sweeps, K5's outlier threshold), and not for an equal
    Config."""
    calib, _, fp = snap
    nf = len(fp.window_frames)
    up = torch.zeros(tfs.activation_upload_size(fp.ef.F))

    def key(fs, n):
        _, static, _, inputs = fs._activation_call(fp.ef.W, fp.imm_arena,
                                                   fp.dIs, up, n)
        return graphs._key(static, inputs)
    k0 = key(fp, nf)
    assert key(copy.copy(fp), nf) == k0
    assert len({key(fp, n) for n in range(1, fp.ef.F + 1)}) == fp.ef.F
    for field in ("dist_map_steps", "outlier_th"):
        other = copy.copy(fp)
        other.cfg = dataclasses.replace(
            fp.cfg, **{field: 2 * getattr(fp.cfg, field)})
        assert key(other, nf) != k0, field


# -------------------------------------------------- nothing read back
# aten operators whose CUDA kernels read the card from the host (a value,
# a count, a size) or copy host values into a tensor (an upload that a
# capture may not make)
READS = ("aten._local_scalar_dense", "aten.nonzero", "aten.bincount",
         "aten.masked_select", "aten.masked_scatter", "aten.unique_dim",
         "aten._unique2", "aten.unique_consecutive", "aten.equal",
         "aten.is_nonzero", "aten.index_put_", "aten.index_put",
         "aten._index_put_impl_")
UPLOADS = ("aten.lift_fresh",)
# the kernel wrappers: on the CPU their plain versions stand in for a
# launch, and what they do inside is not the dispatch's
WRAPPERS = ("distance_transform", "tracker_trip", "cutoff_trip", "lm_trip",
            "ba_projector", "trace_arena", "activate_arena", "ba_linearize",
            "ba_accumulate_top", "ba_accumulate_sc")


class HostReads(TorchDispatchMode):
    """Records every operator that reads the device from the host: READS,
    an index or index_put with a boolean index, and (with uploads=True)
    UPLOADS; `host_reads` adds the tensor methods that copy to the host."""

    def __init__(self, uploads: bool = True):
        super().__init__()
        self.names = READS + (UPLOADS if uploads else ())
        self.seen = collections.Counter()
        self.paused = 0

    def note(self, what):
        if not self.paused:
            where = [f"{f.filename.split('/')[-1]}:{f.lineno}"
                     for f in traceback.extract_stack()[:-2]
                     if "ldso_tpu_torch" in f.filename]
            self.seen[(what, tuple(where[-3:]))] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.replace("::", ".")
        if name in self.names:
            self.note(name)
        elif name == "aten.index" and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            self.note("boolean index")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def host_reads(uploads: bool = True):
    """A HostReads mode, with the tensor methods that copy to the host
    (`cpu`, `numpy`, `tolist`) recorded too, and the kernel wrappers'
    CPU stand-ins left out."""
    mode = HostReads(uploads)
    saved = {}
    for m in ("cpu", "numpy", "tolist"):
        saved[m] = getattr(torch.Tensor, m)

        def method(self, *a, _m=m, **k):
            mode.note(f"Tensor.{_m}")
            return saved[_m](self, *a, **k)
        setattr(torch.Tensor, m, method)
    wrapped = {}
    for name in WRAPPERS:
        wrapped[name] = fn = getattr(cuda_kernels, name)

        def paused(*a, _fn=fn, **k):
            mode.paused += 1
            try:
                return _fn(*a, **k)
            finally:
                mode.paused -= 1
        setattr(cuda_kernels, name, paused)
    try:
        with mode:
            yield mode.seen
    finally:
        for m, fn in saved.items():
            setattr(torch.Tensor, m, fn)
        for name, fn in wrapped.items():
            setattr(cuda_kernels, name, fn)


def _program_cases(calib, fp):
    """name -> a call of each program on the snapshot's inputs."""
    F = fp.ef.F
    W = fp.ef.W
    nf = len(fp.window_frames)
    up = _upload(F, np.arange(F) == 1, nf - 1)
    pyr = fp.window_pyrs[-1]
    gp = tdet.detect_grid_params(calib.h[0], calib.w[0],
                                 int(fp.cfg.desired_immature_density))
    st = tdet.detect_status_map(pyr.dI[0], pyr.abs_grad[0], *gp)
    cp = W.center_proj[:, nf - 1]
    act_up = fp._activation_upload()
    ref, ref_shell = fp._current_tracker_ref()
    img = pyr.dI[0][..., 0].contiguous()
    step_up = fp._frame_upload(np.eye(4), np.zeros(2), 1.0, True,
                               ref_shell.T_cw)
    eye = torch.eye(4)
    chain = tfs.TrackChain(eye, eye, torch.zeros(2),
                           torch.full((calib.levels,), float("inf")))
    chain_up = torch.from_numpy(np.r_[np.ravel(ref_shell.T_cw),
                                      1.0].astype(np.float32))
    return {
        "segment_sum": lambda: segment_sum(W.pt_u, torch.clamp(
            cp[:, 0].to(torch.int64), 0, 99), 100),
        "detect_status_map": lambda: tdet.detect_status_map(
            pyr.dI[0], pyr.abs_grad[0], *gp),
        "arena_add_from_status": lambda: tim.arena_add_from_status(
            tim.arena_compact(fp.imm_arena), st, pyr.dI[0], up[F].long(),
            fp._imm_cap, fp.cfg),
        "post_ba": lambda: tfs._program(*fp._post_ba_call(W, up)),
        "tracker_ref": lambda: tfs._program(*fp._tracker_ref_call(
            W, up, pyr.dI)),
        "new_candidates": lambda: tfs._program(*fp._candidates_call(
            fp.imm_arena, pyr.dI[0], pyr.abs_grad[0], up)),
        "add_candidates": lambda: tfs._candidates_program(
            None, fp._imm_cap, fp.cfg)(
            *tfs._arena_flat(fp.imm_arena), pyr.dI[0], st, up),
        "activate": lambda: tfs._program(*fp._activation_call(
            W, fp.imm_arena, fp.dIs, act_up, nf)),
        "frame_step": lambda: tfs._program(*fp._frame_step_call(
            img, ref, fp.imm_arena, step_up)),
        "frame_step_chain": lambda: tfs._program(*fp._chain_step_call(
            img, ref, chain, chain_up)),
    }


@pytest.mark.parametrize("name", ["segment_sum", "detect_status_map",
                                  "arena_add_from_status", "post_ba",
                                  "tracker_ref", "new_candidates",
                                  "add_candidates", "activate",
                                  "frame_step", "frame_step_chain"])
def test_programs_read_nothing_back(snap, name):
    """Each program, after one run (the eager warm-up a capture makes,
    which fills utils/static.device_const), calls no operator that reads
    the device from the host or uploads host values: what lets a CUDA
    graph capture it."""
    calib, fj, fp = snap
    fn = _program_cases(calib, fp)[name]
    want = fn()
    with host_reads() as seen:
        got = fn()
    assert not seen, dict(seen)
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        equal(a, b)


def test_host_reads_sees_them():
    """The guard itself: each kind of read it must catch."""
    x = torch.arange(6.0)
    reads = {
        "item": lambda: float(x.sum()),
        "bool index": lambda: x[x > 2],
        "nonzero": lambda: torch.nonzero(x),
        "bincount": lambda: torch.bincount(x.long()),
        "indexed assignment": lambda: x.clone().__setitem__(
            torch.tensor([1]), 1.0),
        "cpu": lambda: x.cpu(),
        "numpy": lambda: x.numpy(),
        "upload": lambda: torch.as_tensor(np.zeros(2)),
    }
    for what, fn in reads.items():
        with host_reads() as seen:
            fn()
        assert seen, what


# ------------------------------------------------ the keyframe's dispatch
@pytest.fixture(scope="module")
def port_run():
    """RUN frames of the bench scene at 256x192 through a CPU FullSystem,
    with every keyframe's dispatch watched from the activation through the
    new candidates (host_reads without uploads: the pinned uploads the
    card path makes are allowed), and each keyframe's frame flags checked
    against a fresh read of the arena's counts."""
    calib, poses, images = time_modes.bench_frames(RUN, 256, 192, "cpu")
    fs = tfs.FullSystem(calib, TC(**KW), device="cpu")
    spans, staged = [], []
    activate, new_traces = fs._activate_points, fs._make_new_traces
    flag = fs._flag_frames_for_marginalization
    watch = []

    def watched_activate(*a, **k):
        cm = host_reads(uploads=False)
        watch.append((cm, cm.__enter__()))
        return activate(*a, **k)

    def watched_new_traces(*a, **k):
        out = new_traces(*a, **k)
        cm, seen = watch.pop()
        cm.__exit__(None, None, None)
        spans.append(dict(seen))
        return out

    def checked_flag():
        got = fs._imm_counts
        if got is not None:
            fresh = npy(tim.arena_counts(fs.imm_arena, fs.ef.F))
            staged.append(np.array_equal(got[0].numpy()[:fs.ef.F], fresh))
        return flag()

    acts = []
    act_pass = fs._activation_pass

    def recorded_pass():
        # the pass's inputs, then what it left: the window, the arena and
        # its rows on their way home
        before = (fs.ef.W, fs.imm_arena, fs.dIs.clone(),
                  fs._activation_upload(), len(fs.window_frames))
        act_pass()
        acts.append(before + (fs.ef.W, fs.imm_arena, fs._act_pull[0]))

    fs._activate_points = watched_activate
    fs._activation_pass = recorded_pass
    fs._make_new_traces = watched_new_traces
    fs._flag_frames_for_marginalization = checked_flag
    for i, img in enumerate(images):
        fs.add_active_frame(img, i, 1.0, i * 0.05)
        assert not (fs.is_lost or fs.init_failed)
    return fs, spans, staged, acts


def test_keyframe_dispatch_reads_nothing_back(port_run):
    """From the activation's dispatch through the new candidates, no
    keyframe of the run read the device from the host (the K1, K5, K6/K7
    and K12 wrappers' CPU stand-ins aside: on the card they are
    launches)."""
    fs, spans, staged, _ = port_run
    assert len(spans) == len(fs.global_map.get_all_kfs()) - 1 >= 3
    assert all(not s for s in spans), spans


def test_frame_flags_read_the_staged_counts(port_run):
    """Every keyframe after the first took its frame flags from the
    counts the previous finish() staged, and they equal a fresh read of
    the arena's counts at that point."""
    fs, spans, staged, _ = port_run
    assert len(staged) == len(spans) - 1 and all(staged), staged
    assert fs._imm_counts is not None


def test_deferred_stats_match_the_blocking_read(snap):
    """optimize(..., defer_stats=True) then consume_stats gives the same
    rmse, res_in_a and is_lost as the blocking read, and the same window;
    the host LM refuses defer_stats."""
    calib, fj, fp = snap
    a, b = copy.copy(fp.ef), copy.copy(fp.ef)
    args = (fp.dIs, fp.cfg.max_opt_iterations, calib.w[0], calib.h[0])
    rmse_a = a.optimize(*args)
    handle = b.optimize(*args, defer_stats=True)
    assert isinstance(handle, HostCopy)
    assert b.res_in_a == fp.ef.res_in_a        # nothing read yet
    rmse_b = b.consume_stats(handle)
    assert rmse_a == rmse_b and np.isfinite(rmse_a)
    assert (a.res_in_a, a.is_lost) == (b.res_in_a, b.is_lost) != (0, True)
    for f in ("idepth", "state", "res_state", "pt_idepth_hessian"):
        equal(getattr(b.W, f), getattr(a.W, f), f)
    host = copy.copy(fp.ef)
    host.cfg = dataclasses.replace(fp.cfg, ba_device_lm=False)
    with pytest.raises(ValueError):
        host.optimize(*args, defer_stats=True)


@pytest.mark.parametrize("energy", [1234.5, float("nan"), float("inf")])
def test_consume_stats_matches_jax(snap, energy):
    """consume_stats' bookkeeping against the JAX package's on the same
    stats [energy, res_in_a, rmse]: a non-finite energy loses the
    system."""
    calib, fj, fp = snap
    stats = np.array([energy, 321.0, 0.75], np.float32)
    tj, tp = copy.copy(fj.ef), copy.copy(fp.ef)
    tj.is_lost = tp.is_lost = False
    rj = tj.consume_stats(stats)
    rp = tp.consume_stats(HostCopy(torch.from_numpy(stats)))
    assert rp == rj == np.float32(0.75)
    assert (tp.res_in_a, tp.is_lost) == (tj.res_in_a, tj.is_lost)
    assert tp.is_lost == (not np.isfinite(energy))
