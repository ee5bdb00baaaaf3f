"""K5, the keyframe's activation of the candidate arena: what of it the CPU
can check. The kernel itself (csrc/immature_activate.cu) runs only on the
card (tests/test_torch_cuda.py -k activate, chip_smoke.py); here its
wrapper takes the plain version, the plain version (written out in K5's
order) is held against the JAX package's `activate`, the port's one-pass
activation against the JAX package's `_activate_fused` on a window and an
arena carried across, the whole-arena pass against the JAX package's
prefix pass, the activation is shown to read nothing back until
`_consume_activation`, and the check that holds the kernel
(torch_kernel_checks.activate_err) is shown to catch planted faults and to
pass a flip at a tie."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_kernel_checks as kc
from torch_port_utils import plane_frames

from ldso_tpu.config import Config as JC
from ldso_tpu.frontend import immature as jim
from ldso_tpu.system import full_system as jfs
from ldso_tpu_torch.backend import energy_functional as tef
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.frontend import immature as tim
from ldso_tpu_torch.ops import cuda_kernels
from ldso_tpu_torch.slam_map import FrameShell
from ldso_tpu_torch.system import full_system as tfs
from ldso_tpu_torch.utils import convert
from ldso_tpu_torch.utils.device import HostCopy

W, H = 640, 480
_HOST_READS = ("__bool__", "item", "tolist", "cpu", "numpy")
# the windows of 1..ACTIVATE_MAX_SLOTS frames, at a small size
WIDE_W, WIDE_H, WIDE_LANES = 160, 120, 512
WIDTHS = range(1, cuda_kernels.ACTIVATE_MAX_SLOTS + 1)


@pytest.fixture(scope="module")
def scene():
    return kc.activate_scene(W, H, "cpu")


@pytest.fixture(scope="module")
def cases(scene):
    return kc.activate_cases(scene)


def _bitwise(a, b):
    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


def _jax_flips(got, want, ties):
    """The lanes whose idepths part beyond 1e-4 relative (1e-6 absolute):
    each must be at one of the port's ties with the JAX package
    (activate_ties(..., jax=True)), and they are held to ACT_TIE_SHARE."""
    far = np.abs(got - want) > 1e-6 + 1e-4 * np.abs(want)
    assert not (far & ~ties).any(), np.nonzero(far & ~ties)[0]
    return int(far.sum())


def test_plain_activation_matches_jax(cases, scene):
    """The plain version's depth LM in K5's order against the JAX package's
    `activate` on the bench scene's whole arena of 4,096 lanes against a
    window of 8 frames, from the same gate: ok, n_good and the states
    exactly, the candidates' idepths within 1e-4 relative (1e-6 absolute),
    as test_activate holds them, except where the LM's accept test lies
    within ACT_JAX_RTOL of its threshold (kc.activate_ties's `jax`), on at
    most ACT_TIE_SHARE of the live lanes. On this arena 12 of 2,533
    candidates part by 1.0e-4 to 4.9e-4 relative, each with an accept test
    within 2e-4 of its threshold, in the parent's order of sums as in K5's: XLA
    contracts the projections' multiply-adds, so the two packages'
    energies differ by up to 4e-3 relative, and near convergence the
    accept test compares two energies closer than that."""
    inputs = cases["window 8"]
    arena, dist_map, KRKis, Kts, Rs, ts, affs, masks, dIs, mad, marg, \
        newest, nf, cfg = inputs
    calib = scene["calib"]
    p = arena.pool
    h = torch.clamp(arena.host, 0, KRKis.shape[0] - 1).long()
    to_opt, _, idm = tim.gate_candidates(
        p._replace(valid=p.valid & (arena.host >= 0)), KRKis[h], Kts[h],
        dist_map, mad, marg[h], cfg)
    cand = to_opt & (arena.host < nf) & (arena.host != newest)
    assert int(cand.sum()) > 500
    args = (p.u, p.v, p.color, p.weights, p.energy_th, idm, cand, Rs[h],
            ts[h], affs[h], masks[h])
    ot = tim.activate(*args, dIs, calib, cfg)
    oj = jim.activate(*(jnp.asarray(a.numpy()) for a in args),
                      jnp.asarray(dIs.numpy()), calib, JC())
    for k in (1, 2, 3):
        np.testing.assert_array_equal(ot[k].numpy(), np.asarray(oj[k]))
    _, parts = kc.plain_activate(inputs, calib)
    ties = kc.activate_ties(parts, cfg, jax=True).numpy()
    live = int(parts["live"].sum())
    # the LM runs on every lane here; a lane the gate refuses has no ties
    flips = _jax_flips(torch.where(cand, ot[0], 0).numpy(),
                       np.where(cand.numpy(), np.asarray(oj[0]), 0), ties)
    assert flips <= kc.ACT_TIE_SHARE * live, (flips, live)
    assert int(ot[1].sum()) > 300


@pytest.fixture(scope="module")
def wide_scene():
    return kc.activate_scene(WIDE_W, WIDE_H, "cpu", n_lanes=WIDE_LANES,
                             slots=max(WIDTHS))


@pytest.mark.parametrize("F", WIDTHS, ids=[f"F{F}" for F in WIDTHS])
def test_plain_activation_matches_jax_at_every_width(wide_scene, F):
    """The cases of tests/test_torch_cuda.py::
    test_activate_kernel_matches_plain_at_every_width at 160x120 with 512
    lanes: a window of F frames in F slots, F = 1..ACTIVATE_MAX_SLOTS (K5
    runs its slots in groups of 8). The wrapper on CPU tensors is the plain
    version bit for bit, and the plain version's depth LM is held against
    the JAX package's `activate` (run op by op) from the same gate as
    test_plain_activation_matches_jax holds it: ok, n_good and the states
    exactly, the idepths within 1e-4 relative (1e-6 absolute) but at the
    LM's ties, on at most ACT_TIE_SHARE of the live lanes. At one frame no
    lane is optimised (its host is the newest)."""
    calib = wide_scene["calib"]
    inputs = kc.activate_inputs(wide_scene, F, slots=F)
    arena, dist_map, KRKis, Kts, Rs, ts, affs, masks, dIs, mad, marg, \
        newest, nf, cfg = inputs
    got = cuda_kernels.activate_arena(*inputs[:13], calib, cfg)
    want, parts = kc.plain_activate(inputs, calib)
    _bitwise(got, want)
    p = arena.pool
    h = torch.clamp(arena.host, 0, F - 1).long()
    to_opt, _, idm = tim.gate_candidates(
        p._replace(valid=p.valid & (arena.host >= 0)), KRKis[h], Kts[h],
        dist_map, mad, marg[h], cfg)
    cand = to_opt & (arena.host < nf) & (arena.host != newest)
    assert torch.equal(cand, got[0])
    assert int(cand.sum()) > (100 if F > 1 else -1)
    args = (p.u, p.v, p.color, p.weights, p.energy_th, idm, cand, Rs[h],
            ts[h], affs[h], masks[h])
    ot = tim.activate(*args, dIs, calib, cfg)
    with jax.disable_jit():
        oj = jim.activate(*(jnp.asarray(a.numpy()) for a in args),
                          jnp.asarray(dIs.numpy()), calib, JC())
    for k in (1, 2, 3):
        np.testing.assert_array_equal(ot[k].numpy(), np.asarray(oj[k]))
    ties = kc.activate_ties(parts, cfg, jax=True).numpy()
    flips = _jax_flips(torch.where(cand, ot[0], 0).numpy(),
                       np.where(cand.numpy(), np.asarray(oj[0]), 0), ties)
    assert flips <= kc.ACT_TIE_SHARE * int(parts["live"].sum()), flips


@pytest.mark.parametrize("case", [*(f"window {n}" for n in kc.ACT_FRAMES),
                                  "planted"])
def test_wrapper_on_cpu_is_the_plain_version(cases, scene, case):
    """cuda_kernels.activate_arena on CPU tensors is activate_arena_ref,
    bit for bit, and launches nothing."""
    inputs = cases[case]
    calib = scene["calib"]
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.activate_arena(*inputs[:13], calib, inputs[13])
    assert cuda_kernels.LAUNCHES == before
    want, parts = kc.plain_activate(inputs, calib)
    _bitwise(got, want)
    assert [t.dtype for t in got] == [torch.bool, torch.bool, torch.float32,
                                      torch.bool, torch.int32]
    rep = kc.activate_err(want, got, parts, inputs[13])
    assert rep["ok"] and not rep["flips"] and rep["optimised"] > 0, rep


def test_planted_lanes_reach_their_branches(cases, scene):
    """The planted case puts lanes in each branch it names: dead lanes,
    lanes removed and not optimised, optimised lanes with ok and without,
    lanes with out-of-bounds or masked targets (n_good below the live
    targets), and ties at the outlier limit."""
    inputs = cases["planted"]
    (to_opt, remove, _, ok, n_good), parts = kc.plain_activate(
        inputs, scene["calib"])
    lane = torch.arange(to_opt.shape[0])
    live = parts["live"]
    assert int((~live).sum()) > 300
    assert int((remove & ~to_opt).sum()) > 50
    assert int((to_opt & ok).sum()) > 100 and int((to_opt & ~ok).sum()) > 20
    for k in (6, 7):                  # host == newest, out of range
        assert not bool((to_opt & (lane % 19 == k)).any())
    assert not bool((ok & (lane % 19 == 4)).any())     # zero weights
    assert bool((to_opt & (n_good < 6)).any())
    ties = kc.activate_ties(parts, inputs[13])
    assert int((ties & (lane % 19 == 5)).sum()) > 10


# ---------------------------------------------------------------------------
# the one-pass activation against the JAX package's _activate_fused
# ---------------------------------------------------------------------------

KW = dict(max_points=1024, max_immature=1024,
          tracker_caps=(8192, 4096, 2048, 1024, 512, 256),
          desired_point_density=500, desired_immature_density=400,
          enable_loop_closing=False)


@pytest.fixture(scope="module")
def jax_activation():
    """The inputs and output of the JAX FullSystem's last `_activate_fused`
    call on 12 plane frames at 256x192 (keyframes at frames 0, 7, 9 and
    11), through its live-prefix watermark as it ran."""
    calib, _, imgs, _ = plane_frames(13, 256, 192, step=2.0)
    fj = jfs.FullSystem(calib, JC(**KW))
    seen = []
    fused = jfs._activate_fused

    def recorded(*a, **k):
        out = fused(*a, **k)
        seen.append((a, k, out))
        return out
    jfs._activate_fused = recorded
    try:
        for i in range(12):
            fj.add_active_frame(imgs[i], i, 1.0, i * 0.05)
    finally:
        jfs._activate_fused = fused
    args, kw, out = seen[-1]
    assert int(args[12]) >= 3 and kw["n_act"] < args[1].host.shape[0]
    return calib, args, kw, out


def _port_inputs(args):
    """The JAX call's inputs as the port's."""
    (Wj, aj, dIs, KRKis, Kts, Rs, ts, affs, masks, mad, marg, newest,
     nf) = args[:13]
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.array(a), dtype=dt)
    return (convert.window_to_torch(Wj), convert.arena_to_torch(aj),
            convert.window_images_to_torch(dIs), t(KRKis), t(Kts), t(Rs),
            t(ts), t(affs), t(masks, torch.bool), t(mad), t(marg, torch.bool),
            int(newest), int(nf))


def _port_fused(args, calib):
    """The port's _activate_fused on the JAX call's inputs, and the lanes
    where its plain version ties with the JAX package's
    (activate_ties's `jax`)."""
    ins = _port_inputs(args)
    Wt, at = ins[0], ins[1]
    w1, h1 = args[15], args[16]
    cfg = TC(**KW)
    dist_map = cuda_kernels.distance_transform(
        tfs._occupancy(Wt, ins[11], w1, h1), cfg.dist_map_steps)
    _, parts = kc.plain_activate(
        (at, dist_map, *ins[3:9], ins[2], *ins[9:], cfg), calib)
    ties = kc.activate_ties(parts, cfg, jax=True)
    return tfs._activate_fused(*ins, cfg, calib, w1, h1), ties


def _windows_equal(Wt, Wj, rows, tie_rows):
    """Every field of the port's window equals the JAX one's but idepth and
    idepth_zero on `rows` (the inserted points), which agree within 1e-4
    relative (1e-6 absolute) but at `tie_rows` (those of lanes at a tie
    with the JAX package's accept test), at most ACT_TIE_SHARE of them."""
    Wjt = convert.window_to_torch(Wj)
    for f in Wt._fields:
        a, b = getattr(Wt, f), getattr(Wjt, f)
        if f in ("idepth", "idepth_zero"):
            keep = torch.ones_like(a, dtype=torch.bool)
            keep[rows] = False
            assert torch.equal(a[keep], b[keep]), f
            ties = np.zeros(a.shape[0], bool)
            ties[tie_rows.numpy()] = True
            flips = _jax_flips(a.numpy(), b.numpy(), ties)
            assert flips <= kc.ACT_TIE_SHARE * rows.numel(), (f, flips)
        else:
            assert torch.equal(a.to(b.dtype), b), f


def test_fused_activation_matches_jax(jax_activation):
    """The port's one-pass activation against the JAX package's
    `_activate_fused` over the whole arena on the same window and arena:
    slot, host, inserted and removed exactly, every window field exactly
    but the inserted points' idepths (1e-4 relative, but at a tie with the
    JAX package's accept test: one point of this window parts by 1.3e-4),
    the arena's `valid` exactly."""
    calib, args, kw, _ = jax_activation
    Wj, aj, pj = jfs._activate_fused(*args)
    (Wt, at, pt), ties = _port_fused(args, calib)
    pj = np.asarray(pj)
    np.testing.assert_array_equal(pt.numpy(), pj.astype(np.int64))
    ins = pt[:, 2] > 0
    assert int(ins.sum()) > 20 and int((pt[:, 3] > 0).sum()) > 20
    _windows_equal(Wt, Wj, pt[ins, 0].long(), pt[ins & ties, 0].long())
    assert torch.equal(at.pool.valid, torch.as_tensor(
        np.asarray(aj.pool.valid)))


def test_activation_program_matches_jax(jax_activation):
    """The activation as the program a card FullSystem replays
    (full_system._activation_program over the window's ACT_FIELDS, the
    arena, the images and one upload of the JAX call's tables), run
    eagerly: bitwise the port's `_activate_fused` on the same inputs, and
    so against the JAX package's `_activate_fused` as
    test_fused_activation_matches_jax holds that (rows exactly, the
    inserted idepths within 1e-4 relative but at the accept test's
    ties)."""
    calib, args, kw, _ = jax_activation
    ins = _port_inputs(args)
    W, arena, dIs = ins[:3]
    newest, nf = ins[11:13]
    assert newest == nf - 1
    up = torch.cat([t.reshape(-1).to(torch.float32) for t in ins[3:11]])
    assert up.numel() == tfs.activation_upload_size(W.frame_valid.shape[0])
    program = tfs._activation_program(nf, TC(**KW), calib, args[15],
                                      args[16])
    out = program(*(tuple(getattr(W, f) for f in tfs.ACT_FIELDS)
                    + tfs._arena_flat(arena) + (dIs, up)))
    (Wt, at, pt), ties = _port_fused(args, calib)
    nw = len(tfs.ACT_FIELDS)
    for f, got in zip(tfs.ACT_FIELDS, out[:nw]):
        assert torch.equal(got, getattr(Wt, f)), f
    for got, want in zip(out[nw:-1], tfs._arena_flat(at)):
        assert torch.equal(got, want)
    assert torch.equal(out[-1], pt)
    Wj, aj, pj = jfs._activate_fused(*args)
    np.testing.assert_array_equal(out[-1].numpy(),
                                  np.asarray(pj).astype(np.int64))
    ins_ = pt[:, 2] > 0
    _windows_equal(Wt, Wj, pt[ins_, 0].long(), pt[ins_ & ties, 0].long())


def test_whole_arena_pass_equals_the_prefix_pass(jax_activation):
    """The port's pass over all lanes equals the JAX run's pass over the
    live prefix (its watermark, `n_act`): the prefix's rows exactly, the
    lanes past it dead ([P, host, 0, 0]), the window and the arena alike
    (the window as test_fused_activation_matches_jax holds it)."""
    calib, args, kw, (Wj, aj, pj) = jax_activation
    n = kw["n_act"]
    (Wt, at, pt), ties = _port_fused(args, calib)
    pj = np.asarray(pj)
    assert pj.shape[0] == n
    np.testing.assert_array_equal(pt[:n].numpy(), pj.astype(np.int64))
    P = Wt.pt_valid.shape[0]
    assert (pt[n:, 0] == P).all() and (pt[n:, 2:] == 0).all()
    np.testing.assert_array_equal(
        pt[n:, 1].numpy(), np.asarray(args[1].host)[n:])
    ins = pt[:, 2] > 0
    _windows_equal(Wt, Wj, pt[ins, 0].long(), pt[ins & ties, 0].long())
    assert torch.equal(at.pool.valid, torch.as_tensor(
        np.asarray(aj.pool.valid)))


# ---------------------------------------------------------------------------
# the FullSystem's activation: no host read until finish()
# ---------------------------------------------------------------------------

def _system_at_activation(scene, device="cpu"):
    """A FullSystem on `device` at a keyframe's activation: the scene's
    window of 8 frames (ACT_WINDOW), an empty point window, the scene's
    arena hosted by slots 0-2."""
    fs = tfs.FullSystem(scene["calib"], scene["cfg"], device=device)
    for slot, k in enumerate(kc.ACT_WINDOW):
        fs.window_frames.append(FrameShell(
            id=k, T_cw=scene["poses"][k], aff=np.zeros(2), exposure=1.0))
    fs.marg_flags = [False] * len(kc.ACT_WINDOW)
    fs.imm_live = [s < 3 for s in range(len(kc.ACT_WINDOW))]
    fs.dIs = torch.stack([scene["dI"][k] for k in kc.ACT_WINDOW])
    return fs


def _activation_run(fs, W, arena):
    """fs._activate_points from window W and `arena`; returns the window,
    the arena and the pull as tensors."""
    fs.ef.W = W
    fs.imm_arena = arena
    fs.current_min_act_dist = 2.0
    fs._activate_points()
    return list(fs.ef.W) + list(fs.imm_arena.pool) + [fs._act_pull[0]._host]


def test_activation_reads_nothing_back(scene, monkeypatch):
    """FullSystem._activate_points with every tensor method that reads a
    value to the host patched to raise, and torch.tensor and
    torch.as_tensor of a value that is not a tensor too (after a first
    call has made the constants): the card runs the same code, K1 and K5
    behind one upload that does not wait. The results equal an unpatched
    run bitwise; `_consume_activation` is the one read, and it applies the
    pull to the host mirrors."""
    fs = _system_at_activation(scene)
    W0 = fs.ef.W
    want = _activation_run(fs, W0, scene["arena"])

    def refuse(*a, **k):
        raise AssertionError("the activation read a value to the host")
    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse)
    as_tensor = torch.as_tensor

    def tensors_only(x, *a, **k):
        if not isinstance(x, torch.Tensor):
            refuse()
        return as_tensor(x, *a, **k)
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", tensors_only)
    got = _activation_run(fs, W0, scene["arena"])
    with pytest.raises(AssertionError, match="read a value"):
        fs._consume_activation()
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    pk = got[-1].numpy()
    assert int((pk[:, 2] > 0).sum()) > 100
    fs._act_pull = (HostCopy(got[-1]), len(fs.window_frames))
    fs.ef.pt_valid_np[:] = False
    fs._consume_activation()
    assert fs._act_pull is None
    ins = (pk[:, 2] > 0) & (pk[:, 0] < fs.ef.P)    # overflow drops
    assert fs.ef.pt_valid_np.sum() == ins.sum() == fs.ef.P
    np.testing.assert_array_equal(fs.ef.pt_host_np[pk[ins, 0]], pk[ins, 1])
    dead = [getattr(f, "_n_dead_points", 0) for f in fs.window_frames]
    assert sum(dead) == int((pk[:, 3] > 0).sum()) and dead[3:] == [0] * 5


def _insert_points_dev_parent(W, slot, valid, host, u, v, idepth, prior,
                              energy_th, color, weights):
    """insert_points_dev as it was before the activation's device pass
    (boolean indexes, which read their count on the host): the function the
    new one must equal bitwise."""
    P, F = W.P, W.F
    keep = valid & (slot >= 0) & (slot < P)
    sl = slot[keep]
    hk = host[keep].to(torch.int64)
    rows = W.frame_valid[None, :] & (
        hk[:, None] != torch.arange(F, device=hk.device)[None, :])

    def put(t, val):
        t = t.clone()
        t[sl] = val if not torch.is_tensor(val) else val.to(t.dtype)
        return t

    return W._replace(
        pt_valid=put(W.pt_valid, True), pt_host=put(W.pt_host, hk),
        pt_u=put(W.pt_u, u[keep]), pt_v=put(W.pt_v, v[keep]),
        pt_color=put(W.pt_color, color[keep]),
        pt_weights=put(W.pt_weights, weights[keep]),
        idepth=put(W.idepth, idepth[keep]),
        idepth_zero=put(W.idepth_zero, idepth[keep]),
        pt_prior=put(W.pt_prior, prior[keep]),
        pt_energy_th=put(W.pt_energy_th, energy_th[keep]),
        pt_num_good_res=put(W.pt_num_good_res, 0),
        pt_max_rel_baseline=put(W.pt_max_rel_baseline, 0.0),
        pt_idepth_hessian=put(W.pt_idepth_hessian, 0.0),
        res_exist=put(W.res_exist, rows),
        res_active=put(W.res_active, False),
        res_linearized=put(W.res_linearized, False),
        res_state=put(W.res_state, RES_IN),
        res_energy=put(W.res_energy, 0.0))


RES_IN = tef.RES_IN


@pytest.mark.parametrize("seed", [0, 1])
def test_insert_points_dev_has_no_boolean_index(scene, seed):
    """insert_points_dev (a spare row for the dropped lanes, cut after the
    scatter) equals its boolean-index form bitwise, with lanes dropped as
    invalid, at slot P (overflow) and at negative slots, and distinct
    slots kept."""
    cfg, calib = scene["cfg"], scene["calib"]
    rng = np.random.RandomState(seed)
    F, P, N = 8, 512, 300
    W = tef.empty_window(F, P, calib.intrinsics_vec(), cfg, "cpu")
    W = W._replace(frame_valid=torch.from_numpy(np.arange(F) < 5),
                   pt_valid=torch.from_numpy(rng.rand(P) < 0.5))
    slot = torch.from_numpy(rng.permutation(P + 40)[:N] - 20)
    valid = torch.from_numpy(rng.rand(N) < 0.8)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.randn(N, *s).astype(np.float32))
    args = (slot, valid, torch.from_numpy(rng.randint(0, 5, N)), f(), f(),
            f(), f(), f(), f(8), f(8))
    got = tef.insert_points_dev(W, *args)
    want = _insert_points_dev_parent(W, *args)
    for name in W._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_activate_params_follow_the_plain_version():
    """K5's launch arguments: the GN iterations, the pattern, and the plain
    version's Python scalars as float32."""
    from ldso_tpu_torch.synthetic import default_calib
    calib, cfg = default_calib(640, 480), TC()
    ints, floats = cuda_kernels.activate_params(calib, cfg)
    assert ints == (cfg.gn_its_on_point_activation, *(
        int(c) for c in np.asarray(tim.PATTERN).reshape(-1)))
    assert floats == tuple(float(np.float32(x)) for x in (
        calib.fx[0], calib.fy[0], calib.cx[0], calib.cy[0], 638.999,
        478.999, cfg.min_trace_quality, cfg.huber_th, cfg.min_idepth_h_act))


# ---------------------------------------------------------------------------
# activate_err against an emulated kernel: the plain version with faults
# ---------------------------------------------------------------------------

def _pick(mask):
    i = torch.nonzero(mask).reshape(-1)
    assert i.numel() > 0, "no lane to plant the fault in"
    return int(i[i.numel() // 2])


@pytest.mark.parametrize("fault", ["idepth", "ok", "n_good", "dead lane",
                                   "remove", "flip at a tie"])
def test_activate_err_reports_planted_faults(cases, scene, fault):
    """Each planted fault is reported as a fault at its lane; a flip at a
    planted tie is reported as a flip and passes."""
    inputs = cases["planted"]
    cfg = inputs[13]
    plain, parts = kc.plain_activate(inputs, scene["calib"])
    ties = kc.activate_ties(parts, cfg)
    clean = kc.activate_err(plain, plain, parts, cfg)
    assert clean["ok"] and not clean["flips"]
    got = [t.clone() for t in plain]
    to_opt = parts["to_opt"] & ~ties
    if fault == "idepth":
        i = _pick(to_opt)
        got[2][i] *= 1.0 + 1e-3
    elif fault == "ok":
        i = _pick(to_opt)
        got[3][i] = ~got[3][i]
    elif fault == "n_good":
        i = _pick(to_opt)
        got[4][i] += 1
    elif fault == "dead lane":
        i = _pick(~parts["live"])
        got[2][i] += 1.0
        fault = "idepth of a dead lane"
    elif fault == "remove":
        i = _pick(parts["live"] & ~ties)
        got[1][i] = ~got[1][i]
    else:
        i = _pick(parts["to_opt"] & ties)
        got[4][i] += 1
    rep = kc.activate_err(plain, tuple(got), parts, cfg)
    if fault == "flip at a tie":
        assert rep["ok"] and rep["flips"] == [i] and not rep["faults"], rep
    else:
        assert not rep["ok"] and i in rep["faults"][fault], rep


def test_tie_share_covers_the_plain_spread(cases, scene):
    """ACT_TIE_SHARE against the plain version's own spread: the plain
    version with its taps summed left to right (reordered_taps) against
    the plain version (the tree) on every case: no lane differs outside a
    tie, and the lanes that differ are at most a tenth of the share."""
    calib = scene["calib"]
    flips = live = 0
    for name, inputs in cases.items():
        plain, parts = kc.plain_activate(inputs, calib)
        with kc.reordered_taps():
            other = tim.activate_arena_ref(*inputs[:13], calib, inputs[13])
        rep = kc.activate_err(plain, other, parts, inputs[13])
        assert not rep["faults"], (name, rep["faults"])
        flips += len(rep["flips"])
        live += rep["live"]
    assert flips <= kc.ACT_TIE_SHARE / 10 * live, (flips, live)


def test_wrapper_refuses_what_k5_does_not_take(cases, scene):
    """More window slots than a warp's threads: the card wrapper raises
    rather than hand the case to the plain version (checked before any
    tensor's device, so it shows on the CPU through the same test)."""
    inputs = list(cases["window 2"])
    F = cuda_kernels.ACTIVATE_MAX_SLOTS + 1
    meta = lambda t, shape: torch.empty(shape, dtype=t.dtype,  # noqa: E731
                                        device="meta")
    arena = inputs[0]
    arena = arena._replace(pool=arena.pool._replace(
        u=meta(arena.pool.u, arena.pool.u.shape)))
    with pytest.raises(ValueError, match="window slots"):
        cuda_kernels.activate_arena(
            arena, inputs[1], meta(inputs[2], (F, 3, 3)), inputs[3],
            inputs[4], inputs[5], inputs[6], inputs[7], inputs[8], inputs[9],
            inputs[10], 0, 2, scene["calib"], inputs[13])
