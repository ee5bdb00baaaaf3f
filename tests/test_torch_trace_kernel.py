"""K4, the epipolar trace of the candidate arena: what of it the CPU can
check. The kernel itself (csrc/immature_trace.cu) runs only on the card
(tests/test_torch_cuda.py -k trace, chip_smoke.py); here its wrapper takes
the plain version, the plain version is held against the JAX package,
the whole-arena trace against the prefix trace the card path no longer
reads a watermark for, the trace path is shown to read nothing back, and
the check that holds the kernel (torch_kernel_checks.trace_err) is shown
to catch planted faults and to pass a flip at a tie."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_kernel_checks as kc
from torch_port_utils import j32, plane_frames, t32

from ldso_tpu.config import Config as JC
from ldso_tpu.frontend import detector as jdet
from ldso_tpu.frontend import immature as jim
from ldso_tpu.ops.preprocess import make_pyramid as jmp
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.frontend import immature as tim
from ldso_tpu_torch.ops import cuda_kernels
from ldso_tpu_torch.slam_map import FrameShell
from ldso_tpu_torch.system.full_system import FullSystem
from ldso_tpu_torch.utils import convert

W, H = 256, 192
_HOST_READS = ("__bool__", "item", "tolist", "cpu", "numpy")


@pytest.fixture(scope="module")
def scene():
    return kc.trace_scene(W, H, "cpu")


@pytest.fixture(scope="module")
def cases(scene):
    return kc.trace_cases(scene)


def _fields(arena):
    return list(arena.pool) + [arena.host]


def _bitwise(a, b):
    """Every field of two arenas equal bit for bit (all are bool or 32-bit)."""
    for x, y in zip(_fields(a), _fields(b)):
        if x.dtype != torch.bool:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@pytest.mark.parametrize("variant", list(kc.TRACE_VARIANTS))
def test_whole_arena_trace_equals_prefix_trace(scene, variant):
    """The trace of all 4,096 lanes equals, bit for bit, the trace of the
    live prefix up to the watermark with the dead lanes past it copied
    through: so the card may trace the whole arena in one K4 launch and
    drop the watermark's host read. Dead lanes sit inside the prefix too."""
    arena = scene["arena"]
    lane = torch.arange(arena.host.shape[0])
    dead = (lane >= 1700) | (lane % 11 == 0)
    arena = tim.ImmatureArena(
        pool=arena.pool._replace(valid=arena.pool.valid & (lane < 1700)),
        host=torch.where(dead, torch.full_like(arena.host, -1), arena.host))
    n = tim.arena_watermark(arena)
    assert 0 < n < arena.host.shape[0]
    cfg = dataclasses.replace(scene["cfg"], **kc.TRACE_VARIANTS[variant])
    t0, t1 = kc.TRACE_TARGETS
    for target in (t0, t1):
        ins = kc.trace_inputs(scene, target)
        dI = scene["pyrs"][target].dI[0]
        whole = tim.trace_arena(arena, dI, *ins, scene["calib"], cfg)
        prefix = tim.trace_arena_prefix(arena, dI, *ins, scene["calib"], cfg,
                                        n)
        _bitwise(whole, prefix)
        assert int((whole.pool.status == tim.IPS_GOOD).sum()) > 100
        arena = whole          # the second trace narrows the first's


@pytest.mark.parametrize("case", [
    *(f"{v} {k}" for v in kc.TRACE_VARIANTS
      for k in ("uninitialised", "narrowing")), "planted"])
def test_wrapper_on_cpu_is_the_plain_version(cases, scene, case):
    """cuda_kernels.trace_arena on CPU tensors is trace_arena_ref, bit for
    bit, and launches nothing."""
    arena, dI, KRKis, Kts, affs, cfg = cases[case]
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.trace_arena(arena, dI, KRKis, Kts, affs,
                                   scene["calib"], cfg)
    assert cuda_kernels.LAUNCHES == before
    want = tim.trace_arena_ref(arena, dI, KRKis, Kts, affs, scene["calib"],
                               cfg)
    _bitwise(got, want)
    for f in got.pool._fields:
        if f not in cuda_kernels.TRACE_OUTPUTS:
            assert getattr(got.pool, f) is getattr(arena.pool, f), f


@pytest.fixture(scope="module")
def jax_arena():
    """The JAX package's arena of 4,096 lanes with the candidates of two
    plane-scene frames (window slots 0 and 1) and the trace's inputs
    against frames 2 and 3."""
    calib, poses, imgs, _ = plane_frames(4, W, H)
    pj = [jmp(jnp.asarray(im), calib.levels) for im in imgs]
    gp = jdet.detect_grid_params(H, W, 400)
    status = np.asarray(jdet.detect_status_map(pj[0].dI[0], pj[0].abs_grad[0],
                                               *gp))
    aj = jim.empty_arena(4096, JC())
    for h in (0, 1):
        aj = jim.arena_add_from_status(aj, jnp.asarray(status), pj[h].dI[0],
                                       jnp.int32(h), 1024, JC())
    ins = {}
    for tgt in (2, 3):
        F = kc.TRACE_SLOTS
        KRKis = np.tile(np.eye(3, dtype=np.float32), (F, 1, 1))
        Kts = np.zeros((F, 3), np.float32)
        affs = np.tile(np.array([1.0, 0.0], np.float32), (F, 1))
        for h in (0, 1):
            T = poses[tgt] @ np.linalg.inv(poses[h])
            KRKis[h] = calib.K(0) @ T[:3, :3] @ calib.Ki(0)
            Kts[h] = calib.K(0) @ T[:3, 3]
            affs[h] = (1.0 + 0.02 * h, 0.5 * h)
        ins[tgt] = (KRKis, Kts, affs)
    return calib, pj, aj, ins


@pytest.mark.parametrize("variant", list(kc.TRACE_VARIANTS))
def test_trace_arena_matches_jax(jax_arena, variant):
    """The port's trace of the whole arena (the wrapper, one K4 launch on
    the card) against the JAX package's trace_arena on the same arena, an
    uninitialised trace and then a narrowing one, each from the same JAX
    state, at the tolerances of test_trace_twice (statuses equal, the
    intervals and last positions within 1e-4 relative, quality within
    2e-3), held by trace_err with the JAX package as the plain side: a
    lane may differ only where the port's own numbers tie, counting the
    rounding of the projection that the search start amplifies (`start`,
    TRACE_START_ULPS), and such lanes are held to TRACE_TIE_SHARE. On this
    arena one lane of 432 differs, in the narrowing trace of every search
    (idepth_min 1.1e-3 relative, last_u 2.4e-3 px): the port's GN moves
    0.0997 px in its second step, 3e-4 px short of the 0.1 at which it
    stops, and the search start that step depends on moves by 1000 times
    any difference in u_min (the reference's randShift,
    frac(1000 u_min)), so the two evaluations stop at different steps."""
    calib, pj, aj, ins = jax_arena
    kw = kc.TRACE_VARIANTS[variant]
    jc, tc = dataclasses.replace(JC(), **kw), dataclasses.replace(TC(), **kw)
    flips = 0
    for tgt in (2, 3):
        KRKis, Kts, affs = (t32(x) for x in ins[tgt])
        at = convert.arena_to_torch(aj)
        aj = jim.trace_arena(aj, pj[tgt].dI[0], j32(ins[tgt][0]),
                             j32(ins[tgt][1]), j32(ins[tgt][2]), calib, jc)
        dI = t32(np.asarray(pj[tgt].dI[0]))
        got = tim.trace_arena(at, dI, KRKis, Kts, affs, calib, tc)
        _, parts = kc.plain_trace(at, dI, KRKis, Kts, affs, calib, tc)
        rep = kc.trace_err(convert.arena_to_torch(aj), got, parts, tc,
                           start=True)
        assert rep["ok"], (tgt, rep["faults"], rep["flips"])
        flips += len(rep["flips"])
    assert flips <= 1
    assert int((np.asarray(aj.pool.status) == jim.IPS_GOOD).sum()) > 100


def test_trace_reads_nothing_back(scene, monkeypatch):
    """FullSystem._trace_transforms and _trace_arena with every tensor
    method that reads a value to the host patched to raise, and
    torch.tensor and torch.as_tensor of a value that is not a tensor too
    (after a first call has made the constants): the card runs the same
    code, one K4 launch behind uploads that do not wait. The results
    equal an unpatched run bitwise."""
    calib, cfg = scene["calib"], scene["cfg"]
    fs = FullSystem(calib, cfg, device="cpu")
    for slot, k in enumerate(kc.TRACE_HOSTS):
        fs.window_frames.append(FrameShell(
            id=k, T_cw=scene["poses"][k], aff=np.array([0.02 * slot, 1.0]),
            exposure=1.0 + 0.1 * slot))
    target = kc.TRACE_TARGETS[0]
    pyr = scene["pyrs"][target]

    def run():
        fs.imm_arena = scene["arena"]
        transforms = fs._trace_transforms(
            fs._f32(scene["poses"][target]), fs._f32([0.01, -0.5]), 1.2)
        fs._trace_arena(pyr, *transforms)
        return list(transforms) + _fields(fs.imm_arena)

    want = run()

    def refuse(*a, **k):
        raise AssertionError("the trace read a value to the host")
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
    status = got[3 + tim.ImmaturePool._fields.index("status")]
    assert int((status == tim.IPS_GOOD).sum()) > 100
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# trace_err against an emulated kernel: the plain version with faults
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flat_scene(scene):
    """The scene's narrowing trace against a target whose right half is one
    flat grey: every step of a lane searching there has the same energy up
    to rounding (a tie), while the left half's lanes keep their minima."""
    arena, dI, KRKis, Kts, affs, cfg = \
        kc.trace_cases(scene)["packed narrowing"]
    dI = dI.clone()
    dI[:, W // 2:, 0] = 100.0
    dI[:, W // 2:, 1:] = 0.0
    plain, parts = kc.plain_trace(arena, dI, KRKis, Kts, affs, scene["calib"],
                                  cfg)
    return (arena, dI, KRKis, Kts, affs, cfg), plain, parts


def _moved_argmin(inputs, calib, lanes):
    """The plain version with the search's first minimum moved one step
    on in `lanes`."""
    first_min = tim._first_min
    calls = []

    def moved(e):
        idx, val = first_min(e)
        if not calls:
            nxt = torch.clamp(idx + 1, max=e.shape[1] - 1)
            idx = torch.where(lanes, nxt, idx)
            val = torch.gather(e, 1, idx[:, None])[:, 0]
        calls.append(1)
        return idx, val
    tim._first_min = moved
    try:
        return tim.trace_arena_ref(*inputs[:5], calib, inputs[5])
    finally:
        tim._first_min = first_min


def _pick(mask, plain, other=None):
    """The first lane of mask where the plain output and `other` differ
    beyond the tolerance (or the first lane of mask)."""
    for i in torch.nonzero(mask).reshape(-1).tolist():
        if other is None or abs(float(other.pool.last_u[i])
                                - float(plain.pool.last_u[i])) > 1e-2:
            return i
    raise AssertionError("no lane to plant the fault in")


@pytest.mark.parametrize("fault", ["status", "interval", "argmin",
                                   "dead lane", "flip at a tie"])
def test_trace_err_reports_planted_faults(flat_scene, scene, fault):
    """Each planted fault is reported as a fault at its lane; a flip at a
    planted tie is reported as a flip and passes."""
    inputs, plain, parts = flat_scene
    cfg, calib = inputs[5], scene["calib"]
    N = plain.host.shape[0]
    ties = kc.trace_ties(parts, cfg)
    u = parts["ptx0"]
    left = parts["do_search"] & ~ties & (u < W // 2 - 40)
    right = parts["do_search"] & ties & (u > W // 2 + 40)
    assert int(left.sum()) > 50 and int(right.sum()) > 20
    clean = kc.trace_err(plain, plain, parts, cfg)
    assert clean["ok"] and not clean["flips"]
    pool = plain.pool
    if fault == "status":
        i = _pick(left, plain)
        st = pool.status.clone()
        st[i] = tim.IPS_OUTLIER if int(st[i]) != tim.IPS_OUTLIER else 0
        got = plain._replace(pool=pool._replace(status=st))
        want_fault = "status"
    elif fault == "interval":
        i = _pick(left & (pool.status == tim.IPS_GOOD), plain)
        d = pool.idepth_min.clone()
        d[i] *= 1.0 + 1e-3
        got = plain._replace(pool=pool._replace(idepth_min=d))
        want_fault = "idepth_min"
    elif fault == "dead lane":
        i = _pick(~parts["active"], plain)
        lu = pool.last_u.clone()
        lu[i] = lu[i] + 1.0
        got = plain._replace(pool=pool._replace(last_u=lu))
        want_fault = "last_u of a dead lane"
    else:
        mask = left if fault == "argmin" else right
        moved = _moved_argmin(inputs, calib, mask)
        i = _pick(mask, plain, moved)
        one = torch.zeros(N, dtype=torch.bool)
        one[i] = True
        got = _moved_argmin(inputs, calib, one)
        want_fault = None if fault == "flip at a tie" else "last_u"
    rep = kc.trace_err(plain, got, parts, cfg)
    if want_fault is None:
        assert rep["ok"] and rep["flips"] == [i] and not rep["faults"], rep
    else:
        assert not rep["ok"] and i in rep["faults"][want_fault], rep


def test_tie_share_covers_the_plain_spread():
    """TRACE_TIE_SHARE's derivation: the plain version with its taps summed
    in the tree against the plain version (left to right), on every case of
    the bench scene at 640x480 with 4,096 lanes: no lane differs outside
    a tie, and the lanes that differ are at most a tenth of the share."""
    scene = kc.trace_scene(640, 480, "cpu")
    calib = scene["calib"]
    flips = live = 0
    for name, (arena, dI, KRKis, Kts, affs, cfg) in \
            kc.trace_cases(scene).items():
        plain, parts = kc.plain_trace(arena, dI, KRKis, Kts, affs, calib, cfg)
        with kc.reordered_taps():
            other = tim.trace_arena_ref(arena, dI, KRKis, Kts, affs, calib,
                                        cfg)
        rep = kc.trace_err(plain, other, parts, cfg)
        assert not rep["faults"], (name, rep["faults"])
        flips += len(rep["flips"])
        live += rep["live"]
    assert flips <= kc.TRACE_TIE_SHARE / 10 * live, (flips, live)


def test_trace_params_follow_the_plain_version():
    """K4's launch arguments: the plain version's step cap, its search by
    (nearest, packed), refine steps only for a nearest search, and its
    Python scalars as float32; a refine wider than a warp is refused."""
    from ldso_tpu_torch.synthetic import default_calib
    calib, cfg = default_calib(640, 480), TC()
    ints, floats = cuda_kernels.trace_params(calib, cfg)
    assert ints[:6] == (640, 480, tim._steps_cap(640, 480, cfg), 0, 0, 3)
    assert ints[6:] == tuple(int(c) for c in np.asarray(
        tim.PATTERN).reshape(-1))
    assert floats[0] == float(np.float32(1120 * cfg.max_pix_search))
    assert floats[7:] == (float(np.float32(638.999)),
                          float(np.float32(478.999)))
    for kw, search, refine in (
            (dict(trace_packed=False), 1, 0),
            (dict(trace_search_nearest=True), 2, cfg.trace_refine_steps),
            (dict(trace_search_nearest=True, trace_packed=False), 3,
             cfg.trace_refine_steps),
            (dict(trace_refine_steps=7), 0, 0)):
        got = cuda_kernels.trace_params(calib, dataclasses.replace(cfg, **kw))
        assert got[0][3:5] == (search, refine), kw
    with pytest.raises(ValueError, match="refine"):
        cuda_kernels.trace_params(calib, dataclasses.replace(
            cfg, trace_search_nearest=True, trace_refine_steps=16))
