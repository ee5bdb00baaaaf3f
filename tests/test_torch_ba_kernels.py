"""K6 and K7, the windowed BA's linearization and accumulation
(ops/cuda_kernels.ba_linearize, ba_accumulate_top, ba_accumulate_sc), on
the CPU: their plain versions (backend/ba.linearize_ref, written out in
K6's order; _accumulate_top_ref and _sc_sums_ref) against the JAX
package's functions on one window, whole and with planted residuals; the
checks that hold the kernels to the plain versions on the card
(torch_kernel_checks.lin_err and acc_err) against planted faults; the
kernels' own orders of sums (the eight-lane tap sums, K7's chunked order
written out by torch_kernel_checks.acc_emulated) against the plain
versions and the JAX package; and the point marginalization as one
program with one packed result (energy_functional.marg_points_packed)
against the JAX package's `_marg_points_fused`, reading nothing on the
host.

Windows: torch_kernel_checks.ba_scene, 5 frames of 6 slots (one slot
empty), 144 points hosted by every frame, 96x64 images."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_kernel_checks as kc
from torch_port_utils import close, equal, npy

from ldso_tpu.backend import ba as jba
from ldso_tpu.backend import energy_functional as jef
from ldso_tpu.backend.window import Window as JWindow
from ldso_tpu.config import Config as JConfig
from ldso_tpu_torch.backend import ba, energy_functional as efm
from ldso_tpu_torch.backend.window import RES_OOB, RES_OUTLIER, Window
from ldso_tpu_torch.ops import cuda_kernels as ck
from ldso_tpu_torch.utils import convert

N_FRAMES, SLOTS, POINTS, WIDTH, HEIGHT = 5, 6, 144, 96, 64
LIN_CASES = ("window", "column", "planted", "planted column", "affine off")
ACC_CASES = ("top mode 0", "top mode 1", "top mode 2", "sc build",
             "sc marg")
# the plain versions against the JAX package (test_torch_backend's
# tolerances): Jacobian pieces within 1e-4 of each field's largest entry
# (float32 projections and bilinear samples in another order of
# operations), energies 1e-5 relative; the accumulations within 1e-4 of
# each block's largest entry (sums over ~1e3 residual rows)
JAC_RTOL = 1e-4
ENERGY_RTOL = 1e-5
ACC_JAX_RTOL = 1e-4


@pytest.fixture(scope="module")
def scene():
    return kc.ba_scene(N_FRAMES, SLOTS, POINTS, WIDTH, HEIGHT, seed=4)


@pytest.fixture(scope="module")
def lin_cases(scene):
    return kc.lin_cases(scene)


def _jax_window(W: Window):
    return JWindow(**{k: jnp.asarray(v)
                      for k, v in convert.window_to_numpy(W).items()})


def _jax_cfg(cfg):
    return JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(JConfig)})


def _rel(a, b, rtol, what):
    """Close relative to the array's own largest finite entry; NaN where
    the other is NaN."""
    b = npy(b)
    big = np.abs(b[np.isfinite(b)]).max() if np.isfinite(b).any() else 1.0
    close(a, b, rtol, rtol * max(float(big), 1e-30), what)


@pytest.mark.parametrize("case", LIN_CASES)
def test_linearize_plain_matches_jax(scene, lin_cases, case):
    """K6's plain version against ldso_tpu's linearize_all /
    linearize_target on the same window: the new states exact, NaN where
    JAX's is, the Jacobian pieces within JAC_RTOL of their scale, the
    energy sum within ENERGY_RTOL."""
    W, dIs, cfg, tgt = lin_cases[case]
    w, h = scene["w"], scene["h"]
    got, e = kc.plain_lin(W, dIs, cfg, w, h, tgt)
    Wj, dj, cj = _jax_window(W), jnp.asarray(npy(dIs)), _jax_cfg(cfg)
    if tgt is None:
        Wj2, ej = jba.linearize_all(Wj, dj, cj, w, h)
    else:
        Wj2, ej = jba.linearize_target(Wj, dj, cj, w, h, jnp.int32(tgt))
    equal(got["res_new_state"], Wj2.res_new_state, f"{case} states")
    for f in ck.LIN_FIELDS:
        if f != "res_new_state":
            _rel(got[f], getattr(Wj2, f), JAC_RTOL, f"{case} {f}")
    close(e, ej, ENERGY_RTOL, 0.0, f"{case} energy sum")


def test_planted_residuals_are_what_they_say(scene, lin_cases):
    """Each plant of ba_plant does what BA_PLANTS names on the plain
    version: centre out of bounds, sticky OOB and the NaN patch give OOB,
    the colour offset an outlier, masked, linearized and missing residuals
    copy their fields through, one tap sits exactly on the Huber
    threshold, and the affine flags zero JabF's rows."""
    W, dIs, cfg, _ = lin_cases["planted"]
    got, _ = kc.plain_lin(W, dIs, cfg, scene["w"], scene["h"])
    P, F = W.P, W.F
    at = {k: kc._every(P, k, "cpu") for k in kc.BA_PLANTS}
    lin = ba._lin_mask(W)
    state = got["res_new_state"]
    assert bool((state[at[1][:, None] & lin] == RES_OOB).all())
    assert bool((state[at[3][:, None] & lin] == RES_OOB).all())
    assert bool((state[at[2][:, None] & lin] == RES_OUTLIER).any())
    # the NaN patch: residuals into frame 1 whose taps hit it are OOB
    nan_hit = torch.isnan(got["resF"][:, 1]).any(-1) & lin[:, 1]
    assert bool(nan_hit.any()) and bool((state[:, 1][nan_hit] == RES_OOB).all())
    copied = ~lin
    for f in ck.LIN_FIELDS:
        assert torch.equal(got[f][copied], getattr(W, f)[copied]), f
    assert bool(copied[at[4]].all()) and bool(copied[at[5]].all())
    # the Huber threshold is one tap's |residual|, bit for bit
    assert cfg.huber_th != scene["cfg"].huber_th
    off = lin_cases["affine off"]
    got_off, _ = kc.plain_lin(off[0], off[1], off[2], scene["w"],
                              scene["h"])
    assert bool((got_off["JabF"][lin] == 0).all())
    assert int(W.frame_valid.sum()) == N_FRAMES < SLOTS


def test_energy_sum_in_k6_order(scene):
    """ordered_energy_sum is K6's order written out (an independent
    emulation of its blocks, warps and lanes) and the sum within float32
    rounding."""
    gen = torch.Generator().manual_seed(3)
    for P, F in ((144, 6), (2048, 8), (1, 1), (300, 5)):
        e = torch.rand((P, F), generator=gen) * 100.0
        x = torch.nn.functional.pad(e.reshape(-1), (0, (-P * F) % 256))
        blocks = []
        for b in x.reshape(-1, 256):
            warps = [_tree(b[w * 32:(w + 1) * 32]) for w in range(8)]
            blocks.append(_tree(torch.stack(warps + [torch.zeros(())] * 24)))
        blocks += [torch.zeros(())] * ((-len(blocks)) % 32)
        lanes = torch.zeros(32)
        for c in range(len(blocks) // 32):
            lanes = lanes + torch.stack(blocks[c * 32:(c + 1) * 32])
        want = _tree(lanes)
        got = ba.ordered_energy_sum(e)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        exact = float(e.double().sum())
        assert abs(float(got) - exact) <= 1e-6 * exact


def _tree(v):
    """A warp's shuffle tree on a 32-vector: lane i takes lane i + m."""
    v = v.clone()
    m = 16
    while m:
        v = v[:m] + v[m:2 * m]
        m //= 2
    return v[0]


@pytest.mark.parametrize("planted", [False, True])
def test_build_system_and_marg_plain_match_jax(scene, lin_cases, planted):
    """K7's plain versions, through build_system and accumulate_marg,
    against the JAX package's on the same linearized window: every block
    within ACC_JAX_RTOL of its largest entry, NaN where JAX's is (the
    planted NaN patch), the counts and aux equal."""
    W, dIs, cfg, _ = lin_cases["planted" if planted else "window"]
    Wl = kc.linearized(W, dIs, cfg, scene["w"], scene["h"])
    Wj = _jax_window(Wl)
    got, want = ba.build_system(Wl), jba.build_system(Wj)
    for name, a, b in zip(("HA", "bA", "HL", "bL", "Hsc", "bsc"), got[:6],
                          want[:6]):
        _rel(a, b, ACC_JAX_RTOL, f"build {name}")
    # a point whose per-point sums take a masked non-finite term (0 x NaN)
    # has NaN HdiF and bdSum here, as in the JAX package's eager
    # _accumulate_top; inside its jitted build_system XLA:CPU turns
    # `mask * term` into a select and drops that NaN, so those points are
    # held to the eager function instead
    pc = jba.make_precalc(Wj)
    eager = sum(np.asarray(jba._accumulate_top(Wj, pc, m)[1]) for m in (0, 1))
    lost = np.isnan(npy(got[6]["HdiF"])) & ~np.isnan(np.asarray(
        want[6]["HdiF"]))
    assert planted or not lost.any()
    assert np.isnan(eager[lost]).all()
    for k in ("HdiF", "bdSum", "Hcd", "JpJdF"):
        keep = ~lost.reshape((-1,) + (1,) * (got[6][k].dim() - 1))
        _rel(np.where(keep, npy(got[6][k]), 0.0),
             np.where(keep, np.asarray(want[6][k]), 0.0), ACC_JAX_RTOL,
             f"aux {k}")
    equal(got[6]["ngood"], want[6]["ngood"])
    equal(got[8], want[8])
    marg = Wl.pt_valid & (torch.arange(Wl.P) % 3 == 0)
    Hm, bm, nm = ba.accumulate_marg(Wl, marg)
    Hj, bj, nj = jba.accumulate_marg(Wj, jnp.asarray(npy(marg)))
    _rel(Hm, Hj, ACC_JAX_RTOL, "marg H")
    _rel(bm, bj, ACC_JAX_RTOL, "marg b")
    assert int(nm) == int(nj)


@pytest.mark.parametrize("case", ACC_CASES)
def test_acc_err_passes_a_reordered_sum(scene, case):
    """The plain version with its points in reverse order (every sum over
    the points in another order, as K7's) stays within a tenth of
    acc_err's tolerance of the plain version: ACC_RTOL leaves room for
    K7's order."""
    W = scene["W_lin"]
    part, args = kc.acc_cases(W)[case]
    want = kc.plain_acc(part, W, args)
    flip = lambda x: x.flip(0) if x.dim() and x.shape[0] == W.P else x  # noqa: E731
    Wr = Window(*(flip(x) for x in W))
    argr = tuple(flip(a) if torch.is_tensor(a) else a for a in args)
    got = {k: flip(v) for k, v in kc.plain_acc(part, Wr, argr).items()}
    rep = kc.acc_err(got, want, kc.acc_scale(part, W, args))
    assert rep["ok"], rep["faults"]
    assert max(rep["worst"].values()) < 0.1, rep["worst"]


BUTTERFLY_INPUTS = ("spread", "ties", "infinities", "nan")


def _butterfly_inputs(kind: str):
    """(N, 8) float32 tap terms of one kind, from a seed: spread over many
    magnitudes and both signs; exact ties and signed zeros; infinities of
    both signs among finite terms; NaN among finite terms."""
    gen = np.random.RandomState(11)
    x = (gen.randn(512, 8) * 10.0 ** gen.randint(-6, 7, (512, 8)))
    x = x.astype(np.float32)
    if kind == "ties":
        x = gen.choice(np.float32([1.0, -1.0, 0.5, 3.0, 0.0, -0.0, 2.0 ** -24,
                                   2.0 ** 24]), (512, 8))
    elif kind == "infinities":
        x[gen.rand(512, 8) < 0.2] = np.inf
        x[gen.rand(512, 8) < 0.2] = -np.inf
    elif kind == "nan":
        x[gen.rand(512, 8) < 0.15] = np.nan
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


@pytest.mark.parametrize("kind", BUTTERFLY_INPUTS)
def test_lane_butterfly_gives_sum8(kind):
    """K6 and K7 take a residual's sums over its 8 taps with lane k on tap
    k, as xor shuffles over the eight lanes with masks 1, 2 and 4 (each
    lane adds its partner's value). Emulated here in float32 on seeded
    inputs with ties, signed zeros, infinities and NaN, every lane ends
    with the bits of sum8's tree ((x0 + x1) + (x2 + x3)) + ((x4 + x5) + (x6
    + x7)) and of the port's `_sum8` (frontend/immature), which the plain
    versions use (backend/ba._residual_core), NaN where they are NaN."""
    from ldso_tpu_torch.frontend.immature import _sum8
    x = _butterfly_inputs(kind)
    lanes = x.clone()
    for m in (1, 2, 4):
        lanes = lanes + lanes[:, torch.arange(8) ^ m]
    tree = ((x[:, 0] + x[:, 1]) + (x[:, 2] + x[:, 3])) + (
        (x[:, 4] + x[:, 5]) + (x[:, 6] + x[:, 7]))
    for want in (tree, _sum8(x)):
        for k in range(8):
            assert bool(kc._bits_equal(lanes[:, k], want).all()), (kind, k)
    if kind in ("infinities", "nan"):
        assert bool(torch.isnan(tree).any())


def _acc_windows(scene, lin_cases):
    planted = kc.linearized(*lin_cases["planted"][:3], scene["w"], scene["h"])
    return {"scene": scene["W_lin"], "planted": planted}


@pytest.mark.parametrize("window", ["scene", "planted"])
@pytest.mark.parametrize("case", ACC_CASES)
def test_acc_emulated_matches_plain(scene, lin_cases, window, case):
    """K7's own order of sums written out in plain float32 PyTorch
    (torch_kernel_checks.acc_emulated, which the card holds K7 to bit for
    bit) against K7's plain versions: within acc_err at the unchanged
    ACC_RTOL, NaN where they are NaN (the planted window's NaN patch),
    counts exact."""
    W = _acc_windows(scene, lin_cases)[window]
    part, args = kc.acc_cases(W)[case]
    rep = kc.acc_err(kc.acc_emulated(part, W, args),
                     kc.plain_acc(part, W, args), kc.acc_scale(part, W, args))
    assert rep["ok"], rep["faults"]
    if window == "planted" and part == "top":
        assert bool(torch.isnan(kc.acc_emulated(part, W, args)["acc"]).any())


@pytest.mark.parametrize("F,P", [(1, 48), (2, 96), (13, 624), (32, 1536),
                                 (8, 4096)])
def test_acc_emulated_matches_plain_at_other_widths(F, P):
    """acc_emulated against K7's plain versions on the windows the card
    test of every slot count runs (torch_kernel_checks.ba_scene, F frames
    in F slots at 96x64; 4,096 points: K7's point lists in two rounds):
    every call within acc_err at the unchanged ACC_RTOL, counts exact."""
    W = kc.ba_scene(F, F, P, 96, 64, seed=5)["W_lin"]
    for name, (part, args) in kc.acc_cases(W).items():
        rep = kc.acc_err(kc.acc_emulated(part, W, args),
                         kc.plain_acc(part, W, args),
                         kc.acc_scale(part, W, args))
        assert rep["ok"], (name, rep["faults"])


@pytest.mark.parametrize("case", ACC_CASES)
def test_acc_emulated_matches_jax(scene, case, monkeypatch):
    """K7's order (acc_emulated) against the JAX package's `_accumulate_top`
    and `_accumulate_sc` (with its stitch: the port's stitch fed the
    emulated sums) on the scene's linearized window: every output within
    ACC_RTOL of its largest entry, the counts equal."""
    W = scene["W_lin"]
    part, args = kc.acc_cases(W)[case]
    Wj = _jax_window(W)
    pcj = jba.make_precalc(Wj)
    got = kc.acc_emulated(part, W, args)
    if part == "top":
        _, mode, mask = args
        want = jba._accumulate_top(Wj, pcj, mode, jnp.asarray(npy(mask)))
        for name, g, w in zip(ck.TOP_OUTPUTS[:4], ck.TOP_OUTPUTS[:4], want):
            _rel(got[g], w, kc.ACC_RTOL, f"{case} {name}")
        assert int(got["nres"]) == int(want[4])
        return
    Hdd, bd, Hcd, shift, mask = args
    monkeypatch.setattr(ck, "ba_accumulate_sc",
                        lambda W_, *a: kc.acc_emulated("sc", W_, a))
    H, b, aux = ba._accumulate_sc(W, ba.make_precalc(W), Hdd, bd, Hcd, shift,
                                  mask)
    Hj, bj, auxj = jba._accumulate_sc(
        Wj, pcj, *(jnp.asarray(npy(x)) for x in (Hdd, bd, Hcd)), shift,
        jnp.asarray(npy(mask)))
    _rel(H, Hj, kc.ACC_RTOL, f"{case} H")
    _rel(b, bj, kc.ACC_RTOL, f"{case} b")
    for k in ("HdiF", "bdSum", "Hcd", "JpJdF"):
        _rel(aux[k], auxj[k], kc.ACC_RTOL, f"{case} {k}")
    equal(aux["ngood"], auxj["ngood"])


FAULTS = ("missing point", "wrong host", "NaN lost", "NaN added",
          "mode 1 without J delta")


@pytest.mark.parametrize("fault", FAULTS)
def test_acc_err_catches_planted_faults(scene, lin_cases, fault):
    """acc_err flags an accumulation that drops a point, books one point
    under another host, loses or adds a NaN, or sums mode 1 without its
    J delta."""
    W = scene["W_lin"]
    cases = kc.acc_cases(W)
    part, args = cases["top mode 1" if fault.startswith("mode")
                       else "sc build" if fault == "wrong host"
                       else "top mode 0"]
    want = kc.plain_acc(part, W, args)
    scale = kc.acc_scale(part, W, args)
    if fault == "missing point":
        p = int(torch.nonzero(W.pt_valid)[3])
        mask = args[2].clone()
        mask[p] = False
        got = kc.plain_acc(part, W, args[:2] + (mask,))
        got = dict(got, Hdd=want["Hdd"], bd=want["bd"], Hcd=want["Hcd"],
                   nres=want["nres"])
    elif fault == "wrong host":
        p = int(torch.nonzero(W.pt_valid)[3])
        host = W.pt_host.clone()
        host[p] = (host[p] + 1) % N_FRAMES
        got = kc.plain_acc(part, W._replace(pt_host=host), args)
    elif fault == "NaN lost":
        Wp, dIp, cfgp, _ = lin_cases["planted"]
        Wn = kc.linearized(Wp, dIp, cfgp, scene["w"], scene["h"])
        part, args = kc.acc_cases(Wn)["top mode 0"]
        want = kc.plain_acc(part, Wn, args)
        scale = kc.acc_scale(part, Wn, args)
        assert bool(torch.isnan(want["acc"]).any())
        got = dict(want, acc=torch.nan_to_num(want["acc"], nan=0.0))
    elif fault == "NaN added":
        acc = want["acc"].clone()
        acc[0, 1, 0, 0] = float("nan")
        got = dict(want, acc=acc)
    else:
        pc = args[0]
        got = kc.plain_acc(part, W, (pc._replace(
            adHTdelta=torch.zeros_like(pc.adHTdelta),
            c_delta=torch.zeros_like(pc.c_delta)),) + args[1:])
    rep = kc.acc_err(got, want, scale)
    assert not rep["ok"], rep


def test_lin_err_catches_one_ulp(scene, lin_cases):
    """lin_err wants bits: one ulp in one field, or in the energy sum, is a
    fault; the plain version against itself is not."""
    W, dIs, cfg, _ = lin_cases["window"]
    want = kc.plain_lin(W, dIs, cfg, scene["w"], scene["h"])
    assert kc.lin_err(want, want)["ok"]
    f = dict(want[0])
    f["JIdx"] = f["JIdx"].clone()
    f["JIdx"].view(torch.int32)[0, 1, 0, 0] += 1
    rep = kc.lin_err((f, want[1]), want)
    assert not rep["ok"] and rep["not_bitwise"]["JIdx"] == 1
    e = want[1].clone()
    e.view(torch.int32).add_(1)
    assert not kc.lin_err((want[0], e), want)["ok"]


def test_wrappers_take_the_plain_versions_on_the_cpu(scene, lin_cases):
    """On CPU tensors the wrappers are the plain versions, bit for bit,
    and launch nothing."""
    W, dIs, cfg, tgt = lin_cases["planted column"]
    before = dict(ck.LAUNCHES)
    got = ck.ba_linearize(W, dIs, ba.make_precalc(W), cfg, scene["w"],
                          scene["h"], tgt)
    assert kc.lin_err(got, kc.plain_lin(W, dIs, cfg, scene["w"], scene["h"],
                                        tgt))["ok"]
    Wl = scene["W_lin"]
    for case, (part, args) in kc.acc_cases(Wl).items():
        got = kc.kernel_acc(part, Wl, args)
        want = kc.plain_acc(part, Wl, args)
        for k, v in want.items():
            assert torch.equal(got[k], v), (case, k)
    assert ck.LAUNCHES == before


def _marg_inputs(scene, planted):
    W, dIs, cfg, _ = kc.lin_cases(scene)["planted" if planted else "window"]
    Wl = kc.linearized(W, dIs, cfg, scene["w"], scene["h"])
    P = Wl.P
    # idepth Hessians either side of the gate, as a BA leaves them
    hess = torch.linspace(0.0, 2.0 * cfg.min_idepth_h_marg, P)
    Wl = Wl._replace(pt_idepth_hessian=hess)
    cand = Wl.pt_valid & (torch.arange(P) % 4 == 1)
    drop = Wl.pt_valid & (torch.arange(P) % 9 == 2) & ~cand
    return Wl, cand, drop, dIs, cfg


@pytest.mark.parametrize("planted", [False, True])
def test_packed_marginalization_matches_jax(scene, planted):
    """marg_points_packed against the JAX package's _marg_points_fused on
    the same window and masks, field by field of the packed result: H and
    b within ACC_JAX_RTOL of their largest entry, nres exact, rec within
    JAC_RTOL, really and drop exact; the window's point and residual
    bookkeeping after it equal."""
    Wl, cand, drop, dIs, cfg = _marg_inputs(scene, planted)
    w, h = scene["w"], scene["h"]
    mih = float(np.float32(cfg.min_idepth_h_marg))
    fac = float(np.float32(cfg.idepth_fix_prior_marg_fac))
    Wt, pk = efm.marg_points_packed(Wl, cand, drop, dIs, mih, fac, cfg, w, h)
    Wj, pj = jef._marg_points_fused(
        _jax_window(Wl), jnp.asarray(npy(cand)), jnp.asarray(npy(drop)),
        jnp.asarray(npy(dIs)), jnp.float32(mih), jnp.float32(fac),
        _jax_cfg(cfg), w, h)
    assert tuple(pk.shape) == tuple(pj.shape)
    got = efm.unpack_marg(npy(pk).astype(np.float64), Wl.P)
    want = efm.unpack_marg(np.asarray(pj, np.float64), Wl.P)
    _rel(got[0], want[0], ACC_JAX_RTOL, "H")
    _rel(got[1], want[1], ACC_JAX_RTOL, "b")
    assert got[2] == want[2]
    _rel(got[3], want[3], JAC_RTOL, "rec")
    equal(got[4], want[4], "really")
    equal(got[5], want[5], "drop")
    assert got[4].any() and got[5].any()
    for f in ("pt_valid", "res_exist", "res_active", "res_linearized",
              "res_state"):
        equal(getattr(Wt, f), getattr(Wj, f), f)


def test_marg_pack_layout():
    """pack_marg's rows and unpack_marg's reading of them, as the JAX
    package lays them out."""
    n, P = 12, 29
    gen = torch.Generator().manual_seed(5)
    H, b = torch.rand((n, n), generator=gen), torch.rand(n, generator=gen)
    rec = torch.rand((P, 4), generator=gen)
    really = torch.rand(P, generator=gen) > 0.5
    drop = torch.rand(P, generator=gen) > 0.7
    pk = efm.pack_marg(H, b, torch.tensor(17), rec, really, drop)
    assert tuple(pk.shape) == (n + 2 + 6 * 3, n)
    Hu, bu, nres, recu, ru, du = efm.unpack_marg(npy(pk).astype(np.float64),
                                                 P)
    equal(Hu, npy(H).astype(np.float64))
    equal(bu, npy(b).astype(np.float64))
    assert nres == 17
    equal(recu, npy(rec).astype(np.float64))
    equal(ru, npy(really))
    equal(du, npy(drop))


_HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item",
               "tolist", "cpu", "numpy")


def test_marginalization_reads_nothing_on_the_host(scene, monkeypatch):
    """marg_points_packed with every tensor method that reads a value to
    the host patched to raise, and torch.tensor and torch.as_tensor of a
    value that is not a tensor too (after a first call has made its
    constants): on the card the same call is one graph replay. The result
    equals the unpatched call's bit for bit."""
    Wl, cand, drop, dIs, cfg = _marg_inputs(scene, False)
    args = (Wl, cand, drop, dIs, 50.0, 0.5, cfg, scene["w"], scene["h"])
    want = efm.marg_points_packed(*args)

    def refuse(*a, **k):
        raise AssertionError("the marginalization read a value to the host")
    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse)
    as_tensor = torch.as_tensor

    def tensors_only(x, *a, **k):
        if not isinstance(x, torch.Tensor):
            refuse()
        return as_tensor(x, *a, **k)
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", tensors_only)
    got = efm.marg_points_packed(*args)
    monkeypatch.undo()
    assert torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))


def test_energy_functional_pulls_the_packed_result_once(scene):
    """EnergyFunctional's dispatch hands back one HostCopy of the packed
    array, and consume reads only it: the same rec, really, dropped and
    prior as the unpacked results applied by hand."""
    from ldso_tpu_torch.utils.device import HostCopy
    Wl, cand, drop, dIs, cfg = _marg_inputs(scene, False)
    ef = efm.EnergyFunctional(cfg, scene["calib"], F=SLOTS, P=Wl.P,
                              device="cpu")
    ef.W, ef.n_frames = Wl, N_FRAMES
    ef.HM = np.zeros((4 + 8 * N_FRAMES,) * 2)
    ef.bM = np.zeros(4 + 8 * N_FRAMES)
    ef.pt_valid_np = npy(Wl.pt_valid).copy()
    pull = ef.marginalize_and_drop_dispatch(cand, drop, dIs, scene["w"],
                                            scene["h"])
    assert isinstance(pull, HostCopy)
    pk = pull.numpy().astype(np.float64)
    rec, really, dropped = ef.marginalize_and_drop_consume(pull)
    H, b, nres, rec_u, really_u, drop_u = efm.unpack_marg(pk, Wl.P)
    equal(rec, rec_u)
    equal(really, really_u)
    equal(dropped, drop_u)
    n = 4 + 8 * N_FRAMES
    close(ef.HM, cfg.marg_weight_fac * H[:n, :n], 0, 0, "HM")
    close(ef.bM, cfg.marg_weight_fac * b[:n], 0, 0, "bM")
    assert ef.res_in_m == nres > 0
    assert not (ef.pt_valid_np & (really | dropped)).any()
