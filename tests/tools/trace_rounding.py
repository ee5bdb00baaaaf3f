"""The trace's quality on the bench scene: where the port's float32
rounding parted from the JAX package's, each term of the search against
float64, and the activation lane the parity bisect flags.

    PYTHONPATH=$PWD python tests/tools/trace_rounding.py --build \
        --parent-root build/parent [--frames 26 104 110 133 134 136] \
        [--out tests/data/trace_rounding_lanes.npz]
    PYTHONPATH=$PWD python tests/tools/trace_rounding.py --terms \
        [--fixture tests/data/trace_rounding_lanes.npz]
    PYTHONPATH=$PWD python tests/tools/trace_rounding.py --arenas \
        [--frames 26 104 110 133 134 136]
    PYTHONPATH=$PWD python tests/tools/trace_rounding.py \
        --activation 138 [--activation-from 131]

--build steps the JAX FullSystem through the bench scene (the parity
bisect of tests/test_torch_parity.py, `--scene bench` with the bench's
photometric Config, carried into the port at the first frame's
predecessor) and, at each listed frame, takes the trace's inputs as the
bisect feeds them (the arena before the frame, the host tables from the
tracked pose). It keeps the lanes where the plain trace of another
checkout (`--parent-root`, a `git archive` of it: the port's order before
the trace took the JAX package's) leaves the trace's 2e-3 quality
tolerance against the JAX package's jitted trace, and writes their pool
fields, host slots, the host tables and the frame index. No image is
stored: the tests re-render the target frame from PlaneScene.

--terms holds the discrete search of each fixture lane, term by term,
against float64 on the same inputs (the step positions of the port's
trace): the bilinear samples of the 8 taps, the residuals, the Huber
weights, the terms hw r^2 (2 - hw), the 8-tap energies, the best and
second minima and their ratio. Each in two float32 orders: the JAX
package's jitted one (XLA:CPU's contracted multiply-adds, the taps summed
left to right; the port's since this change) and the order of separate
operations (the port's before it: one rounding a product and a sum, the
taps summed in a tree, the Huber weight as a reciprocal times the
threshold). Prints one JSON line per term: the median and largest
|float32 - float64| of each order over the fixture's lanes and live
steps.

--arenas traces each listed frame's whole arena (as the bisect feeds it)
through the port's plain trace and the JAX package's jitted trace and
prints, per field, the lanes that are not bit for bit the same.

--activation K runs the bisect from `--activation-from` through frame K
and, on keyframe K's activation as the bisect feeds it, prints the lane
whose idepth is farthest, relative to `test_activate`'s tolerance,
between the port's activation and the JAX package's jitted one, with
that lane's idepth from the JAX package run op by op (jax.disable_jit: no
fusion, so no contracted multiply-add), from the JAX package in float64
and from the port with its residual in the jitted order
(`xla_linearize_depth_residual`), each version's largest distance from
float64 over the optimised lanes, and how many lanes the jitted order
leaves apart from the JAX package's.
CPU only; --build and --activation take some minutes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)

FIXTURE = os.path.join(ROOT, "tests", "data", "trace_rounding_lanes.npz")
# the bisect's Config: the bench's photometric settings over the parity
# script's mode=1 defaults (Config() with loop closing off)
BENCH_CONFIG = dict(photometric_calibration=2, affine_opt_mode_a=1e12,
                    affine_opt_mode_b=1e8)
POOL_FIELDS = ("u", "v", "valid", "color", "weights", "gradH", "idepth_min",
               "idepth_max", "quality", "energy_th", "status", "last_u",
               "last_v", "last_interval", "my_type")
QUALITY_RTOL, QUALITY_ATOL = 2e-3, 1e-4
# the search's terms, in the chain's order (search_terms' keys)
TERMS = ("sample", "residual", "huber", "e_pix", "energy", "best", "second",
         "ratio")
ACT_RTOL, ACT_ATOL = 1e-4, 1e-6      # test_activate's


def configs():
    from test_torch_parity import _configs
    return _configs(**BENCH_CONFIG)


def _load_parent_immature(root: str):
    """The plain trace of another checkout, imported beside this one's."""
    path = os.path.join(root, "ldso_tpu_torch", "frontend", "immature.py")
    spec = importlib.util.spec_from_file_location("parent_immature", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bisect_inputs(first: int, last: int, frames, act_frame=None):
    """Run the parity bisect on the bench scene from `first` through
    `last` and return the JAX module inputs it feeds the port: the trace's
    at each frame of `frames` ({frame: {pool, host, KRKis, Kts, affs}}) and
    the activation's at `act_frame` (under "act": pool, host, idm, sane,
    Rs, ts, affs, masks, dIs), float32 as the bisect passes them."""
    import jax
    from ldso_tpu.frontend import immature as jim
    from ldso_tpu.system.full_system import FullSystem as JFS
    import test_torch_parity as tp
    seen, now = {}, {}
    tap, act, add0 = jim.trace_arena_prefix, jim.activate_arena, \
        JFS.add_active_frame

    def traced(arena, dI, KRKis, Kts, affs, calib, cfg, n):
        if (not isinstance(dI, jax.core.Tracer)
                and np.asarray(KRKis).dtype == np.float32
                and now["frame"] in frames):
            seen[now["frame"]] = dict(
                pool={f: np.asarray(getattr(arena.pool, f))[:n]
                      for f in POOL_FIELDS},
                host=np.asarray(arena.host)[:n], KRKis=np.asarray(KRKis),
                Kts=np.asarray(Kts), affs=np.asarray(affs))
        return tap(arena, dI, KRKis, Kts, affs, calib, cfg, n)

    def activated(arena, idm, sane, Rs, ts, affs, masks, dIs, calib, cfg):
        if (not isinstance(idm, jax.core.Tracer)
                and np.asarray(Rs).dtype == np.float32
                and now["frame"] == act_frame):
            seen["act"] = dict(
                pool={f: np.asarray(getattr(arena.pool, f))
                      for f in POOL_FIELDS},
                host=np.asarray(arena.host), idm=np.asarray(idm),
                sane=np.asarray(sane), Rs=np.asarray(Rs), ts=np.asarray(ts),
                affs=np.asarray(affs), masks=np.asarray(masks),
                dIs=np.asarray(dIs))
        return act(arena, idm, sane, Rs, ts, affs, masks, dIs, calib, cfg)

    def add(self, img, i, *a, **k):
        now["frame"] = i
        return add0(self, img, i, *a, **k)
    jim.trace_arena_prefix, jim.activate_arena = traced, activated
    JFS.add_active_frame = add
    try:
        tp.bisect(first, last, frames=tp._frames(last + 1, "bench"),
                  configs=configs())
    finally:
        jim.trace_arena_prefix, jim.activate_arena = tap, act
        JFS.add_active_frame = add0
    return seen


def build(args) -> None:
    import jax.numpy as jnp
    import torch
    from ldso_tpu.frontend import immature as jim
    from ldso_tpu.synthetic import default_calib
    parent = _load_parent_immature(args.parent_root)
    frames = sorted(args.frames)
    seen = _bisect_inputs(frames[0] - 1, frames[-1], frames)
    calib = default_calib(640, 480)
    jc, tc = configs()
    out = dict(frames=np.asarray(frames, np.int32))
    t32 = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    for F in frames:
        s = seen[F]
        ja = jim.ImmatureArena(
            pool=jim.ImmaturePool(**{f: jnp.asarray(v)
                                     for f, v in s["pool"].items()}),
            host=jnp.asarray(s["host"]))
        dI = render_dI(F)
        qj = np.asarray(jim.trace_arena(
            ja, jnp.asarray(dI.numpy()), jnp.asarray(s["KRKis"]),
            jnp.asarray(s["Kts"]), jnp.asarray(s["affs"]), calib,
            jc).pool.quality)
        pa = parent.ImmatureArena(
            pool=parent.ImmaturePool(**{f: t32(v)
                                        for f, v in s["pool"].items()}),
            host=t32(s["host"]))
        qp = parent.trace_arena_ref(pa, dI, t32(s["KRKis"]), t32(s["Kts"]),
                                    t32(s["affs"]), calib, tc).pool.quality
        qp = qp.numpy()
        both = np.isfinite(qj) & np.isfinite(qp)
        lanes = np.flatnonzero(both & (np.abs(qp - qj) > QUALITY_ATOL
                                       + QUALITY_RTOL * np.abs(qj)))
        print(json.dumps(dict(frame=F, lanes=int(lanes.size),
                              of=int(qj.size))), flush=True)
        for f in POOL_FIELDS:
            out[f"f{F}_{f}"] = s["pool"][f][lanes]
        out[f"f{F}_host"] = s["host"][lanes]
        out[f"f{F}_lane"] = lanes.astype(np.int32)
        for t in ("KRKis", "Kts", "affs"):
            out[f"f{F}_{t}"] = s[t]
    np.savez_compressed(args.out, **out)
    print(json.dumps(dict(written=args.out,
                          bytes=os.path.getsize(args.out))), flush=True)


def xla_linearize_depth_residual(u, v, color, weights, energy_th, idepth,
                                 R, t, affLL, dI_target, calib, cfg,
                                 outlier_slack, parts=None):
    """The port's linearize_depth_residual in the order the JAX package's
    jitted activation rounds it on the CPU (read off its outputs on the
    bisect's activation): the pattern rays times the focal lengths'
    float32 reciprocals (XLA turns a division by a constant into that
    multiply), each row of the projection fma(r1, y, r0 x) + r2, then + t
    idepth, the pixel fma(uu, fx, cx), the bilinear blend and the
    residual's affine model contracted, the depth derivative
    fma(dxI dr, fma(-t2, uu, t0), dyI dr fma(-t2, vv, t1)); the tap sums,
    the Huber weight and the LM's step as the port's. Not the port's
    order (ROADMAP §3, 3a)."""
    import torch
    from ldso_tpu_torch.frontend import immature as tim
    from ldso_tpu_torch.math.rounding import fma
    fx, fy = calib.fx[0], calib.fy[0]
    cx, cy = calib.cx[0], calib.cy[0]
    W, H = calib.w[0], calib.h[0]
    patt = tim._patt(u.device)
    zero = torch.zeros((), dtype=torch.float32, device=u.device)
    one = np.float32(1.0)
    x = (u[:, None] + patt[None, :, 0] - cx) * float(one / np.float32(fx))
    y = (v[:, None] + patt[None, :, 1] - cy) * float(one / np.float32(fy))

    def row(i):
        return ((fma(R[:, i, 1:2], y, R[:, i, 0:1] * x) + R[:, i, 2:3])
                + t[:, i:i + 1] * idepth[:, None])
    p0, p1, p2 = row(0), row(1), row(2)
    drescale = p2.reciprocal()
    uu, vv = p0 * drescale, p1 * drescale
    Ku, Kv = fma(uu, fx, cx), fma(vv, fy, cy)
    inb = (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < W - 3) & (Kv < H - 3)
    hit = tim._bilinear(dI_target, Ku, Kv)
    pix_ok = inb & torch.isfinite(hit[..., 0])
    oob = ~torch.all(pix_ok, dim=-1)
    r = hit[..., 0] - fma(affLL[:, None, 0], color, affLL[:, None, 1])
    hw = tim._huber_w(torch.abs(r), cfg)
    w2 = weights * weights
    energy = tim._sum8(torch.where(pix_ok, w2 * hw * r * r * (2.0 - hw),
                                   zero))
    dxI, dyI = hit[..., 1] * fx, hit[..., 2] * fy
    d_id = fma(dxI * drescale, fma(-t[:, 2:3], uu, t[:, 0:1]),
               dyI * drescale * fma(-t[:, 2:3], vv, t[:, 1:2]))
    hww = hw * w2
    Hdd = tim._sum8(torch.where(pix_ok, hww * d_id * d_id, zero))
    bd = tim._sum8(torch.where(pix_ok, hww * r * d_id, zero))
    lim = energy_th * outlier_slack
    over = energy > lim
    energy = torch.where(over, lim, energy)
    i32 = lambda c: torch.full((), c, dtype=torch.int32)  # noqa: E731
    state = torch.where(oob, i32(tim.RES_OOB),
                        torch.where(over, i32(tim.RES_OUTLIER),
                                    i32(tim.RES_IN)))
    return (energy, torch.where(oob, zero, Hdd), torch.where(oob, zero, bd),
            state)


def activation(args) -> None:
    """--activation: the flagged lane of keyframe `args.activation`'s
    activation in the JAX package jitted, op by op and in float64, and in
    the port."""
    import jax
    import jax.numpy as jnp
    import torch
    from ldso_tpu.frontend import immature as jim
    from ldso_tpu.synthetic import default_calib
    from ldso_tpu_torch.frontend import immature as tim
    from ldso_tpu_torch.utils import convert
    s = _bisect_inputs(args.activation_from, args.activation, (),
                       args.activation)["act"]
    calib = default_calib(640, 480)
    jc, tc = configs()

    def jax_run(dtype):
        cast = lambda a: (jnp.asarray(np.asarray(a, dtype))  # noqa: E731
                          if np.asarray(a).dtype == np.float32
                          else jnp.asarray(a))
        arena = jim.ImmatureArena(
            pool=jim.ImmaturePool(**{f: cast(v)
                                     for f, v in s["pool"].items()}),
            host=jnp.asarray(s["host"]))
        return np.asarray(jim.activate_arena(
            arena, cast(s["idm"]), jnp.asarray(s["sane"]), cast(s["Rs"]),
            cast(s["ts"]), cast(s["affs"]), jnp.asarray(s["masks"]),
            cast(s["dIs"]), calib, jc))
    jit = jax_run(np.float32)
    with jax.disable_jit():
        eager = jax_run(np.float32)
    with jax.enable_x64(True):
        f64 = jax_run(np.float64)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    arena = tim.ImmatureArena(
        pool=tim.ImmaturePool(**{f: t(v) for f, v in s["pool"].items()}),
        host=t(s["host"]))
    port = tim.activate_arena(
        arena, t(s["idm"]), t(s["sane"]), t(s["Rs"]), t(s["ts"]),
        t(s["affs"]), t(s["masks"]),
        convert.window_images_to_torch(jnp.asarray(s["dIs"])), calib,
        tc).numpy()
    plain = tim.linearize_depth_residual
    tim.linearize_depth_residual = xla_linearize_depth_residual
    try:
        xla = tim.activate_arena(
            arena, t(s["idm"]), t(s["sane"]), t(s["Rs"]), t(s["ts"]),
            t(s["affs"]), t(s["masks"]),
            convert.window_images_to_torch(jnp.asarray(s["dIs"])), calib,
            tc).numpy()
    finally:
        tim.linearize_depth_residual = plain
    ok = s["sane"] & (jit[:, 1] > 0.5) & (port[:, 1] > 0.5) & \
        np.isfinite(f64[:, 0])
    r = np.abs(port[:, 0] - jit[:, 0]) / (ACT_ATOL
                                          + ACT_RTOL * np.abs(jit[:, 0]))
    k = int(np.argmax(np.where(ok, r, 0.0)))
    far = lambda x: float(np.max(np.abs(x[ok, 0] - f64[ok, 0])))  # noqa: E731
    print(json.dumps(dict(
        frame=args.activation, lane=k, over_tolerance=float(r[k]),
        idepth=dict(jax_jit=float(jit[k, 0]), jax_op_by_op=float(eager[k, 0]),
                    port=float(port[k, 0]), port_xla_order=float(xla[k, 0]),
                    float64=float(f64[k, 0])),
        envelope_vs_float64=dict(jax_jit=far(jit), jax_op_by_op=far(eager),
                                 port=far(port), port_xla_order=far(xla)),
        xla_order_lanes_not_jit=int(np.sum(xla[ok, 0] != jit[ok, 0])),
        xla_order_max_rel=float(np.max(np.abs(xla[ok, 0] - jit[ok, 0])
                                       / np.abs(jit[ok, 0]))),
        optimised_lanes=int(ok.sum()),
        port_equals_op_by_op_lanes=int(np.sum(port[ok, 0] == eager[ok, 0])),
        port_equals_jit_lanes=int(np.sum(port[ok, 0] == jit[ok, 0])))),
        flush=True)


def render_frame(i: int) -> np.ndarray:
    """Frame i of the bench scene as the bisect renders it
    (tests/test_torch_parity._frames: JAX's PlaneScene, uint8)."""
    import jax.numpy as jnp
    from ldso_tpu.math import lie
    from ldso_tpu.synthetic import PlaneScene, default_calib
    t = np.array([0.03 * i, 0.01 * np.sin(0.2 * i), 0.004 * i])
    w = np.array([0.0, 0.0018 * i, 0.0004 * i])
    T_wc = np.asarray(lie.se3_exp(jnp.asarray(np.concatenate([t, w]))))
    img, _ = PlaneScene(freq_hi=25.0, contrast=80.0).render(
        default_calib(640, 480), jnp.asarray(np.linalg.inv(T_wc),
                                             jnp.float32))
    return np.clip(np.round(np.asarray(img)), 0, 255).astype(np.uint8)


def render_dI(frame: int):
    """Level 0 (I, dx, dy) of `render_frame(frame)`, a float32 tensor."""
    import torch
    from ldso_tpu_torch.ops.preprocess import make_pyramid_ref
    return make_pyramid_ref(torch.from_numpy(render_frame(frame)), 1).dI[0]


# ------------------------------------------------------------------ --terms

def search_terms(fix: dict, frame: int, order: str, dtype):
    """The discrete search's terms of the fixture lanes of `frame`: each
    step's 8 samples, residuals, Huber weights, e_pix terms, the energies,
    the best and second minima and the ratio. `order`: "xla" or "separate"
    (see the module docstring); dtype float32 or float64 (float64 computes
    the same formula in float64 on the float32 inputs). Positions: the
    port's trace's steps (its `parts`)."""
    import torch
    from ldso_tpu_torch.frontend import immature as tim
    from ldso_tpu_torch.math.rounding import fma
    from ldso_tpu.synthetic import default_calib
    calib = default_calib(640, 480)
    _, tc = configs()
    arena, dI, KRKis, Kts, affs = fixture_inputs(fix, frame)
    parts = {}
    tim.trace_arena_ref(arena, dI, KRKis, Kts, affs, calib, tc, parts)
    steps = torch.arange(parts["energies"].shape[1], dtype=torch.float32)
    sx = fma(steps[None, :], parts["dxn"][:, None], parts["ptx0"][:, None])
    sy = fma(steps[None, :], parts["dyn"][:, None], parts["pty0"][:, None])
    img = dI[..., 0].to(dtype)
    H, W = img.shape
    xs = torch.clamp(sx.to(dtype), 0.0, W - 1.001)
    ys = torch.clamp(sy.to(dtype), 0.0, H - 1.001)
    x0, y0 = torch.floor(xs), torch.floor(ys)
    dx, dy = (xs - x0)[..., None], (ys - y0)[..., None]
    patt = torch.tensor(tim._PATTERN, dtype=torch.int64)
    cx = torch.clamp(x0.long()[..., None] + patt[:, 0], 0, W - 1)
    cy = torch.clamp(y0.long()[..., None] + patt[:, 1], 0, H - 1)
    cx1, cy1 = torch.clamp(cx + 1, max=W - 1), torch.clamp(cy + 1, max=H - 1)
    flat = img.reshape(-1)
    v00, v01 = flat[cy * W + cx], flat[cy * W + cx1]
    v10, v11 = flat[cy1 * W + cx], flat[cy1 * W + cx1]
    h = torch.clamp(arena.host, 0, affs.shape[0] - 1).long()
    a0 = affs[h][:, None, None, 0].to(dtype)
    a1 = affs[h][:, None, None, 1].to(dtype)
    color = arena.pool.color[:, None, :].to(dtype)
    th = tc.huber_th
    xla = order == "xla" and dtype == torch.float32
    if xla:
        sample = tim._blend(dx, dy, v00, v01, v10, v11)
        res = sample - fma(a0, color, a1)
    else:
        dxdy = dx * dy
        sample = (dxdy * v11 + (dy - dxdy) * v10 + (dx - dxdy) * v01
                  + (1.0 - dx - dy + dxdy) * v00)
        res = sample - (a0 * color + a1)
    ar = torch.abs(res)
    if xla or dtype == torch.float64:
        hw = torch.where(ar < th, torch.ones_like(ar),
                         torch.full((), th, dtype=dtype)
                         / torch.clamp(ar, min=1e-12))
    else:
        hw = torch.where(ar < th, torch.ones_like(ar),
                         th / torch.clamp(ar, min=1e-12))
    e_pix = hw * res * res * (2.0 - hw)
    energy = tim._tap_sum(e_pix) if (xla or dtype == torch.float64) \
        else tim._sum8(e_pix)
    live = parts["energies"] < 1e10
    energy = torch.where(live, energy, torch.full_like(energy, 1e10))
    best, bi = torch.amin(energy, dim=-1), torch.argmin(energy, dim=-1)
    far = torch.abs(steps[None, :] - bi[:, None].float()) > 2.0
    second = torch.amin(torch.where(far, energy,
                                    torch.full_like(energy, 1e10)), dim=-1)
    ratio = second / torch.clamp(best, min=1e-12)
    return dict(sample=sample, residual=res, huber=hw, e_pix=e_pix,
                energy=energy, best=best, second=second, ratio=ratio,
                _live=live, _search=parts["do_search"])


def fixture_inputs(fix: dict, frame: int):
    """(arena, dI, KRKis, Kts, affs) of the fixture's lanes of `frame`,
    the target re-rendered."""
    import torch
    from ldso_tpu_torch.frontend import immature as tim
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    pool = tim.ImmaturePool(**{f: t(fix[f"f{frame}_{f}"])
                               for f in POOL_FIELDS})
    arena = tim.ImmatureArena(pool=pool, host=t(fix[f"f{frame}_host"]))
    return (arena, render_dI(frame), t(fix[f"f{frame}_KRKis"]),
            t(fix[f"f{frame}_Kts"]), t(fix[f"f{frame}_affs"]))


def _bits_equal(a, b) -> bool:
    """Two float32 tensors bit for bit."""
    import torch
    return a.shape == b.shape and bool(
        (a.contiguous().view(torch.int32)
         == b.contiguous().view(torch.int32)).all())


def term_errors(got: dict, ref: dict, k: str) -> np.ndarray:
    """|got - ref| of term k (search_terms' dicts, the same lanes) over the
    searching lanes' live steps where the float64 value is finite."""
    import torch
    r = ref[k]
    mask = ref["_search"]
    while mask.dim() < r.dim():
        mask = mask[..., None]
    if r.dim() >= 2:
        live = ref["_live"]
        while live.dim() < r.dim():
            live = live[..., None]
        mask = mask & live
    mask = mask.expand_as(r) & torch.isfinite(r)
    return torch.abs(got[k].double() - r)[mask].numpy()


def terms(args) -> None:
    import torch
    fix = dict(np.load(args.fixture))
    acc = {}
    for F in fix["frames"]:
        F = int(F)
        ref = search_terms(fix, F, "xla", torch.float64)
        for order in ("xla", "separate"):
            got = search_terms(fix, F, order, torch.float32)
            for k in got:
                if not k.startswith("_"):
                    acc.setdefault((k, order), []).append(
                        term_errors(got, ref, k))
    for k in TERMS:
        row = dict(term=k)
        for order in ("xla", "separate"):
            d = np.concatenate(acc[(k, order)])
            row[order] = dict(median=float(np.median(d)),
                              max=float(d.max()), n=int(d.size))
        print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build", action="store_true")
    ap.add_argument("--terms", action="store_true")
    ap.add_argument("--arenas", action="store_true")
    ap.add_argument("--parent-root")
    ap.add_argument("--frames", type=int, nargs="+",
                    default=[26, 104, 110, 133, 134, 136])
    ap.add_argument("--activation", type=int)
    ap.add_argument("--activation-from", type=int, default=131)
    ap.add_argument("--out", default=FIXTURE)
    ap.add_argument("--fixture", default=FIXTURE)
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.build:
        build(args)
    if args.terms:
        terms(args)
    if args.arenas:
        arenas(args)
    if args.activation:
        activation(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
