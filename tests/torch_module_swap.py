"""Swap one module of the JAX system for the port's, inside a running
system.

`swap_hooks(jfs, tcfg, tcalib, modules)` makes every call of a named
module of the JAX FullSystem `jfs` carry on with the port's output: the
port's module gets the JAX module's inputs (converted as the bisect of
tests/test_torch_parity.py converts them) and its output is converted back
to the JAX package's types. The JAX module still runs on the same inputs,
so each call also adds the signed difference port - JAX to a running
mean (`Bias`): over the output's inverse depths and over the norms of its
translations (and, for the marginalizations, over the prior's b). A
signed mean, not the largest |error|: a small bias that always has the
same sign adds up over a hundred frames, a tolerance test cannot see it.

Modules (the JAX function each replaces):
  track   the frame step `full_system._frame_step` (pyramid, track,
          retrack gate, trace), the chain step `_frame_step_chain` and the
          mapping side's trace `immature.trace_arena_sized`;
  act     the activation pass `full_system._activate_fused`;
  opt     the windowed BA, `ba_device.optimize_device`;
  mpts    the point marginalization, `energy_functional._marg_points_fused`
          (its dispatch and consume; `mdisp` and `mcons` name it too);
  mframe  the frame marginalization, `EnergyFunctional.marginalize_frame`
          (its float64 prior and the window's compaction).
The frame step split in its parts: `defused` runs the JAX frame and chain
steps as separately jitted parts (the pyramid, the track, the retrack gate
and the trace's tables, the trace) and swaps nothing, the control of the
two below, which run the same parts with one of them the port's:
  tracker the track of hypothesis 0 (`tracker._track_batch`);
  tracker_pose, tracker_aff  the same, of whose outputs only the pose, or
          only the brightness affine, is the port's;
  tracker_mirror  the JAX pose moved by the port's difference from it
          with its sign turned (exp(-log(T_port T_jax^-1)) T_jax): a
          difference that matters by its direction moves the system the
          other way, one that matters by its size alike;
  tracker_noise  the JAX pose moved by random se(3) steps of the size of
          the port's difference (NOISE_SIGMA each coordinate, seeded by
          `noise_seed`), the system's sensitivity to rounding that size;
  tracker_f64sum  the port's tracker with its Gauss-Newton sums H and b
          taken in float64 and rounded once (`_calc_gs_f64sum`): whether
          the sums' rounding is what parts the two trackers;
  trace   the trace of the arena, in the frame step and on the mapping
          side (`immature.trace_arena`).

`source="jax"` swaps in the JAX module's own output, sent to the port's
types and back: the run must then be bitwise the unhooked run, which
tests the plumbing (tests/test_torch_module_swap.py). `eager=True` runs
the JAX module op by op (`jax.disable_jit()`) and swaps nothing: the
rounding control of a module whose swap moves the ATE.

Used by `tests/tools/bench_ate_cpu.py --package jax --swap ...`.
"""

from __future__ import annotations

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

# tracker_noise: the standard deviation of each coordinate of the random
# se(3) step; the port's pose differs from the JAX package's by about
# 1e-7 in translation and rotation on the bench (tests/tools/
# tracker_rounding.py)
NOISE_SIGMA = 6e-8

MODULES = ("track", "act", "opt", "mpts", "mframe", "tracker", "trace",
           "defused", "tracker_pose", "tracker_aff", "tracker_mirror",
           "tracker_noise", "tracker_f64sum")
ALIASES = {"mdisp": "mpts", "mcons": "mpts"}


def module_names(spec: str) -> tuple:
    """'track,act' / 'all' -> the module names, aliases resolved."""
    if spec == "all":
        return MODULES
    out = []
    for m in spec.split(","):
        m = ALIASES.get(m.strip(), m.strip())
        if m not in MODULES:
            raise ValueError(f"unknown module {m!r}; one of {MODULES}")
        if m not in out:
            out.append(m)
    return tuple(out)


class Bias:
    """Signed running means of port - JAX, per module and quantity: the
    mean over every element of every call, the number of calls, and how
    many calls had a positive mean."""

    def __init__(self):
        self.acc = {}

    def add(self, module: str, what: str, port, ref, mask=None):
        p = np.asarray(port, np.float64).ravel()
        r = np.asarray(ref, np.float64).ravel()
        ok = np.isfinite(p) & np.isfinite(r)
        if mask is not None:
            ok &= np.asarray(mask, bool).ravel()
        if not ok.any():
            return
        d = p[ok] - r[ok]
        a = self.acc.setdefault((module, what), [0.0, 0, 0, 0])
        a[0] += float(d.sum())
        a[1] += int(d.size)
        a[2] += 1
        a[3] += int(d.mean() > 0)

    def table(self) -> dict:
        out = {}
        for (m, w), (s, n, calls, pos) in sorted(self.acc.items()):
            out.setdefault(m, {})[w] = dict(mean=s / n, n=n, calls=calls,
                                            positive_calls=pos)
        return out


# ------------------------------------------------------------- conversions

def _t(a) -> torch.Tensor:
    """A JAX/numpy array -> a CPU tensor with the same dtype and bits."""
    return torch.from_numpy(np.array(np.asarray(a)))


def _j(t, like) -> jax.Array:
    """A tensor -> a JAX array of `like`'s dtype and shape."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    like = np.asarray(like)
    return jnp.asarray(np.asarray(a).astype(like.dtype).reshape(like.shape))


def _nt_t(cls, nt):
    """A JAX NamedTuple -> the port's NamedTuple `cls` of tensors; index
    fields the port indexes with widen to int64 (utils/convert)."""
    from ldso_tpu_torch.utils import convert
    return cls(**{k: convert._t(k, np.asarray(getattr(nt, k)), "cpu")
                  for k in cls._fields})


def _nt_j(tnt, like):
    """A port NamedTuple -> the JAX NamedTuple of `like`'s type, each field
    in `like`'s dtype."""
    return type(like)(**{k: _j(getattr(tnt, k), getattr(like, k))
                         for k in type(like)._fields})


def _window_t(W):
    from ldso_tpu_torch.backend.window import Window
    return _nt_t(Window, W)


def _arena_t(arena):
    from ldso_tpu_torch.frontend.immature import ImmatureArena, ImmaturePool
    return ImmatureArena(pool=_nt_t(ImmaturePool, arena.pool),
                         host=_t(arena.host))


def _arena_j(at, like):
    return type(like)(pool=_nt_j(at.pool, like.pool),
                      host=_j(at.host, like.host))


def _pyr_t(pyr):
    from ldso_tpu_torch.ops.preprocess import FramePyramid
    return FramePyramid(dI=tuple(_t(a) for a in pyr.dI),
                        abs_grad=tuple(_t(a) for a in pyr.abs_grad))


def _pyr_j(pt, like):
    return type(like)(dI=tuple(_j(a, b) for a, b in zip(pt.dI, like.dI)),
                      abs_grad=tuple(_j(a, b) for a, b in
                                     zip(pt.abs_grad, like.abs_grad)))


def _ref_t(ref):
    from ldso_tpu_torch.utils import convert
    return convert.tracker_ref_to_torch(ref)


def _dIs_t(dIs):
    from ldso_tpu_torch.utils import convert
    return convert.window_images_to_torch(dIs)


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a), np.float32))


def _tnorms(packed) -> np.ndarray:
    """The translation norm of a packed row's T (the first 16 entries)."""
    p = np.asarray(packed, np.float64)
    return np.linalg.norm(p[..., :16].reshape(-1, 4, 4)[:, :3, 3], axis=-1)


def _pose_tnorms(W) -> np.ndarray:
    """The window's frames' translation norms (valid frames, else NaN)."""
    from ldso_tpu.backend.window import current_poses
    T = np.asarray(current_poses(W), np.float64)
    n = np.linalg.norm(T[:, :3, 3], axis=-1)
    return np.where(np.asarray(W.frame_valid), n, np.nan)


def _calc_gs_f64sum(bufs, lvl, ref, aff_new, new_exposure, calib):
    """The port's `tracker._calc_gs` with H = sum w J J^T / n and b = sum w
    J r / n taken in float64 and rounded once to float32 (tracker_f64sum);
    J, w and r are the float32 ones."""
    from ldso_tpu_torch.frontend import affine
    from ldso_tpu_torch.frontend import tracker as ttr
    fx, fy = calib.fx[lvl], calib.fy[lvl]
    rel = affine.from_to(ref.ref_exposure, new_exposure, ref.ref_aff, aff_new)
    a_rel = rel[:, 0:1]
    b0 = ref.ref_aff[1]
    dxf = bufs["dx"] * fx
    dyf = bufs["dy"] * fy
    u, v, idep = bufs["u"], bufs["v"], bufs["idepth"]
    J = torch.stack([
        idep * dxf, idep * dyf, -idep * (u * dxf + v * dyf),
        -(u * v * dxf + (1.0 + v * v) * dyf),
        u * v * dyf + (1.0 + u * u) * dxf, u * dyf - v * dxf,
        (a_rel * (b0 - bufs["color"][None, :])).expand_as(u),
        -torch.ones_like(u)], dim=-1)
    w = bufs["hw"] * bufs["good"]
    n = torch.clamp(torch.sum(bufs["good"], dim=1), min=1.0)[:, None, None]
    Jw = (J * w[..., None]).double()
    J = J.double()
    n = n.double()
    H = ((Jw.transpose(1, 2) @ J) / n).float()
    b = ((Jw.transpose(1, 2) @ bufs["residual"].double()[..., None])[..., 0]
         / n[..., 0]).float()
    scale = ttr._scale_vec(u.device)
    return H * scale[:, None] * scale[None, :], b * scale, scale


@jax.jit
def _trace_tables_jax(T, T_ref_cw, T_hosts, host_affs, host_expos, aff,
                      exposure, calib_K):
    """The trace's per-host tables of the JAX package's `_frame_step`
    (full_system.py:72-83) as a program of their own."""
    K = calib_K
    Ki = jnp.linalg.inv(K)
    T_new_cw = T @ T_ref_cw
    T_rel = jnp.einsum("ij,fjk->fik", T_new_cw, jnp.linalg.inv(T_hosts))
    KRKis = jnp.einsum("ij,fjk,kl->fil", K, T_rel[:, :3, :3], Ki)
    Kts = jnp.einsum("ij,fj->fi", K, T_rel[:, :3, 3])
    ra = jnp.exp(aff[0] - host_affs[:, 0]) * exposure / host_expos
    affs = jnp.stack([ra, aff[1] - ra * host_affs[:, 1]], axis=-1)
    return KRKis, Kts, affs


# ------------------------------------------------------------------- hooks

@contextlib.contextmanager
def swap_hooks(jfs, tcfg, tcalib, modules, bias: Bias | None = None,
               source: str = "port", eager: bool = False,
               noise_seed: int = 0):
    """While active, each call of a module in `modules` (MODULES) of the
    JAX system `jfs` returns the port's output (source="port") or its own
    output sent through the port's types and back (source="jax"); with
    eager=True the named modules run op by op and nothing is swapped.
    Differences port - JAX go to `bias`."""
    from ldso_tpu.backend import ba_device as jbd
    from ldso_tpu.backend import energy_functional as jef_mod
    from ldso_tpu.frontend import immature as jim
    from ldso_tpu.system import full_system as jfull
    from ldso_tpu_torch.backend import ba_device as tbd
    from ldso_tpu_torch.backend import energy_functional as tef_mod
    from ldso_tpu_torch.backend.energy_functional import EnergyFunctional
    from ldso_tpu_torch.frontend import immature as tim
    from ldso_tpu_torch.system import full_system as tfull
    modules = module_names(",".join(modules)) if modules else ()
    bias = bias if bias is not None else Bias()
    ef = jfs.ef
    patched = []   # (owner, name, original)

    def patch(owner, name, fn):
        patched.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def op_by_op(fn):
        def run(*a, **k):
            with jax.disable_jit():
                return fn(*a, **k)
        return run

    if eager:
        for m in modules:
            if m == "track":
                patch(jfull, "_frame_step", op_by_op(jfull._frame_step))
                patch(jfull, "_frame_step_chain",
                      op_by_op(jfull._frame_step_chain))
                patch(jim, "trace_arena_sized",
                      op_by_op(jim.trace_arena_sized))
            elif m == "act":
                patch(jfull, "_activate_fused", op_by_op(jfull._activate_fused))
            elif m == "opt":
                patch(jbd, "optimize_device", op_by_op(jbd.optimize_device))
            elif m == "mpts":
                patch(jef_mod, "_marg_points_fused",
                      op_by_op(jef_mod._marg_points_fused))
            elif m == "mframe":
                ef.marginalize_frame = op_by_op(ef.marginalize_frame)
        try:
            yield bias
        finally:
            for owner, name, fn in reversed(patched):
                setattr(owner, name, fn)
            ef.__dict__.pop("marginalize_frame", None)
        return

    port = source == "port"
    orig = {}

    def frame_step(image, arena, ref, T0, aff0, exposure, last_rmse,
                   T_ref_cw, T_hosts, host_affs, host_expos, b_grad,
                   enable_trace, calib, cfg, coarsest, n_trace=1 << 30):
        aj, pj, kj = orig["frame_step"](
            image, arena, ref, T0, aff0, exposure, last_rmse, T_ref_cw,
            T_hosts, host_affs, host_expos, b_grad, enable_trace, calib,
            cfg, coarsest, n_trace=n_trace)
        if port:
            up = torch.cat([_f32(T0).reshape(-1), _f32(aff0),
                            _f32(exposure).reshape(1),
                            _f32(last_rmse).reshape(-1)[:1],
                            torch.tensor([float(enable_trace)]),
                            _f32(T_ref_cw).reshape(-1),
                            _f32(T_hosts).reshape(-1),
                            _f32(host_affs).reshape(-1), _f32(host_expos)])
            pt, at, kt = tfull.frame_step(
                _t(image), _ref_t(ref), _arena_t(arena), up,
                None if b_grad is None else _t(b_grad), tcalib, tcfg)
        else:
            pt, at, kt = _pyr_t(pj), _arena_t(aj), _t(kj)
        if np.asarray(kj)[19] > 0.5 or float(kt[19]) > 0.5:
            _trace_bias("track", at, aj)
        bias.add("track", "tnorm", _tnorms(kt), _tnorms(kj))
        return _arena_j(at, aj), _pyr_j(pt, pj), _j(kt, kj)

    def frame_step_chain(image, ref, T0, aff0, exposure, last_rmse, b_grad,
                         calib, cfg, coarsest):
        pj, kj = orig["frame_step_chain"](image, ref, T0, aff0, exposure,
                                          last_rmse, b_grad, calib, cfg,
                                          coarsest)
        if port:
            pt, T, aff, ok, res, flow = tfull._track_hypothesis0(
                _t(image), _ref_t(ref), _f32(T0), _f32(aff0),
                _f32(exposure).reshape(()),
                None if b_grad is None else _t(b_grad), tcalib, tcfg)
            kt = torch.cat([T.reshape(-1), aff, ok.to(torch.float32)[None],
                            torch.zeros(1), res, flow])
        else:
            pt, kt = _pyr_t(pj), _t(kj)
        bias.add("track", "tnorm", _tnorms(kt), _tnorms(kj))
        return _pyr_j(pt, pj), _j(kt, kj)

    def _trace_bias(module, at, aj):
        live = np.asarray(aj.pool.valid) & np.asarray(at.pool.valid.numpy())
        for f in ("idepth_min", "idepth_max"):
            bias.add(module, "idepth", getattr(at.pool, f).numpy(),
                     np.asarray(getattr(aj.pool, f)), live)

    def trace_sized(arena, dI, KRKis, Kts, affs, calib, cfg, n):
        aj = orig["trace_sized"](arena, dI, KRKis, Kts, affs, calib, cfg, n)
        if port:
            at = tim.trace_arena(_arena_t(arena), _t(dI), _f32(KRKis),
                                 _f32(Kts), _f32(affs), tcalib, tcfg)
        else:
            at = _arena_t(aj)
        _trace_bias("track", at, aj)
        return _arena_j(at, aj)

    def activate(W, arena, dIs, KRKis, Kts, Rs, ts, affs_a, masks,
                 min_act_dist, marg_flags, newest, nf, cfg, calib, w1, h1,
                 n_act=1 << 30):
        Wj, aj, kj = orig["act"](W, arena, dIs, KRKis, Kts, Rs, ts, affs_a,
                                 masks, min_act_dist, marg_flags, newest, nf,
                                 cfg, calib, w1, h1, n_act=n_act)
        if port:
            Wt, at, kt = tfull._activate_fused(
                _window_t(W), _arena_t(arena), _dIs_t(dIs), _f32(KRKis),
                _f32(Kts), _f32(Rs), _f32(ts), _f32(affs_a), _t(masks),
                _f32(min_act_dist).reshape(()), _t(marg_flags), int(newest),
                int(nf), tcfg, tcalib, w1, h1)
        else:
            Wt, at, kt = _window_t(Wj), _arena_t(aj), _t(kj)
        both = np.asarray(Wj.pt_valid) & Wt.pt_valid.numpy()
        bias.add("act", "idepth", Wt.idepth.numpy(), np.asarray(Wj.idepth),
                 both)
        # the JAX pass packs only the lanes under its watermark; the port's
        # packs every lane, and the ones past the watermark are dead
        return (_nt_j(Wt, Wj), _arena_j(at, aj),
                _j(kt[:np.asarray(kj).shape[0]], kj))

    def optimize_device(W, dIs, HM, bM, newest, cfg, img_w, img_h,
                        max_iterations):
        Wj, sj = orig["opt"](W, dIs, HM, bM, newest, cfg, img_w, img_h,
                             max_iterations)
        if port:
            Wt, st = tbd.optimize_device(_window_t(W), _dIs_t(dIs), _f32(HM),
                                         _f32(bM), int(newest), tcfg, img_w,
                                         img_h, max_iterations)
        else:
            Wt, st = _window_t(Wj), _t(sj)
        WJ = _nt_j(Wt, Wj)
        both = np.asarray(Wj.pt_valid) & Wt.pt_valid.numpy()
        bias.add("opt", "idepth", Wt.idepth.numpy(), np.asarray(Wj.idepth),
                 both)
        bias.add("opt", "tnorm", _pose_tnorms(WJ), _pose_tnorms(Wj))
        return WJ, _j(st, sj)

    def marg_points(W, marg_cand, drop, dIs, min_h, fac, cfg, img_w, img_h):
        Wj, kj = orig["mpts"](W, marg_cand, drop, dIs, min_h, fac, cfg,
                              img_w, img_h)
        if port:
            Wt, kt = tef_mod.marg_points_packed(
                _window_t(W), _t(marg_cand), _t(drop), _dIs_t(dIs),
                float(min_h), float(fac), tcfg, img_w, img_h)
        else:
            Wt, kt = _window_t(Wj), _t(kj)
        P = W.pt_valid.shape[0]
        Hj, bj, _, recj, rj, _ = tef_mod.unpack_marg(
            np.asarray(kj, np.float64), P)
        Ht, bt, _, rect, rt, _ = tef_mod.unpack_marg(
            kt.numpy().astype(np.float64), P)
        bias.add("mpts", "idepth", rect[:, 2], recj[:, 2], rj & rt)
        bias.add("mpts", "prior_b", bt, bj)
        return _nt_j(Wt, Wj), _j(kt, kj)

    def marg_frame(idx, pre_drop=None, prior_delta=None):
        tef = EnergyFunctional(tcfg, ef.calib, F=ef.F, P=ef.P, device="cpu")
        tef.W = _window_t(ef.W)
        tef.n_frames = ef.n_frames
        tef.HM, tef.bM = ef.HM.copy(), ef.bM.copy()
        tef.res_in_m = ef.res_in_m
        tef.pt_valid_np = ef.pt_valid_np.copy()
        tef.pt_host_np = ef.pt_host_np.astype(np.int64)
        tef.window_shells = [types.SimpleNamespace(kf_id=f.kf_id)
                             for f in ef.window_shells]
        if port:
            tef.marginalize_frame(
                idx, pre_drop=None if pre_drop is None else _t(pre_drop),
                prior_delta=prior_delta)
        orig["mframe"](idx, pre_drop=pre_drop, prior_delta=prior_delta)
        if not port:
            tef.W, tef.HM, tef.bM = _window_t(ef.W), ef.HM, ef.bM
            tef.pt_host_np = ef.pt_host_np
        bias.add("mframe", "prior_b", tef.bM, ef.bM)
        ef.W = _nt_j(tef.W, ef.W)
        ef.HM, ef.bM = np.array(tef.HM), np.array(tef.bM)
        ef.pt_host_np = np.asarray(tef.pt_host_np).astype(ef.pt_host_np.dtype)

    parts = ("tracker", "tracker_pose", "tracker_aff", "tracker_mirror",
             "tracker_f64sum")
    noise = np.random.RandomState(noise_seed)
    from ldso_tpu.math import lie as jlie
    split = [m for m in modules
             if m in parts + ("trace", "defused", "tracker_noise")]
    if split and "track" in modules:
        raise ValueError("swap track or its parts, not both")
    from ldso_tpu.frontend import tracker as jtr
    from ldso_tpu.ops import preprocess as jpre
    from ldso_tpu_torch.frontend import tracker as ttr

    def split_track(image, ref, T0, aff0, exposure, b_grad, calib, cfg,
                    coarsest):
        """The JAX pyramid, and the track of T0: the JAX package's, or the
        port's with `tracker` swapped."""
        pyr = jpre.make_pyramid(image, calib.levels, b_grad)
        no_abort = jnp.full((calib.levels,), 1e9, jnp.float32)
        oj = jtr.track_frame(ref, pyr, T0, aff0, exposure, no_abort, calib,
                             cfg, coarsest)
        if "tracker_noise" in modules:
            step = noise.randn(6) * NOISE_SIGMA
            T = np.asarray(jlie.se3_exp(jnp.asarray(step))) @ np.asarray(
                oj[0], np.float64)
            bias.add("tracker_noise", "tnorm", _tnorms(T.reshape(-1)),
                     _tnorms(np.asarray(oj[0]).reshape(-1)))
            return pyr, (_j(T, oj[0]),) + tuple(oj[1:])
        which = [m for m in modules if m in parts]
        if not which:
            return pyr, oj
        keep = ttr._calc_gs
        if "tracker_f64sum" in which:
            ttr._calc_gs = _calc_gs_f64sum
        try:
            ot = ttr._track_batch(_ref_t(ref), _pyr_t(pyr),
                                  _f32(T0)[None], _f32(aff0),
                                  _f32(exposure).reshape(()),
                                  _f32(no_abort), tcalib, tcfg, coarsest)
        finally:
            ttr._calc_gs = keep
        ot = tuple(_j(o[0], j) for o, j in zip(ot, oj))
        bias.add(which[0], "tnorm", _tnorms(np.asarray(ot[0]).reshape(-1)),
                 _tnorms(np.asarray(oj[0]).reshape(-1)))
        bias.add(which[0], "aff_a", np.asarray(ot[1])[0],
                 np.asarray(oj[1])[0])
        bias.add(which[0], "aff_b", np.asarray(ot[1])[1],
                 np.asarray(oj[1])[1])
        if "tracker" in which or "tracker_f64sum" in which:
            return pyr, ot
        if "tracker_mirror" in which:
            Tj = np.asarray(oj[0], np.float64)
            Tt = np.asarray(ot[0], np.float64)
            d = np.asarray(jlie.se3_log(jnp.asarray(Tt @ np.linalg.inv(Tj))))
            T = np.asarray(jlie.se3_exp(jnp.asarray(-d))) @ Tj
            return pyr, (_j(T, oj[0]),) + tuple(oj[1:])
        take = {"tracker_pose": 0, "tracker_aff": 1}
        return pyr, tuple(ot[k] if k in [take[m] for m in which] else oj[k]
                          for k in range(len(oj)))

    def split_trace(arena, dI, KRKis, Kts, affs, calib, cfg, n):
        aj = orig["trace_sized"](arena, dI, KRKis, Kts, affs, calib, cfg, n)
        if "trace" not in modules:
            return aj
        at = tim.trace_arena(_arena_t(arena), _t(dI), _f32(KRKis),
                             _f32(Kts), _f32(affs), tcalib, tcfg)
        _trace_bias("trace", at, aj)
        return _arena_j(at, aj)

    def split_frame_step(image, arena, ref, T0, aff0, exposure, last_rmse,
                         T_ref_cw, T_hosts, host_affs, host_expos, b_grad,
                         enable_trace, calib, cfg, coarsest,
                         n_trace=1 << 30):
        pyr, (T, aff, ok, res, flow) = split_track(
            image, ref, T0, aff0, exposure, b_grad, calib, cfg, coarsest)
        accept = bool(ok) and bool(jnp.isfinite(res[0])) and (
            not bool(jnp.isfinite(last_rmse[0]))
            or bool(res[0] < last_rmse[0] * cfg.re_track_threshold))
        traced = bool(enable_trace) and accept
        if traced:
            K = np.zeros((3, 3), np.float32)
            K[0, 0], K[1, 1] = calib.fx[0], calib.fy[0]
            K[0, 2], K[1, 2], K[2, 2] = calib.cx[0], calib.cy[0], 1.0
            KRKis, Kts, affs = _trace_tables_jax(T, T_ref_cw, T_hosts,
                                                 host_affs, host_expos, aff,
                                                 exposure, jnp.asarray(K))
            arena = split_trace(arena, pyr.dI[0], KRKis, Kts, affs, calib,
                                cfg, min(n_trace, arena.host.shape[0]))
        packed = jnp.concatenate([
            T.reshape(-1), aff, ok.astype(jnp.float32)[None],
            jnp.asarray([float(traced)], jnp.float32), res, flow])
        return arena, pyr, packed

    def split_frame_step_chain(image, ref, T0, aff0, exposure, last_rmse,
                               b_grad, calib, cfg, coarsest):
        pyr, (T, aff, ok, res, flow) = split_track(
            image, ref, T0, aff0, exposure, b_grad, calib, cfg, coarsest)
        packed = jnp.concatenate([
            T.reshape(-1), aff, ok.astype(jnp.float32)[None],
            jnp.zeros((1,), jnp.float32), res, flow])
        return pyr, packed

    if split:
        orig["trace_sized"] = jim.trace_arena_sized
        patch(jfull, "_frame_step", split_frame_step)
        patch(jfull, "_frame_step_chain", split_frame_step_chain)
        patch(jim, "trace_arena_sized", split_trace)
    for m in modules:
        if m == "track":
            orig["frame_step"] = jfull._frame_step
            orig["frame_step_chain"] = jfull._frame_step_chain
            orig["trace_sized"] = jim.trace_arena_sized
            patch(jfull, "_frame_step", frame_step)
            patch(jfull, "_frame_step_chain", frame_step_chain)
            patch(jim, "trace_arena_sized", trace_sized)
        elif m == "act":
            orig["act"] = jfull._activate_fused
            patch(jfull, "_activate_fused", activate)
        elif m == "opt":
            orig["opt"] = jbd.optimize_device
            patch(jbd, "optimize_device", optimize_device)
        elif m == "mpts":
            orig["mpts"] = jef_mod._marg_points_fused
            patch(jef_mod, "_marg_points_fused", marg_points)
        elif m == "mframe":
            orig["mframe"] = ef.marginalize_frame
            ef.marginalize_frame = marg_frame
    try:
        yield bias
    finally:
        for owner, name, fn in reversed(patched):
            setattr(owner, name, fn)
        ef.__dict__.pop("marginalize_frame", None)


# ------------------------------------------- the tracker against float64

class _Float64:
    """jax.numpy with jnp.float32 read as float64: the JAX tracker (and its
    affine brightness model) name float32 for their state and constants;
    run under x64 with it, they compute in float64 throughout."""

    def __init__(self, jnp_):
        self._jnp = jnp_

    def __getattr__(self, name):
        return getattr(self._jnp, "float64" if name == "float32" else name)


def _f64(x):
    a = np.asarray(x)
    return jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)


TRACK_DIFFS = ("d_norm", "d_along", "d_back", "d_t", "d_R", "d_aff_a",
               "d_aff_b", "d_res0", "d_tx", "d_ty", "d_tz", "d_wx", "d_wy",
               "d_wz")


def tracker_vs_float64(track, out, args, tcalib, tcfg,
                       terms: bool = False) -> dict:
    """One track of hypothesis 0 (`track` the JAX package's
    `tracker.track_frame`, `out` its result on `args`) against the same
    track in float64 (the JAX tracker under x64 with float32 read as
    float64, on the inputs cast to float64), beside the port's
    (`tracker._track_batch`) on the same inputs. Returns the float64
    result's |t| and, for "jax" and "port", the signed differences from it
    (TRACK_DIFFS): of |t|, of t along t's direction and along the way back
    to the track's start T0 (positive where the LM stopped short of
    float64's end), |dt|, the largest rotation entry, the affine's a and
    b, the level-0 residual, and each coordinate of dt and of the
    rotation's difference (a small angle vector); with `terms` also
    tracker_gs_vs_float64's (GS_DIFFS) at the float64 track's end."""
    from ldso_tpu.frontend import affine as jaff
    from ldso_tpu.frontend import tracker as jtr
    from ldso_tpu.frontend.tracker import TrackerRef
    from ldso_tpu.ops.preprocess import FramePyramid
    from ldso_tpu_torch.frontend import tracker as ttr
    ref, pyr, T0, aff0, exposure, no_abort, calib, cfg, coarsest = args
    ot = ttr._track_batch(_ref_t(ref), _pyr_t(pyr), _f32(T0)[None],
                          _f32(aff0), _f32(exposure).reshape(()),
                          _f32(no_abort), tcalib, tcfg, coarsest)
    with jax.enable_x64(True):
        jtr.jnp = jaff.jnp = _Float64(jnp)
        try:
            o64 = track(
                TrackerRef(points=tuple(map(_f64, ref.points)),
                           valid=tuple(map(_f64, ref.valid)),
                           ref_exposure=_f64(ref.ref_exposure),
                           ref_aff=_f64(ref.ref_aff)),
                FramePyramid(dI=tuple(map(_f64, pyr.dI)),
                             abs_grad=tuple(map(_f64, pyr.abs_grad))),
                _f64(T0), _f64(aff0), _f64(exposure), _f64(no_abort),
                calib, cfg, coarsest)
        finally:
            jtr.jnp = jaff.jnp = jnp
        assert np.asarray(o64[0]).dtype == np.float64
        T64 = np.asarray(o64[0], np.float64)
        aff64 = np.asarray(o64[1], np.float64)
        res64 = np.asarray(o64[3], np.float64)
    t64 = T64[:3, 3]
    along = t64 / max(np.linalg.norm(t64), 1e-300)
    t0 = np.asarray(T0, np.float64)[:3, 3]
    back = (t0 - t64) / max(np.linalg.norm(t0 - t64), 1e-300)
    row = dict(t_norm_f64=float(np.linalg.norm(t64)), res0_f64=float(res64[0]))
    if terms:
        gs_rows = tracker_gs_vs_float64(args, T64, aff64, tcalib, tcfg)
    for name, T, aff, res in (("jax", out[0], out[1], out[3]),
                              ("port", ot[0][0].numpy(), ot[1][0].numpy(),
                               ot[3][0].numpy())):
        T = np.asarray(T, np.float64)
        aff = np.asarray(aff, np.float64)
        # the rotation's difference as a small angle vector (R R64^T - I)
        dR = T[:3, :3] @ T64[:3, :3].T
        dw = 0.5 * np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                             dR[1, 0] - dR[0, 1]])
        dt = T[:3, 3] - t64
        row[name] = dict(
            d_norm=float(np.linalg.norm(T[:3, 3]) - np.linalg.norm(t64)),
            d_along=float((T[:3, 3] - t64) @ along),
            d_back=float((T[:3, 3] - t64) @ back),
            d_t=float(np.linalg.norm(T[:3, 3] - t64)),
            d_R=float(np.abs(T[:3, :3] - T64[:3, :3]).max()),
            d_aff_a=float(aff[0] - aff64[0]),
            d_aff_b=float(aff[1] - aff64[1]),
            d_res0=float(np.asarray(res, np.float64)[0] - res64[0]),
            **{f"d_t{c}": float(dt[k]) for k, c in enumerate("xyz")},
            **{f"d_w{c}": float(dw[k]) for k, c in enumerate("xyz")})
        if terms:
            row[name].update(gs_rows[name])
    return row


GS_DIFFS = ("b_along", "b_tx", "b_ty", "b_tz", "E_rel")


def tracker_gs_vs_float64(args, T64, aff64, tcalib, tcfg) -> dict:
    """The level-0 warp and reduce (`_calc_res` and `_calc_gs`) of one
    track's inputs `args` at the float64 track's end (T64, aff64, rounded
    to float32): H, b and the energy in float64 (the JAX package's
    functions under x64 with float32 read as float64) and in float32 by
    the JAX package's (jitted) and the port's (`tracker_trip_ref`).
    Where the float32 LM stops, b is 0 in its arithmetic, so the pose
    moves from float64's by about -H^-1 (b32 - b64): per package that
    implied translation (scaled back) along the float64 track's t and
    per coordinate, and the energy's relative error."""
    from ldso_tpu.frontend import affine as jaff
    from ldso_tpu.frontend import tracker as jtr
    from ldso_tpu.frontend.tracker import TrackerRef
    from ldso_tpu.ops.preprocess import FramePyramid
    from ldso_tpu_torch.frontend import tracker as ttr
    ref, pyr, T0, aff0, exposure, no_abort, calib, cfg, coarsest = args
    T32 = np.asarray(T64, np.float32)
    a32 = np.asarray(aff64, np.float32)
    cut = np.float32(cfg.coarse_cutoff_th)

    @jax.jit
    def gs(ref, pyr, T, aff, expo):
        bufs, stats = jtr._calc_res(ref, pyr, 0, T, aff, expo, cut, calib,
                                    cfg, compute_flow=False)
        H, b, scale = jtr._calc_gs(bufs, 0, ref, aff, expo, calib)
        return H, b, scale, stats[0]
    Hj, bj, scale, Ej = gs(ref, pyr, jnp.asarray(T32), jnp.asarray(a32),
                           jnp.float32(exposure))
    st, Ht, bt = ttr.tracker_trip_ref(
        _ref_t(ref), _pyr_t(pyr), 0, torch.from_numpy(T32)[None],
        torch.from_numpy(a32)[None], _f32(exposure).reshape(()),
        torch.tensor([float(cut)]), tcalib, tcfg, False)
    with jax.enable_x64(True):
        jtr.jnp = jaff.jnp = _Float64(jnp)
        try:
            H64, b64, _, E64 = jax.jit(gs.__wrapped__)(
                TrackerRef(points=tuple(map(_f64, ref.points)),
                           valid=tuple(map(_f64, ref.valid)),
                           ref_exposure=_f64(ref.ref_exposure),
                           ref_aff=_f64(ref.ref_aff)),
                FramePyramid(dI=tuple(map(_f64, pyr.dI)),
                             abs_grad=tuple(map(_f64, pyr.abs_grad))),
                _f64(T32), _f64(a32), _f64(exposure))
        finally:
            jtr.jnp = jaff.jnp = jnp
        H64 = np.asarray(H64, np.float64)
        b64 = np.asarray(b64, np.float64)
        E64 = float(E64)
    t64 = np.asarray(T64, np.float64)[:3, 3]
    along = t64 / max(np.linalg.norm(t64), 1e-300)
    scale = np.asarray(scale, np.float64)
    row = {}
    for name, b, E in (("jax", bj, Ej), ("port", bt[0].numpy(), st[0, 0])):
        db = np.asarray(b, np.float64) - b64
        dxi = -np.linalg.solve(H64 + 1e-12 * np.eye(8), db) * scale
        row[name] = dict(b_along=float(dxi[:3] @ along),
                         b_tx=float(dxi[0]), b_ty=float(dxi[1]),
                         b_tz=float(dxi[2]),
                         E_rel=float((float(E) - E64) / abs(E64)))
    return row


def tracker_summary(rows) -> dict:
    """Per package, each of TRACK_DIFFS over the calls: its mean, how many
    calls had it positive and its mean |value|."""
    return {name: {k: dict(mean=float(np.mean([r[name][k] for r in rows])),
                           positive=int(sum(r[name][k] > 0 for r in rows)),
                           mean_abs=float(np.mean([abs(r[name][k])
                                                   for r in rows])))
                   for k in TRACK_DIFFS + GS_DIFFS if k in rows[0][name]}
            for name in ("jax", "port")}
