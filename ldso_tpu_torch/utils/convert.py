"""Carry state between the JAX package and the port.

The JAX package's state goes in as numpy arrays (`np.asarray` of each JAX
field) and comes out as the port's tensors on a given device, and back.
Covered: Window, TrackerRef, ImmaturePool / ImmatureArena, FramePyramid,
InitializerState, and for loop closing a Vocabulary, a GlobalMap with
its FrameShells (features, descriptors, pose_rel edges, S_cw) and the
LoopClosing with its database. Index fields the port uses to index tensors
(`pt_host`, the initializer's `neighbours` / `parent`) widen from int32 to
int64 on the way in and narrow back on the way out.

The JAX window keeps its level-0 image stack tap-packed, (F, H, W, 12) in
the `pack_taps` layout [img, right, down, down_right] of (I, dx, dy);
`window_images_to_torch` unpacks it to the port's (F, H, W, 3).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ldso_tpu_torch.backend.window import Window
from ldso_tpu_torch.frontend.immature import ImmatureArena, ImmaturePool
from ldso_tpu_torch.frontend.initializer import InitializerState, InitLevel
from ldso_tpu_torch.frontend.tracker import TrackerRef
from ldso_tpu_torch.loop.vocab import Vocabulary
from ldso_tpu_torch.ops.preprocess import FramePyramid
from ldso_tpu_torch.slam_map import FrameShell, GlobalMap, MapPointRecord

_WIDEN = {"pt_host", "neighbours", "parent"}


def _t(name, a, device):
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a)).to(device)
    if name in _WIDEN:
        t = t.to(torch.int64)
    return t


def _n(name, t):
    a = t.detach().cpu().numpy()
    if name in _WIDEN:
        a = a.astype(np.int32)
    return a


def _nt_to_torch(cls, nt, device):
    return cls(**{k: _t(k, getattr(nt, k), device) for k in cls._fields})


def _nt_to_numpy(nt):
    return {k: _n(k, getattr(nt, k)) for k in type(nt)._fields}


def window_to_torch(W, device="cpu") -> Window:
    return _nt_to_torch(Window, W, device)


def window_to_numpy(W: Window) -> dict:
    return _nt_to_numpy(W)


def window_images_to_torch(dIs, device="cpu") -> torch.Tensor:
    """(F, H, W, 12) tap-packed or (F, H, W, 3) plain -> (F, H, W, 3)."""
    a = np.asarray(dIs, np.float32)
    if a.shape[-1] == 12:
        a = a[..., 0:3]          # the first tap group is the image itself
    return torch.from_numpy(np.array(a)).to(device)


def tracker_ref_to_torch(ref, device="cpu") -> TrackerRef:
    return TrackerRef(
        points=tuple(_t("", p, device) for p in ref.points),
        valid=tuple(_t("", v, device) for v in ref.valid),
        ref_exposure=_t("", ref.ref_exposure, device),
        ref_aff=_t("", ref.ref_aff, device))


def tracker_ref_to_numpy(ref: TrackerRef) -> dict:
    return dict(points=[p.cpu().numpy() for p in ref.points],
                valid=[v.cpu().numpy() for v in ref.valid],
                ref_exposure=ref.ref_exposure.cpu().numpy(),
                ref_aff=ref.ref_aff.cpu().numpy())


def pool_to_torch(pool, device="cpu") -> ImmaturePool:
    return _nt_to_torch(ImmaturePool, pool, device)


def arena_to_torch(arena, device="cpu") -> ImmatureArena:
    return ImmatureArena(pool=pool_to_torch(arena.pool, device),
                         host=_t("host", arena.host, device))


def arena_to_numpy(arena: ImmatureArena) -> dict:
    d = _nt_to_numpy(arena.pool)
    d["host"] = arena.host.cpu().numpy()
    return d


def pyramid_to_torch(pyr, device="cpu") -> FramePyramid:
    return FramePyramid(dI=tuple(_t("", a, device) for a in pyr.dI),
                        abs_grad=tuple(_t("", a, device) for a in pyr.abs_grad))


def pyramid_to_numpy(pyr: FramePyramid) -> dict:
    return dict(dI=[a.cpu().numpy() for a in pyr.dI],
                abs_grad=[a.cpu().numpy() for a in pyr.abs_grad])


def init_state_to_torch(state, device="cpu") -> InitializerState:
    return InitializerState(
        levels=tuple(_nt_to_torch(InitLevel, L, device) for L in state.levels),
        T=np.asarray(state.T, np.float64).copy(),
        aff=np.asarray(state.aff, np.float64).copy(),
        snapped=bool(state.snapped), frame_id=int(state.frame_id),
        snapped_at=int(state.snapped_at))


def init_state_to_numpy(state: InitializerState) -> dict:
    return dict(levels=[_nt_to_numpy(L) for L in state.levels],
                T=state.T.copy(), aff=state.aff.copy(), snapped=state.snapped,
                frame_id=state.frame_id, snapped_at=state.snapped_at)


def vocabulary_to_torch(voc) -> Vocabulary:
    """A JAX-package Vocabulary (numpy tables) -> the port's."""
    return Vocabulary(voc.k, voc.L, np.array(voc.node_desc, np.uint32),
                      np.array(voc.children, np.int32),
                      np.array(voc.is_leaf, bool),
                      np.array(voc.word_id, np.int32),
                      np.array(voc.word_weight, np.float32))


def frame_shell_to_torch(sh) -> FrameShell:
    """A JAX-package FrameShell -> the port's (deep copies of every field;
    retired points become the port's MapPointRecord)."""
    kw = {f.name: copy.deepcopy(getattr(sh, f.name))
          for f in dataclasses.fields(FrameShell)}
    kw["map_points"] = [MapPointRecord(**dataclasses.asdict(p))
                        for p in sh.map_points]
    out = FrameShell(**kw)
    for k, v in vars(sh).items():       # runtime extras (e.g. dead counts)
        if k not in kw:
            setattr(out, k, copy.deepcopy(v))
    return out


def global_map_to_torch(gm) -> GlobalMap:
    """A JAX-package GlobalMap -> the port's, keyframe by keyframe."""
    out = GlobalMap()
    out.latest_optimized_kf_id = gm.latest_optimized_kf_id
    for k in sorted(gm.keyframes):
        out.keyframes[k] = frame_shell_to_torch(gm.keyframes[k])
    return out


def loop_closing_to_torch(lc, global_map: GlobalMap, cfg, device="cpu"):
    """A JAX-package LoopClosing -> the port's, on the port GlobalMap
    `global_map` (which must hold the carried shells of the JAX map: their
    features, descriptors, BoW vectors, pose_rel edges and S_cw come with
    them). Carries the vocabulary, the retrieval database (rebuilt by
    `_add_to_db` in the JAX `_db_order`, so the native index holds the same
    entries in the same order), the vocabulary's pending training
    corpus, `n_loops_closed`, `loop_pairs` and `need_pose_graph`.

    The JAX PRNG key cannot become a torch.Generator: the port's generator
    starts from cfg.seed, so later RANSAC hypotheses differ from the JAX
    package's unless a caller supplies the JAX draws."""
    from ldso_tpu_torch.loop.loopclosing import LoopClosing
    vocab = None if lc.vocab is None else vocabulary_to_torch(lc.vocab)
    out = LoopClosing(lc.calib, cfg, global_map, vocab=vocab, device=device)
    out._pending_train = [np.array(d) for d in lc._pending_train]
    for kf_id in lc._db_order:
        out._add_to_db(global_map.keyframes[kf_id])
    out.n_loops_closed = lc.n_loops_closed
    out.loop_pairs = [tuple(p) for p in lc.loop_pairs]
    out.need_pose_graph = lc.need_pose_graph
    return out


def full_system_to_torch(jfs, cfg, device="cpu"):
    """A JAX-package FullSystem between frames -> a port FullSystem in the
    same state, on `device`, under the port Config `cfg`: the energy
    functional (window, HM/bM, frame count, host mirrors), the frame shells
    (one port shell per JAX shell, so all_frames, the window, the global
    map and the tracking reference share them as in the JAX system), the
    window's pyramids and image stack, the tracking reference, the
    candidate arena, the pipelined chain and the last-pose state, the
    random generator and, with loop closing on, the LoopClosing
    (`loop_closing_to_torch`). Reads the JAX system's attributes only."""
    from ldso_tpu_torch.system.full_system import FullSystem, TrackChain
    if (jfs.loop_closing is not None) != bool(cfg.enable_loop_closing):
        raise ValueError("the port Config's enable_loop_closing must match "
                         "the JAX system's")
    tfs = FullSystem(jfs.calib, cfg, device=device)
    dev = tfs.device
    shells = {}

    def shell(sh):
        if sh is None:
            return None
        if id(sh) not in shells:
            shells[id(sh)] = frame_shell_to_torch(sh)
        return shells[id(sh)]

    def pyr(p):
        return None if p is None else pyramid_to_torch(p, dev)

    ef, jef = tfs.ef, jfs.ef
    ef.W = window_to_torch(jef.W, dev)
    ef.n_frames = jef.n_frames
    ef.HM, ef.bM = np.array(jef.HM), np.array(jef.bM)
    ef.res_in_a, ef.res_in_m = jef.res_in_a, jef.res_in_m
    ef.is_lost = jef.is_lost
    ef.pt_valid_np = np.array(jef.pt_valid_np)
    ef.pt_host_np = np.array(jef.pt_host_np, np.int64)

    tfs.all_frames[:] = [shell(s) for s in jfs.all_frames]
    tfs.window_frames[:] = [shell(s) for s in jfs.window_frames]
    tfs.window_pyrs = [pyr(p) for p in jfs.window_pyrs]
    tfs.marg_flags = list(jfs.marg_flags)
    tfs.imm_live = list(jfs.imm_live)
    tfs.imm_arena = arena_to_torch(jfs.imm_arena, dev)
    tfs.dIs = window_images_to_torch(jfs.dIs, dev)
    tfs.global_map = GlobalMap()
    tfs.global_map.latest_optimized_kf_id = jfs.global_map.latest_optimized_kf_id
    for k in sorted(jfs.global_map.keyframes):
        tfs.global_map.keyframes[k] = shell(jfs.global_map.keyframes[k])
    if jfs.loop_closing is not None:
        tfs.loop_closing = loop_closing_to_torch(
            jfs.loop_closing, tfs.global_map, cfg, dev)

    tfs.initialized = jfs.initialized
    tfs.is_lost = jfs.is_lost
    tfs.init_failed = jfs.init_failed
    tfs.init_state = (None if jfs.init_state is None
                      else init_state_to_torch(jfs.init_state, dev))
    tfs.first_pyr = pyr(jfs.first_pyr)
    tfs.first_shell = shell(jfs.first_shell)
    ref, ref_shell = jfs._tracker_ref_pair
    if ref is None:
        ref, ref_shell = jfs.tracker_ref, jfs.tracker_ref_shell
    tfs._tracker_ref_pair = (
        None if ref is None else tracker_ref_to_torch(ref, dev),
        shell(ref_shell), None)
    if jfs.track_chain is not None:
        tfs.track_chain = TrackChain(*[_t("", a, dev) for a in jfs.track_chain])
    tfs._traced_this_frame = bool(getattr(jfs, "_traced_this_frame", False))
    tfs._frame_pyr = pyr(jfs._frame_pyr)
    tfs.last_coarse_rmse = np.array(jfs.last_coarse_rmse, np.float64)
    tfs.first_coarse_rmse = jfs.first_coarse_rmse
    tfs.current_min_act_dist = jfs.current_min_act_dist
    tfs.rng.set_state(jfs.rng.get_state())
    tfs._n_retry_sweeps = getattr(jfs, "_n_retry_sweeps", 0)
    for k in ("_marg_priors", "_marg_deltas", "_last_flow", "_last_rmse"):
        v = getattr(jfs, k, None)
        setattr(tfs, k, copy.deepcopy(v) if v is None or np.isscalar(v)
                else np.array(v))
    if hasattr(jfs, "_last_track_ref"):
        tfs._last_track_ref = shell(jfs._last_track_ref)
    return tfs
