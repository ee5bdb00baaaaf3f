"""Multi-device scaling: batched sequence replay and point-sharded BA.

Counterpart of ldso_tpu/parallel/replay.py. The reference is one process
with a thread pool (SURVEY.md §2.3); the JAX package scales on two axes,
and so does the port, on `torch.distributed`:

  (a) sequence replay: S sequences tracked in lockstep. On one card that is
      a leading sequence axis (`make_batched_tracker`: the masked tracker
      under `torch.func.vmap`, one CUDA graph per (S, shape)); across
      processes each rank takes its slice of the sequences
      (`shard_sequences_global`, `shard_batch`) and needs no collective.
  (b) the point-sharded window Hessian (`make_sharded_build_system`): each
      rank accumulates and stitches the system of its shard of the point
      pool, then one collective reduces the stacked systems.

The JAX package's `Mesh` becomes a grid of ranks (`ReplayMesh`): rows are
hosts (the `seq` axis), columns the ranks of one host (the `dp` axis).

Reductions sum in rank order: the collective gathers every rank's
contribution and each rank adds them 0, 1, ..., R-1, so a repeated run
gives the same bits on any backend (`all_reduce_ordered`; NCCL's and
gloo's own all-reduce fix no summation order).

Multi-process use: every rank calls `initialize_multihost()` with
LDSO_TPU_COORDINATOR=host:port, LDSO_TPU_NUM_PROCESSES and
LDSO_TPU_PROCESS_ID set (NCCL on the card, gloo on the CPU).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ldso_tpu_torch.backend import ba
from ldso_tpu_torch.backend.window import Window
from ldso_tpu_torch.camera.calib import Calibration
from ldso_tpu_torch.config import Config
from ldso_tpu_torch.frontend import track_graph, tracker
from ldso_tpu_torch.frontend.tracker import TrackerRef
from ldso_tpu_torch.ops.preprocess import FramePyramid


# ---------------------------------------------------------------------------
# process group and the rank grid
# ---------------------------------------------------------------------------

def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> bool:
    """`torch.distributed.init_process_group` from LDSO_TPU_COORDINATOR
    ("host:port"), LDSO_TPU_NUM_PROCESSES and LDSO_TPU_PROCESS_ID when the
    arguments are omitted. The backend is NCCL when torch sees a card
    (each rank then takes card `rank % device_count`) and gloo otherwise.
    Returns True when the group is (or already was) initialized, False
    when no multi-process configuration is given."""
    if dist.is_initialized():
        return True
    coord = coordinator_address or os.environ.get("LDSO_TPU_COORDINATOR")
    if coord is None:
        return False
    nproc = num_processes if num_processes is not None else int(
        os.environ.get("LDSO_TPU_NUM_PROCESSES", "0"))
    pid = process_id if process_id is not None else int(
        os.environ.get("LDSO_TPU_PROCESS_ID", "0"))
    if nproc <= 1:
        return False
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(pid % torch.cuda.device_count())
    if "://" not in coord:
        coord = "tcp://" + coord
    dist.init_process_group(backend, init_method=coord, world_size=nproc,
                            rank=pid)
    return True


class ReplayMesh(NamedTuple):
    """A (hosts, ranks per host) grid of global ranks."""
    ranks: np.ndarray                  # (hosts, per_host) int
    axis_names: tuple = ("seq", "dp")

    @property
    def shape(self):
        return self.ranks.shape


def global_replay_mesh(seq_axis: str = "seq", dp_axis: str = "dp",
                       ranks_per_host: Optional[int] = None,
                       world_size: Optional[int] = None) -> ReplayMesh:
    """The (hosts, ranks per host) grid: `seq_axis` spans hosts (the replay
    batch needs no collective across them), `dp_axis` the ranks of one host
    (where the sharded BA's reduction runs). ranks_per_host defaults to the
    host's card count (one rank per card), capped at the world size; a
    single process is a (1, 1) grid."""
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    if ranks_per_host is None:
        ranks_per_host = min(world_size, max(torch.cuda.device_count(), 1))
    if world_size % ranks_per_host:
        raise ValueError(f"{world_size} ranks do not split into hosts of "
                         f"{ranks_per_host}")
    grid = np.arange(world_size).reshape(world_size // ranks_per_host,
                                         ranks_per_host)
    return ReplayMesh(grid, (seq_axis, dp_axis))


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return tree


def _cut(tree, k: int, n: int):
    def cut(x):
        if x.dim() == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"leading axis {x.shape[0]} does not split "
                             f"into {n} shards")
        sz = x.shape[0] // n
        return x[k * sz:(k + 1) * sz]
    return _tree_map(cut, tree)


def shard_sequences_global(tree, mesh: ReplayMesh, rank: Optional[int] = None):
    """This rank's slice of a leading sequence axis cut over BOTH axes of
    the grid (hosts x ranks): pure data parallelism, no collective."""
    rank = _rank() if rank is None else rank
    pos = int(np.flatnonzero(mesh.ranks.reshape(-1) == rank)[0])
    return _cut(tree, pos, mesh.ranks.size)


def shard_batch(tree, mesh: ReplayMesh, rank: Optional[int] = None):
    """This rank's slice of a leading batch axis cut over the `dp` axis
    (the ranks of one host) and replicated over hosts."""
    rank = _rank() if rank is None else rank
    col = int(np.nonzero(mesh.ranks == rank)[1][0])
    return _cut(tree, col, mesh.ranks.shape[1])


# ---------------------------------------------------------------------------
# (a) batched replay
# ---------------------------------------------------------------------------

def make_batched_tracker(calib: Calibration, cfg: Config, coarsest: int):
    """A function tracking S sequences in lockstep: refs (a TrackerRef whose
    tensors carry a leading S axis), pyrs (a FramePyramid of (S, H, W, 3)
    levels), T_init (S,4,4), aff (S,2), exposure (S,) and min_abort (S,L),
    all on one device. Returns (T (S,4,4), aff (S,2), ok (S,),
    last_residuals (S,L), flow (S,3)), each member the result of
    `tracker.track_frame` on its own sequence.

    It is the masked tracker (`tracker._track_batch`) under
    `torch.func.vmap`; on the card one CUDA graph per (S, shapes) replays
    it (frontend/track_graph.py), so nothing reads the host. Each trip is
    one launch of K3 for all S sequences: the vmap rule of the operator
    `ldso_tpu_torch::tracker_trip` (ops/cuda_kernels.py) hands the kernel
    the vmapped axis as its sequence axis."""

    def single(ref, pyr, T, aff, expo, min_abort):
        out = tracker._track_batch(ref, pyr, T[None], aff, expo, min_abort,
                                   calib, cfg, coarsest)
        return tuple(o[0] for o in out)

    batched = torch.func.vmap(single)

    def step(refs: TrackerRef, pyrs: FramePyramid, T_init, aff, exposure,
             min_abort):
        dev = refs.ref_aff.device
        args = tuple(x.to(device=dev, dtype=torch.float32)
                     for x in (T_init, aff, exposure, min_abort))
        pyrs = FramePyramid(dI=tuple(pyrs.dI), abs_grad=())
        if dev.type == "cpu":
            return batched(refs, pyrs, *args)
        L, P = len(refs.points), len(pyrs.dI)

        def program(*xs):
            r = TrackerRef(points=xs[:L], valid=xs[L:2 * L],
                           ref_exposure=xs[2 * L], ref_aff=xs[2 * L + 1])
            p = FramePyramid(dI=xs[2 * L + 2:2 * L + 2 + P], abs_grad=())
            return batched(r, p, *xs[2 * L + 2 + P:])

        inputs = (*refs.points, *refs.valid, refs.ref_exposure, refs.ref_aff,
                  *pyrs.dI, *args)
        return track_graph.replay(
            ("batched", calib, tracker.graph_key(cfg), coarsest, L, P),
            program, inputs)

    return step


# ---------------------------------------------------------------------------
# (b) point-sharded BA accumulation
# ---------------------------------------------------------------------------

def all_reduce_ordered(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of x over the ranks of `group` in rank order: one all-gather,
    then 0 + 1 + ... + (R-1) on every rank, so every rank and every repeat
    holds the same bits."""
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


_POINT_FIELDS = (
    "pt_valid", "pt_host", "pt_u", "pt_v", "pt_color", "pt_weights", "idepth",
    "idepth_zero", "idepth_backup", "pt_step", "pt_prior", "pt_energy_th",
    "pt_num_good_res", "pt_max_rel_baseline", "pt_idepth_hessian",
    "res_exist", "res_active", "res_linearized", "res_state", "res_energy",
    "res_new_state", "res_new_energy", "res_new_energy_wo", "res_toZero",
    "Jpdxi", "Jpdc", "Jpdd", "JIdx", "JabF", "resF", "center_proj")


def _shard_points(W: Window, n_shards: int, shard_idx: int) -> Window:
    """The shard_idx-th of n_shards equal slices of the point pool and its
    residual lattice. P must be divisible by n_shards."""
    P = W.P
    if P % n_shards:
        raise ValueError(f"P={P} does not split into {n_shards} shards")
    sz = P // n_shards
    lo = shard_idx * sz
    return W._replace(**{f: getattr(W, f)[lo:lo + sz] for f in _POINT_FIELDS})


def make_sharded_build_system(group=None):
    """Point-sharded window-Hessian accumulation over the ranks of `group`
    (the default group when None): each rank accumulates (modes 0 and 1),
    stitches and Schur-complements the system of its shard of the points,
    one ordered reduction sums the stacked [HA, HL, Hsc], [bA, bL, bsc] and
    nres, and the priors enter once after it. Every rank passes the same
    (replicated) window and gets
    (HA, bA, HL, bL, Hsc, bsc, nres) as `ba.build_system` does."""

    def build(W: Window):
        n_ranks = dist.get_world_size(group)
        Ws = _shard_points(W, n_ranks, dist.get_rank(group))
        pc = ba.make_precalc(Ws)
        accA, HddA, bdA, HcdA, nresA = ba._accumulate_top(Ws, pc, mode=0)
        accL, HddL, bdL, HcdL, _ = ba._accumulate_top(Ws, pc, mode=1)
        HA, bA = ba._stitch_top(accA, pc, Ws, use_prior=False)
        HL, bL = ba._stitch_top(accL, pc, Ws, use_prior=False)
        Hsc, bsc, _ = ba._accumulate_sc(Ws, pc, HddA + HddL, bdA + bdL,
                                        HcdA + HcdL, shift_prior=True)
        n = HA.shape[0]
        packed = torch.cat([torch.stack([HA, HL, Hsc]).reshape(-1),
                            torch.stack([bA, bL, bsc]).reshape(-1),
                            nresA.to(torch.float32).reshape(1)])
        packed = all_reduce_ordered(packed, group)
        Hs = packed[:3 * n * n].reshape(3, n, n)
        bs = packed[3 * n * n:3 * n * n + 3 * n].reshape(3, n)
        nres = packed[-1].round().to(torch.int64)
        HLp, bLp = ba._add_priors(Hs[1], bs[1], W, ba.make_precalc(W))
        return Hs[0], bs[0], HLp, bLp, Hs[2], bs[2], nres

    return build
