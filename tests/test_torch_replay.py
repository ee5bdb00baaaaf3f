"""parallel/replay and the edge-sharded pose graph against the JAX package.

The batched tracker runs S sequences in lockstep in one process. The
sharded build system and the sharded PCG run on `gloo` in 2 and 4 spawned
ranks (tests/torch_dist_workers.py, jax-free), each held against the
port's unsharded function and against the JAX package's sharded oracle on
the 8-device CPU mesh that tests/conftest.py sets up."""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from torch_port_utils import close, equal, npy

from test_backend import CFG, _build_ef
from test_torch_loop_math import _circle_system

from ldso_tpu.backend import ba as jba
from ldso_tpu.backend.energy_functional import _reset_oob
from ldso_tpu.loop import posegraph as jpg
from ldso_tpu.parallel import replay as jrep
from ldso_tpu_torch.backend import ba as tba
from ldso_tpu_torch.loop import posegraph as tpg
from ldso_tpu_torch.parallel import replay as trep
from ldso_tpu_torch.utils import convert


def _mesh(axis):
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:8])
    if devs.size < 8:
        pytest.skip("needs the 8-device CPU mesh")
    return Mesh(devs, (axis,))


def _scale(b):
    return max(float(np.abs(npy(b)).max()), 1.0)


# --------------------------------------------------------------- batched tracker

def test_batched_tracker_matches_jax():
    """S = 3 sequences (one reference, three motions) in lockstep: the
    port's vmapped masked tracker against JAX `make_batched_tracker` at
    the single-track tolerances of test_torch_tracker (T 1e-4, aff 1e-3,
    residuals and flow 1e-3 relative), and against the port's own single
    `track_frame` per sequence: T within 1e-5, residuals within 1e-4
    relative (the vmapped matmuls and reductions round differently)."""
    from ldso_tpu.config import Config as JC
    from ldso_tpu.frontend import tracker as jtr
    from ldso_tpu.math import lie
    from ldso_tpu.ops.preprocess import make_pyramid as jmp
    from ldso_tpu.synthetic import PlaneScene, default_calib
    from ldso_tpu_torch.config import Config as TC
    from ldso_tpu_torch.frontend import tracker as ttr
    S = 3
    calib = default_calib(160, 120)
    scene = PlaneScene(freq_hi=18.0, contrast=80.0)
    coarsest = calib.levels - 1
    img0, idep0 = scene.render(calib, jnp.eye(4, dtype=jnp.float32))
    ref = jtr.make_tracker_ref_from_idepth(
        idep0, jmp(img0, calib.levels), calib,
        JC().tracker_caps[:calib.levels], stride=2)
    pyrs = []
    for b in range(S):
        xi = np.array([0.02 + 0.002 * b, 0.004 * b, 0, 0, 0.002 * b, 0])
        T = np.asarray(lie.se3_exp(jnp.asarray(xi)), np.float32)
        pyrs.append(jmp(scene.render(calib, jnp.asarray(T))[0], calib.levels))
    refs = jax.tree_util.tree_map(lambda x: jnp.stack([x] * S), ref)
    pyr_b = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *pyrs)
    T0 = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    aff0 = np.zeros((S, 2), np.float32)
    expo = np.ones(S, np.float32)
    noab = np.full((S, calib.levels), 1e9, np.float32)
    oj = jrep.make_batched_tracker(calib, JC(), coarsest)(
        refs, pyr_b, *map(jnp.asarray, (T0, aff0, expo, noab)))

    refs_t = convert.tracker_ref_to_torch(refs)
    pyr_t = convert.pyramid_to_torch(pyr_b)
    ot = trep.make_batched_tracker(calib, TC(), coarsest)(
        refs_t, pyr_t, *map(torch.from_numpy, (T0, aff0, expo, noab)))
    close(ot[0], oj[0], 0, 1e-4, "T")
    close(ot[1], oj[1], 0, 1e-3, "aff")
    equal(ot[2], oj[2], "ok")
    close(ot[3], oj[3], 1e-3, 1e-4, "residuals")
    close(ot[4], oj[4], 1e-3, 1e-4, "flow")
    assert bool(npy(ot[2]).all())

    ref_t = convert.tracker_ref_to_torch(ref)
    for b in range(S):
        single = ttr.track_frame(ref_t, convert.pyramid_to_torch(pyrs[b]),
                                 torch.eye(4), torch.zeros(2),
                                 torch.tensor(1.0), torch.from_numpy(noab[0]),
                                 calib, TC(), coarsest)
        close(ot[0][b], single[0], 0, 1e-5, f"T vs single {b}")
        close(ot[3][b], single[3], 1e-4, 1e-6, f"residuals vs single {b}")


# ------------------------------------------------------------------ rank grid

def test_rank_grid_and_shards(monkeypatch):
    """The (hosts, ranks per host) grid, and the two cuts of a leading
    axis: over both axes (sequences) and over `dp` only (batches)."""
    for k in ("LDSO_TPU_COORDINATOR",):
        monkeypatch.delenv(k, raising=False)
    assert trep.initialize_multihost() is False
    one = trep.global_replay_mesh()
    assert one.shape == (1, 1) and one.axis_names == ("seq", "dp")
    mesh = trep.global_replay_mesh(ranks_per_host=4, world_size=8)
    assert mesh.shape == (2, 4)
    x = torch.arange(16 * 3).reshape(16, 3)
    tree = (x, {"not a tensor": 1}, [x[:8]])
    got = trep.shard_sequences_global(tree, mesh, rank=6)
    equal(got[0], x[12:14])
    equal(got[2][0], x[6:7])
    equal(trep.shard_batch(x, mesh, rank=6), x[8:12])
    equal(trep.shard_batch(x, mesh, rank=2), x[8:12])
    with pytest.raises(ValueError):
        trep.global_replay_mesh(ranks_per_host=3, world_size=8)


# ------------------------------------------------------ sharded, multi-process

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """One linearized window (test_replay's), the padded circle graph of
    test_torch_loop_math, and a drifted map for run_pose_graph."""
    ef, dIs, poses, idep0, calib, (w, h) = _build_ef(
        pose_noise=2e-3, idepth_noise=0.05, n_pts=64)
    W = _reset_oob(ef.W)
    W, _ = jba.linearize_all(W, dIs, CFG, w, h)
    W = jba.apply_res(W)
    gt, est, (S, fixed, ei, ej, Z, info, valid) = _circle_system()
    E = ei.shape[0]
    Eb = ((E + 7) // 8) * 8                 # padded to the 8-device mesh
    pad = Eb - E
    n = S.shape[0]
    graph = (S, fixed, np.r_[ei, np.full(pad, n - 1, np.int32)],
             np.r_[ej, np.full(pad, n - 1, np.int32)],
             np.concatenate([Z, np.tile(np.eye(4), (pad, 1, 1))]),
             np.concatenate([info, np.tile(np.eye(7), (pad, 1, 1))]),
             np.r_[valid, np.zeros(pad, bool)])
    gt2, est2, _ = _circle_system(n=20, sigma=0.004)
    d = tmp_path_factory.mktemp("replay")
    path = str(d / "in.pt")
    torch.save(dict(W=convert.window_to_torch(W),
                    graph=tuple(torch.from_numpy(np.array(a)) for a in graph),
                    map=(np.stack(est2), gt2[0] @ np.linalg.inv(gt2[-1]))),
               path)
    return dict(W=W, graph=graph, map=(est2, gt2), path=path, dir=d, runs={})


def _ranks(inputs, world):
    """Spawn `world` gloo ranks once per world size; their saved outputs."""
    if world not in inputs["runs"]:
        from torch_dist_workers import sharded_rank
        out = inputs["dir"] / f"w{world}"
        out.mkdir()
        mp.spawn(sharded_rank, args=(world, _free_port(), inputs["path"],
                                     str(out)), nprocs=world, join=True)
        inputs["runs"][world] = [torch.load(out / f"rank{r}.pt",
                                            weights_only=False)
                                 for r in range(world)]
    return inputs["runs"][world]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_build_system(inputs, world):
    """Every rank holds the same bits (rank-order reduction). Against the
    port's unsharded build_system within 1e-5 of each block's scale (the
    shard sums regroup float32 terms), and against the JAX package's
    8-device psum within 2e-4 of the scale, test_replay's bound; nres
    exact."""
    runs = _ranks(inputs, world)
    for r in runs[1:]:
        for a, b in zip(r["build"], runs[0]["build"]):
            equal(a, b, "ranks disagree")
    got = runs[0]["build"]
    full = tba.build_system(convert.window_to_torch(inputs["W"]))
    ref = (full[0], full[1], full[2], full[3], full[4], full[5], full[8])
    jref = jrep.make_sharded_build_system(_mesh("dp"))(inputs["W"])
    names = ("HA", "bA", "HL", "bL", "Hsc", "bsc")
    for k, name in enumerate(names):
        close(got[k], ref[k], 0, 1e-5 * _scale(ref[k]), name + " vs unsharded")
        close(got[k], jref[k], 0, 2e-4 * _scale(jref[k]), name + " vs JAX")
    assert int(got[6]) == int(ref[6]) == int(np.asarray(jref[6]))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_pcg(inputs, world):
    """The edge-sharded PCG in float64: every rank the same bits; against
    the port's single-process PCG and the JAX package's mesh-sharded PCG
    within 1e-8 on every vertex (the solvers' parity tolerance); and
    run_pose_graph takes the sharded solver under the group, landing
    within 1e-8 of the single-process run."""
    runs = _ranks(inputs, world)
    for r in runs[1:]:
        equal(r["pcg"], runs[0]["pcg"], "ranks disagree")
        equal(r["run_pose_graph"], runs[0]["run_pose_graph"])
    g = inputs["graph"]
    single = tpg.optimize_pose_graph_cg(*map(torch.from_numpy, g),
                                        iterations=15, cg_iters=150)
    jsh = jpg.optimize_pose_graph_cg_sharded(
        *map(jnp.asarray, g), _mesh("e"), iterations=15, cg_iters=150)
    close(runs[0]["pcg"], single, 0, 1e-8, "vs single-process PCG")
    close(runs[0]["pcg"], jsh, 0, 1e-8, "vs JAX sharded PCG")
    assert all(r["sharded_calls"] == 1 for r in runs)


def test_run_pose_graph_single_process_reference(inputs, monkeypatch):
    """The run_pose_graph result the sharded ranks are held to: the same
    drifted map through the single-process PCG (no process group), which
    the ranks match within 1e-8."""
    from ldso_tpu_torch.slam_map import FrameShell, GlobalMap
    monkeypatch.setattr(tpg, "_DENSE_MAX_VERTICES", 8)
    est, gt = inputs["map"]
    gm = GlobalMap()
    for k, T in enumerate(est):
        gm.add_keyframe(FrameShell(id=k, kf_id=k, T_cw=np.array(T)))
    kfs = gm.get_all_kfs()
    for k in range(1, len(est)):
        kfs[k].add_pose_rel(k - 1, est[k] @ np.linalg.inv(est[k - 1]))
    kfs[0].add_pose_rel(len(est) - 1, gt[0] @ np.linalg.inv(gt[-1]),
                        is_loop=True)
    tpg.run_pose_graph(gm, iterations=10, device="cpu", dtype=torch.float64)
    S = np.stack([kf.S_cw for kf in gm.get_all_kfs()])
    for world in (2, 4):
        close(_ranks(inputs, world)[0]["run_pose_graph"], S, 0, 1e-8,
              f"run_pose_graph, {world} ranks")
