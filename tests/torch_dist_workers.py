"""Rank bodies for tests/test_torch_replay.py's multi-process checks.

Spawned by torch.multiprocessing, so this module imports torch and the port
only (no JAX): each rank joins a gloo group through
`replay.initialize_multihost` (the LDSO_TPU_* environment variables), runs
the sharded functions on the inputs the test saved, and saves what it got.
"""

import os

import numpy as np
import torch


def sharded_rank(rank: int, world: int, port: int, in_path: str,
                 out_dir: str):
    torch.set_num_threads(1)
    os.environ.update(LDSO_TPU_COORDINATOR=f"127.0.0.1:{port}",
                      LDSO_TPU_NUM_PROCESSES=str(world),
                      LDSO_TPU_PROCESS_ID=str(rank))
    import torch.distributed as dist
    from ldso_tpu_torch.loop import posegraph
    from ldso_tpu_torch.parallel import replay
    from ldso_tpu_torch.slam_map import FrameShell, GlobalMap

    assert replay.initialize_multihost()
    assert dist.get_backend() == "gloo"
    inp = torch.load(in_path, weights_only=False)
    out = {}
    out["build"] = replay.make_sharded_build_system()(inp["W"])
    out["pcg"] = posegraph.optimize_pose_graph_cg_sharded(
        *inp["graph"], iterations=15, cg_iters=150)

    # run_pose_graph picks the sharded solver for a graph above the dense
    # limit when the group divides its padded edge count
    calls = []
    sharded = posegraph.optimize_pose_graph_cg_sharded

    def spy(*a, **k):
        calls.append(1)
        return sharded(*a, **k)

    posegraph.optimize_pose_graph_cg_sharded = spy
    posegraph._DENSE_MAX_VERTICES = 8
    gm = GlobalMap()
    est, loop = inp["map"]
    for k, T in enumerate(est):
        gm.add_keyframe(FrameShell(id=k, kf_id=k, T_cw=np.array(T)))
    kfs = gm.get_all_kfs()
    for k in range(1, len(est)):
        kfs[k].add_pose_rel(k - 1, est[k] @ np.linalg.inv(est[k - 1]))
    kfs[0].add_pose_rel(len(est) - 1, loop, is_loop=True)
    posegraph.run_pose_graph(gm, iterations=10, device="cpu",
                             dtype=torch.float64)
    out["run_pose_graph"] = np.stack([kf.S_cw for kf in gm.get_all_kfs()])
    out["sharded_calls"] = len(calls)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
