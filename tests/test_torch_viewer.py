"""The live viewer and the offline plots: the port's LiveViewer against the
JAX package's on the same map, its PNG frame path, a short port run with a
viewer attached, and viz.py's two plots."""

import json
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from torch_port_utils import equal

from ldso_tpu import slam_map as jmap
from ldso_tpu.viz_live import LiveViewer as JViewer
from ldso_tpu_torch import slam_map as tmap
from ldso_tpu_torch.io.png import decode_png
from ldso_tpu_torch.viz_live import LiveViewer as TViewer


def _get(viewer, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}{path}",
                                timeout=30) as r:
        return r.read()


@pytest.fixture
def viewers():
    started = []

    def start(cls):
        v = cls(port=0).start()
        started.append(v)
        return v
    yield start
    for v in started:
        v.stop()


def _maps(rng, mod):
    """A GlobalMap of `mod` (either package's slam_map) with five keyframes,
    retired points, covisibility and one loop edge, from one seed."""
    gm = mod.GlobalMap()
    shells = []
    for k in range(5):
        T = np.eye(4)
        T[:3, 3] = rng.randn(3) * 0.1
        sh = mod.FrameShell(id=3 * k, timestamp=0.05 * k, kf_id=k, T_cw=T)
        sh.is_keyframe = True
        if k % 2:
            sh.S_cw = T * 1.01
        for u, v, d in rng.rand(7, 3):
            sh.map_points.append(mod.MapPointRecord(k, u - 0.5, v - 0.5,
                                                    0.2 + d))
        if k:
            sh.add_pose_rel(k - 1, np.eye(4), is_loop=(k == 4))
        gm.add_keyframe(sh)
        shells.append(sh)
    return gm, shells


def test_viewer_state_matches_jax(viewers):
    """Fed the same shells and map, both viewers serve the same /state
    JSON (the same Python code on the same numpy values)."""
    out = []
    for cls, mod in ((JViewer, jmap), (TViewer, tmap)):
        gm, shells = _maps(np.random.RandomState(3), mod)
        v = viewers(cls)
        for sh in shells:
            v.publish_cam_pose(sh)
        v.publish_keyframes(gm, shells[-3:])
        out.append(json.loads(_get(v, "/state")))
        assert b"<canvas" in _get(v, "/")
    assert out[0] == out[1]
    assert out[1]["n_kfs"] == 5 and out[1]["n_loops"] == 1
    assert len(out[1]["points"]) == 35 and len(out[1]["traj_odo"]) == 5


def test_viewer_frame_is_a_png(viewers):
    """/frame: 404 before a frame, then the latest frame as an 8-bit PNG
    (floats clipped to 0..255 as the JAX viewer does), encoded by io/png.py
    at the request; a tensor frame is kept as it is until then."""
    v = viewers(TViewer)
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(v, "/frame")
    assert e.value.code == 404
    img = (np.random.RandomState(0).rand(24, 32) * 300 - 20).astype(np.float32)
    v.publish_frame(img)
    img[:] = 0                       # the hook copied the array
    want = np.clip((np.random.RandomState(0).rand(24, 32) * 300 - 20)
                   .astype(np.float32), 0, 255).astype(np.uint8)
    equal(decode_png(_get(v, "/frame")), want)
    frame = torch.arange(48, dtype=torch.uint8).reshape(6, 8)
    v.publish_frame(frame)
    equal(decode_png(_get(v, "/frame")), frame.numpy())
    equal(decode_png(_get(v, "/frame")), frame.numpy())   # cached


def test_port_run_serves_the_viewer(viewers):
    """A short port run (192x144, CPU) with a viewer on port 0: /state
    follows the run's keyframes and last frame, /frame is that frame."""
    from ldso_tpu_torch.examples import time_modes
    from ldso_tpu_torch.system.full_system import FullSystem
    import dataclasses
    from ldso_tpu_torch.config import Config
    calib, poses, images = time_modes.bench_frames(14, 192, 144, "cpu")
    fs = FullSystem(calib, dataclasses.replace(Config(),
                                               enable_loop_closing=False),
                    device="cpu")
    v = viewers(TViewer)
    fs.set_viewer(v)
    for i, img in enumerate(images):
        fs.add_active_frame(img, i, 1.0, i * 0.05)
    state = json.loads(_get(v, "/state"))
    assert fs.global_map.num_frames() >= 3
    assert state["n_kfs"] == fs.global_map.num_frames()
    assert state["frame_id"] == len(images) - 1
    assert len(state["traj_opt"]) == state["n_kfs"]
    equal(decode_png(_get(v, "/frame")), images[-1])


def test_plots_write_pngs(tmp_path, monkeypatch):
    """plot_trajectory and plot_depth_map (the port's Window, tensors)
    write PNGs; without matplotlib they raise."""
    from ldso_tpu_torch import viz
    from ldso_tpu_torch.backend.window import empty_window
    from ldso_tpu_torch.config import Config
    gm, _ = _maps(np.random.RandomState(1), tmap)
    viz.plot_trajectory(gm, str(tmp_path / "traj.png"),
                        gt_poses_cw=[kf.T_cw for kf in gm.get_all_kfs()])
    W = empty_window(2, 64, [20.0, 20.0, 16.0, 12.0], Config(), "cpu")
    W = W._replace(pt_valid=torch.arange(64) < 10,
                   pt_u=torch.rand(64) * 30, pt_v=torch.rand(64) * 20,
                   idepth=torch.rand(64) + 0.1)
    viz.plot_depth_map(W, torch.rand(24, 32) * 255, 0,
                       str(tmp_path / "depth.png"))
    for name in ("traj.png", "depth.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        viz.plot_trajectory(gm, str(tmp_path / "x.png"))
