"""The port's host layer: import isolation, the jax-free host copies pinned
to their originals, and the synthetic renderer."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_utils import close, equal, npy

import ldso_tpu.config as jcfg
import ldso_tpu_torch.config as tcfg
from ldso_tpu.camera.calib import Calibration as JCalib
from ldso_tpu.math import lie_np as jlie_np
from ldso_tpu_torch.camera.calib import Calibration as TCalib
from ldso_tpu_torch.math import lie_np as tlie_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """The port and its main entry point load without jax or ldso_tpu."""
    code = ("import sys, ldso_tpu_torch, ldso_tpu_torch.system.full_system, "
            "ldso_tpu_torch.utils.convert, ldso_tpu_torch.ops.cuda_kernels, "
            "ldso_tpu_torch.loop.loopclosing, ldso_tpu_torch.native, "
            "ldso_tpu_torch.system.pipeline, ldso_tpu_torch.io.datasets, "
            "ldso_tpu_torch.io.png, ldso_tpu_torch.io.trajectory, "
            "ldso_tpu_torch.ops.perturb, ldso_tpu_torch.camera.undistort, "
            "ldso_tpu_torch.examples.run_common, "
            "ldso_tpu_torch.examples.run_dso_kitti, "
            "ldso_tpu_torch.examples.run_dso_tum_mono, "
            "ldso_tpu_torch.examples.run_dso_euroc, "
            "ldso_tpu_torch.examples.time_modes, "
            "ldso_tpu_torch.frontend.track_graph, ldso_tpu_torch.viz_live, "
            "ldso_tpu_torch.viz, ldso_tpu_torch.io.ldso_binary, "
            "ldso_tpu_torch.synthetic, ldso_tpu_torch.parallel.replay, "
            "ldso_tpu_torch.loop.posegraph, "
            "ldso_tpu_torch.backend.energy_functional; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'ldso_tpu' "
            "or m.startswith('ldso_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_the_card():
    """FullSystem, LoopClosing and run_pose_graph run on the CUDA card
    unless the caller passes device="cpu"; with no card the default
    raises instead of running on the CPU."""
    from ldso_tpu_torch.loop import posegraph
    from ldso_tpu_torch.loop.loopclosing import LoopClosing
    from ldso_tpu_torch.slam_map import GlobalMap
    from ldso_tpu_torch.synthetic import default_calib
    from ldso_tpu_torch.system.full_system import FullSystem
    calib, cfg = default_calib(64, 48), tcfg.Config()
    entry_points = (lambda: FullSystem(calib, cfg),
                    lambda: LoopClosing(calib, cfg, GlobalMap()),
                    lambda: posegraph.run_pose_graph(GlobalMap()))
    if torch.cuda.is_available():
        assert FullSystem(calib, cfg).ef.W.idepth.device.type == "cuda"
        assert LoopClosing(calib, cfg, GlobalMap()).device.type == "cuda"
    else:
        for make in entry_points:
            with pytest.raises(RuntimeError, match="no CUDA card"):
                make()
    assert FullSystem(calib, cfg, device="cpu").device.type == "cpu"


def test_cli_and_reader_default_to_the_card(tmp_path):
    """The CLI's build_system and the dataset reader run on the card
    unless given device="cpu"; with no card they raise."""
    from ldso_tpu_torch.examples import run_common
    from ldso_tpu_torch.io.datasets import ImageFolderReader
    from ldso_tpu_torch.io.png import write_png
    (tmp_path / "images").mkdir()
    write_png(str(tmp_path / "images" / "0.png"), np.zeros((48, 64), np.uint8))
    cam = tmp_path / "camera.txt"
    cam.write_text("0.5 0.6 0.5 0.5 0\n64 48\nnone\n64 48\n")
    opts = run_common.parse_args([f"files={tmp_path / 'images'}",
                                  f"calib={cam}", "loopclosing=0"])
    if torch.cuda.is_available():
        assert run_common.build_system(opts, "tum")[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            run_common.build_system(opts, "tum")
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ImageFolderReader(str(tmp_path / "images"), str(cam))
    fs, reader, _, _ = run_common.build_system(opts, "tum", device="cpu")
    assert fs.device.type == reader.device.type == "cpu"
    assert reader.get_image(0)[0].device.type == "cpu"


def test_stage_timer_counts_across_threads():
    """The pipelines time stages from two threads: no update is lost."""
    import threading
    from ldso_tpu_torch.utils.timing import StageTimer
    t = StageTimer()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(2000):
            with t.stage("s"):
                pass
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert t.count["s"] == 16 * 2000


def test_matmul_policy():
    import ldso_tpu_torch  # noqa: F401
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_config_copy_matches():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.Config)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.Config)}
    assert jf == tf
    for name in ("PYR_LEVELS", "PATTERN_NUM", "PATTERN_PADDING", "CPARS"):
        assert getattr(jcfg, name) == getattr(tcfg, name)
    for name in dir(jcfg):
        if name.startswith(("SCALE_", "SOLVER_")):
            assert getattr(jcfg, name) == getattr(tcfg, name), name
    equal(tcfg.PATTERN, jcfg.PATTERN)
    for idx in range(4):
        assert (dataclasses.asdict(jcfg.preset(idx))
                == dataclasses.asdict(tcfg.preset(idx)))
    c = tcfg.Config(point_selection=0)
    with pytest.raises(ValueError):
        c.validate()
    assert tcfg.Config().pyr_levels_used(640, 480) == \
        jcfg.Config().pyr_levels_used(640, 480)


@pytest.mark.parametrize("wh", [(640, 480), (256, 192), (61, 97), (752, 480)])
def test_calibration_pyramid_matches(wh):
    w, h = wh
    a = JCalib.create(w, h, 0.55 * w, 0.6 * w, (w - 1) / 2.0, (h - 1) / 2.1)
    b = TCalib.create(w, h, 0.55 * w, 0.6 * w, (w - 1) / 2.0, (h - 1) / 2.1)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for lvl in range(a.levels):
        equal(b.K(lvl), a.K(lvl))
        equal(b.Ki(lvl), a.Ki(lvl))
    c = np.array([300.0, 310.0, 150.0, 100.0])
    assert dataclasses.asdict(a.with_intrinsics(c)) == \
        dataclasses.asdict(b.with_intrinsics(c))


def test_lie_np_copy_matches():
    rng = np.random.RandomState(0)
    for scale in (1e-9, 1e-3, 0.5, 3.1):
        for _ in range(5):
            xi = rng.randn(6) * scale
            equal(tlie_np.se3_exp(xi), jlie_np.se3_exp(xi))
            T = jlie_np.se3_exp(xi)
            equal(tlie_np.se3_log(T), jlie_np.se3_log(T))
            q = rng.randn(4)
            equal(tlie_np.quat_to_rotmat(q), jlie_np.quat_to_rotmat(q))
            equal(tlie_np.rotmat_to_quat(T[:3, :3]),
                  jlie_np.rotmat_to_quat(T[:3, :3]))


def test_slam_map_copy_roundtrips_with_original(tmp_path):
    from ldso_tpu.slam_map import GlobalMap as JMap
    from ldso_tpu_torch.slam_map import FrameShell, GlobalMap, MapPointRecord
    gm = GlobalMap()
    for k in range(3):
        sh = FrameShell(id=10 * k, timestamp=0.5 * k, kf_id=k,
                        T_cw=np.eye(4) + 0.01 * k)
        sh.map_points.append(MapPointRecord(k, 0.1, -0.2, 0.5 + k))
        if k:
            sh.add_pose_rel(k - 1, np.eye(4) * 2.0)
        gm.add_keyframe(sh)
    p = str(tmp_path / "map.npz")
    gm.save(p)
    back = JMap.load(p)
    assert sorted(back.keyframes) == sorted(gm.keyframes)
    close(back.point_cloud(), gm.point_cloud(), 0, 0)
    assert back.keyframes[2].pose_rel.keys() == gm.keyframes[2].pose_rel.keys()


def test_stage_timer_matches_original():
    from ldso_tpu.utils.timing import StageTimer as JTimer
    from ldso_tpu_torch.utils.timing import StageTimer
    t, j = StageTimer(), JTimer()
    for timer in (t, j):
        with timer.stage("a"):
            pass
        with timer.stage("a"):
            pass
        timer.total["a"] = 1.5          # pin the report format, not the clock
        timer.total["b"] = 0.25
        timer.count["b"] = 3
    assert t.count == j.count
    assert t.summary() == j.summary()


@pytest.mark.parametrize("lvl", [0, 1])
def test_plane_scene_render_matches(lvl):
    """Port renderer vs the JAX renderer; float32 sin sums agree to
    ~1e-4 of the 0..255 range (summation order differs)."""
    from ldso_tpu.math import lie
    from ldso_tpu.synthetic import PlaneScene as JScene, default_calib as jdc
    from ldso_tpu_torch.synthetic import PlaneScene as TScene, default_calib
    calib = default_calib(160, 120)
    assert dataclasses.asdict(calib) == dataclasses.asdict(jdc(160, 120))
    T = np.linalg.inv(np.asarray(lie.se3_exp(jnp.asarray(
        np.array([0.1, -0.05, 0.2, 0.01, 0.02, -0.03])))))
    kw = dict(freq_hi=25.0, contrast=80.0)
    ij, dj = JScene(**kw).render(calib, jnp.asarray(T, jnp.float32), lvl=lvl,
                                 exposure=1.2, aff_a=0.1, aff_b=3.0)
    it, dt = TScene(**kw).render(calib, T, lvl=lvl, exposure=1.2, aff_a=0.1,
                                 aff_b=3.0)
    close(it, ij, rtol=0, atol=2e-3, what="image")
    close(dt, dj, rtol=1e-5, atol=1e-7, what="idepth")
    assert npy(it).dtype == np.float32


def test_qlz_copy_matches_original():
    """loop/qlz.py is a verbatim copy (it never imported jax)."""
    a = open(os.path.join(REPO, "ldso_tpu", "loop", "qlz.py"), "rb").read()
    b = open(os.path.join(REPO, "ldso_tpu_torch", "loop", "qlz.py"),
             "rb").read()
    assert a == b


def test_orb_pattern_copy_matches_original():
    from ldso_tpu.frontend import detector as jd
    from ldso_tpu_torch.frontend import detector as td
    equal(td._PATTERN, jd._PATTERN)
    equal(td.UMAX, jd.UMAX)


def _tree_state(path):
    return sorted((f, os.path.getmtime(os.path.join(path, f)),
                   os.path.getsize(os.path.join(path, f)))
                  for f in os.listdir(path))


def test_native_cpp_copy_matches_original():
    """csrc/native.cpp is a verbatim copy of the JAX package's (it never
    used jax)."""
    a = open(os.path.join(REPO, "ldso_tpu", "native", "native.cpp"),
             "rb").read()
    b = open(os.path.join(REPO, "ldso_tpu_torch", "csrc", "native.cpp"),
             "rb").read()
    assert a == b


def test_native_loader_builds_into_build_dir():
    """The port compiles its own copy, ldso_tpu_torch/csrc/native.cpp, into
    build/ldso_tpu_torch/native-<hash>/ and leaves its source directory
    and ldso_tpu/native/ as it found them; the library it loads is that
    build."""
    from ldso_tpu_torch import native
    src_dir = os.path.join(REPO, "ldso_tpu_torch", "csrc")
    jax_dir = os.path.join(REPO, "ldso_tpu", "native")
    before = _tree_state(src_dir), _tree_state(jax_dir)
    path = native.build()
    assert path == native.library_path()
    assert os.path.dirname(os.path.dirname(path)) == os.path.join(
        REPO, "build", "ldso_tpu_torch")
    assert os.path.basename(os.path.dirname(path)).startswith("native-")
    assert native.SOURCE == os.path.join(src_dir, "native.cpp")
    lib = native.get_lib()
    assert lib._name == path
    out = native.bow_transform(np.zeros((3, 8), np.uint32),
                               np.zeros((2, 8), np.uint32),
                               np.array([[1], [-1]], np.int32),
                               np.array([-1, 0], np.int32), 1, 1)
    equal(out, np.zeros(3, np.int32))
    assert (_tree_state(src_dir), _tree_state(jax_dir)) == before
    assert not any(f.endswith(".cpp") for f in os.listdir(
        os.path.join(REPO, "ldso_tpu_torch")))


def test_native_loader_raises_when_the_build_fails(tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises, and so does
    every entry point that needs the library."""
    from ldso_tpu_torch import native
    bad = tmp_path / "native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    with pytest.raises(RuntimeError):
        native.radius_nms(np.zeros(2, np.float32), np.zeros(2, np.float32),
                          np.ones(2, np.float32), 5.0)
    with pytest.raises(RuntimeError):
        native.NativeDatabase()


def _read(*parts):
    with open(os.path.join(REPO, *parts), encoding="utf-8") as f:
        return f.read()


def test_ldso_binary_copy_matches_original():
    """io/ldso_binary.py differs from the JAX package's only in the package
    name (it never imported jax)."""
    assert _read("ldso_tpu_torch", "io", "ldso_binary.py") == _read(
        "ldso_tpu", "io", "ldso_binary.py").replace(
        "from ldso_tpu.slam_map", "from ldso_tpu_torch.slam_map")


def test_viewer_copies_match_originals():
    """viz_live.LiveViewer and viz.py are the JAX package's code except
    where the port takes other inputs: the viewer's frame path (PNG by
    io/png.py, encoded when /frame asks, a card tensor kept with an event:
    __init__'s frame slot, start's /frame branch, publish_frame,
    _encoded_frame) and plot_depth_map (the port's Window of tensors)."""
    import inspect
    from ldso_tpu import viz as jviz, viz_live as jlive
    from ldso_tpu_torch import viz as tviz, viz_live as tlive
    for name in ("publish_cam_pose", "publish_keyframes", "stop", "port"):
        a = getattr(jlive.LiveViewer, name)
        b = getattr(tlive.LiveViewer, name)
        if isinstance(a, property):
            a, b = a.fget, b.fget
        assert inspect.getsource(a) == inspect.getsource(b), name
    assert tlive._PAGE == jlive._PAGE
    assert tlive._MAX_VIEW_POINTS == jlive._MAX_VIEW_POINTS
    assert inspect.getsource(tviz.plot_trajectory) == inspect.getsource(
        jviz.plot_trajectory)
