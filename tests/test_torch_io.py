"""The port's dataset path against the JAX package's: camera models and
undistortion, the PNG codec, the dataset readers, the benchmark
perturbations, trajectory I/O and the CLI runner."""

import dataclasses
import io
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_utils import close, equal, npy, t32

from ldso_tpu.camera import undistort as jund
from ldso_tpu.io import trajectory as jtraj
from ldso_tpu.math import lie
from ldso_tpu_torch.camera import undistort as tund
from ldso_tpu_torch.io import png
from ldso_tpu_torch.io import trajectory as ttraj

from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one parameter set per camera model (fx fy cx cy + distortion), relative
# like the datasets' camera.txt files
MODELS = {
    "pinhole": "Pinhole 0.55 0.73 0.5 0.5 0",
    "fov": "FOV 0.52 0.69 0.49 0.51 0.9",
    "radtan": "RadTan 0.55 0.73 0.5 0.5 -0.28 0.07 0.001 -0.0005",
    "equidistant": "EquiDistant 0.5 0.66 0.5 0.5 0.01 -0.005 0.001 0.0",
    "kannalabrandt": "KannalaBrandt 0.5 0.66 0.5 0.5 0.01 -0.005 0.001 0.0",
}


# ------------------------------------------------------------- host copies
def test_camera_copies_match_originals():
    """models.py is a verbatim copy; undistort.py differs only in the
    package name (neither module imports JAX)."""
    def read(*p):
        with open(os.path.join(REPO, *p)) as f:
            return f.read()
    assert read("ldso_tpu_torch", "camera", "models.py") == \
        read("ldso_tpu", "camera", "models.py")
    assert read("ldso_tpu_torch", "camera", "undistort.py") == read(
        "ldso_tpu", "camera", "undistort.py").replace("ldso_tpu.",
                                                      "ldso_tpu_torch.")


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("out_spec", ["crop", "0.5 0.6 0.5 0.5"])
def test_undistorter_remaps_equal(tmp_path, model, out_spec):
    """The rectification remap, K and the rectified calibration, exactly."""
    calib = tmp_path / "camera.txt"
    calib.write_text(f"{MODELS[model]}\n160 120\n{out_spec}\n128 96\n")
    a = jund.Undistorter.from_file(str(calib))
    b = tund.Undistorter.from_file(str(calib))
    assert a.model.value == b.model.value
    for f in ("pars", "K", "remap_x", "remap_y"):
        equal(getattr(b, f), getattr(a, f), f)
    assert (b.w, b.h, b.passthrough) == (a.w, a.h, a.passthrough)
    assert dataclasses.asdict(b.calibration()) == \
        dataclasses.asdict(a.calibration())
    assert (b.remap_x >= 0).mean() > 0.5


def test_photometric_calib_equal(tmp_path):
    g = tmp_path / "pcalib.txt"
    g.write_text(" ".join(f"{255.0 * (i / 255.0) ** 0.8:.6f}"
                          for i in range(256)) + "\n")
    vig = np.linspace(0.5, 1.0, 160 * 120).reshape(120, 160) * 255
    a = jund.PhotometricCalib.load(str(g), vig, 160, 120)
    b = tund.PhotometricCalib.load(str(g), vig, 160, 120)
    equal(b.G, a.G, "G")
    equal(b.vignette_inv, a.vignette_inv, "vignette")
    equal(b.inverse_response_B(), a.inverse_response_B(), "B")
    assert b.valid and a.valid
    bad = tund.PhotometricCalib.load(str(tmp_path / "missing.txt"), None,
                                     160, 120)
    assert not bad.valid


# -------------------------------------------------------------------- PNG
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_reader_matches_pil(dtype):
    """Files PIL writes (its adaptive filters, and optimized), and files the
    port writes with each of the five row filters, decode to the same
    array in both."""
    rng = np.random.RandomState(5)
    top = 255 if dtype == np.uint8 else 65535
    a = (rng.rand(61, 83) * top).astype(dtype)
    a[:20] = (np.arange(83)[None] * 3 + np.arange(20)[:, None]).astype(dtype)
    for opt in (False, True):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="PNG", optimize=opt)
        equal(png.decode_png(buf.getvalue()), a, f"PIL optimize={opt}")
    for f in range(5):
        data = png.encode_png(a, filter_type=f)
        pil = np.asarray(Image.open(io.BytesIO(data)))
        assert pil.dtype == a.dtype
        equal(pil, a, f"PIL reads filter {f}")
        got = png.decode_png(data)
        assert got.dtype == a.dtype
        equal(got, a, f"port reads filter {f}")


def test_png_reader_refuses_what_it_cannot_read():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(buf, format="PNG")
    with pytest.raises(ValueError, match="colour type 2"):
        png.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a")
    data = bytearray(png.encode_png(np.zeros((4, 5), np.uint8)))
    data[-20] ^= 1                              # corrupt a chunk
    with pytest.raises(ValueError):
        png.decode_png(bytes(data))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 5), np.float32))


# --------------------------------------------------------------- datasets
def _step_motion(i):
    """tests/test_io.py's motion: 5 cm and 1 cm a frame."""
    return [0.05 * i, 0.01 * i, 0.0, 0, 0, 0]


def _pipeline_motion(i):
    """tests/test_pipeline.py's motion: 3.5 cm a frame and a slow turn."""
    return [0.035 * i, 0.01 * np.sin(0.2 * i), 0.003 * i, 0.0, 0.0015 * i,
            0.0]


def _frames(n, w, h, motion=_step_motion):
    from ldso_tpu.synthetic import PlaneScene, default_calib
    calib = default_calib(w, h)
    scene = PlaneScene(freq_hi=25.0, contrast=80.0)
    poses, imgs = [], []
    for i in range(n):
        t = np.array(motion(i))
        T = np.linalg.inv(np.asarray(lie.se3_exp(jnp.asarray(t))))
        img, _ = scene.render(calib, jnp.asarray(T, jnp.float32))
        poses.append(T)
        imgs.append(np.clip(np.round(np.asarray(img)), 0, 255).astype(np.uint8))
    return poses, imgs


def _camera(path, w, h, line="0.55 0.73 0.497 0.496 0", out="none"):
    path.write_text(f"{line}\n{w} {h}\n{out}\n{w} {h}\n")
    return str(path)


def _layout(tmp_path, kind, imgs):
    """Write `imgs` in a dataset layout; returns (files=, dataset_type)."""
    if kind in ("tum", "tum_zip"):
        d = tmp_path / "seq" / "images"
        d.mkdir(parents=True)
        for i, im in enumerate(imgs):
            Image.fromarray(im).save(d / f"{i:05d}.png")
        (tmp_path / "seq" / "times.txt").write_text("".join(
            f"{i:05d} {i * 0.05:.6f} {0.02 + 0.001 * i:.6f}\n"
            for i in range(len(imgs))))
        if kind == "tum":
            return str(d), "tum"
        zpath = tmp_path / "seq" / "images.zip"
        with zipfile.ZipFile(zpath, "w") as z:
            for p in sorted(d.iterdir()):
                z.write(p, arcname=f"images/{p.name}")
        return str(zpath), "tum"
    if kind == "kitti":
        d = tmp_path / "00"
        (d / "image_0").mkdir(parents=True)
        for i, im in enumerate(imgs):
            png.write_png(str(d / "image_0" / f"{i:06d}.png"), im)
        (d / "times.txt").write_text("".join(f"{i * 0.1:.6f}\n"
                                             for i in range(len(imgs))))
        return str(d), "kitti"
    d = tmp_path / "mav0" / "cam0"
    (d / "data").mkdir(parents=True)
    rows = []
    for i, im in enumerate(imgs):
        name = f"{1403636579763555584 + i * 50000000}.png"
        png.write_png(str(d / "data" / name), im, filter_type=4)
        rows.append(f"{1403636579763555584 + i * 50000000},{name}")
    (d / "data.csv").write_text("#timestamp [ns],filename\n"
                                + "\n".join(rows) + "\n")
    return str(d), "euroc"


@pytest.mark.parametrize("kind", ["tum", "tum_zip", "kitti", "euroc"])
def test_reader_get_image_matches(tmp_path, kind):
    """get_image through the RadTan remap, a gamma response and a vignette
    (16-bit PNG): images within 1e-5 relative of JAX's (a float32 ulp at
    the 256 the vignette lifts them to is 3e-5; XLA contracts the remap's
    multiply-adds), same exposures and timestamps."""
    from ldso_tpu.io.datasets import ImageFolderReader as JReader
    from ldso_tpu_torch.io.datasets import ImageFolderReader as TReader
    w, h = 160, 120
    _, imgs = _frames(3, w, h)
    files, dtype = _layout(tmp_path, kind, imgs)
    cam = _camera(tmp_path / "camera.txt", w, h,
                  MODELS["radtan"].split(" ", 1)[1], "crop")
    gamma = tmp_path / "pcalib.txt"
    gamma.write_text(" ".join(f"{255.0 * (i / 255.0) ** 0.8:.6f}"
                              for i in range(256)) + "\n")
    yy, xx = np.mgrid[:h, :w]
    vig = (65535 * (1.0 - 0.4 * ((xx - w / 2) ** 2 + (yy - h / 2) ** 2)
                    / (w * w / 4 + h * h / 4))).astype(np.uint16)
    Image.fromarray(vig).save(tmp_path / "vignette.png")
    args = (files, cam, str(gamma), str(tmp_path / "vignette.png"))
    rj = JReader(*args, dataset_type=dtype)
    rt = TReader(*args, dataset_type=dtype, device="cpu")
    assert rt.files == rj.files and rt.num_images() == 3
    assert rt.timestamps == rj.timestamps
    assert rt.exposures == rj.exposures
    equal(rt.get_photometric_gamma(), rj.get_photometric_gamma())
    for i in range(3):
        ij, ej, sj = rj.get_image(i)
        it, et, st = rt.get_image(i)
        assert it.device.type == "cpu" and it.dtype == torch.float32
        close(it, ij, 1e-5, 1e-5, f"frame {i}")
        assert (et, st) == (ej, sj)
        equal(rt.get_raw(i), rj.get_raw(i))


def test_reader_jpeg_through_pil_or_raises(tmp_path, monkeypatch):
    from ldso_tpu.io.datasets import ImageFolderReader as JReader
    from ldso_tpu_torch.io.datasets import ImageFolderReader as TReader
    d = tmp_path / "images"
    d.mkdir()
    _, imgs = _frames(1, 64, 48)
    Image.fromarray(imgs[0]).save(d / "00000.jpg", quality=95)
    cam = _camera(tmp_path / "camera.txt", 64, 48)
    rt = TReader(str(d), cam, device="cpu")
    close(rt.get_image(0)[0], JReader(str(d), cam).get_image(0)[0], 0, 1e-5)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="JPEG needs PIL"):
        rt.get_image(0)


def test_reader_defaults_to_the_card(tmp_path):
    from ldso_tpu_torch.io.datasets import ImageFolderReader
    d = tmp_path / "images"
    d.mkdir()
    png.write_png(str(d / "0.png"), np.zeros((48, 64), np.uint8))
    cam = _camera(tmp_path / "camera.txt", 64, 48)
    if torch.cuda.is_available():
        assert ImageFolderReader(str(d), cam).get_image(0)[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ImageFolderReader(str(d), cam)


# ---------------------------------------------------------------- perturb
def _jax_fields(idx, grid_size=3):
    """The uniform grids jax.random draws inside ldso_tpu's perturb for
    the key PRNGKey(idx), in the port's PerturbFields order."""
    g = grid_size + 8
    k_warp, k_blur = jax.random.split(jax.random.PRNGKey(idx))
    out = []
    for k in (k_warp, k_blur):
        kx, ky = jax.random.split(k)
        out += [np.asarray(jax.random.uniform(kx, (g, g)), np.float32),
                np.asarray(jax.random.uniform(ky, (g, g)), np.float32)]
    return out


@pytest.mark.parametrize("noise,blur", [(2.0, 0.0), (0.0, 1.5), (1.0, 2.0)])
def test_perturb_matches_with_jax_fields(noise, blur):
    """The port's apply on JAX's draws. The blur agrees within 1e-4; the
    warp moves every pixel by interpolated offsets that XLA:CPU rounds
    with fused multiply-adds, one float32 ulp of a coordinate (7.6e-6 px
    at x = 95) against gradients up to ~40 per px: atol 1e-3 of the 0..255
    range."""
    from ldso_tpu.ops.perturb import benchmark_perturb as jbp
    from ldso_tpu_torch.ops.perturb import PerturbFields, benchmark_perturb
    _, imgs = _frames(1, 96, 72)
    img = imgs[0].astype(np.float32)
    want = jbp(jnp.asarray(img), jax.random.PRNGKey(4), noise, blur, 3)
    fields = PerturbFields(*(t32(f) for f in _jax_fields(4)))
    got = benchmark_perturb(t32(img), fields, noise, blur, 3)
    close(got, want, 0, 1e-3 if noise > 0 else 1e-4)
    assert np.abs(npy(got) - img).max() > 1.0      # it did perturb


def test_perturb_fields_seeded_per_frame():
    from ldso_tpu_torch.ops.perturb import perturb_fields
    a, b, c = (perturb_fields(i, 3, "cpu") for i in (7, 7, 8))
    for x, y in zip(a, b):
        equal(x, y)
    assert not torch.equal(a.warp_x, c.warp_x)
    assert all(f.shape == (11, 11) and 0 <= f.min() and f.max() < 1
               for f in a)


# ------------------------------------------------------------- trajectory
def _poses(n=6, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        T = np.array(lie.se3_exp(jnp.asarray(rng.randn(6) * 0.4)))
        T[:3, :3] *= 1.3                       # a Sim(3) scale to drop
        out.append(T)
    return out


def test_trajectory_writers_match(tmp_path):
    """KITTI and PLY files byte-equal; TUM rows the same stamps, positions
    and rotations (the quaternion's sign may differ), and read back by
    both readers alike."""
    poses = _poses()
    ts = [0.1 * i for i in range(len(poses))]
    for name, fn in (("kitti", lambda m, p: m.write_kitti(p, range(6), poses)),
                     ("ply", lambda m, p: m.save_ply(
                         p, np.random.RandomState(1).rand(9, 3),
                         (np.random.RandomState(2).rand(9, 3) * 255)))):
        fn(jtraj, str(tmp_path / f"j.{name}"))
        fn(ttraj, str(tmp_path / f"t.{name}"))
        assert (tmp_path / f"j.{name}").read_bytes() == \
            (tmp_path / f"t.{name}").read_bytes(), name
    jtraj.write_tum(str(tmp_path / "j.txt"), ts, poses)
    ttraj.write_tum(str(tmp_path / "t.txt"), ts, poses)
    for reader in (jtraj.read_tum, ttraj.read_tum):
        tj, pj = reader(str(tmp_path / "j.txt"))
        tt, pt = reader(str(tmp_path / "t.txt"))
        equal(tt, tj)
        close(pt, pj, 0, 1e-9)
    _, back = ttraj.read_tum(str(tmp_path / "t.txt"))
    for T, W in zip(poses, back):
        T_wc = np.linalg.inv(T)
        close(W[:3, 3], T_wc[:3, 3], 0, 1e-9)
        close(W[:3, :3] * np.cbrt(np.linalg.det(T_wc[:3, :3])), T_wc[:3, :3],
              0, 1e-9)


@pytest.mark.parametrize("with_scale", [True, False])
def test_alignment_and_ate_match(with_scale):
    est, gt = _poses(8, 3), _poses(8, 4)
    for T in est + gt:
        T[:3, :3] /= np.cbrt(np.linalg.det(T[:3, :3]))
    ec = np.stack([np.linalg.inv(T)[:3, 3] for T in est])
    gc = np.stack([np.linalg.inv(T)[:3, 3] for T in gt])
    for a, b in zip(ttraj.umeyama_alignment(ec, gc, with_scale),
                    jtraj.umeyama_alignment(ec, gc, with_scale)):
        close(a, b, 0, 1e-12)
    assert ttraj.ate_rmse(est, gt, with_scale) == \
        jtraj.ate_rmse(est, gt, with_scale)


# -------------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def kitti_seq(tmp_path_factory):
    """The 14-frame 192x120 KITTI layout of tests/test_io.py:131-167, on
    the motion of tests/test_pipeline.py. On test_io's 5 cm steps the
    pipelined modes of both packages lose the frames after the bootstrap:
    their chain restarts from the motion between the first frame and the
    bootstrap frame, eight frames apart, and the gate accepts the first
    result (no previous RMSE), so the JAX runner's lookahead and async
    keyframe ATEs there are 108 and 80 mm (ROADMAP §3)."""
    tmp = tmp_path_factory.mktemp("cli")
    poses, imgs = _frames(14, 192, 120, _pipeline_motion)
    files, _ = _layout(tmp, "kitti", imgs)
    cam = _camera(tmp / "camera.txt", 192, 120,
                  f"0.55 {0.55 * 192 / 120:.6f} {95.5 / 192:.6f} "
                  f"{59.5 / 120:.6f} 0")
    return tmp, files, cam, poses


def _kitti_rows(path):
    rows = [r.split() for r in open(path) if r.strip()]
    assert rows and all(len(r) == 13 for r in rows)
    return rows


@pytest.fixture(scope="module")
def jax_cli_rows(kitti_seq):
    """The JAX CLI's strict run (examples/run_common.py), in process."""
    tmp, files, cam, _ = kitti_seq
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import run_common as jrc
    finally:
        sys.path.remove(os.path.join(REPO, "examples"))
    out = str(tmp / "jax_results.txt")
    opts = jrc.parse_args([f"files={files}", f"calib={cam}", "preset=3",
                           "mode=1", "loopclosing=0", "quiet=1",
                           f"output={out}"])
    jrc.run(opts, dataset_type="kitti", kitti_output=True)
    return _kitti_rows(out)


@pytest.mark.parametrize("pipeline", ["strict", "lookahead", "async"])
def test_cli_modes_match_jax_strict(kitti_seq, jax_cli_rows, pipeline):
    """The port's runner in each mode writes results.txt and .noloop with
    orthonormal rotations and a keyframe ATE under 1 cm; the strict and
    lookahead runs have as many keyframe rows as the JAX runner's strict
    run. Async picks its keyframes by the mapping thread's timing, so it
    is held to the bootstrap pair and the ATE."""
    from ldso_tpu_torch.examples import run_common as trc
    tmp, files, cam, poses = kitti_seq
    out = str(tmp / f"port_{pipeline}.txt")
    opts = trc.parse_args([f"files={files}", f"calib={cam}", "preset=3",
                           "mode=1", "loopclosing=0", "quiet=1",
                           f"pipeline={pipeline}", f"output={out}"])
    fs = trc.run(opts, dataset_type="kitti", kitti_output=True, device="cpu")
    assert fs.device.type == "cpu" and not fs.is_lost
    rows = _kitti_rows(out)
    assert len(_kitti_rows(out + ".noloop")) == len(rows)
    if pipeline == "async":
        assert len(rows) >= 2
    else:
        assert len(rows) == len(jax_cli_rows) >= 3
    est, gt = [], []
    for r in rows:
        M = np.array([float(x) for x in r[1:]]).reshape(3, 4)
        close(M[:, :3] @ M[:, :3].T, np.eye(3), 0, 1e-4, "rotation")
        T_wc = np.eye(4)
        T_wc[:3] = M
        est.append(np.linalg.inv(T_wc))
        gt.append(poses[int(r[0])])
    assert ttraj.ate_rmse(est, gt) < 0.01
    assert os.path.exists(tmp / "pointcloud.ply")


def test_cli_refuses_the_viewer(kitti_seq):
    from ldso_tpu_torch.examples import run_common as trc
    _, files, cam, _ = kitti_seq
    opts = trc.parse_args([f"files={files}", f"calib={cam}", "nogui=0"])
    with pytest.raises(NotImplementedError, match="viewer not ported"):
        trc.build_system(opts, "kitti", device="cpu")
    with pytest.raises(ValueError, match="pipeline=fast"):
        trc.parse_args(["pipeline=fast"])


def test_cli_module_runs_on_the_card(kitti_seq):
    """`python -m ldso_tpu_torch.examples.run_dso_kitti` asks for the card:
    with none it fails, naming it, and never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go ahead on it")
    tmp, files, cam, _ = kitti_seq
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "ldso_tpu_torch.examples.run_dso_kitti",
         f"files={files}", f"calib={cam}", f"output={tmp / 'card.txt'}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA card" in out.stderr
    assert not os.path.exists(tmp / "card.txt")
