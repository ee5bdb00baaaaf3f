"""The port's benchmark (ldso_tpu_torch/examples/bench.py) on the
CPU: its trajectory and ATE against bench.py's own expressions, a whole
run at 192x144 with every count cut to a few frames, the schedule of
frames it feeds against a transcript of bench.py's, and its failures,
which print the line with `error` and exit with 1."""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_utils  # noqa: F401 -- one torch thread per worker

from ldso_tpu.math import lie
from ldso_tpu_torch.examples import bench, time_modes
from ldso_tpu_torch.math import lie_np
from ldso_tpu_torch.system.full_system import FullSystem
from ldso_tpu_torch.system.pipeline import AsyncPipeline, DeterministicPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every count cut to a few frames: the initializer finishes on frame 8
COUNTS = dict(warm=9, sync_warm=1, window=1, pipe_warm=1, pipe_window=1,
              seqs=2, unique_seqs=1, seq_warm=9, seq_window=1, batch=2,
              steps=1, ba_batch=2)
ARGV = ["--device", "cpu", "--width", "192", "--height", "144"] + [
    a for k, v in COUNTS.items() for a in (f"--{k.replace('_', '-')}",
                                            str(v))]


def bench_py_pose(i, sidx=None):
    """bench.py:136-140 (sidx None) and :512-514, through the JAX
    package's se3_exp."""
    if sidx is None:
        t = np.array([0.03 * i, 0.01 * np.sin(0.2 * i), 0.004 * i])
        w = np.array([0.0, 0.0018 * i, 0.0004 * i])
    else:
        t = np.array([0.03 * i, 0.01 * np.sin(0.2 * i + sidx), 0.004 * i])
        w = np.array([0.0, 0.0018 * i, 0.0004 * i + 0.0002 * sidx])
    T_wc = np.asarray(lie.se3_exp(jnp.asarray(np.concatenate([t, w]))))
    return np.linalg.inv(T_wc)


def bench_py_ate(all_frames, poses, N_sync):
    """bench.py:250-262 as written."""
    est_ids = [f.id for f in all_frames
               if f.pose_valid and f.id < N_sync]
    est = [f.T_cw.copy() for f in all_frames
           if f.pose_valid and f.id < N_sync]
    gt = [poses[i] for i in est_ids]
    est_c = np.stack([np.linalg.inv(T)[:3, 3] for T in est])
    gt_c = np.stack([np.linalg.inv(T)[:3, 3] for T in gt])
    ec = est_c - est_c.mean(0)
    gc = gt_c - gt_c.mean(0)
    s = np.sqrt((gc ** 2).sum() / max((ec ** 2).sum(), 1e-12))
    U, _, Vt = np.linalg.svd(ec.T @ gc)
    R = (U @ Vt).T
    return float(np.sqrt(np.mean(np.sum((gc - s * (ec @ R.T)) ** 2, 1))))


def bench_py_schedule(n_warm, n_sync_warm, n_meas, n_pipe_warm, n_pw):
    """The calls bench.py:148-243 makes on its one FullSystem, with the
    strict leg of the port's bench (three windows of n_meas // 3 frames)
    between its sync and piped legs: (receiver, frame id), (receiver, "end")
    for a window's drain, (receiver, "new") for a pipeline built; the
    receiver is the FullSystem or the pipeline class fed."""
    ev = [("FullSystem", i) for i in range(n_warm)]
    ev += [("DeterministicPipeline", i)
           for i in range(n_warm, n_warm + n_sync_warm)]
    ev += [("DeterministicPipeline", "end")]
    sync_base = n_warm + n_sync_warm
    w = n_meas // 3
    for k in range(3):
        lo, hi = sync_base + k * w, sync_base + (k + 1) * w
        ev += [("DeterministicPipeline", i) for i in range(lo, hi)]
        ev += [("DeterministicPipeline", "end")]
    N = sync_base + n_meas
    for k in range(3):
        ev += [("FullSystem", i) for i in range(N + k * w, N + (k + 1) * w)]
        ev += [("FullSystem", "end")]
    N += n_meas
    ev += [("AsyncPipeline", "new")]
    ev += [("AsyncPipeline", i) for i in range(N, N + n_pipe_warm)]
    ev += [("AsyncPipeline", "end")]
    N += n_pipe_warm
    for wk in range(3):
        ev += [("AsyncPipeline", "new")]
        ev += [("AsyncPipeline", i)
               for i in range(N + wk * n_pw, N + (wk + 1) * n_pw)]
        ev += [("AsyncPipeline", "end")]
    return ev


def bench_py_sequence_schedule(n_warm, n_meas):
    """bench.py:524-571's calls on one of its S systems."""
    ev = [("FullSystem", i) for i in range(n_warm)]
    w = n_meas // 3
    for wk in range(3):
        lo, hi = n_warm + wk * w, n_warm + (wk + 1) * w
        ev += [("AsyncPipeline", "new")]
        ev += [("AsyncPipeline", i) for i in range(lo, hi)]
        ev += [("AsyncPipeline", "end")]
    return ev


@contextlib.contextmanager
def recorded(mp):
    """Record (system, receiver, frame id / "new" / "end") for every frame
    fed, pipeline built and window ended, and the FullSystems built."""
    events, systems = [], []

    def wrap(cls, name, what):
        fn = getattr(cls, name)

        def recording(self, *a, **k):
            fs = getattr(self, "fs", self)
            if name == "__init__":
                out = fn(self, *a, **k)
                if cls is FullSystem:
                    systems.append(self)
                else:
                    events.append((self.fs, cls.__name__, "new"))
                return out
            events.append((fs, cls.__name__, what(a)))
            return fn(self, *a, **k)
        mp.setattr(cls, name, recording)
    for cls in (FullSystem, DeterministicPipeline, AsyncPipeline):
        wrap(cls, "add_active_frame", lambda a: a[1])
    wrap(FullSystem, "__init__", None)
    wrap(AsyncPipeline, "__init__", None)
    end = bench._end_window

    def ended(target, dev):
        events.append((getattr(target, "fs", target), type(target).__name__,
                       "end"))
        return end(target, dev)
    mp.setattr(bench, "_end_window", ended)
    yield events, systems


def run_main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv)
    lines = out.getvalue().splitlines()
    return rc, lines, json.loads(lines[-1])


@pytest.fixture(scope="module")
def whole_run():
    with pytest.MonkeyPatch.context() as mp, recorded(mp) as (events,
                                                              systems):
        rc, lines, result = run_main(ARGV)
    return rc, lines, result, events, systems


def test_poses_are_bench_py_s():
    """The bench trajectory and its aggregate sequences equal bench.py's
    expressions through the JAX package's se3_exp."""
    for i in range(0, 320, 17):
        np.testing.assert_allclose(time_modes.bench_pose(i),
                                   bench_py_pose(i), rtol=0, atol=1e-6)
    for sidx in range(8):
        for i in (0, 13, 39):
            np.testing.assert_allclose(time_modes.bench_pose(i, sidx),
                                       bench_py_pose(i, sidx), rtol=0,
                                       atol=1e-6)


class _Frame:
    def __init__(self, i, T, valid):
        self.id, self.T_cw, self.pose_valid = i, T, valid


def _random_poses(rng, n):
    return [lie_np.se3_exp(rng.normal(0, 0.3, 6)) for _ in range(n)]


def test_ate_is_bench_py_s():
    """bench_ate over a system's frames equals bench.py's ATE, frames with
    no valid pose and frames after N_sync left out."""
    rng = np.random.RandomState(3)
    for trial in range(5):
        n = 30
        gt = _random_poses(rng, n)
        frames = [_Frame(i, T, bool(rng.rand() > 0.2))
                  for i, T in enumerate(_random_poses(rng, n))]
        N_sync = 25
        est = [f for f in frames if f.pose_valid and f.id < N_sync]
        got = bench.bench_ate([f.T_cw for f in est], [gt[f.id] for f in est])
        want = bench_py_ate(frames, gt, N_sync)
        assert got > 0.1
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_ate_of_a_noise_free_similarity_is_zero():
    rng = np.random.RandomState(4)
    est = _random_poses(rng, 20)
    R = lie_np.se3_exp(np.r_[0.0, 0.0, 0.0, rng.normal(0, 1, 3)])[:3, :3]
    s, t = 2.5, rng.normal(0, 1, 3)
    gt = []
    for T_cw in est:
        T_wc = np.linalg.inv(T_cw)
        G = np.eye(4)
        G[:3, :3] = R @ T_wc[:3, :3]
        G[:3, 3] = s * R @ T_wc[:3, 3] + t
        gt.append(np.linalg.inv(G))
    assert bench.bench_ate(est, gt) < 1e-9


def test_whole_run_prints_every_key_last(whole_run):
    """At 192x144 on the CPU: exit code 0, one JSON line and it is the
    last, with every key of bench.py's line and the port's."""
    rc, lines, result, _, _ = whole_run
    assert rc == 0, result.get("error")
    assert len(lines) == 1
    keys = {"metric", "value", "unit", "vs_baseline", "sync_fps_windows",
            "sync_fps", "frames_measured", "strict_fps_windows",
            "strict_fps", "piped_fps_windows", "piped_keyframes_windows",
            "ate_m_sim_aligned", "util", "aggregate_vo_fps_2seq",
            "aggregate", "batched_tracking_fps_2seq", "batched_ba_2seq",
            "launches", "graphs", "leg_s", "peak_memory_gb", "device"}
    assert keys <= set(result), keys - set(result)
    assert "error" not in result
    assert result["unit"] == "fps" and result["value"] > 0
    assert result["vs_baseline"] == result["value"] / bench.BASELINE_FPS
    assert result["ate_m_sim_aligned"] < bench.ATE_BOUND_M
    assert result["frames_measured"] == 3 * COUNTS["window"]
    assert result["device"]["type"] == "cpu"
    legs = ["warmup", "lookahead", "strict", "async", "ate", "util",
            "aggregate_2seq", "batched_tracking", "batched_ba"]
    for key in ("launches", "graphs", "leg_s", "peak_memory_gb",
                "activations"):
        assert list(result[key]) == legs
    assert set(result["batched_ba_2seq"]) == {
        "S", "trips", "ms", "ms_per_seq_kf", "agg_kf_per_sec"}


def test_each_leg_has_three_windows(whole_run):
    result = whole_run[2]
    for key in ("sync_fps_windows", "strict_fps_windows",
                "piped_fps_windows", "piped_keyframes_windows"):
        assert len(result[key]) == 3, key
    agg = result["aggregate"]["2seq"]
    assert agg["S"] == 2 and agg["unique_seqs"] == 1 and agg["warm_s"] > 0
    assert len(agg["fps_windows"]) == 3
    assert result["aggregate_vo_fps_2seq"] == np.median(agg["fps_windows"])
    assert result["value"] == np.median(result["piped_fps_windows"])
    assert all(x > 0 for x in result["sync_fps_windows"]
               + result["strict_fps_windows"] + result["piped_fps_windows"]
               + agg["fps_windows"])


def test_device_times_are_null_on_the_cpu(whole_run):
    """A host time is never written under a device metric's name."""
    result = whole_run[2]
    util = result["util"]
    assert {"frame_step(track)", "ba_lm", "batched_track(2 seq)"} <= set(util)
    assert any(k.startswith("trace(") for k in util)
    assert any(k.startswith("activate(") for k in util)
    for name, rec in util.items():
        assert rec["ms"] is None and rec["hbm_pct_min"] is None, name
        assert rec["io_gb"] > 0, name
    ba = result["batched_ba_2seq"]
    assert ba["S"] == 2 and ba["ms"] is None
    assert ba["ms_per_seq_kf"] is None and ba["agg_kf_per_sec"] is None
    assert set(result["peak_memory_gb"].values()) == {None}


def test_schedule_is_bench_py_s(whole_run):
    """Every FullSystem and pipeline is fed the frame ids of bench.py's
    schedule, in its order, with its windows' ends and its pipelines built
    where bench.py builds them; each aggregate system likewise, every
    window's pipelines built before any of its frames."""
    _, _, _, events, systems = whole_run
    c = COUNTS
    assert len(systems) == 1 + c["seqs"]

    def of(fs):
        return [(kind, x) for s, kind, x in events if s is fs]
    assert of(systems[0]) == bench_py_schedule(
        c["warm"], c["sync_warm"], 3 * c["window"], c["pipe_warm"],
        c["pipe_window"])
    for fs in systems[1:]:
        assert of(fs) == bench_py_sequence_schedule(
            c["seq_warm"], 3 * c["seq_window"])
    agg = [(s, x) for s, _, x in events if s is not systems[0]]
    news = [k for k, (_, x) in enumerate(agg) if x == "new"]
    for w in range(3):
        built = news[w * c["seqs"]:(w + 1) * c["seqs"]]
        first = min(k for k, (_, x) in enumerate(agg)
                    if k > built[0] and x not in ("new", "end"))
        assert max(built) < first


def test_a_failing_leg_still_prints_the_line(monkeypatch):
    """An exception in a leg: the line comes last with `error` and the
    earlier legs' numbers, the later legs do not run, the exit code is 1."""
    def planted(run, result):
        raise RuntimeError("planted failure")
    monkeypatch.setattr(bench, "leg_strict", planted)
    rc, lines, result = run_main(ARGV)
    assert rc == 1
    assert "strict" in result["error"] and "planted failure" in result["error"]
    assert len(result["sync_fps_windows"]) == 3 and result["sync_fps"] > 0
    assert "strict_fps" not in result and "value" not in result
    assert list(result["launches"]) == ["warmup", "lookahead", "strict"]


def test_a_lost_system_exits_with_1(monkeypatch):
    monkeypatch.setattr(FullSystem, "_track_new_coarse",
                        lambda self, *a, **k: False)
    argv = list(ARGV)
    argv[argv.index("--warm") + 1] = "10"
    rc, lines, result = run_main(argv)
    assert rc == 1
    assert result["error"].startswith("warmup: BenchError: system lost")
    assert not any("fps" in k for k in result) and "value" not in result


@pytest.fixture(scope="module")
def no_card_run():
    """One process where torch sees no card: the jax and ldso_tpu modules
    loaded by importing the bench (on stderr), then the bench run with its
    default device."""
    code = ("import sys; from ldso_tpu_torch.examples import bench; "
            "print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'ldso_tpu' "
            "or m.startswith('ldso_tpu.')), file=sys.stderr); "
            "sys.exit(bench.main(['--width', '192', '--height', '144']))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_no_card_fails_and_reports_no_fps(no_card_run):
    """With no --device the bench asks for the card; where torch sees none
    it exits non-zero and reports no fps, and never falls back to the
    CPU."""
    out = no_card_run
    assert out.returncode == 1, out.stdout + out.stderr
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["error"].startswith("device: RuntimeError")
    assert "no CUDA card" in result["error"]
    assert not any("fps" in k for k in result) and "value" not in result
    assert "device" not in result


def test_bench_imports_no_jax(no_card_run):
    assert no_card_run.stderr.splitlines()[0] == "[]", no_card_run.stderr
