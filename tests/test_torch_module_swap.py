"""The module swap of tests/torch_module_swap.py (ROADMAP fault 3a): the
JAX system carries on with another implementation's output at each call
of a named module. Here, at a small size, the plumbing: swapping in the
JAX module's own output through the port's types and back, and running
the frame step in separately jitted parts, leave the JAX system's run
bitwise as it was; a swap of the port's modules runs and records a bias
per module.

The bench-size runs are `tests/tools/bench_ate_cpu.py --package jax
--swap ...` (ROADMAP §3 has their table)."""

import dataclasses

import numpy as np
import pytest

import torch_module_swap as sw

W, H, N_STRICT, N_LOOKAHEAD = 128, 96, 24, 4
_RUNS = {}


def _run(modules=(), source="port"):
    """The JAX system over N_STRICT strict frames then N_LOOKAHEAD through
    a lookahead pipeline, with `modules` swapped: (camera centres by frame,
    keyframe ids, the swap's bias table, the window's frame count, and
    with `defused` every third track held against float64,
    torch_module_swap.tracker_vs_float64's rows)."""
    key = (tuple(modules), source)
    if key in _RUNS:
        return _RUNS[key]
    from ldso_tpu.frontend import tracker as jtr
    from ldso_tpu.config import Config
    from ldso_tpu.synthetic import default_calib
    from ldso_tpu.system.full_system import FullSystem
    from ldso_tpu.system.pipeline import DeterministicPipeline
    from ldso_tpu_torch.config import Config as TConfig
    from ldso_tpu_torch.examples import time_modes
    tcalib, _, images = time_modes.bench_frames(N_STRICT + N_LOOKAHEAD, W, H,
                                                "cpu")
    fs = FullSystem(default_calib(W, H),
                    dataclasses.replace(Config(), enable_loop_closing=False))
    tcfg = dataclasses.replace(TConfig(), enable_loop_closing=False)
    rows, calls, track = [], [0], jtr.track_frame

    def recorded(*args):
        out = track(*args)
        if "defused" in modules and len(rows) < 8 and calls[0] % 3 == 0:
            rows.append(sw.tracker_vs_float64(track, out, args, tcalib, tcfg))
        calls[0] += 1
        return out
    jtr.track_frame = recorded
    try:
        with sw.swap_hooks(fs, tcfg, tcalib, modules, source=source) as bias:
            for i in range(N_STRICT):
                fs.add_active_frame(images[i], i, 1.0, i * 0.05)
            pipe = DeterministicPipeline(fs, depth=3)
            for i in range(N_STRICT, N_STRICT + N_LOOKAHEAD):
                pipe.add_active_frame(images[i], i, 1.0, i * 0.05)
            pipe.block_until_mapping_is_finished()
    finally:
        jtr.track_frame = track
    centres = {f.id: np.linalg.inv(f.T_cw)[:3, 3] for f in fs.all_frames
               if f.pose_valid}
    out = (centres, [kf.id for kf in fs.global_map.get_all_kfs()],
           bias.table(), fs.ef.n_frames, rows)
    _RUNS[key] = out
    return out


@pytest.mark.parametrize("modules,source", [
    (sw.MODULES[:5], "jax"),
    (("defused",), "port"),
])
def test_swap_plumbing_keeps_the_run_bitwise(modules, source):
    """Every module swapped for the JAX module's own output sent to the
    port's types and back (track, act, opt, mpts, mframe), or the frame
    step run in separately jitted parts: the same keyframes and every
    camera centre bit for bit, and (for the swap) each module called, its
    bias exactly 0."""
    base_c, base_kf = _run()[:2]
    got_c, got_kf, bias = _run(modules, source)[:3]
    assert got_kf == base_kf and len(base_kf) >= 4
    assert sorted(got_c) == sorted(base_c)
    for i in base_c:
        np.testing.assert_array_equal(got_c[i], base_c[i], err_msg=str(i))
    if source == "jax":
        assert set(bias) >= {"track", "act", "opt", "mpts"}, bias
        for m, quantities in bias.items():
            for q, v in quantities.items():
                assert v["mean"] == 0.0 and v["calls"] > 0, (m, q, v)


def test_swap_of_the_port_tracker_runs():
    """The port's tracker swapped into the JAX system: the run keeps its
    keyframes at this size, the tracker's calls are counted beside the
    frame steps', and its poses part from the plain run's by rounding
    (well under a millimetre here)."""
    base_c, base_kf = _run()[:2]
    got_c, got_kf, bias = _run(("tracker",))[:3]
    assert got_kf == base_kf
    calls = bias["tracker"]["tnorm"]["calls"]
    assert calls >= N_STRICT + N_LOOKAHEAD - 9
    gap = max(np.linalg.norm(got_c[i] - base_c[i]) for i in base_c)
    assert 0.0 < gap < 1e-3, gap


def test_port_tracker_is_as_close_to_float64_as_jax():
    """What parts the two systems in fault 3a (ROADMAP §3): swapped into
    the JAX system at the bench's size, the port's tracker moves its ATE
    beyond its own controls, yet call by call it is a faithful float32
    evaluation. Here, on tracks of the JAX run, the port's and the JAX
    package's tracker against the JAX tracker in float64: the port's pose
    no farther from float64 than twice the JAX package's on average, and
    each within 1e-5 of it."""
    rows = _run(("defused",))[4]
    assert len(rows) >= 4
    s = sw.tracker_summary(rows)
    assert s["port"]["d_t"]["mean"] <= 2.0 * s["jax"]["d_t"]["mean"], s
    assert max(max(r["port"]["d_t"], r["jax"]["d_t"]) for r in rows) < 1e-5
