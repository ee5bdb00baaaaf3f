"""The loop slice head to head: the port's FullSystem and the JAX
package's on the same 40 frames of the out-and-back scene
(tests/test_full_system_loop.py's, rendered once by the JAX renderer):
same keyframe ids, same loop pairs, loop edges within 0.05 of each
other.

Marked slow like tests/test_full_system_loop.py: the JAX run alone takes
~105 s of the file's ~150 s on a CPU. The port-alone run of the same scene
is tests/test_torch_loop_slice.py, in tier-1.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_utils  # noqa: F401  (one torch thread per worker)
from ldso_tpu.config import Config as JC
from ldso_tpu.math import lie as jlie
from ldso_tpu.synthetic import PlaneScene, default_calib
from ldso_tpu.system.full_system import FullSystem as JFS
from ldso_tpu_torch.config import Config as TC
from ldso_tpu_torch.system.full_system import FullSystem as TFS

from test_torch_loop_slice import LOOP_KW, N_LOOP, exposure_gains, out_and_back


pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def runs():
    calib = default_calib(256, 192)
    scene = PlaneScene(freq_hi=30.0, contrast=80.0, n_waves=32)
    gains = exposure_gains(N_LOOP)
    imgs = [np.asarray(scene.render(calib, jnp.asarray(T, jnp.float32))[0],
                       np.float32) * np.float32(gains[i])
            for i, T in enumerate(out_and_back(N_LOOP))]
    out = []
    for fs in (JFS(calib, JC(**LOOP_KW)), TFS(calib, TC(**LOOP_KW))):
        for i, img in enumerate(imgs):
            fs.add_active_frame(img, i, 1.0, i * 0.05)
            assert not fs.is_lost and not fs.init_failed, i
        out.append(fs)
    return out


def test_same_keyframes_and_loop_pairs(runs):
    fj, fp = runs
    kj = [f.id for f in fj.all_frames if f.kf_id >= 0]
    kp = [f.id for f in fp.all_frames if f.kf_id >= 0]
    assert kp == kj
    assert fj.loop_closing.loop_pairs
    assert fp.loop_closing.loop_pairs == fj.loop_closing.loop_pairs


def test_loop_edges_agree(runs):
    """Each loop edge's Sim(3) within |sim3_log(S_jax^-1 S_port)| < 0.05
    (the two trajectories and their feature depths differ at float32
    rounding; the edges carry the loop-measurement noise of each)."""
    fj, fp = runs
    for a, b in fj.loop_closing.loop_pairs:
        Sj = fj.global_map.keyframes[a].pose_rel[b][0]
        Sp = fp.global_map.keyframes[a].pose_rel[b][0]
        e = np.asarray(jlie.sim3_log(jnp.asarray(np.linalg.inv(Sj) @ Sp)))
        assert np.linalg.norm(e) < 0.05, (a, b, np.linalg.norm(e))
