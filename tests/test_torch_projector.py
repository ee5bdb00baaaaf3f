"""K12's algorithm (csrc/ba_projector.cu: the 7x7 Gram matrix, cyclic
two-sided Jacobi on it in one warp, the eigenvalue gate, U'U'^T) in its CPU
emulation, torch_kernel_checks.projector_emulated, against the port's
plain projector (backend/ba_device.nullspace_projector_ref, an SVD) and
the JAX package's (I - _orthogonalize_dev(I, N, delta)), within
torch_kernel_checks.projector_err's tolerance, on the BA windows of 1 to 8
frames in the main path's 8 slots, an empty window and planted bases.
The card tests hold K12 itself to the emulation
(tests/test_torch_cuda.py::test_projector_kernel_matches_plain)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_kernel_checks as kc

from ldso_tpu.backend.ba_device import _orthogonalize_dev
from ldso_tpu_torch.backend import ba_device
from ldso_tpu_torch.backend.window import empty_window
from ldso_tpu_torch.config import Config

DELTA = Config().solver_mode_delta
F = 8                        # the main path's window slots
PLANTED = tuple(kc.planted_bases(DELTA))
AT_GATE = ("gate_1.01", "gate_0.99")


def _basis(case):
    if case.startswith("window_"):
        nf = int(case.split("_")[1])
        W = kc.ba_window(nf, F, n_pts=16, seed=nf)[0]
        return ba_device.orth_basis(W)
    if case == "empty":
        W = empty_window(F, 16, (100.0, 100.0, 80.0, 60.0), Config(), "cpu")
        return ba_device.orth_basis(W)
    return torch.from_numpy(kc.planted_bases(DELTA)[case])


def _jax_projector(Nn):
    """The JAX package's projector on the same basis: x - P x at x = I."""
    n = Nn.shape[0]
    eye = jnp.eye(n, dtype=jnp.float32)
    orth = _orthogonalize_dev(eye, jnp.asarray(Nn.numpy()), DELTA)
    return torch.from_numpy(np.array(eye - orth))


@pytest.mark.parametrize("case", [f"window_{nf}" for nf in range(1, F + 1)]
                         + ["empty", *PLANTED])
def test_emulated_projector_matches_references(case):
    """The emulation within projector_err's tolerance of both references,
    symmetric bit for bit, its Jacobi converged inside the sweep cap; the
    two bases with a singular value at 1.01 and 0.99 times the gate are
    reported as at the gate (each version may keep or drop it), not held
    to the tolerance, and the emulation keeps the first and drops the
    second, as float64 singular values do."""
    Nn = _basis(case)
    assert Nn.shape == (kc.PROJ_N, 7)
    got, sweeps, rotations = kc.projector_emulated(Nn, DELTA)
    assert torch.equal(got, got.T)
    assert 1 <= sweeps < kc.PROJ_MAX_SWEEPS and rotations >= 0
    for want in (ba_device.nullspace_projector_ref(Nn, DELTA),
                 _jax_projector(Nn)):
        err, share, at_gate = kc.projector_err(got[None], want[None],
                                               Nn[None], DELTA)
        assert at_gate == ([0] if case in AT_GATE else []), (case, at_gate)
        assert share <= 1.0, (case, err, share)
    if case in AT_GATE:
        S = torch.linalg.svdvals(Nn.double())
        rank = int((S > DELTA * S.max()).sum())
        assert rank == (7 if case == "gate_1.01" else 6)
        assert abs(float(torch.trace(got.double())) - rank) < 1e-3


@pytest.mark.parametrize("case", ["window_8", "kappa_1e3"])
def test_projector_err_reports_a_dropped_direction(case):
    """A planted fault: the emulation with one kept direction left out is
    off by that direction's u u^T, far past projector_err's tolerance."""
    Nn = _basis(case)
    bad = kc.projector_emulated(Nn, DELTA, drop=1)[0]
    want = ba_device.nullspace_projector_ref(Nn, DELTA)
    err, share, at_gate = kc.projector_err(bad[None], want[None], Nn[None],
                                           DELTA)
    assert not at_gate and share > 1.0 and err > 1e-2, (err, share)


def test_emulated_sweeps_match_the_one_sided_count():
    """The two-sided Jacobi on G = Nn^T Nn makes the one-sided Jacobi's
    rotations on Nn's columns (the same pairs, the same angles), so the
    full window takes some 5 sweeps of 7 rounds, the last rotating nothing,
    and columns on disjoint rows (G diagonal) take one sweep and no
    rotation."""
    _, sweeps, rotations = kc.projector_emulated(_basis("window_8"), DELTA)
    assert 4 <= sweeps <= 7 and 60 <= rotations <= 7 * 4 * (sweeps - 1)
    B = np.zeros((kc.PROJ_N, 7), np.float32)
    for c in range(7):
        B[8 * c:8 * c + 8, c] = np.random.RandomState(c).randn(8)
    P, sweeps, rotations = kc.projector_emulated(torch.from_numpy(B), DELTA)
    assert (sweeps, rotations) == (1, 0)
    assert abs(float(torch.trace(P.double())) - 7) < 1e-5
