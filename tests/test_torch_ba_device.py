"""backend/ba_device.optimize_device as one device program: masked LM trips
on a device `done` flag, the newest frame as a device integer and the
nullspace projector formed once per call, so that it reads nothing on the
host, runs under torch.func.vmap over windows and (on the card) replays as
one CUDA graph. On the CPU it is held bit for bit to the early-exit loop
it replaces, with the in-place code that loop ran
(torch_ba_parent.early_exit_optimize); the windows come from
torch_kernel_checks.ba_window, which the card tests and chip_smoke.py use
too."""

import dataclasses
import warnings

import pytest
import torch

import torch_kernel_checks as kc
from torch_ba_parent import early_exit_optimize

from ldso_tpu_torch.backend import ba, ba_device
from ldso_tpu_torch.backend.window import Window

# (frames in the window, slots F, LM trips, pose noise, idepth noise, seed,
# ba_finalize_sliced): trip counts 20, 15 and 6 as EnergyFunctional.optimize
# runs them for two, three and more frames. The break test stops the first
# three and the sliced one after 3-4 trips, so their later trips are masked;
# the noisy full window runs all 6.
CASES = {
    "two_frames_20_trips": (2, 4, 20, 2e-3, 0.05, 0, False),
    "three_frames_15_trips": (3, 4, 15, 2e-3, 0.05, 1, False),
    "full_window_6_trips": (5, 5, 6, 2e-3, 0.05, 2, False),
    "full_window_all_6_trips_run": (5, 5, 6, 1e-2, 0.2, 7, False),
    "full_window_sliced_finalize": (5, 5, 6, 2e-3, 0.05, 3, True),
}


def _case(name):
    nf, F, trips, pose_noise, idepth_noise, seed, sliced = CASES[name]
    W, dIs, HM, bM, cfg, (w, h) = kc.ba_window(
        nf, F, n_pts=64, seed=seed, pose_noise=pose_noise,
        idepth_noise=idepth_noise)
    cfg = dataclasses.replace(cfg, ba_finalize_sliced=sliced)
    return W, dIs, HM, bM, nf - 1, cfg, w, h, trips


def _bits(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _same_window(got, want):
    bad = [name for name, a, b in zip(Window._fields, got, want)
           if not _bits(a, b)]
    assert not bad, f"fields that differ: {bad}"


@pytest.mark.parametrize("name", list(CASES))
def test_masked_program_matches_the_early_exit_loop(name):
    """optimize_device, newest as a 0-d tensor, against the early-exit loop
    with newest an int: every Window field and the stats bit for bit, for
    the loops that stop early (their later trips masked) and for one that
    runs every trip."""
    W, dIs, HM, bM, newest, cfg, w, h, trips = _case(name)
    Wo, so, ran = early_exit_optimize(W, dIs, HM, bM, newest, cfg, w, h,
                                      trips)
    if name == "full_window_all_6_trips_run":
        assert ran == trips
    else:
        assert ran < trips        # the break test fired: masked trips ran
    Wn, sn = ba_device.optimize_device(W, dIs, HM, bM, torch.tensor(newest),
                                       cfg, w, h, trips)
    _same_window(Wn, Wo)
    assert _bits(sn, so)


_HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item",
               "tolist", "cpu", "numpy")


def test_optimize_device_never_reads_the_host(monkeypatch):
    """optimize_device with every tensor method that reads a value to the
    host patched to raise, and torch.tensor and torch.as_tensor of a value
    that is not a tensor too (after a first call has made its constants):
    on the card the same call is one graph replay. The results equal the
    unpatched call's bit for bit."""
    W, dIs, HM, bM, newest, cfg, w, h, trips = _case("full_window_6_trips")
    newest = torch.tensor(newest)
    want = ba_device.optimize_device(W, dIs, HM, bM, newest, cfg, w, h,
                                     trips)

    def refuse(*a, **k):
        raise AssertionError("the device LM read a value to the host")
    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse)
    as_tensor = torch.as_tensor

    def tensors_only(x, *a, **k):
        if not isinstance(x, torch.Tensor):
            refuse()
        return as_tensor(x, *a, **k)
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", tensors_only)
    got = ba_device.optimize_device(W, dIs, HM, bM, newest, cfg, w, h, trips)
    monkeypatch.undo()
    _same_window(got[0], want[0])
    assert _bits(got[1], want[1])


def test_vmap_over_windows_matches_single_calls():
    """torch.func.vmap of optimize_device over S = 3 distinct windows (3, 4
    and 5 frames of 5 slots, other seeds, so other newest frames and other
    masked trips) against 3 single calls, with no batching rule falling
    back to a loop over the windows: within torch_kernel_checks.
    ba_batch_err's tolerance (each member no farther from its window's
    float64 result than BA_F64_FACTOR times the farthest single call),
    the residual bookkeeping equal."""
    singles = [kc.ba_window(nf, 5, n_pts=64, seed=10 + nf)
               for nf in (3, 4, 5)]
    cfg, (w, h) = singles[0][4], singles[0][5]
    newest = torch.tensor([2, 3, 4])
    batched = Window(*(torch.stack([s[0][i] for s in singles])
                       for i in range(len(Window._fields))))
    ins = [torch.stack([s[k] for s in singles]) for k in (1, 2, 3)]

    def one(W, dIs, HM, bM, n):
        return ba_device.optimize_device(W, dIs, HM, bM, n, cfg, w, h, 6)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            Wv, sv = torch.func.vmap(one)(batched, *ins, newest)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    fallbacks = [str(m.message) for m in seen
                 if "batching rule" in str(m.message)]
    assert not fallbacks, fallbacks
    args = [(W, dIs, HM, bM, newest[s])
            for s, (W, dIs, HM, bM, _, _) in enumerate(singles)]
    worst, tol, faults = kc.ba_batch_err(
        [(Window(*(x[s] for x in Wv)), sv[s]) for s in range(3)],
        [one(*a) for a in args], [kc.ba_f64(one, *a) for a in args])
    assert not faults, (faults, worst, tol)


def test_hoisted_projector_matches_the_per_trip_one():
    """The nullspace projector formed once before the trips equals, bit for
    bit, the one formed from the window of a later trip (after the steps
    and relinearizations): the LM trips write none of T_eval, state_zero,
    exposure and frame_valid, which it reads."""
    W, dIs, HM, bM, newest, cfg, w, h, _ = _case("full_window_all_6_trips_run")
    newest = torch.tensor(newest)
    W, _ = ba.linearize_all(ba_device._reset_oob_dev(W), dIs, cfg, w, h)
    W = ba_device._commit(ba.set_new_frame_energy_th(W, newest, cfg))
    first = ba_device.nullspace_projector(W, cfg)
    for it in range(4):
        W, _, _, _ = ba_device._trip(W, dIs, HM, bM, newest, 0.1,
                                     first if it >= 2 else None, cfg, w, h)
        assert _bits(ba_device.nullspace_projector(W, cfg), first), it
    # and the trips did move the window
    assert not torch.equal(W.state, _case("full_window_all_6_trips_run")[0]
                           .state)


def test_projector_float32_against_float64():
    """The plain projector (float32 SVD) against a float64 one on the
    windows of 1 to 8 frames of 8 slots (the main path's F), each frame
    5 cm off its path: within a quarter of torch_kernel_checks'
    tolerance for K12 (PROJ_ULPS 2^-23 kappa per entry), which K12, in
    float64, is held to against the plain version on the card."""
    from ldso_tpu_torch.backend.ba_device import (nullspace_projector_ref,
                                                  orth_basis)
    for nf in range(1, 9):
        W, _, _, _, cfg, _ = kc.ba_window(nf, 8, n_pts=16, seed=nf,
                                          pose_noise=0.05)
        Nn = orth_basis(W)
        U, S, _ = torch.linalg.svd(Nn.double(), full_matrices=False)
        keep = S > cfg.solver_mode_delta * S.max()
        exact = U[:, keep] @ U[:, keep].T
        err, share, at_gate = kc.projector_err(
            nullspace_projector_ref(Nn, cfg.solver_mode_delta)[None],
            exact[None], Nn[None], cfg.solver_mode_delta)
        assert not at_gate and share <= 0.25, (nf, err, share)


# 7e's yardstick (torch_kernel_checks.ba_batch_err): a vmapped batch of the
# port's own BA windows, recorded from a CPU run of its FullSystem in the
# activation's present (jitted) order and in its earlier one, held to the
# float64 results of those windows
_RECORDED = {}


def _recorded_batch(order: str):
    """(batched, singles, reference, readings, plants) over the last 3
    recorded device-LM calls of one trip count, in activation `order`
    ("jitted" or "earlier"); plants: ba_batch_plants' arguments for the
    faults that rerun a member."""
    if order not in _RECORDED:
        calls = kc.recorded_ba_windows(earlier_activation=order == "earlier")
        trips = calls[-1][-1]
        calls = [c for c in calls if c[-1] == trips][-3:]
        assert len(calls) == 3, [c[-1] for c in calls]
        cfg, w, h = calls[0][5:8]

        def one(W, dIs, HM, bM, n, t=trips):
            return ba_device.optimize_device(W, dIs, HM, bM, n, cfg, w, h, t)
        Wv, sv = torch.func.vmap(one)(
            Window(*(torch.stack([c[0][i] for c in calls])
                     for i in range(len(Window._fields)))),
            *(torch.stack([c[k] for c in calls]) for k in (1, 2, 3, 4)))
        batched = [(Window(*(x[s] for x in Wv)), sv[s]) for s in range(3)]
        singles = [one(*c[:5]) for c in calls]
        reference = [kc.ba_f64(one, *c[:5]) for c in calls]
        _RECORDED[order] = (batched, singles, reference,
                            kc.ba_batch_readings(batched, singles, reference),
                            dict(calls=[c[:5] for c in calls], run=one,
                                 trips=trips))
    return _RECORDED[order]


@pytest.mark.parametrize("order", ["jitted", "earlier"])
def test_batch_yardstick_passes_on_recorded_windows(order):
    """On windows the port's own run hands its BA (30 bench frames at
    160x120), in either order of the activation's rounding, every member of
    the vmapped batch is within BA_F64_FACTOR times the farthest single
    call's distance from float64, its bookkeeping its single call's; and
    float32 rounding is what both carry: each single call lies off its
    float64 result by more than nothing and by less than 1e-3."""
    batched, singles, reference, readings, _ = _recorded_batch(order)
    worst, tol, faults = kc.ba_batch_err(batched, singles, reference)
    print(order, worst, tol, readings)
    assert not faults, (faults, worst, tol)
    for r in readings:
        assert 0.0 < r["single_f64"]["pose"] < 1e-3, r


@pytest.mark.parametrize("plant", ["neighbour's window",
                                   "pose moved 10x the tolerance",
                                   "last live trip lost",
                                   "1 in 256 points masked"])
def test_batch_yardstick_refuses_planted_faults(plant):
    """The yardstick refuses a batch whose member 0 carries its
    neighbour's result, one whose member 1's newest pose moved by 10
    times the pose tolerance, and two real runs of member 2 in its place:
    one that stops a trip before the LM's `done`, one with 1 in 256 of its
    points masked. The last two are real faults of a size a batched path
    could make; their distances over the tolerance (printed) move with
    torch's thread count, and PERF.md gives the readings."""
    batched, singles, reference, _, plants = _recorded_batch("jitted")
    _, tol, faults = kc.ba_batch_err(batched, singles, reference)
    assert not faults
    got = kc.ba_plant_readings(batched, singles, reference, **plants)[plant]
    print(plant, got)
    assert got["faults"], (plant, got)


def test_float64_plain_leaves_the_float32_path_alone():
    """ba_f64 runs the device LM in float64 (every float output float64)
    and the float32 call after it gives the bits it gave before: the
    context puts torch, the device constants and the kernels back."""
    from ldso_tpu_torch.ops import cuda_kernels
    W, dIs, HM, bM, newest, cfg, w, h, trips = _case("full_window_6_trips")

    def one(*a):
        return ba_device.optimize_device(*a, cfg, w, h, trips)
    before = one(W, dIs, HM, bM, newest)
    W64, s64 = kc.ba_f64(one, W, dIs, HM, bM, newest)
    assert s64.dtype == torch.float64
    assert all(x.dtype == torch.float64 for x in W64 if x.is_floating_point())
    assert ba.torch is torch and ba_device.cuda_kernels is cuda_kernels
    after = one(W, dIs, HM, bM, newest)
    _same_window(after[0], before[0])
    assert torch.equal(after[1], before[1])
    assert kc.ba_diffs(kc.window_f64(*before), (W64, s64))["pose"] < 1e-3
