"""Configuration: frozen dataclass mirroring the reference's setting_* knobs.

The reference keeps ~120 global mutable `setting_*` variables plus
compile-time constants (reference: include/Settings.h, src/Setting.cc).
Here the same knobs live in one frozen, hashable dataclass that every
function takes explicitly. This is a numpy-only copy of
`ldso_tpu/config.py`, so the PyTorch port runs where JAX is absent;
tests/test_torch_host.py pins it field by field to the original.

Only knobs that are actually consumed somewhere in this package are kept;
render/debug-display toggles of the reference GUI are out of scope
(SURVEY.md §2 C31: viewer replaced by PLY dump + offline plots).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Compile-time constants (reference: include/Settings.h:8-44,165-172)
# ---------------------------------------------------------------------------

PYR_LEVELS = 6           # max pyramid levels (reference: Settings.h:8)
PATTERN_NUM = 8          # residual pattern size (reference: Settings.h:165)
PATTERN_PADDING = 2      # border padding required by the pattern
CPARS = 4                # optimizable intrinsics: fx fy cx cy

# Parameter scalings used to balance the Hessian (reference: Settings.h:26-33).
SCALE_IDEPTH = 1.0
SCALE_XI_ROT = 1.0
SCALE_XI_TRANS = 0.5
SCALE_F = 50.0
SCALE_C = 50.0
SCALE_A = 10.0
SCALE_B = 1000.0

# The DSO-paper residual pattern: 8 offsets (dx, dy) forming a spread cross
# (reference: Setting.cc:224-229, pattern index 8 of staticPattern).
PATTERN = np.array(
    [[0, -2], [-1, -1], [1, -1], [-2, 0], [0, 0], [2, 0], [-1, 1], [0, 2]],
    dtype=np.int32,
)
assert PATTERN.shape == (PATTERN_NUM, 2)

# Solver-mode bitflags (reference: Settings.h:11-23).
SOLVER_SVD = 1
SOLVER_ORTHOGONALIZE_SYSTEM = 2
SOLVER_ORTHOGONALIZE_POINTMARG = 4
SOLVER_ORTHOGONALIZE_FULL = 8
SOLVER_SVD_CUT7 = 16
SOLVER_REMOVE_POSEPRIOR = 32
SOLVER_USE_GN = 64
SOLVER_FIX_LAMBDA = 128
SOLVER_ORTHOGONALIZE_X = 256
SOLVER_MOMENTUM = 512          # previous-step blending (FullSystem.cc:1557)
SOLVER_STEPMOMENTUM = 1024     # step-direction momentum (FullSystem.cc:785)
SOLVER_ORTHOGONALIZE_X_LATER = 2048


@dataclasses.dataclass(frozen=True)
class Config:
    """All runtime knobs. Defaults mirror reference src/Setting.cc:8-137."""

    # --- static capacities (pad-to-capacity pools) --------------------------
    max_frames: int = 7                  # sliding window KFs (Setting.cc:34)
    min_frames: int = 5                  # (Setting.cc:33)
    max_points: int = 2048               # active-point pool capacity
    max_immature: int = 2048             # immature-candidate pool capacity
    # per-level coarse-tracker point capacities (lvl 0..5). The splat
    # occupies at most max_points cells per level (downsampling only
    # merges) and the single dilation pass (CoarseTracker.cc:313-398
    # analogue) adds at most 4 neighbours per occupied cell, so the valid
    # set is bounded by 5 * max_points = 10240; 12288/10240 leave margin
    # (measured 8557/7666 valid at lvl 0/1 on the bench scene). The warp
    # lattice cost of every LM iteration scales with these caps.
    tracker_caps: Tuple[int, ...] = (12288, 10240, 8192, 4096, 2048, 1024)

    # --- densities / window policy -----------------------------------------
    desired_immature_density: float = 1500.0   # (Setting.cc:29)
    desired_point_density: float = 2000.0      # (Setting.cc:30)
    min_points_remaining: float = 0.05         # (Setting.cc:31)
    max_log_aff_fac_in_window: float = 0.7     # (Setting.cc:32)
    min_frame_age: int = 1                     # (Setting.cc:35)
    keyframes_per_second: float = 0.0          # 0 = heuristic (Setting.cc:9)
    kf_global_weight: float = 1.0              # (Setting.cc:14)
    max_shift_weight_t: float = 0.04 * (640 + 480)   # (Setting.cc:11)
    max_shift_weight_r: float = 0.0 * (640 + 480)
    max_shift_weight_rt: float = 0.02 * (640 + 480)
    max_affine_weight: float = 2.0
    # LDSO's keyframe criterion reads the NEW frame's affine from the
    # FrameHessian accessor (FullSystem.cc:133 `fh->aff_g2l()`), whose
    # state is only set later in make[Non]KeyFrame (setEvalPT_scaled,
    # FullSystem.cc:417/596) — so the new frame's affine is (0,0) at
    # decision time and rel_a = exp(-a_ref)·(t_new/t_ref) tracks the
    # ABSOLUTE brightness drift of the reference KF. Upstream DSO uses the
    # tracked `fh->shell->aff_g2l` instead. True (default) reproduces the
    # LDSO cadence (root cause of the 106-vs-29 KF split on the revisit
    # head-to-head, BASELINE.md); False restores DSO's semantics.
    kf_affine_frame_zero: bool = True

    # --- optimization -------------------------------------------------------
    max_opt_iterations: int = 6                # (Setting.cc:36)
    min_opt_iterations: int = 1
    th_opt_iterations: float = 1.2
    solver_mode: int = SOLVER_FIX_LAMBDA | SOLVER_ORTHOGONALIZE_X_LATER
    solver_mode_delta: float = 0.00001
    force_accept_step: bool = True             # (Setting.cc:77)
    relin_always: bool = True                  # (Setting.cc:73)
    fix_calib: bool = False
    # JAX package only: store the window's level-0 image stack tap-packed
    # (F,H,W,12) so each bilinear sample is ONE gather index (bit-identical).
    # The port keeps the plain (F,H,W,3) stack and does not read this knob.
    ba_packed_taps: bool = True
    # run the whole windowed-BA LM loop as one device program
    # (backend/ba_device.py, f32 solve). False = host-orchestrated loop with
    # the f64 HM/bM + f64 scaled-LDLT solve (EnergyFunctional.cc:324-337
    # double semantics) — the ATE-ablation / parity-debug mode.
    ba_device_lm: bool = True
    # the post-LM final relinearization (after re-fixing the newest frame's
    # evaluation point, FullSystem.cc:833-846) touches only residuals
    # targeting the newest frame — True relinearizes just that column
    # (ba.linearize_target; also keeps the reference's literal sticky-OOB
    # early-out, Residuals.cc:17-21). Default False: in the JAX package's
    # ablation (BASELINE.md) the full-lattice finalize with OOB reset lands
    # closer to the reference's keyframe ATE on the parity scene (the
    # unlatch gives borderline residuals another chance), while the sliced
    # path is the better one on the multi-depth boxes scene — so the knob
    # stays.
    ba_finalize_sliced: bool = False

    # --- priors (Setting.cc:16-22) ------------------------------------------
    idepth_fix_prior: float = 50.0 * 50.0
    idepth_fix_prior_marg_fac: float = 600.0 * 600.0
    initial_rot_prior: float = 1e11
    initial_trans_prior: float = 1e10
    initial_aff_b_prior: float = 1e14
    initial_aff_a_prior: float = 1e14
    initial_calib_hessian: float = 5e9
    marg_weight_fac: float = 0.5 * 0.5         # (Setting.cc:45)

    # --- outliers / robust kernel -------------------------------------------
    huber_th: float = 9.0                      # (Setting.cc:80)
    outlier_th: float = 12.0 * 12.0            # (Setting.cc:40)
    outlier_th_sum_component: float = 50.0 * 50.0
    frame_energy_th_const_weight: float = 0.5
    frame_energy_th_n: float = 0.7
    frame_energy_th_fac_median: float = 1.5
    overall_energy_th_weight: float = 1.0
    coarse_cutoff_th: float = 20.0             # (Setting.cc:86)

    # --- point lifecycle -----------------------------------------------------
    min_idepth_h_act: float = 100.0            # (Setting.cc:26)
    min_idepth_h_marg: float = 50.0
    max_pix_search: float = 0.027              # (Setting.cc:28)
    gn_its_on_point_activation: int = 3        # (Setting.cc:47)
    min_trace_quality: float = 3.0             # (Setting.cc:52)
    trace_stepsize: float = 1.0                # (Setting.cc:95)
    # single-tap nearest sampling for the discrete epipolar SSD search
    # instead of the reference's bilinear search energy
    # (ImmaturePoint.cc:182-205). Default False: with trace_packed the
    # bilinear search costs the same ONE gather per step (integer pattern
    # offsets share the step's fractional part — pack_pattern_bilinear),
    # and the round-4 ablation showed the bilinear search is the entire
    # remaining ATE-parity gap (0.106 vs 0.20 mm; BASELINE.md).
    trace_search_nearest: bool = False
    # with trace_search_nearest: bilinearly re-score the +-K steps around
    # the nearest-tap argmin (the reference's search energy,
    # ImmaturePoint.cc:182-205) before the GN refinement — recovers the
    # bilinear argmin at a fraction of a full bilinear search. 0 = off.
    trace_refine_steps: int = 2
    trace_gn_iterations: int = 3
    # one-gather-per-step pattern-packed search + packed-tap GN/refine
    # (ops/interp.pack_pattern / pack_taps): 8x / 4x fewer gather indices
    # on the trace lattices. GN/refine stay bit-identical; the packed
    # search samples the unrotated integer pattern (see frontend/immature).
    trace_packed: bool = True
    trace_gn_threshold: float = 0.1
    trace_extra_slack_on_th: float = 1.2
    trace_slack_interval: float = 1.5
    trace_min_improvement_factor: float = 2.0

    # chamfer relaxation steps for the activation-spacing distance map.
    # 18 is provably decision-equivalent to the reference's 40 BFS rounds
    # for the default gates (see _gate_candidates_fused); 40 restores the
    # reference's exact bound (CoarseTracker.cc:726) for ablations.
    dist_map_steps: int = 18

    # --- pixel selection ------------------------------------------------------
    point_selection: int = 1                   # 0=DSO grad, 1=LDSO corner-aware, 2=random
    min_grad_hist_cut: float = 0.5             # (Setting.cc:87)
    min_grad_hist_add: float = 7.0
    grad_downweight_per_level: float = 0.75
    select_direction_distribution: bool = True
    gamma_weights_pixel_select: int = 1        # (Setting.cc:71)

    # --- photometric ----------------------------------------------------------
    photometric_calibration: int = 2           # 0/1/2 (Setting.cc:64)
    use_exposure: bool = True
    affine_opt_mode_a: float = 1e12            # -1 fixes a (Setting.cc:67)
    affine_opt_mode_b: float = 1e8

    # --- tracking -------------------------------------------------------------
    re_track_threshold: float = 1.5            # (Setting.cc:54)
    coarse_lm_iterations: Tuple[int, ...] = (10, 20, 50, 50, 50, 50)
    # sample the tracker's warp pass from a pack_taps image (one gather of
    # 4 pre-packed taps instead of 4 separate gathers; ops/interp.pack_taps).
    # Bit-identical to the 4-tap path; False = the plain formulation.
    tracker_packed_taps: bool = True

    # --- loop closing -----------------------------------------------------------
    enable_loop_closing: bool = True
    fast_loop_closing: bool = True
    loop_kf_gap: int = 10                      # exclusion window (LoopClosing.cc:30)
    loop_score_th: float = 0.06                # DBoW3 score gate (LoopClosing.cc:119)

    # --- misc -------------------------------------------------------------------
    seed: int = 3141592                        # PixelSelector srand (PixelSelector2.cc:11)

    def validate(self) -> "Config":
        """Config-time mode interlocks (the reference checks these at CLI
        startup, run_dso_tum_mono.cc:286-290; solver-mode interactions were
        previously a runtime ValueError deep in EnergyFunctional.optimize).
        Returns self so call sites can chain."""
        if self.enable_loop_closing and self.point_selection != 1:
            raise ValueError(
                "enable_loop_closing requires point_selection=1 (LDSO "
                "corner-aware selection provides the ORB features loop "
                "closing matches on; reference interlock "
                "run_dso_tum_mono.cc:286-290)")
        if self.solver_mode & SOLVER_MOMENTUM and not self.ba_device_lm:
            # momentum always uses the host loop; nothing to check
            pass
        if not self.force_accept_step and self.ba_device_lm and (
                self.solver_mode & SOLVER_MOMENTUM):
            raise ValueError(
                "SOLVER_MOMENTUM with force_accept_step=False is "
                "unsupported on the device LM path; set ba_device_lm=False "
                "for the host-orchestrated momentum loop")
        if len(self.coarse_lm_iterations) < PYR_LEVELS:
            raise ValueError("coarse_lm_iterations must cover PYR_LEVELS")
        return self

    def pyr_levels_used(self, w: int, h: int) -> int:
        """Number of pyramid levels: halve until w*h <= 5000, capped at
        PYR_LEVELS (reference: GlobalCalib.cc:20-44)."""
        levels = 1
        ww, hh = w, h
        while ww % 2 == 0 and hh % 2 == 0 and ww * hh > 5000 and levels < PYR_LEVELS:
            ww //= 2
            hh //= 2
            levels += 1
        return levels


# Presets mirroring the reference CLI presets 0..3
# (reference: examples/run_dso_tum_mono.cc:42-89).
def preset(idx: int) -> Config:
    if idx in (0, 1):
        return Config()
    if idx in (2, 3):
        return Config(
            desired_point_density=800.0,
            desired_immature_density=600.0,
            max_frames=6,
            min_frames=4,
            max_opt_iterations=4,
            min_opt_iterations=1,
            max_points=1024,
            max_immature=1024,
        )
    raise ValueError(f"unknown preset {idx}")
