"""Drive the PyTorch port (sonar_slam_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises and
the script exits non-zero without printing the result line:

1. device: a CUDA card is required (there is no CPU fallback); prints
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build: compiles the CFAR kernels (kernels/csrc/cfar.cu) with nvcc;
3. kernels against plain versions, on the same simulated full-geometry
   pings: two stacks of 128 pings of 512 x 256 (pings 0-127 and 128-255).
   The sum kernel at (128, 512, 256) SOCA with edge extension and the
   intensity gate at 65, with and without the threshold map, plus CA, GOCA
   and the strict edge at (4, 96, 40); the OS mask path (mask only, the
   feature path's call) and the OS threshold path at (128, 512, 256),
   extend, gate 65, rank 10, plus ranks 0, 10 and 39 with both edges at
   (4, 96, 40), on the float pings and on an integer-valued copy. Masks and
   thresholds must be equal bit for bit. Times by CUDA events after warm-up,
   alternating between the two stacks (so no launch reads its input from
   L2), in the order plain, kernel, kernel, plain; then the threshold path,
   a call whose gate no pixel passes (no window arithmetic: the tile's
   floor), and one PyTorch call that computes the window statistic alone
   as a yardstick (``conv2d`` for the sums, ``kthvalue`` for OS). Each kernel's
   bound is its bytes (one image read, one mask write) over the card's
   memory rate, or its operations over the float32 rate if that is larger;
4. the SOCA slice: ``pipeline.replay`` at bench.py's full configuration
   with refinement off (480 s survey at 5 Hz, 2,400 pings of 512 x 256,
   128 keyframe slots), seed 0, with the CFAR launch counters reset just
   before. Checks a finite trajectory, at least 3 launches, all of the sum
   kernel, and the expected keyframes, loops and ATE below, exactly;
5. the OS slice: the same survey through bench.py's whole full pipeline
   with the order-statistic detector: ``replay`` with bench.py's
   refinement (``refine_loops``), then the mapping stage, ``map_metrics``
   and ``loop_metrics``, with the launch counters reset just before. Checks
   a finite trajectory, at least 3 launches, all of the OS mask kernel, and
   the expected keyframes, loops, ATE and map metrics below, exactly;
6. reference, refinement off: the small configuration (bench.py --small)
   on the card, twice, stage by stage against the port on the CPU and as a
   whole against the JAX package's results for the same input
   (tests/golden/small_norefine_traj.npz); see ``check_small``;
7. reference, refinement on: the small configuration with refinement
   against the JAX package's result (tests/golden/small_traj.npz), twice;
   see ``check_small_refine``;
8. the FOG-gyro front end: phase 4's survey and configuration through
   ``replay(frontend="dr_gyro")``, with the launch counters reset just
   before. Checks the odometry at the pings and the keyframe pings against
   the JAX package's (tests/golden/full_frontends_odometry.npz), at least one
   CFAR launch, all of the sum kernel, and the keyframes, loops and ATE
   below, exactly; see ``run_frontend_path``;
9. the Kalman front end: the same with ``frontend="kalman"`` (DR-basis
   aggregation off: the Kalman filter gives no basis integrals) and the
   default Kalman configuration adapted to the 50 Hz IMU, the same checks;
   then the Kalman scan alone, timed, and once more under ``torch.profiler``
   to count its kernel launches;
10. bench.py's dual-sonar lane (bench.py:792-953): ``replay(use_vertical=True)``
   at its configuration, twice, with the counters reset before each. Checks
   (a) the vertical launch's mask against the plain version bit for bit and
   against the JAX mask (tests/golden/dual_lane.npz) up to pixels within a
   relative 1e-5 of their threshold, and times that call; (b) the fusion
   stage on the golden's JAX inputs against its JAX outputs; (c) the lane's
   keyframes against the JAX result's and bench.py's ``dual_sonar`` numbers,
   its z RMSE within DUAL_Z_BAND_M of the JAX result's; see ``run_dual_lane``.

11. the bag seam: a small simulated survey with its pings quantized to
   8 bits by the sonar's gamma, written as an lz4-chunked ROS bag with raw
   ``sensor_msgs/Image`` pings (``io.rosbag.write_bag``), converted by
   ``cli.convert_bag`` and replayed by ``cli.replay`` on the card with the
   YAML configuration. The bundle must hold exactly the quantized arrays,
   and the replay must equal an in-process ``pipeline.replay`` of those
   arrays bit for bit; see ``run_bag_seam``;
12. the CLI at full width: phase 4's survey written as an uncompressed
   bundle and replayed by ``cli.replay`` (``--max-keyframes 128 --intensity
   --save-submaps``, the YAML configuration), with the launch counters reset
   just before. Checks the sum kernel's launches, ``slam_carry.npz``
   reloaded leaf for leaf, ``occupancy.npz`` against a full repaint, the
   ``states`` dtype, and the keyframes, loops and ATE below, exactly; see
   ``run_cli_full``;
13. the ``parallel/`` entry points, each with the launch counters reset just
   before: (a) ``cli.sweep --simulate --lanes 8`` (one CFAR launch for the
   whole sweep; lanes 0 and 7 bit for bit against a lone ``slam_scan`` of
   their params), (b) ``cli.two_robot_demo`` (one launch a robot), (c)
   ``cli.sharded_replay --max-keyframes 1024 --check --duration 60`` (the
   replay at capacity 1024 against capacity 128; one launch a replay), each
   with its
   wall time and peak memory, and the keyframes, loops and ATE below,
   exactly; see ``run_sweep``, ``run_two_robot`` and ``run_sharded``;
14. the accuracy CLIs, each run in process through its ``main`` with the
   launch counters reset just before, each result pinned exactly: (a)
   ``cli.multi_seed --full --seeds 1``, bench.py's production SOCA +
   refinement path at full width (73 keyframes, the sum kernel); (b)
   ``cli.yscale_lane --seeds 1``, the same on the 20-degree crab survey;
   (c) ``cli.error_budget``, (d) ``cli.accuracy_sweep`` and (e)
   ``cli.map_probe`` at the small configuration, then
   ``cli.frontier_coverage_probe --alg OS`` (the OS mask kernel); (f)
   ``cli.run_repeats`` with two ``cli.replay`` runs in subprocesses and
   ``cli.plot_runs.trajectory_spread`` over them, which must be 0.0; see
   ``run_multi_seed`` to ``run_repeats``.

The second-to-last line is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# The full-config SOCA slice (seed 0, refinement off). No JAX result of this
# configuration with refinement off is recorded, and the full size is not run
# on a host CPU, so the expected values are the port's own on an H100 80GB
# HBM3 (700 W), the same bit for bit in every run since they were first
# taken: 73 keyframes, 7 loops, ATE 0.0606 m / 0.146 deg (rounded to 0.1 mm
# and 0.001 deg). A fault that changes any detection moves them. For scale,
# the JAX package with refinement on records 3.33 cm / 0.147 deg
# (BENCH_r05.json).
FULL_KEYFRAMES = 73
FULL_LOOPS = 7
FULL_ATE_M, FULL_ATE_DEG = 0.0606, 0.146
# The full-config OS slice (seed 0, bench.py's refinement and mapping). No
# JAX result of it is recorded either (the JAX package's full runs use SOCA),
# so the expected values are the port's own result on an H100 80GB HBM3
# (700 W), repeated bit for bit: 95 loops, ATE 0.0282 m / 0.153 deg, map
# precision 0.951, recall 0.722 and chamfer 177.5 cm (map_metrics' own
# rounding). The keyframe count depends only on dead reckoning, so it must
# equal the SOCA slice's.
OS_LOOPS = 95
OS_ATE_M, OS_ATE_DEG = 0.0282, 0.153
OS_MAP = {"precision": 0.951, "recall": 0.722, "chamfer_cm": 177.5}
# the JAX package's full config with SOCA and refinement, seed 0, on a TPU
# (BENCH_r05.json): printed beside the OS slice for scale only
BENCH_R05_SOCA = {"ate_cm": 3.33, "ate_deg": 0.147, "loops": 95,
                  "map_precision": 0.947, "map_recall": 0.721}
# small-config checks (see check_small): stage outputs on the card against
# the CPU, and the card's trajectory against a JAX result, within
# SCAN_ATOL_M; the card's ATE within SMALL_ATE_BAND_M of the JAX result's,
# either way
SCAN_ATOL_M = 1e-3
SMALL_ATE_BAND_M = 0.02
# phases 8 and 9: the odometry at the pings against the JAX package's within
# these (the cumulative sums run in other orders; on the CPU the gaps are
# 1.1e-4 m / 1.9e-6 rad with dr_gyro and 2.1e-4 m / 3e-8 rad with kalman,
# tests/test_torch_frontends.py; on an H100 80GB HBM3 at 700 W 1.6e-4 m /
# 6.7e-6 rad and 2.1e-4 m / 3e-8 rad), and the port's own result on that
# card, exactly (keyframes, loops, ATE m and deg, rounded as for phase 4),
# the same in two processes since the gyro and Kalman integrals scan rows
# (tests/test_torch_odometry_cuda.py); with the single-row scans they
# replaced, one run's gyro odometry came out 1.1e-4 m from JAX's instead of
# 9.0e-5 m and its dr_gyro ATE 0.0714 m, and kalman gave 0.2357 m / 0.245
# deg. No JAX run of the full survey through these front
# ends past the keyframe gate exists, as for phase 4.
ODO_POS_ATOL_M, ODO_ANG_ATOL = 1e-3, 2e-5
FRONTEND_EXPECTED = {"dr_gyro": (73, 7, 0.0715, 0.121),
                     "kalman": (72, 7, 0.2283, 0.251)}
# phase 10: the card's z RMSE within this of the JAX result's (the port on
# the CPU lands 0.0 m from it, tests/test_torch_dual_lane.py), and the JAX
# package's lane on a TPU (BENCH_r05.json), printed for scale only
DUAL_Z_BAND_M = 5e-3
BENCH_R05_DUAL = {"z_rmse_cm": 4.15, "z_points": 922}
# phase 12: the CLI on phase 4's survey with the YAML configuration
# (keyframes, loops, ATE m and deg, rounded as for phase 4): the port's own
# first result on an H100 80GB HBM3 (700 W); no JAX run of this
# configuration at full size exists. The keyframes are phase 4's (the gate
# sees the same odometry and thresholds).
CLI_EXPECTED = (73, 30, 0.2615, 0.652)
# phase 12: the grid the CLI builds keyframe by keyframe against a full
# repaint, as a share of the observed cells whose method-1 value may differ
# (each keyframe's cells are divided exactly in the one and by the
# reciprocal in the other; on the CPU none of 30,444 and 6 of 31,136
# differ, tests/test_torch_cli.py and tests/test_torch_occupancy.py)
CLI_REPAINT_SHARE = 0.002
# phase 13: the port's own first results on an H100 80GB HBM3 (700 W), as for
# phases 4 and 12 (no JAX run of these on a card exists; on the CPU the three
# CLIs are held to the JAX scripts at shorter durations by
# tests/test_torch_{parallel,multi_robot,sharded_replay}.py): the sweep's
# (keyframes, loops per lane, best ATE m), the two-robot demo's (keyframes,
# loops, proposals, PCM accepts, clique size, merged ATE m rounded to 0.1
# mm) and the large-capacity replay's (keyframes, loops, ATE m)
SWEEP_LANES = 8
SWEEP_EXPECTED = (19, [6, 6, 6, 6, 8, 8, 8, 8], 0.3014)
TWO_ROBOT_EXPECTED = ([18, 19], [9, 4], 5, 5, 5, 0.0568)
SHARDED_EXPECTED = (13, 4, 0.0496)
# phase 13c replays a 60 s survey: on the card the 90 s default's loops
# are ill-conditioned in the capacity (K 1024 closes 9 loops, K 128 eight;
# python tests/test_torch_sharded_replay.py cuda), so --check would fail
# there; at 60 s the two capacities agree within 1.9e-6 m
SHARDED_DURATION = "60"
# phase 14: the accuracy CLIs. The pins are the port's own first results on
# an H100 80GB HBM3 (700 W), exact as printed (the CLIs' own rounding), as for
# phases 4, 12 and 13: no JAX run of these on a card exists, and the full
# size is not run on a host CPU. On the CPU the small configurations are
# held to the JAX scripts by tests/test_torch_{error_budget,multi_seed,
# accuracy_sweep,map_probes,run_repeats}.py. 14a: cli.multi_seed --full
# --seeds 1 (bench.py's SOCA + refinement path; the keyframes depend only on
# dead reckoning); (keyframes, loops, ATE cm, heading deg, loop precision,
# recall, estimated DVL scale x/y)
MULTI_SEED_EXPECTED = (73, 94, 4.5, 0.154, 1.0, 0.841, [1.0257, 0.99941])
# 14b: cli.yscale_lane --seeds 1 (est. scale x/y, x and y error %, loops,
# ATE cm)
YSCALE_EXPECTED = ([1.02851, 0.99811], 0.514, 0.27, 69, 5.41)
# 14c: cli.error_budget (small): the whole report
ERROR_BUDGET_EXPECTED = {
    "feature_rms_cm": 10.1, "feature_median_cm": 7.63,
    "A_full_pipeline": {"ate_cm": 3.16, "dr_ate_cm": 3.68, "keyframes": 19,
                        "loops": 8},
    "B_noiseless_sensors": {"ate_cm": 1.62, "dr_ate_cm": 1.33,
                            "keyframes": 18, "loops": 9},
    "C_gt_features": {"ate_cm": 2.52, "dr_ate_cm": 3.68, "keyframes": 19,
                      "loops": 11},
    "D_noiseless_gt_features": {"ate_cm": 1.46, "dr_ate_cm": 1.33,
                                "keyframes": 18, "loops": 9}}
# 14d: cli.accuracy_sweep (small, 1 seed): (label, ATE cm, loops), ranked
ACCURACY_SWEEP_EXPECTED = [
    ("baseline r1 (.5/.5/.5)", 3.07, 10), ("agg.25 (.25/.25/.5)", 3.82, 9),
    ("noise.35 (.25/.25/.35)", 6.01, 9), ("feat.25 (.25/.5/.5)", 6.29, 6),
    ("fine (.125/.25/.25) 2xpts", 7.64, 11),
    ("noise.25 (.25/.25/.25)", 8.87, 8), ("no-subbin (.5/.5/.5)", 9.07, 9)]
# 14e: cli.map_probe (small) and cli.frontier_coverage_probe --alg OS
# (small): their whole reports
MAP_PROBE_EXPECTED = {
    "config": "small", "n_cells": 1709, "n_truth": 988, "precision@0.4": 0.802,
    "recall@0.4": 0.718, "recall@0.8": 0.747,
    "d_truth_q_m": {"50": 0.12, "75": 0.83, "90": 5.1, "95": 8.04, "99": 10.41,
                    "100": 11.24},
    "d_cell_q_m": {"50": 0.21, "75": 0.36, "90": 0.51, "95": 0.64, "99": 0.9,
                   "100": 1.1},
    "d_cell_mean_m": 0.26, "d_truth_mean_m": 1.33, "feat_recall@0.4": 0.892,
    "d_truth_feat_q_m": {"50": 0.09, "75": 0.18, "90": 0.42, "95": 1.01,
                         "99": 2.49, "100": 7.76}}
FRONTIER_OS_EXPECTED = {
    "config": "small", "max_points": 128, "kf_count": 18,
    "mean_wedge_truth": 209.5, "mean_occupied_vox": 114.7,
    "capacity_binding_frac": 0.44, "coverage_A_raw": 0.996,
    "coverage_B_voxel": 0.995, "coverage_C_final": 0.844, "alg": "OS",
    "pfa": 0.1, "miss_range_med_m": 29.1, "hit_range_med_m": 16.4,
    "miss_absbrg_med_deg": 36.6, "hit_absbrg_med_deg": 37.1}
# 14f: cli.run_repeats with two runs on a 20 s survey of 64 x 32 pings
REPEAT_RUNS = 2
# the JAX package's records of the same scripts, accuracy only (their
# speed figures were taken on a TPU and are not the port's): printed beside
# the pins for scale. docs/MULTISEED_r05_tpu.json and docs/YSCALE_r05.json
# seed 0; beside 14c, the JAX script's small error budget on a CPU
# (tests/golden/error_budget_small.json)
MULTISEED_R05_SEED0 = {"keyframes": 73, "loops": 95, "ate_cm": 4.85,
                       "heading_deg": 0.172, "precision": 1.0, "recall": 0.818,
                       "est_dvl_scale_xy": [1.02571, 0.99772]}
YSCALE_R05_SEED0 = {"est_scale_xy": [1.03117, 0.99758], "x_err_pct": 0.78,
                    "y_err_pct": 0.217, "loops": 51, "ate_cm": 8.84}
# the JAX package's state array layout (sonar_slam_tpu/io/state.py)
JAX_STATE_DTYPE = [("time", "<f8"), ("pose", "<f4", (3,)),
                   ("dr_pose3", "<f4", (6,)), ("cov", "<f4", (9,))]


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, stacks, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn(stack)`` by CUDA events, alternating over ``stacks``
    (two distinct ping stacks, together over the 50 MB L2, so that no launch
    reads its input from L2)."""
    import torch

    for i in range(warmup):
        fn(stacks[i % len(stacks)])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(reps):
        fn(stacks[i % len(stacks)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, stacks, reps: int = 50) -> float:
    """Mean device ms of ``fn(stack)`` for a call too small to outrun the
    host: the launches are queued behind a kernel that sleeps (about 30 ms)
    while the host enqueues them, so they run back to back and the events
    time the device alone."""
    import torch

    fn(stacks[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(reps):
        fn(stacks[i % len(stacks)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s and float32 outside the
# tensor cores, operations/s
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12


def bound(imgs, ops: float, with_threshold: bool = False) -> tuple[float, str]:
    """Least ms the card could take for a CFAR call on ``imgs``: the larger
    of its bytes (each float32 pixel read once, each bool written once, and
    with the threshold map each float32 threshold written once) over the
    memory rate and ``ops`` over the float32 rate."""
    per_pixel = 4 + 1 + (4 if with_threshold else 0)
    bytes_ms = imgs.numel() * per_pixel / HBM_BYTES_S * 1e3
    ops_ms = ops / FP32_OPS_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def gated_pixels(imgs, gate: float) -> int:
    """Pixels over the intensity gate: the ones whose window arithmetic the
    mask needs (extend edge, so every row may detect)."""
    return int((imgs > gate).sum())


def full_config(seed: int = 0):
    """bench.py's full configuration with refinement off (bench.py
    --no-refine), in the port's types."""
    from sonar_slam_torch.cloud import ICPConfig
    from sonar_slam_torch.io.simulate import SimConfig
    from sonar_slam_torch.slam import FeatureConfig, SlamDims

    icp_prod = ICPConfig(max_iterations=12, min_diff_rot=1e-3,
                         min_diff_trans=1e-2, point_to_line=True,
                         outlier_max_dist=0.5)
    sim = SimConfig(duration=480.0, speed=0.5, sonar_rate=5.0, num_ranges=512,
                    num_bearings=256, loop_radius=18.0, imu_rate=50.0,
                    seed=seed)
    dims = SlamDims(
        max_keyframes=128, max_points=256, target_capacity=1024,
        nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=512, max_loops=128,
        gn_iters=3, icp=icp_prod, nssm_target_window=2, nssm_pair_refine=True,
        pair_refine_max_dt=0.35, pair_refine_max_dr=0.07,
        pair_refine_min_inliers=25, nssm_reinit_after_select=True,
        aggregate_with_dr=True, aggregate_with_dr_basis=True,
        estimate_dvl_scale=True, dvl_scale_prior_sigma=0.05)
    params = _params(dims, kf_translation=3.0, nssm_min_points=50,
                     nssm_every=5, icp_floor=(0.2, 0.2, 0.1))
    return sim, dims, params, FeatureConfig(max_points=dims.max_points,
                                            corroborate=True)


def full_os_config(seed: int = 0):
    """bench.py's whole full configuration (bench.py:232-273), refinement
    included, with its RefineParams overrides (bench.py:350-359) and the
    order-statistic detector: (sim, dims, params, FeatureConfig,
    RefineParams), the last two built on a device by ``params`` and
    ``refine_params``."""
    import dataclasses

    import numpy as np
    from sonar_slam_torch.slam import FeatureConfig, RefineParams

    sim, dims, params, _ = full_config(seed)
    dims = dataclasses.replace(
        dims, refine_iters=2, refine_sweep=True, refine_chain=True,
        refine_final_sweep=True, refine_scale_from_chain=True,
        refine_scale_basis=True, refine_sweep_budget=0,
        refine_incremental=True)

    def refine_params(device):
        return RefineParams.default(device)._replace(
            prune_max_dt=float(np.float32(0.18)),
            prune_max_dr=float(np.float32(0.06)), sweep_min_inliers=15)

    fcfg = FeatureConfig(alg="OS", rank=10, max_points=dims.max_points,
                         corroborate=True)
    return sim, dims, params, fcfg, refine_params


def small_config(seed: int = 0):
    """bench.py --small with refinement off."""
    from sonar_slam_torch.cloud import ICPConfig
    from sonar_slam_torch.io.simulate import SimConfig
    from sonar_slam_torch.slam import FeatureConfig, SlamDims

    icp_prod = ICPConfig(max_iterations=12, min_diff_rot=1e-3,
                         min_diff_trans=1e-2, point_to_line=True,
                         outlier_max_dist=0.5)
    sim = SimConfig(duration=90.0, speed=0.5, sonar_rate=1.0, num_ranges=192,
                    num_bearings=96, loop_radius=10.0, imu_rate=20.0,
                    seed=seed)
    dims = SlamDims(
        max_keyframes=32, max_points=128, target_capacity=512,
        nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=128, max_loops=32,
        gn_iters=3, icp=icp_prod, nssm_target_window=2, nssm_pair_refine=True,
        pair_refine_max_dt=0.35, pair_refine_max_dr=0.07,
        pair_refine_min_inliers=25)
    params = _params(dims, kf_translation=2.0, nssm_min_points=20,
                     nssm_every=1, icp_floor=(0.3, 0.3, 0.1))
    return sim, dims, params, FeatureConfig(max_points=dims.max_points,
                                            corroborate=False)


def dual_config(seed: int = 0):
    """bench.py's dual-sonar lane (bench.py:818-844), in the port's types:
    (sim, dims, params builder, FeatureConfig)."""
    import dataclasses

    import torch
    from sonar_slam_torch.slam import FeatureConfig, SlamParams

    small_sim, dims, _, _ = small_config(seed)
    sim = dataclasses.replace(small_sim, vertical_sonar=True)
    dims = dataclasses.replace(dims, refine_iters=2, refine_sweep=True,
                               refine_chain=True)

    def build(device):
        return SlamParams.default(dims, device)._replace(
            keyframe_translation=2.0, ssm_min_points=20, nssm_min_points=20,
            fuse_odometry=True, use_best_start_tf=True,
            odom_sigmas=torch.tensor([0.05, 0.05, 0.01], device=device),
            icp_odom_sigmas=torch.tensor([0.3, 0.3, 0.03], device=device))

    return sim, dims, build, FeatureConfig(max_points=dims.max_points)


def _params(dims, kf_translation, nssm_min_points, nssm_every, icp_floor):
    """bench.py's SlamParams overrides; the device is set by ``on``."""
    import torch
    from sonar_slam_torch.slam import SlamParams

    def build(device):
        return SlamParams.default(dims, device)._replace(
            keyframe_translation=kf_translation, ssm_min_points=20,
            nssm_min_points=nssm_min_points, fuse_odometry=True,
            use_best_start_tf=True, nssm_every=nssm_every,
            odom_sigmas=torch.tensor([0.05, 0.05, 0.01], device=device),
            icp_odom_sigmas=torch.tensor(icp_floor, device=device))

    return build


def check_kernel(stacks):
    """The sum kernel against its plain version; returns the kernel table
    entry. ``stacks`` are two (128, 512, 256) ping stacks on the card.

    The kernel and its plain version add the training cells in the same
    order and divide the same way, so masks and threshold maps must be equal
    bit for bit: at the main path's shape with and without the threshold map
    (without it, warps whose pixels all fail the gate skip the sums), and at
    (4, 96, 40) for CA, GOCA, SOCA and both edges."""
    import torch
    import torch.nn.functional as F
    from sonar_slam_torch.kernels.cfar_cuda import (_window_sums, cfar_detect,
                                                    cfar_plain)
    from sonar_slam_torch.kernels.cfar_factors import (
        threshold_factor_ca, threshold_factor_goca, threshold_factor_soca)

    imgs = stacks[0]
    t, g, gate = 20, 5, 65.0
    tau = threshold_factor_soca(40, 0.1)
    det_k, thr_k = cfar_detect(imgs, t, g, tau, "SOCA", gate, "extend",
                               with_threshold=True)
    det_m = cfar_detect(imgs, t, g, tau, "SOCA", gate, "extend")
    det_p, thr_p = cfar_plain(imgs, t, g, tau, "SOCA", gate, "extend")
    torch.cuda.synchronize()
    mismatch = int((det_k != det_p).sum())
    mismatch_m = int((det_m != det_p).sum())
    thr_err = float((thr_k - thr_p).abs().max())
    bitwise = bool(torch.equal(thr_k, thr_p))
    log(f"cfar SOCA extend {tuple(imgs.shape)}: mask mismatches {mismatch} "
        f"(mask-only call {mismatch_m}) of {det_p.numel()}, detections "
        f"{int(det_p.sum())}, threshold max abs err {thr_err} (bitwise "
        f"equal: {bitwise})")
    if mismatch or mismatch_m or not bitwise:
        raise RuntimeError("CFAR kernel disagrees with its plain version")

    small = imgs[:4, :96, :40].contiguous()
    for mode, tau_m in (("CA", threshold_factor_ca(40, 0.1)),
                        ("GOCA", threshold_factor_goca(40, 0.1)),
                        ("SOCA", tau)):
        for edge in ("strict", "extend"):
            dk, tk = cfar_detect(small, t, g, tau_m, mode, gate, edge,
                                 with_threshold=True)
            dm = cfar_detect(small, t, g, tau_m, mode, gate, edge)
            dp, tp = cfar_plain(small, t, g, tau_m, mode, gate, edge)
            mm = int((dk != dp).sum()) + int((dm != dp).sum())
            err = float((tk - tp).abs().max())
            log(f"cfar {mode} {edge} {tuple(small.shape)}: mismatches {mm}, "
                f"threshold max abs err {err}")
            if mm or not torch.equal(tk, tp):
                raise RuntimeError(f"CFAR {mode}/{edge} kernel disagrees")

    # the library yardstick: both window sums of every pixel by one
    # convolution of the replicate-padded stack (no threshold, no mask)
    hw = t + g
    weight = torch.zeros((2, 1, 2 * hw + 1, 1), device=imgs.device)
    weight[0, 0, :t] = 1.0  # rows r - hw ... r - g - 1
    weight[1, 0, hw + g + 1:] = 1.0  # rows r + g + 1 ... r + hw
    padded = [F.pad(x[:, None], (0, 0, hw, hw), mode="replicate")
              for x in stacks]
    sums = F.conv2d(padded[0], weight)
    lead, lag = _window_sums(imgs, t, g)
    conv_err = max(float((sums[:, 0] - lead).abs().max()),
                   float((sums[:, 1] - lag).abs().max()))
    log(f"conv2d window sums against the in-order sums: max abs diff "
        f"{conv_err} (sums up to {float(lead.max())})")
    del sums, lead, lag

    def kern(x):
        cfar_detect(x, t, g, tau, "SOCA", gate, "extend")

    def kern_thr(x):
        cfar_detect(x, t, g, tau, "SOCA", gate, "extend", with_threshold=True)

    def plain(x):
        cfar_plain(x, t, g, tau, "SOCA", gate, "extend")

    def library(xp):
        F.conv2d(xp, weight)

    # plain, kernel, kernel, plain on the same card, alternating stacks
    p1 = cuda_time_ms(plain, stacks)
    k1 = cuda_time_ms(kern, stacks)
    k2 = cuda_time_ms(kern, stacks)
    p2 = cuda_time_ms(plain, stacks)
    kt = cuda_time_ms(kern_thr, stacks)
    floor = cuda_time_ms(
        lambda x: cfar_detect(x, t, g, tau, "SOCA", 1e30, "extend"), stacks)
    lib = cuda_time_ms(library, padded)
    ms = min(k1, k2)
    bound_ms, bound_by = bound(imgs, 2 * t * gated_pixels(imgs, gate))
    # with the threshold map every pixel's sums are needed (2 * t adds)
    thr_bound, thr_by = bound(imgs, 2 * t * imgs.numel(), with_threshold=True)
    log(f"cfar SOCA extend {tuple(imgs.shape)} mask only ms: kernel {k1} {k2}, "
        f"plain {p1} {p2}; with the threshold map {kt} (bound {thr_bound} "
        f"({thr_by}), share {thr_bound / kt}); with a gate no pixel "
        f"passes (no window arithmetic) {floor}; conv2d window sums {lib}; "
        f"bound {bound_ms} ({bound_by}), share {bound_ms / ms}")
    return {"name": "cfar_sum_kernel (CA/SOCA/GOCA, fused intensity gate)",
            "route": "cuda",
            "source": "sonar_slam_torch/kernels/csrc/cfar.cu",
            "replaces": "sonar_slam_tpu/kernels/cfar_pallas.py:32",
            "launches": 0, "max_abs_err": thr_err,
            "ms": ms, "plain_ms": min(p1, p2), "bound_ms": bound_ms,
            "bound_by": bound_by, "roofline_share": bound_ms / ms,
            "library_ms": lib, "ms_with_threshold": kt,
            "bound_ms_with_threshold": thr_bound,
            "bound_by_with_threshold": thr_by,
            "roofline_share_with_threshold": thr_bound / kt,
            "library_call": "torch.nn.functional.conv2d, window sums only"}


def check_os_kernel(stacks):
    """The two OS kernels against their plain version; returns the kernel
    table entry.

    The mask path (``cfar_os_mask_kernel``: mask only, tau > 0, the feature
    path's call) must give the plain version's mask bit for bit; the
    threshold path (``cfar_os_kernel``, the exact selection) its mask and
    threshold map. Both on the float pings and on an integer-valued copy, at
    (128, 512, 256) with rank 10 (the main path's call) and at (4, 96, 40),
    which crosses both border bands, with ranks 0, 10 and 39."""
    import torch
    from sonar_slam_torch.kernels.cfar_cuda import cfar_detect, cfar_os_plain
    from sonar_slam_torch.kernels.cfar_factors import threshold_factor_os

    imgs = stacks[0]
    t, g, gate, rank = 20, 5, 65.0, 10
    tau = threshold_factor_os(40, rank, 0.1)
    small = imgs[:4, :96, :40].contiguous()
    cases = [(imgs, rank, "extend")] + [
        (small, k, edge) for k in (0, 10, 39) for edge in ("strict", "extend")]
    thr_err = 0.0
    for kind, prep in (("float", None), ("integer", torch.round)):
        for case, k, edge in cases:
            view = case if prep is None else prep(case)
            dm = cfar_detect(view, t, g, tau, "OS", gate, edge, rank=k)
            dk, tk = cfar_detect(view, t, g, tau, "OS", gate, edge,
                                 with_threshold=True, rank=k)
            dp, tp = cfar_os_plain(view, t, g, k, tau, gate, edge)
            torch.cuda.synchronize()
            mm_mask = int((dm != dp).sum())
            mm = int((dk != dp).sum())
            err = float((tk - tp).abs().max())
            bitwise = bool(torch.equal(tk, tp))
            log(f"cfar OS {edge} rank {k} {kind} {tuple(view.shape)}: mask "
                f"path mismatches {mm_mask}, threshold path mismatches {mm} "
                f"of {dp.numel()}, detections {int(dp.sum())}, threshold max "
                f"abs err {err} (bitwise equal: {bitwise})")
            if mm_mask or mm or not bitwise:
                raise RuntimeError(f"OS kernel disagrees ({edge}, rank {k}, "
                                   f"{kind})")
            if case is imgs and prep is None:
                thr_err = err
            del view, dm, dk, tk, dp, tp

    # which path each warp takes: a warp holds 8 rows x 64 columns of one
    # frame (csrc/cfar.cu's tile); up to 128 gated pixels go on the block's
    # list, more take the strip path
    B, R, C = imgs.shape
    gated = (imgs > gate).view(B, R // 8, 8, C // 64, 64).sum((2, 4))
    log(f"cfar OS mask path: {gated_pixels(imgs, gate)} of {imgs.numel()} "
        f"pixels over the gate; warps with none "
        f"{100 * float((gated == 0).float().mean()):.2f}%, on the strip path "
        f"{100 * float((gated > 128).float().mean()):.3f}%, most in one warp "
        f"{int(gated.max())}")

    # the library yardstick: the k-th smallest of every pixel's prebuilt
    # (128, 512, 256, 40) window stack by one torch.kthvalue (no threshold,
    # no mask)
    rows = torch.arange(R, device=imgs.device)
    offsets = [o for o in range(-t - g, t + g + 1) if abs(o) > g]
    windows = [torch.stack([x[:, torch.clamp(rows + o, 0, R - 1), :]
                            for o in offsets], dim=-1) for x in stacks]
    kth = torch.kthvalue(windows[0], rank + 1, dim=-1).values
    _, tp = cfar_os_plain(imgs, t, g, rank, 1.0, None, "extend")
    if not torch.equal(kth, tp):
        raise RuntimeError("torch.kthvalue disagrees with the sorted window")
    del kth, tp

    def kern(x):
        cfar_detect(x, t, g, tau, "OS", gate, "extend", rank=rank)

    def kern_thr(x):
        cfar_detect(x, t, g, tau, "OS", gate, "extend", with_threshold=True,
                    rank=rank)

    def kern_no_gate(x):
        cfar_detect(x, t, g, tau, "OS", None, "extend", rank=rank)

    def plain(x):
        cfar_os_plain(x, t, g, rank, tau, gate, "extend")

    def library(w):
        torch.kthvalue(w, rank + 1, dim=-1)

    # plain, kernel, kernel, plain on the same card, alternating stacks
    p1 = cuda_time_ms(plain, stacks, reps=4, warmup=1)
    k1 = cuda_time_ms(kern, stacks)
    k2 = cuda_time_ms(kern, stacks)
    p2 = cuda_time_ms(plain, stacks, reps=4, warmup=1)
    kt = cuda_time_ms(kern_thr, stacks)
    kn = cuda_time_ms(kern_no_gate, stacks)
    floor = cuda_time_ms(lambda x: cfar_detect(x, t, g, tau, "OS", 1e30,
                                               "extend", rank=rank), stacks)
    same_bytes = cuda_time_ms(lambda x: x > gate, stacks)
    lib = cuda_time_ms(library, windows, reps=4, warmup=1)
    del windows
    ms = min(k1, k2)
    bound_ms, bound_by = bound(imgs, 2 * t * gated_pixels(imgs, gate))
    # with the threshold map every pixel needs its k-th smallest of 2 * t
    # cells: at least 2 * t - 1 comparisons
    thr_bound, thr_by = bound(imgs, (2 * t - 1) * imgs.numel(),
                              with_threshold=True)
    log(f"cfar OS threshold path bound {thr_bound} ({thr_by}), share "
        f"{thr_bound / kt}")
    log(f"cfar OS extend rank 10 {tuple(imgs.shape)} ms: mask path {k1} {k2}, "
        f"plain {p1} {p2}; threshold path (selection) {kt}; mask path "
        f"without the gate (every warp on the strip path) {kn}; with a gate "
        f"no pixel passes (no window arithmetic) {floor}; imgs > gate (the "
        f"same bytes in one elementwise call) {same_bytes}; "
        f"torch.kthvalue on the "
        f"window stack {lib}; bound {bound_ms} ({bound_by}), share "
        f"{bound_ms / ms}")
    return {"name": "cfar_os_mask_kernel (OS mask path, exact rank count, "
                    "fused intensity gate; threshold path cfar_os_kernel)",
            "route": "cuda",
            "source": "sonar_slam_torch/kernels/csrc/cfar.cu",
            "replaces": "sonar_slam_tpu/kernels/cfar_pallas.py:63",
            "launches": 0, "max_abs_err": thr_err,
            "ms": ms, "plain_ms": min(p1, p2), "bound_ms": bound_ms,
            "bound_by": bound_by, "roofline_share": bound_ms / ms,
            "library_ms": lib, "ms_with_threshold": kt,
            "bound_ms_with_threshold": thr_bound,
            "bound_by_with_threshold": thr_by,
            "roofline_share_with_threshold": thr_bound / kt,
            "library_call": "torch.kthvalue on the window stack, k-th "
                            "smallest only"}


def run_os_path(bag, dev) -> int:
    """The OS slice at full width: replay with refinement, the mapping
    stage and the scores, held to the bands above. Returns the OS launch
    count of the run."""
    import numpy as np
    import torch
    from sonar_slam_torch.kernels import cfar_cuda
    from sonar_slam_torch.mapping import map_metrics
    from sonar_slam_torch.pipeline import (ate_heading_deg, ate_rmse,
                                           loop_metrics, occupancy_map, replay)

    sim, dims, params_on, fcfg, refine_on = full_os_config(seed=0)
    params, rparams = params_on(dev), refine_on(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cfar_cuda.cfar_detect.launches = 0
    cfar_cuda.cfar_detect.kernel_launches["os_mask"] = 0
    t0 = time.perf_counter()
    res = replay(bag, fcfg, params, dims, dev, refine_params=rparams)
    t1 = time.perf_counter()
    occ, mcfg = occupancy_map(res.carry, bag.geometry, dims.max_keyframes)
    torch.cuda.synchronize()
    stage_s = dict(res.stage_s, mapping=time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    launches = cfar_cuda.cfar_detect.launches
    mask_launches = cfar_cuda.cfar_detect.kernel_launches["os_mask"]
    peak = torch.cuda.max_memory_allocated(dev)

    nk = res.num_keyframes
    truth = bag.true_pose_at_ping[res.keyframe_ping_idx]
    ate = ate_rmse(res.trajectory, truth)
    ate_deg = ate_heading_deg(res.trajectory, truth)
    lm = loop_metrics(res.carry, truth, dims.nssm_min_st_sep,
                      prox_radius=0.5 * dims.max_range)
    mm = map_metrics(occ.cpu().numpy(), mcfg, bag.world_points, truth,
                     res.trajectory, dims.max_range, dims.half_aperture)
    nl = res.carry.num_loops
    log(f"OS path: {nk} keyframes, {nl} loops, ATE {ate:.4f} m / "
        f"{ate_deg:.3f} deg, loop precision {lm['precision']} recall "
        f"{lm['recall']} (median error {lm['loop_err_median_cm']} cm), map "
        f"precision {mm['precision']} recall {mm['recall']} chamfer "
        f"{mm['chamfer_cm']} cm ({mm['occupied_cells']} occupied cells), "
        f"DVL log-scale {res.carry.graph.log_scale.tolist()}")
    log(f"OS path: stages s {json.dumps(stage_s)}, wall {wall:.2f} s, peak "
        f"memory {peak / 2**20:.1f} MiB, CFAR launches {launches}, of them "
        f"OS mask kernel {mask_launches}")
    log(f"OS path, for scale only: the JAX package's full config with SOCA "
        f"and refinement on a TPU (BENCH_r05.json) {json.dumps(BENCH_R05_SOCA)}")
    if not np.isfinite(res.trajectory).all():
        raise RuntimeError("OS path: trajectory not finite")
    if mask_launches < 3 or mask_launches != launches:
        raise RuntimeError(f"OS path made {launches} CFAR launches, "
                           f"{mask_launches} of the OS mask kernel; expected "
                           f">= 3, all of it")
    checks = {
        "keyframes": nk == FULL_KEYFRAMES,
        "loops": nl == OS_LOOPS,
        "ATE m": round(ate, 4) == OS_ATE_M,
        "ATE deg": round(ate_deg, 3) == OS_ATE_DEG,
        **{f"map {k}": mm[k] == v for k, v in OS_MAP.items()},
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"OS path differs from its expected result: {failed}")
    return mask_launches


def check_small(dev):
    """bench.py --small (refinement off) on the card, checked by stage.

    The first loop of this survey (keyframe 8 against keyframe 0) is
    ill-conditioned: all 12 starts of its multi-start ICP end with the same
    25 inliers, spread over 2.3 m, and the first start's solution can move
    by 0.78 m when the inputs move by a few microns. The JAX package itself,
    fed the port's dead-reckoning poses (at most 1.7e-5 m from its own),
    ends up 0.17 m from its own result. The golden file holds both JAX
    results (``trajectory`` and ``trajectory_port_dr``).

    So the card's whole replay must give the JAX keyframes and loop count,
    a trajectory within SCAN_ATOL_M of one of the two JAX results and an ATE
    within SMALL_ATE_BAND_M of the JAX result's, either way. Each stage is
    held tightly to the port's CPU run on the same inputs (the feature
    clouds, and the SLAM scan fed the CPU's feature clouds). A second replay
    on the card, after the allocator's free memory is filled with NaN, must
    repeat the first bit for bit.
    """
    import numpy as np
    import torch
    from sonar_slam_torch.io.simulate import simulate_bag
    from sonar_slam_torch.pipeline import ate_heading_deg, ate_rmse, replay
    from sonar_slam_torch.slam import KeyframeInput, slam_scan

    sim, dims, params_on, fcfg = small_config(seed=0)
    bag = simulate_bag(sim)
    ref = np.load(os.path.join(HERE, "tests", "golden", "small_norefine_traj.npz"))
    cpu = replay(bag, fcfg, params_on("cpu"), dims, "cpu")
    gpu = replay(bag, fcfg, params_on(dev), dims, dev)
    torch.full((1 << 28,), float("nan"), device=dev)  # freed, stays cached
    again = replay(bag, fcfg, params_on(dev), dims, dev)
    log(f"small config on the card, second run after a NaN fill: trajectory "
        f"max abs diff {float(np.abs(again.trajectory - gpu.trajectory).max())} m")
    if not np.array_equal(again.trajectory, gpu.trajectory):
        raise RuntimeError("small-config replay on the card does not repeat")
    nk = gpu.num_keyframes
    truth = bag.true_pose_at_ping[ref["keyframe_ping_idx"]]
    if not (np.array_equal(gpu.keyframe_ping_idx, ref["keyframe_ping_idx"])
            and np.array_equal(cpu.keyframe_ping_idx, ref["keyframe_ping_idx"])):
        raise RuntimeError("small config: keyframes differ from the JAX result")

    c, g = cpu.carry, gpu.carry
    mask_mm = int((c.pmasks != g.pmasks.cpu()).sum())
    pts_err = float((c.points - g.points.cpu()).abs().max())
    conf_err = float((c.pconf - g.pconf.cpu()).abs().max())
    log(f"small config features, card vs CPU: mask mismatches {mask_mm}, "
        f"points max abs diff {pts_err} m, conf max abs diff {conf_err}")
    if mask_mm or pts_err > 1e-4 or conf_err > 0:
        raise RuntimeError("feature clouds on the card differ from the CPU's")

    K = dims.max_keyframes
    frames = KeyframeInput(
        time=c.times.to(dev), dr_pose3=c.dr_poses3.to(dev),
        points=c.points.to(dev), pmask=c.pmasks.to(dev),
        valid=torch.arange(K, device=dev) < nk, conf=c.pconf.to(dev))
    scan, _ = slam_scan(frames, params_on(dev), dims)
    scan_err = float((scan.poses[:nk].cpu() - c.poses[:nk]).abs().max())
    log(f"small config SLAM scan on the CPU's clouds, card vs CPU: pose max "
        f"abs diff {scan_err} m, loops {scan.num_loops} vs {c.num_loops}")
    if scan_err > SCAN_ATOL_M or scan.num_loops != c.num_loops:
        raise RuntimeError("SLAM scan on the card differs from the CPU's")

    jax_err = float(np.abs(cpu.trajectory - ref["trajectory"]).max())
    ates = [(ate_rmse(r, truth), ate_heading_deg(r, truth))
            for r in (ref["trajectory"], cpu.trajectory, gpu.trajectory)]
    card_errs = [float(np.abs(gpu.trajectory - ref[k]).max())
                 for k in ("trajectory", "trajectory_port_dr")]
    log(f"small config vs JAX: trajectory max abs diff CPU port {jax_err} m, "
        f"card {card_errs[0]} m (to the JAX result on the port's odometry "
        f"{card_errs[1]} m); first loop (keyframe 8 to 0) CPU "
        f"{c.loops_tf[0].tolist()} card {g.loops_tf[0].tolist()}; loops JAX "
        f"{int(ref['num_loops'])} CPU {c.num_loops} card {g.num_loops}; ATE "
        f"m/deg JAX {ates[0]} CPU {ates[1]} card {ates[2]}")
    if (jax_err > SCAN_ATOL_M or min(card_errs) > SCAN_ATOL_M
            or g.num_loops != int(ref["num_loops"])
            or abs(ates[2][0] - ates[0][0]) > SMALL_ATE_BAND_M):
        raise RuntimeError("small-config replay disagrees with the JAX result")


def check_small_refine(dev):
    """bench.py --small with refinement on (tests/test_golden.py's
    configuration) on the card, twice, against the JAX package's results.

    The survey's ill-conditioned first loop (see ``check_small``) shows here
    too: the JAX package on its own dead reckoning logs 9 loops
    (tests/golden/small_traj.npz), and fed the port's dead-reckoning poses 8
    loops, 0.081 m away (tests/golden/small_traj_port_dr.npz). So the card
    must give the JAX keyframe pings, and the loop count and a trajectory
    within SCAN_ATOL_M of one of the two results. The second replay, after
    the allocator's free memory is filled with NaN, must repeat the first
    bit for bit. The CPU tests hold the port on the CPU to the first result
    (tests/test_torch_replay_refine.py)."""
    import dataclasses

    import numpy as np
    import torch
    from sonar_slam_torch.io.simulate import simulate_bag
    from sonar_slam_torch.pipeline import ate_heading_deg, ate_rmse, replay

    sim, dims, params_on, fcfg = small_config(seed=0)
    dims = dataclasses.replace(dims, refine_iters=2, refine_sweep=True,
                               refine_chain=True)
    bag = simulate_bag(sim)
    refs = {name: np.load(os.path.join(HERE, "tests", "golden", name))
            for name in ("small_traj.npz", "small_traj_port_dr.npz")}
    t0 = time.perf_counter()
    gpu = replay(bag, fcfg, params_on(dev), dims, dev)
    wall = time.perf_counter() - t0
    torch.full((1 << 28,), float("nan"), device=dev)  # freed, stays cached
    again = replay(bag, fcfg, params_on(dev), dims, dev)
    repeat = float(np.abs(again.trajectory - gpu.trajectory).max())
    kf = refs["small_traj.npz"]["keyframe_ping_idx"]
    truth = bag.true_pose_at_ping[kf]
    match = {}
    for name, ref in refs.items():
        err = (float(np.abs(gpu.trajectory - ref["trajectory"]).max())
               if gpu.trajectory.shape == ref["trajectory"].shape
               else float("inf"))
        match[name] = (int(ref["num_loops"]), err,
                       ate_rmse(ref["trajectory"], truth))
    log(f"small config with refinement on the card: {gpu.num_keyframes} "
        f"keyframes, {gpu.carry.num_loops} loops, ATE m/deg "
        f"{(ate_rmse(gpu.trajectory, truth), ate_heading_deg(gpu.trajectory, truth))}; "
        f"JAX results (loops, trajectory max abs diff m, ATE m): "
        f"{json.dumps(match)}; stages s {json.dumps(gpu.stage_s)}, wall "
        f"{wall:.2f} s; second run after a NaN fill: max abs diff {repeat} m")
    if not np.array_equal(again.trajectory, gpu.trajectory):
        raise RuntimeError("refined small-config replay on the card does not "
                           "repeat")
    if not np.array_equal(gpu.keyframe_ping_idx, kf):
        raise RuntimeError("refined small config: keyframes differ from JAX")
    if not any(loops == gpu.carry.num_loops and err <= SCAN_ATOL_M
               for loops, err, _ in match.values()):
        raise RuntimeError("refined small-config replay disagrees with both "
                           "JAX results")


def ping_odometry(res, bag, frontend: str):
    """A replay's odometry at the pings: the front end's ticks are the DVL
    samples (dead reckoning) or the IMU events (Kalman)."""
    from sonar_slam_torch.io.dataset import match_pings_to_ticks

    ticks = bag.imu_time if frontend == "kalman" else bag.dvl_time
    idx, _ = match_pings_to_ticks(bag.ping_time, ticks)
    return res.dr_poses_at_ticks[idx]


def run_frontend_path(bag, dev, frontend: str) -> int:
    """Phase 4's survey through ``frontend`` ("dr_gyro" or "kalman"), held
    to the JAX package's odometry and keyframes and to the port's own first
    card result. Returns the sum kernel's launch count of the run."""
    import dataclasses

    import numpy as np
    import torch
    from sonar_slam_torch.kernels import cfar_cuda
    from sonar_slam_torch.pipeline import ate_heading_deg, ate_rmse, replay

    sim, dims, params_on, fcfg = full_config(seed=0)
    if frontend == "kalman":
        dims = dataclasses.replace(dims, aggregate_with_dr_basis=False)
    ref = np.load(os.path.join(HERE, "tests", "golden",
                               "full_frontends_odometry.npz"))
    params = params_on(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cfar_cuda.cfar_detect.launches = 0
    cfar_cuda.cfar_detect.kernel_launches["sum"] = 0
    t0 = time.perf_counter()
    res = replay(bag, fcfg, params, dims, dev, frontend=frontend)
    wall = time.perf_counter() - t0
    launches = cfar_cuda.cfar_detect.launches
    sum_launches = cfar_cuda.cfar_detect.kernel_launches["sum"]
    peak = torch.cuda.max_memory_allocated(dev)
    truth = bag.true_pose_at_ping[res.keyframe_ping_idx]
    ate = ate_rmse(res.trajectory, truth)
    ate_deg = ate_heading_deg(res.trajectory, truth)
    dr_ate = ate_rmse(res.dr_trajectory, truth)
    odo = ping_odometry(res, bag, frontend)
    want = ref[f"{frontend}_ping_pose3"]
    pos_err = float(np.abs(odo[:, :3] - want[:, :3]).max())
    ang_err = float(np.abs(odo[:, 3:] - want[:, 3:]).max())
    kf_ok = np.array_equal(res.keyframe_ping_idx,
                           ref[f"{frontend}_keyframe_ping_idx"])
    nl = res.carry.num_loops
    log(f"{frontend} path: {res.num_keyframes} keyframes (JAX keyframe pings "
        f"equal: {kf_ok}), {nl} loops, ATE {ate:.4f} m / {ate_deg:.3f} deg (DR "
        f"{dr_ate:.4f} m), odometry at the pings against JAX: max abs diff "
        f"{pos_err} m, {ang_err} rad; wall {wall:.2f} s, stages s "
        f"{json.dumps(res.stage_s)}, peak memory {peak / 2**20:.1f} MiB, CFAR "
        f"launches {launches}, of them the sum kernel {sum_launches}")
    if not np.isfinite(res.trajectory).all():
        raise RuntimeError(f"{frontend} path: trajectory not finite")
    if sum_launches < 1 or sum_launches != launches:
        raise RuntimeError(f"{frontend} path made {launches} CFAR launches, "
                           f"{sum_launches} of the sum kernel")
    if not kf_ok or pos_err > ODO_POS_ATOL_M or ang_err > ODO_ANG_ATOL:
        raise RuntimeError(f"{frontend} path: odometry or keyframes differ "
                           f"from the JAX package's")
    got = (res.num_keyframes, nl, round(ate, 4), round(ate_deg, 3))
    expected = FRONTEND_EXPECTED[frontend]
    if expected is not None and got != expected:
        raise RuntimeError(f"{frontend} path: (keyframes, loops, ATE m, ATE "
                           f"deg) {got}, expected {expected}")
    return sum_launches


def time_kalman_scan(bag, dev) -> dict:
    """The Kalman front end alone on the card: its wall time (twice) and,
    under ``torch.profiler``, its kernel launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sonar_slam_torch.pipeline import odometry

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        odometry(bag, dev, "kalman")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        odometry(bag, dev, "kalman")
        torch.cuda.synchronize()
    names = {}
    for e in prof.key_averages():
        if "LaunchKernel" in e.key or e.key.startswith("cuLaunch"):
            names[e.key] = e.count
    n_events = len(bag.imu_time) + len(bag.dvl_time) + len(bag.depth_time)
    out = {"wall_s": walls, "launch_calls": names,
           "launches": sum(names.values()), "events": n_events}
    log(f"kalman scan on the card ({n_events} events): wall s {walls}, kernel "
        f"launch calls under torch.profiler {json.dumps(names)}")
    return out


def run_dual_lane(dev, entry) -> int:
    """bench.py's dual-sonar lane on the card, twice; see the module doc,
    phase 10. Adds the vertical call's numbers to the sum kernel's entry and
    returns the lane's sum-kernel launches of one replay."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from sonar_slam_torch.io.simulate import simulate_bag
    from sonar_slam_torch.kernels import cfar_cuda
    from sonar_slam_torch.kernels.cfar_cuda import cfar_detect, cfar_plain
    from sonar_slam_torch.kernels.cfar_factors import threshold_factor_soca
    from sonar_slam_torch.pipeline import dual_sonar_metrics, replay
    from sonar_slam_torch.slam import RefineParams
    from sonar_slam_torch.slam.dual_sonar import ElevationSpec, fuse_frames_global

    sim, dims, params_on, fcfg = dual_config(seed=0)
    bag = simulate_bag(sim)
    ref = np.load(os.path.join(HERE, "tests", "golden", "dual_lane.npz"))
    runs = []
    for _ in range(2):  # bench.py times the second run
        params, rparams = params_on(dev), RefineParams.default(dev)
        torch.cuda.synchronize()
        cfar_cuda.cfar_detect.launches = 0
        cfar_cuda.cfar_detect.kernel_launches["sum"] = 0
        t0 = time.perf_counter()
        res = replay(bag, fcfg, params, dims, dev, use_vertical=True,
                     refine_params=rparams)
        wall = time.perf_counter() - t0
        runs.append((res, wall, cfar_cuda.cfar_detect.launches,
                     cfar_cuda.cfar_detect.kernel_launches["sum"]))
    res, wall, launches, sum_launches = runs[1]
    m = dual_sonar_metrics(res, bag, sim)
    lane = {"z_rmse_m": m["z_rmse_m"], "z_points": m["z_points"],
            "elevation_cells": m["elevation_cells"], "wall_s": wall,
            "first_wall_s": runs[0][1], "xrealtime": sim.duration / wall}
    jax_lane = {k: float(ref[k]) for k in ("z_rmse_m", "z_points",
                                            "elevation_cells")}
    kf_ok = np.array_equal(res.keyframe_ping_idx, ref["keyframe_ping_idx"])
    nl = res.carry.num_loops
    repeat = float(np.abs(res.trajectory - runs[0][0].trajectory).max())
    traj_err = (float(np.abs(res.trajectory - ref["trajectory"]).max())
                if res.trajectory.shape == ref["trajectory"].shape else None)
    log(f"dual lane: {res.num_keyframes} keyframes (JAX keyframe pings equal: "
        f"{kf_ok}), {nl} loops (JAX {int(ref['num_loops'])}), trajectory max "
        f"abs diff to JAX {traj_err} m, to the first run {repeat} m; "
        f"dual_sonar {json.dumps(lane)}; JAX result {json.dumps(jax_lane)}; "
        f"stages s {json.dumps(res.stage_s)}; CFAR launches {launches}, of "
        f"them the sum kernel {sum_launches}")
    log(f"dual lane, for scale only: the JAX package's lane on a TPU "
        f"(BENCH_r05.json) {json.dumps(BENCH_R05_DUAL)}")

    # (a) the vertical call: the kernel against the plain version, the JAX
    # mask, and its time beside its bytes bound
    K = dims.max_keyframes
    kf = res.keyframe_ping_idx
    sel = np.concatenate([kf, np.zeros(K - len(kf), np.int64)])
    t, g, gate = fcfg.ntc // 2, fcfg.ngc // 2, fcfg.threshold
    tau = threshold_factor_soca(fcfg.ntc, fcfg.pfa)
    stacks = [torch.as_tensor(bag.vertical_images[np.clip(sel + o, 0, len(
        bag.ping_time) - 1)], dtype=torch.float32, device=dev).contiguous()
        for o in (0, 1)]
    vimgs = stacks[0]
    det_k = cfar_detect(vimgs, t, g, tau, "SOCA", gate, "strict")
    det_p, thr_p = cfar_plain(vimgs, t, g, tau, "SOCA", gate, "strict")
    shape = tuple(int(x) for x in ref["vdet_shape"])
    jdet = torch.as_tensor(np.unpackbits(ref["vdet_bits"])[:int(np.prod(shape))]
                           .reshape(shape).astype(bool), device=dev)
    plain_mm = int((det_k != det_p).sum())
    jdiff = det_k != jdet
    margin = ((vimgs - thr_p).abs() / thr_p.abs().clamp(min=1e-30))[jdiff]
    jax_mm = int(jdiff.sum())
    worst = float(margin.max()) if jax_mm else 0.0
    log(f"dual lane vertical mask {tuple(vimgs.shape)} strict, gated: against "
        f"the plain version {plain_mm} mismatches of {det_p.numel()} "
        f"({int(det_p.sum())} detections); against the JAX mask {jax_mm} "
        f"pixels differ, the farthest at a relative {worst} from its "
        f"threshold")
    if plain_mm or (jax_mm and worst > 1e-5):
        raise RuntimeError("dual lane: the vertical mask disagrees")
    k1 = cuda_time_ms(lambda x: cfar_detect(x, t, g, tau, "SOCA", gate,
                                            "strict"), stacks)
    k2 = cuda_time_ms(lambda x: cfar_detect(x, t, g, tau, "SOCA", gate,
                                            "strict"), stacks)
    p1 = cuda_time_ms(lambda x: cfar_plain(x, t, g, tau, "SOCA", gate,
                                           "strict"), stacks)
    # at this size the host's dispatch paces the calls timed above; queued
    # behind a sleeping kernel, the launches run back to back
    dev_ms = queued_ms(lambda x: cfar_detect(x, t, g, tau, "SOCA", gate,
                                             "strict"), stacks)
    rows = vimgs.shape[1] - 2 * (t + g)  # strict: the rows that may detect
    ops = 2 * t * int((vimgs[:, t + g:t + g + rows] > gate).sum())
    vb, vby = bound(vimgs, ops)
    # the library yardstick at this shape: both window sums of every row
    # that may detect, by one convolution (strict edge: no padding)
    hw = t + g
    weight = torch.zeros((2, 1, 2 * hw + 1, 1), device=dev)
    weight[0, 0, :t] = 1.0
    weight[1, 0, hw + g + 1:] = 1.0
    vstacks = [x[:, None] for x in stacks]
    lib_dispatch = cuda_time_ms(lambda x: F.conv2d(x, weight), vstacks)
    lib_ms = queued_ms(lambda x: F.conv2d(x, weight), vstacks)
    log(f"dual lane vertical call ms: by CUDA events {k1} {k2} (paced by the "
        f"host's dispatch), queued behind a sleeping kernel {dev_ms}, plain "
        f"{p1}; conv2d window sums queued {lib_ms}, by CUDA events "
        f"{lib_dispatch}; bound {vb} ({vby}); the "
        f"{vimgs.numel() * 5 / 1e6:.2f} MB stay in L2")
    entry.update(vertical_ms=dev_ms, vertical_dispatch_ms=min(k1, k2),
                 vertical_plain_ms=p1, vertical_bound_ms=vb,
                 vertical_bound_by=vby, vertical_shape=list(vimgs.shape),
                 vertical_library_ms=lib_ms,
                 vertical_library_dispatch_ms=lib_dispatch)

    # (b) the fusion stage on the golden's JAX inputs
    x0, y0, rs, nx, ny = ref["elevation_spec"]
    out = fuse_frames_global(
        torch.as_tensor(ref["points"], device=dev),
        torch.as_tensor(ref["pmasks"], device=dev), vimgs, jdet,
        torch.as_tensor(ref["poses"], device=dev), bag.vertical_geometry,
        ElevationSpec(float(x0), float(y0), float(rs), int(nx), int(ny)))
    names = ("points3d", "points3d_mask", "floor_points3d", "floor_weights",
             "elevation_z", "elevation_w")
    errs = {}
    for name, a in zip(names, (*out[:4], out[4].z, out[4].w)):
        a = a.cpu().numpy().astype(np.float64)
        b = ref[name].astype(np.float64)
        errs[name] = float(np.abs(a - b).max())
        if not np.allclose(a, b, rtol=1e-5, atol=2e-5):
            raise RuntimeError(f"dual lane fusion stage: {name} differs from "
                               f"the JAX result")
    log(f"dual lane fusion stage on the JAX inputs, max abs diff to the JAX "
        f"outputs: {json.dumps(errs)}")

    # (c) the whole lane
    if not np.array_equal(res.trajectory, runs[0][0].trajectory):
        raise RuntimeError("dual lane: the second replay differs from the first")
    if not kf_ok or abs(m["z_rmse_m"] - jax_lane["z_rmse_m"]) > DUAL_Z_BAND_M:
        raise RuntimeError("dual lane: keyframes or z RMSE differ from the "
                           "JAX result")
    if sum_launches != 2 or launches != 2:
        raise RuntimeError(f"dual lane made {launches} CFAR launches, "
                           f"{sum_launches} of the sum kernel; expected 2 "
                           f"(horizontal and vertical), both of it")
    return sum_launches


# phase 11: ROS message definitions and serializers of the BlueROV topics
# (the reference's raw sensor topics; pings as raw sensor_msgs/Image)
_HEADER_DEF = "MSG: std_msgs/Header\nuint32 seq\ntime stamp\nstring frame_id\n"
_SEP = "=" * 80 + "\n"
IMU_DEF = ("Header header\ngeometry_msgs/Quaternion orientation\n" + _SEP
           + _HEADER_DEF + _SEP + "MSG: geometry_msgs/Quaternion\n"
           "float64 x\nfloat64 y\nfloat64 z\nfloat64 w\n")
DVL_DEF = ("Header header\ngeometry_msgs/Vector3 velocity\nfloat64 altitude\n"
           + _SEP + _HEADER_DEF + _SEP + "MSG: geometry_msgs/Vector3\n"
           "float64 x\nfloat64 y\nfloat64 z\n")
DEPTH_DEF = ("Header header\nfloat64 depth\nfloat64 temperature\n" + _SEP
             + _HEADER_DEF)
PING_DEF = ("Header header\nsonar_oculus/OculusFire fire_msg\nint32 ping_id\n"
            "sensor_msgs/Image ping\nint16[] bearings\nfloat64 range_resolution\n"
            "uint32 num_ranges\nuint32 num_beams\n" + _SEP + _HEADER_DEF + _SEP
            + "MSG: sonar_oculus/OculusFire\nHeader header\nuint8 mode\n"
            "uint8 gamma\nuint8 flags\nfloat64 range\nfloat64 gain\n"
            "float64 speed_of_sound\nfloat64 salinity\n" + _SEP
            + "MSG: sensor_msgs/Image\nHeader header\nuint32 height\n"
            "uint32 width\nstring encoding\nuint8 is_bigendian\nuint32 step\n"
            "uint8[] data\n")


def _stamp(t: float) -> tuple[int, int]:
    secs = int(t)
    return secs, int(round((t - secs) * 1e9))


def _ser_header(seq: int, t: float, frame: str) -> bytes:
    import struct

    b = frame.encode()
    return struct.pack("<III", seq, *_stamp(t)) + struct.pack("<I", len(b)) + b


def _ser_ping(seq, t, gamma, img, bearings_cdeg, res):
    """An OculusPing with a raw 8-bit sensor_msgs/Image payload."""
    import struct

    import numpy as np

    h, w = img.shape
    enc = b"mono8"
    out = _ser_header(seq, t, "sonar") + _ser_header(seq, t, "sonar")
    out += struct.pack("<BBB", 2, gamma, 0) + struct.pack("<dddd", 30.0, 20.0,
                                                          1500.0, 0.0)
    out += struct.pack("<i", seq) + _ser_header(seq, t, "sonar")
    out += struct.pack("<II", h, w) + struct.pack("<I", len(enc)) + enc
    out += struct.pack("<BI", 0, w) + struct.pack("<I", h * w) + img.tobytes()
    b = np.asarray(bearings_cdeg, "<i2")
    out += struct.pack("<I", len(b)) + b.tobytes()
    return out + struct.pack("<dI", res, h) + struct.pack("<I", len(b))


def run_bag_seam(dev, work: str) -> int:
    """Phase 11: a small survey through a genuine lz4 bag, ``cli.convert_bag``
    and ``cli.replay`` on the card, against ``pipeline.replay`` of the same
    quantized arrays in process. Returns the CLI run's sum-kernel launches."""
    import struct

    import numpy as np
    import torch
    from sonar_slam_torch.cli import convert_bag
    from sonar_slam_torch.cli import replay as replay_cli
    from sonar_slam_torch.io.config import load_feature_config, load_slam_config
    from sonar_slam_torch.io.rosbag import ROS_TOPICS, _quat_to_rpy, write_bag
    from sonar_slam_torch.io.simulate import SimConfig, SyntheticBag, simulate_bag
    from sonar_slam_torch.kernels import cfar_cuda
    from sonar_slam_torch.pipeline import replay
    from sonar_slam_torch.slam.sonar import SonarGeometry

    # tests/test_torch_cli.py's survey: 13 keyframes and 4 loops
    sim = SimConfig(duration=40.0, speed=0.5, sonar_rate=1.0, num_ranges=96,
                    num_bearings=48, loop_radius=2.5, imu_rate=20.0, seed=2)
    bag = simulate_bag(sim)
    gamma = 127
    # the sonar's gamma compression to 8 bits, the wire's quantization
    x = np.clip(bag.ping_images.astype(np.float64) / 255.0, 0.0, 1.0)
    imgs_q = np.round(255.0 * x ** (gamma / 255.0)).astype(np.uint8)
    cdeg = np.round(np.degrees(bag.geometry.bearings) * 100)
    res = bag.geometry.range_resolution
    quats = [(0.0, 0.0, float(np.sin(y / 2)), float(np.cos(y / 2)))
             for y in bag.imu_rpy[:, 2]]
    msgs = [(0, float(t), _ser_header(k, float(t), "imu")
             + struct.pack("<dddd", *quats[k]))
            for k, t in enumerate(bag.imu_time)]
    msgs += [(1, float(t), _ser_header(k, float(t), "dvl")
              + struct.pack("<dddd", *map(float, bag.dvl_vel[k]), 5.0))
             for k, t in enumerate(bag.dvl_time)]
    msgs += [(2, float(t), _ser_header(k, float(t), "depth")
              + struct.pack("<dd", float(bag.depth[k]), 20.0))
             for k, t in enumerate(bag.depth_time)]
    msgs += [(3, float(t), _ser_ping(k, float(t), gamma, imgs_q[k], cdeg, res))
             for k, t in enumerate(bag.ping_time)]
    msgs.sort(key=lambda m: m[1])
    conns = [{"id": i, "topic": ROS_TOPICS[name], "type": typ, "definition": d}
             for i, (name, typ, d) in enumerate((
                 ("imu", "sensor_msgs/Imu", IMU_DEF),
                 ("dvl", "rti_dvl/DVL", DVL_DEF),
                 ("depth", "bar30_depth/Depth", DEPTH_DEF),
                 ("sonar", "sonar_oculus/OculusPing", PING_DEF)))]
    bag_path = os.path.join(work, "seam.bag")
    bundle = os.path.join(work, "seam.npz")
    t0 = time.perf_counter()
    write_bag(bag_path, conns, msgs, compression="lz4")
    convert_bag.main([bag_path, "--out", bundle])
    t_convert = time.perf_counter() - t0

    # the same quantized arrays, in process: stamps as the headers carry
    # them, the yaw through its quaternion, the pings through the gamma table
    def stamps(ts):
        return np.asarray([a + b * 1e-9 for a, b in map(_stamp, map(float, ts))])

    times = {n: stamps(getattr(bag, n)) for n in ("imu_time", "dvl_time",
                                                   "depth_time", "ping_time")}
    t_first = min(times["imu_time"].min(), times["dvl_time"].min(),
                  times["ping_time"].min())
    rpy = np.asarray([_quat_to_rpy(*q) for q in quats], np.float32)
    bearings = np.radians(np.asarray(cdeg, np.int16).astype(np.float32) / 100.0)
    mem = SyntheticBag(
        **{n: (v - t_first).astype(np.float32) for n, v in times.items()},
        imu_rpy=rpy, dvl_vel=bag.dvl_vel.astype(np.float32),
        depth=bag.depth.astype(np.float32),
        ping_images=convert_bag.gamma_decompress(imgs_q, gamma),
        true_pose_at_ping=np.zeros((len(bag.ping_time), 3), np.float32),
        geometry=SonarGeometry(num_ranges=bag.geometry.num_ranges,
                               num_bearings=len(bearings),
                               range_resolution=float(res), bearings=bearings),
        world_points=np.zeros((0, 2), np.float32))
    with np.load(bundle) as d:
        for name in ("imu_time", "imu_rpy", "dvl_time", "dvl_vel", "depth_time",
                     "depth", "ping_time", "ping_images"):
            if not np.array_equal(d[name], getattr(mem, name)):
                raise RuntimeError(f"bag seam: the bundle's {name} differs from "
                                   f"the quantized array")
        if not np.array_equal(d["bearings"], bearings):
            raise RuntimeError("bag seam: the bundle's bearings differ")

    torch.cuda.synchronize()
    cfar_cuda.cfar_detect.launches = 0
    cfar_cuda.cfar_detect.kernel_launches["sum"] = 0
    run = replay_cli.main(["--file", bundle, "--out", os.path.join(work, "seam")])
    launches = cfar_cuda.cfar_detect.launches
    sum_launches = cfar_cuda.cfar_detect.kernel_launches["sum"]
    params, dims, _ = load_slam_config(dims_overrides={"max_keyframes": 128},
                                       device=dev)
    ref = replay(mem, load_feature_config(max_points=dims.max_points), params,
                 dims, dev)
    got = run.result
    same = (np.array_equal(got.keyframe_ping_idx, ref.keyframe_ping_idx)
            and np.array_equal(got.trajectory, ref.trajectory)
            and np.array_equal(got.dense_trajectory, ref.dense_trajectory)
            and got.carry.num_loops == ref.carry.num_loops
            and torch.equal(got.carry.points, ref.carry.points))
    log(f"bag seam: {len(msgs)} messages, lz4 bag {os.path.getsize(bag_path)} "
        f"bytes, written and converted in {t_convert:.2f} s; cli.replay "
        f"{got.num_keyframes} keyframes, {got.carry.num_loops} loops, wall "
        f"{run.wall_s:.2f} s, stages s {json.dumps(got.stage_s)}; in-process "
        f"replay equal bit for bit: {same}; CFAR launches {launches}, of them "
        f"the sum kernel {sum_launches}")
    if not same:
        raise RuntimeError("bag seam: cli.replay differs from the in-process "
                           "replay of the quantized arrays")
    if got.carry.num_loops < 1:
        raise RuntimeError("bag seam: the survey's loops were not found")
    if sum_launches < 1 or sum_launches != launches:
        raise RuntimeError(f"bag seam made {launches} CFAR launches, "
                           f"{sum_launches} of the sum kernel")
    return sum_launches


def run_cli_full(bag, dev, work: str) -> int:
    """Phase 12: ``cli.replay`` on phase 4's survey, written as an
    uncompressed bundle, with the YAML configuration. Returns the run's
    sum-kernel launches."""
    import numpy as np
    import torch
    from sonar_slam_torch.cli import replay as replay_cli
    from sonar_slam_torch.cli.simulate_bag import write_bundle
    from sonar_slam_torch.io.state import load_checkpoint
    from sonar_slam_torch.kernels import cfar_cuda
    from sonar_slam_torch.mapping import (occupancy_grid_method1,
                                          render_global_logodds)
    from sonar_slam_torch.pipeline import ate_heading_deg
    from sonar_slam_torch.slam import slam_init

    bundle = os.path.join(work, "full.npz")
    out = os.path.join(work, "full")
    t0 = time.perf_counter()
    write_bundle(bundle, bag, compressed=False)
    t_write = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cfar_cuda.cfar_detect.launches = 0
    cfar_cuda.cfar_detect.kernel_launches["sum"] = 0
    t0 = time.perf_counter()
    run = replay_cli.main(["--file", bundle, "--max-keyframes", "128",
                           "--intensity", "--save-submaps", "--out", out])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = cfar_cuda.cfar_detect.launches
    sum_launches = cfar_cuda.cfar_detect.kernel_launches["sum"]
    peak = torch.cuda.max_memory_allocated(dev)
    res = run.result

    # slam_carry.npz, leaf for leaf
    back = load_checkpoint(os.path.join(out, "slam_carry.npz"),
                           slam_init(run.dims, dev))
    def same(x, y):
        if isinstance(x, tuple):  # the carry and its graph
            return all(same(u, v) for u, v in zip(x, y))
        if isinstance(x, torch.Tensor):
            return (x.dtype == y.dtype and x.device == y.device
                    and torch.equal(x, y))
        return type(x) is type(y) and x == y

    leaves_equal = same(back, res.carry)
    # occupancy.npz against the method-1 map of a full repaint
    with np.load(os.path.join(out, "occupancy.npz")) as d:
        occ, inten = d["occ"], d["intensity"]
    st = run.mapping
    full = occupancy_grid_method1(
        st._replace(grid=render_global_logodds(st, run.model)),
        run.model).cpu().numpy()
    observed = int((occ != 50).sum())
    repaint_diff = int((full != occ).sum())
    with np.load(os.path.join(out, "trajectory.npz")) as d:
        states = d["states"]
    states_ok = (states.dtype == np.dtype(JAX_STATE_DTYPE)
                 and len(states) == res.num_keyframes
                 and np.isfinite(states["cov"]).all())
    truth = bag.true_pose_at_ping[res.keyframe_ping_idx]
    ate_deg = ate_heading_deg(res.trajectory, truth)
    nl = res.carry.num_loops
    log(f"cli.replay full width: {res.num_keyframes} keyframes, {nl} loops, "
        f"ATE {run.ate_m:.4f} m / {ate_deg:.3f} deg, wall_s {run.wall_s:.2f}, "
        f"stages s {json.dumps(res.stage_s)}, mapping loop {run.mapping_s:.3f} "
        f"s, whole CLI {total:.2f} s (bundle of {os.path.getsize(bundle) / 1e9:.2f} "
        f"GB written in {t_write:.2f} s), peak memory {peak / 2**20:.1f} MiB, "
        f"CFAR launches {launches}, of them the sum kernel {sum_launches}")
    log(f"cli.replay full width: carry reloaded leaf for leaf: {leaves_equal}; "
        f"states {states.dtype}, {len(states)} rows, as the JAX package's: "
        f"{states_ok}; occ against a full repaint: {repaint_diff} of "
        f"{observed} observed cells differ (allowed share {CLI_REPAINT_SHARE}); "
        f"intensity cells observed {int((inten >= 0).sum())}")
    if not np.isfinite(res.trajectory).all():
        raise RuntimeError("cli.replay: trajectory not finite")
    if sum_launches < 1 or sum_launches != launches:
        raise RuntimeError(f"cli.replay made {launches} CFAR launches, "
                           f"{sum_launches} of the sum kernel")
    if not leaves_equal:
        raise RuntimeError("cli.replay: slam_carry.npz does not reload equal")
    if not states_ok:
        raise RuntimeError("cli.replay: states array has the wrong layout")
    if repaint_diff > CLI_REPAINT_SHARE * observed:
        raise RuntimeError("cli.replay: occ differs from a full repaint")
    got = (res.num_keyframes, nl, round(run.ate_m, 4), round(ate_deg, 3))
    if got != CLI_EXPECTED:
        raise RuntimeError(f"cli.replay: (keyframes, loops, ATE m, ATE deg) "
                           f"{got}, expected {CLI_EXPECTED}")
    return sum_launches


def _counted(run):
    """``run()`` with the CFAR launch counters reset just before: (its
    result, its seconds ended by a device sync, its peak device MiB, the
    launches by kernel)."""
    import torch
    from sonar_slam_torch.kernels import cfar_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfar_cuda.cfar_detect.launches = 0
    for k in cfar_cuda.cfar_detect.kernel_launches:
        cfar_cuda.cfar_detect.kernel_launches[k] = 0
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = dict(cfar_cuda.cfar_detect.kernel_launches)
    if sum(launches.values()) != cfar_cuda.cfar_detect.launches:
        raise RuntimeError("CFAR launch counters disagree")
    return out, took, torch.cuda.max_memory_allocated() / 2**20, launches


def _check_pin(name: str, got, expected):
    log(f"{name}: {got}, expected {expected}")
    if got != expected:
        raise RuntimeError(f"{name}: {got}, expected {expected}")


def _bit_equal(x, y) -> bool:
    """Equal structure and every leaf equal bit for bit with its dtype (a
    host int against an int64 0-d tensor)."""
    import torch

    if isinstance(x, tuple):
        return all(_bit_equal(u, v) for u, v in zip(x, y))
    if x is None or y is None:
        return x is None and y is None
    u, v = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
    return u.dtype == v.dtype and torch.equal(u, v)


def _lane(tree, i):
    return type(tree)(*(_lane(x, i) if isinstance(x, tuple) else
                        None if x is None else x[i] for x in tree))


def run_sweep(dev) -> dict:
    """Phase 13a: ``cli.sweep --simulate --lanes 8``. Returns its launches by
    kernel."""
    import numpy as np
    from sonar_slam_torch.cli import sweep as sweep_cli
    from sonar_slam_torch.parallel.sweep import lane_params
    from sonar_slam_torch.slam import slam_scan

    run, took, peak, launches = _counted(lambda: sweep_cli.main(
        ["--simulate", "--lanes", str(SWEEP_LANES)]))
    rep = run.report
    log(f"cli.sweep --lanes {SWEEP_LANES}: whole CLI {took:.2f} s, peak memory "
        f"{peak:.1f} MiB, CFAR launches {launches}")
    for i in (0, SWEEP_LANES - 1):
        t0 = time.perf_counter()
        c1, _ = slam_scan(run.frames, lane_params(run.params, i), run.dims)
        same = _bit_equal(_lane(run.carry, i), c1)
        log(f"cli.sweep lane {i} against a lone slam_scan "
            f"({time.perf_counter() - t0:.2f} s): bit for bit {same}")
        if not same:
            raise RuntimeError(f"cli.sweep: lane {i} differs from a lone scan")
    if not np.isfinite(run.carry.poses.cpu().numpy()).all():
        raise RuntimeError("cli.sweep: poses not finite")
    if launches["sum"] != 1 or sum(launches.values()) != 1:
        raise RuntimeError(f"cli.sweep made CFAR launches {launches}, expected "
                           "one of the sum kernel")
    _check_pin("cli.sweep (keyframes, loops per lane, best ATE m)",
               (rep["keyframes"], rep["loops_per_lane"], rep["best_ate_m"]),
               SWEEP_EXPECTED)
    return launches


def run_two_robot(dev) -> dict:
    """Phase 13b: ``cli.two_robot_demo`` at its default 90 s. Returns its
    launches by kernel."""
    import numpy as np
    from sonar_slam_torch.cli import two_robot_demo

    run, took, peak, launches = _counted(lambda: two_robot_demo.main([]))
    log(f"cli.two_robot_demo: whole CLI {took:.2f} s, peak memory {peak:.1f} "
        f"MiB, CFAR launches {launches}")
    if not np.isfinite(run.merged_poses).all():
        raise RuntimeError("cli.two_robot_demo: merged poses not finite")
    if launches["sum"] != 2 or sum(launches.values()) != 2:
        raise RuntimeError(f"cli.two_robot_demo made CFAR launches {launches}, "
                           "expected two of the sum kernel")
    _check_pin("cli.two_robot_demo (keyframes, loops, proposals, PCM accepts, "
               "clique, merged ATE m)",
               (run.keyframes, run.loops, run.proposals, run.accepted,
                run.clique, round(run.ate_joint_m, 4)), TWO_ROBOT_EXPECTED)
    return launches


def run_sharded(dev) -> dict:
    """Phase 13c: ``cli.sharded_replay --max-keyframes 1024 --check
    --duration 60``. Returns its launches by kernel."""
    from sonar_slam_torch.cli import sharded_replay

    run, took, _, launches = _counted(lambda: sharded_replay.main(
        ["--max-keyframes", "1024", "--check", "--duration",
         SHARDED_DURATION]))
    res, ref = run.result, run.check
    log(f"cli.sharded_replay: whole CLI {took:.2f} s; K "
        f"{res.carry.poses.shape[0]} wall {run.wall_s:.2f} s, peak {run.peak_mib:.1f} MiB, stages s "
        f"{json.dumps(res.stage_s)}; K {sharded_replay.CHECK_KEYFRAMES} wall "
        f"{ref.wall_s:.2f} s, peak {ref.peak_mib:.1f} MiB, stages s "
        f"{json.dumps(ref.result.stage_s)}; max |dpose| {run.max_dpose:.3e}; "
        f"CFAR launches {launches}")
    if launches["sum"] != 2 or sum(launches.values()) != 2:
        raise RuntimeError(f"cli.sharded_replay made CFAR launches {launches}, "
                           "expected two of the sum kernel")
    _check_pin("cli.sharded_replay (keyframes, loops, ATE m)",
               (res.num_keyframes, res.carry.num_loops, round(run.ate_m, 4)),
               SHARDED_EXPECTED)
    return launches


def _sum_only(name: str, launches: dict, least: int):
    if launches["sum"] < least or sum(launches.values()) != launches["sum"]:
        raise RuntimeError(f"{name} made CFAR launches {launches}, expected "
                           f">= {least}, all of the sum kernel")


def run_multi_seed(dev) -> dict:
    """Phase 14a: ``cli.multi_seed --full --seeds 1``, bench.py's SOCA +
    refinement path at full width. Returns its launches by kernel."""
    import numpy as np
    from sonar_slam_torch.cli import multi_seed

    run, took, peak, launches = _counted(lambda: multi_seed.main(
        ["--full", "--seeds", "1"]))
    rec = run.summary["per_seed"][0]
    res = run.results[0]
    log(f"cli.multi_seed --full --seeds 1: whole CLI {took:.2f} s, replay "
        f"wall {rec['wall_s']} s, stages s {json.dumps(res.stage_s)}, peak "
        f"memory {peak:.1f} MiB, CFAR launches {launches}")
    log(f"cli.multi_seed, for scale only: the JAX script's seed 0 on a TPU "
        f"(docs/MULTISEED_r05_tpu.json) {json.dumps(MULTISEED_R05_SEED0)}")
    if not np.isfinite(res.trajectory).all():
        raise RuntimeError("cli.multi_seed: trajectory not finite")
    _sum_only("cli.multi_seed", launches, 1)
    if rec["keyframes"] != FULL_KEYFRAMES:
        raise RuntimeError(f"cli.multi_seed: {rec['keyframes']} keyframes, "
                           f"expected {FULL_KEYFRAMES}")
    _check_pin("cli.multi_seed (keyframes, loops, ATE cm, heading deg, precision, "
         "recall, DVL scale x/y)",
         (rec["keyframes"], rec["loops"], rec["ate_cm"], rec["heading_deg"],
          rec["precision"], rec["recall"], rec["est_dvl_scale_xy"]),
         MULTI_SEED_EXPECTED)
    del run, res
    return launches


def run_yscale(dev) -> dict:
    """Phase 14b: ``cli.yscale_lane --seeds 1``, the full pipeline on the
    20-degree crab survey. Returns its launches by kernel."""
    import numpy as np
    from sonar_slam_torch.cli import yscale_lane

    run, took, peak, launches = _counted(lambda: yscale_lane.main(
        ["--seeds", "1"]))
    rec = run.summary["per_seed"][0]
    res = run.results[0]
    log(f"cli.yscale_lane --seeds 1: whole CLI {took:.2f} s, replay wall "
        f"{rec['wall_s']} s, stages s {json.dumps(res.stage_s)}, peak memory "
        f"{peak:.1f} MiB, CFAR launches {launches}, {res.num_keyframes} "
        f"keyframes")
    log(f"cli.yscale_lane, for scale only: the JAX script's seed 0 on a TPU "
        f"(docs/YSCALE_r05.json) {json.dumps(YSCALE_R05_SEED0)}")
    if not np.isfinite(res.trajectory).all():
        raise RuntimeError("cli.yscale_lane: trajectory not finite")
    _sum_only("cli.yscale_lane", launches, 1)
    _check_pin("cli.yscale_lane (est. scale x/y, x err %, y err %, loops, ATE cm)",
         (rec["est_scale_xy"], rec["x_err_pct"], rec["y_err_pct"],
          rec["loops"], rec["ate_cm"]), YSCALE_EXPECTED)
    del run, res
    return launches


def run_error_budget(dev) -> dict:
    """Phase 14c: ``cli.error_budget`` (small): four lanes and the feature
    fidelity. Returns its launches by kernel."""
    from sonar_slam_torch.cli import error_budget

    run, took, peak, launches = _counted(lambda: error_budget.main([]))
    log(f"cli.error_budget: whole CLI {took:.2f} s, peak memory {peak:.1f} "
        f"MiB, CFAR launches {launches}")
    with open(os.path.join(HERE, "tests", "golden",
                           "error_budget_small.json")) as f:
        log(f"cli.error_budget, for scale only: the JAX script on a CPU "
            f"(tests/golden/error_budget_small.json) {json.dumps(json.load(f))}")
    # one launch for each of the feature-fidelity pings, one for each of
    # lanes A and B (lanes C and D take the true features)
    _sum_only("cli.error_budget", launches, 3)
    _check_pin("cli.error_budget report", run.report, ERROR_BUDGET_EXPECTED)
    return launches


def run_accuracy_sweep(dev) -> dict:
    """Phase 14d: ``cli.accuracy_sweep`` (small, one seed): seven variants.
    Returns its launches by kernel."""
    from sonar_slam_torch.cli import accuracy_sweep

    run, took, peak, launches = _counted(lambda: accuracy_sweep.main([]))
    log(f"cli.accuracy_sweep: whole CLI {took:.2f} s, peak memory {peak:.1f} "
        f"MiB, CFAR launches {launches}")
    _sum_only("cli.accuracy_sweep", launches, len(accuracy_sweep.VARIANTS))
    _check_pin("cli.accuracy_sweep ranked (label, ATE cm, loops)",
         [(r["label"], r["ate_cm"][0], r["loops"][0]) for r in run.results],
         ACCURACY_SWEEP_EXPECTED)
    return launches


def run_map_probes(dev) -> tuple[dict, dict]:
    """Phase 14e: ``cli.map_probe`` (small), then
    ``cli.frontier_coverage_probe --alg OS`` (small). Returns their launches
    by kernel."""
    from sonar_slam_torch.cli import frontier_coverage_probe, map_probe

    run, took, peak, launches = _counted(lambda: map_probe.main([]))
    log(f"cli.map_probe: whole CLI {took:.2f} s, peak memory {peak:.1f} MiB, "
        f"CFAR launches {launches}")
    _sum_only("cli.map_probe", launches, 1)
    _check_pin("cli.map_probe report", json.loads(json.dumps(run.report)),
         MAP_PROBE_EXPECTED)
    run, took, peak, launches_os = _counted(
        lambda: frontier_coverage_probe.main(["--alg", "OS"]))
    log(f"cli.frontier_coverage_probe --alg OS: whole CLI {took:.2f} s, peak "
        f"memory {peak:.1f} MiB, CFAR launches {launches_os}")
    if (launches_os["os_mask"] < 1
            or sum(launches_os.values()) != launches_os["os_mask"]):
        raise RuntimeError(f"cli.frontier_coverage_probe made CFAR launches "
                           f"{launches_os}, expected >= 1, all of the OS mask "
                           "kernel")
    _check_pin("cli.frontier_coverage_probe --alg OS report", run.report,
         FRONTIER_OS_EXPECTED)
    return launches, launches_os


def run_repeats(dev, work: str) -> dict:
    """Phase 14f: ``cli.run_repeats`` with two runs of ``cli.replay`` on a
    20 s survey of 64 x 32 pings, each in a subprocess, then
    ``cli.plot_runs.trajectory_spread`` over them: card replays repeat bit
    for bit, so the spread must be 0.0. The runs' launches are read from
    their log lines (their stderr, redirected here into a file). Returns the
    launches by kernel summed over the runs."""
    import re

    from sonar_slam_torch.cli import plot_runs
    from sonar_slam_torch.cli import run_repeats as repeats_cli
    from sonar_slam_torch.cli.simulate_bag import write_bundle
    from sonar_slam_torch.io.simulate import SimConfig, simulate_bag

    bag = os.path.join(work, "repeats.npz")
    write_bundle(bag, simulate_bag(SimConfig(
        duration=20.0, speed=0.5, sonar_rate=1.0, num_ranges=64,
        num_bearings=32, loop_radius=2.5, imu_rate=10.0)))
    outdir = os.path.join(work, "runs")
    with tempfile.TemporaryFile(mode="w+") as cap:
        sys.stderr.flush()
        saved = os.dup(2)
        os.dup2(cap.fileno(), 2)
        t0 = time.perf_counter()
        try:
            run = repeats_cli.main([bag, "--runs", str(REPEAT_RUNS),
                                    "--outdir", outdir, "--timeout", "300"])
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
        took = time.perf_counter() - t0
        cap.seek(0)
        text = cap.read()
    lines = [ln for ln in text.splitlines() if "CFAR launches" in ln]
    for ln in lines:
        log(f"  run: {ln.strip()}")
    per_run = [json.loads(re.search(r"CFAR launches (\{.*\})", ln).group(1))
               for ln in lines]
    launches = {k: sum(r[k] for r in per_run) for k in ("sum", "os_mask",
                                                        "os_select")}
    spread = plot_runs.trajectory_spread(plot_runs.trajectory_files(outdir))
    log(f"cli.run_repeats: {REPEAT_RUNS} runs in {took:.2f} s, exit codes "
        f"{[r[3] for r in run.runs]}, CFAR launches of the runs {launches}; "
        f"cli.plot_runs.trajectory_spread {spread}")
    if [r[3] for r in run.runs] != [0] * REPEAT_RUNS or len(per_run) != REPEAT_RUNS:
        raise RuntimeError(f"cli.run_repeats: runs {run.runs}, {len(per_run)} "
                           "logged their launches")
    if any(r["sum"] != 1 or sum(r.values()) != 1 for r in per_run):
        raise RuntimeError(f"cli.run_repeats: runs made CFAR launches "
                           f"{per_run}, expected one of the sum kernel each")
    if spread != 0.0:
        raise RuntimeError(f"cli.run_repeats: trajectory spread {spread}, "
                           "expected 0.0")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a card")
    if not os.path.isdir(os.path.join(HERE, "sonar_slam_torch")):
        raise RuntimeError("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, HERE)
    import numpy as np

    from sonar_slam_torch.io.simulate import simulate_bag
    from sonar_slam_torch.kernels import cfar_cuda
    from sonar_slam_torch.pipeline import ate_heading_deg, ate_rmse, replay

    # 1) device
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2) build
    t_start = time.perf_counter()
    lib = cfar_cuda.build()
    log(f"built {os.path.relpath(lib, HERE)} in {time.perf_counter() - t_start:.2f} s")

    # 3) kernels against plain versions, on simulated full-geometry pings
    sim, dims, params_on, fcfg = full_config(seed=0)
    t0 = time.perf_counter()
    bag = simulate_bag(sim)
    log(f"simulated {len(bag.ping_time)} pings {bag.ping_images.shape[1:]} "
        f"in {time.perf_counter() - t0:.1f} s")
    # two distinct stacks (pings 0-127 and 128-255, 134 MB together, over
    # the 50 MB L2), alternated in the timings
    stacks = [torch.as_tensor(bag.ping_images[i:i + 128], device=dev)
              .contiguous() for i in (0, 128)]
    entry = check_kernel(stacks)
    entry_os = check_os_kernel(stacks)
    del stacks
    torch.cuda.empty_cache()

    # 4) the SOCA slice: full-config replay with refinement off
    params = params_on(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cfar_cuda.cfar_detect.launches = 0
    cfar_cuda.cfar_detect.kernel_launches["sum"] = 0
    t0 = time.perf_counter()
    res = replay(bag, fcfg, params, dims, dev)
    wall = time.perf_counter() - t0
    launches = cfar_cuda.cfar_detect.launches
    sum_launches = cfar_cuda.cfar_detect.kernel_launches["sum"]
    peak = torch.cuda.max_memory_allocated(dev)
    truth = bag.true_pose_at_ping[res.keyframe_ping_idx]
    ate = ate_rmse(res.trajectory, truth)
    ate_deg = ate_heading_deg(res.trajectory, truth)
    dr_ate = ate_rmse(res.dr_trajectory, truth)
    log(f"replay: {res.num_keyframes} keyframes, {res.carry.num_loops} loops, "
        f"ATE {ate:.4f} m / {ate_deg:.3f} deg (DR {dr_ate:.4f} m), wall "
        f"{wall:.2f} s, stages s {json.dumps(res.stage_s)}, peak memory "
        f"{peak / 2**20:.1f} MiB, CFAR launches {launches}")
    if not np.isfinite(res.trajectory).all() or res.num_keyframes < 2:
        raise RuntimeError("replay trajectory not finite")
    if sum_launches < 3 or sum_launches != launches:
        raise RuntimeError(f"replay made {launches} CFAR launches, "
                           f"{sum_launches} of the sum kernel; expected >= 3, "
                           f"all of it")
    if (res.num_keyframes, res.carry.num_loops) != (FULL_KEYFRAMES, FULL_LOOPS):
        raise RuntimeError(f"{res.num_keyframes} keyframes and "
                           f"{res.carry.num_loops} loops, expected "
                           f"{FULL_KEYFRAMES} and {FULL_LOOPS}")
    if (round(ate, 4), round(ate_deg, 3)) != (FULL_ATE_M, FULL_ATE_DEG):
        raise RuntimeError(f"ATE {ate} m / {ate_deg} deg, expected "
                           f"{FULL_ATE_M} m / {FULL_ATE_DEG} deg")
    entry["launches"] = sum_launches
    del res

    # 5) the OS slice: bench.py's whole full pipeline with the OS detector
    entry_os["launches"] = run_os_path(bag, dev)

    # 6) small configuration, refinement off: the card against the port on
    # the CPU (which the CPU tests hold to the JAX package) and against the
    # JAX result
    check_small(dev)

    # 7) small configuration, refinement on, against the JAX result
    check_small_refine(dev)

    # 8-9) the FOG-gyro and Kalman front ends on phase 4's survey
    by_path = {"soca": entry["launches"]}
    for frontend in ("dr_gyro", "kalman"):
        by_path[frontend] = run_frontend_path(bag, dev, frontend)
    kalman = time_kalman_scan(bag, dev)
    torch.cuda.empty_cache()

    # 10) bench.py's dual-sonar lane
    by_path["dual"] = run_dual_lane(dev, entry)

    # 11-12) the command-line path: a bag through convert_bag and the
    # replay CLI, then the CLI on phase 4's survey
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        by_path["cli_bag_seam"] = run_bag_seam(dev, work)
        by_path["cli_full"] = run_cli_full(bag, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del bag
    torch.cuda.empty_cache()

    # 13) the parallel/ entry points: the sweep, the two-robot merge and the
    # replay at keyframe capacity 1024
    t13 = time.perf_counter()
    by_path_os = {"os": entry_os["launches"]}
    for name, run in (("sweep", run_sweep), ("two_robot", run_two_robot),
                      ("sharded_replay", run_sharded)):
        launches = run(dev)
        by_path[name] = launches["sum"]
        by_path_os[name] = launches["os_mask"] + launches["os_select"]
        torch.cuda.empty_cache()
    log(f"phase 13 took {time.perf_counter() - t13:.1f} s")

    # 14) the accuracy CLIs: the production SOCA + refinement path and the
    # y-scale lane at full width, then the small harnesses
    t14 = time.perf_counter()
    for name, run in (("multi_seed", run_multi_seed), ("yscale_lane", run_yscale),
                      ("error_budget", run_error_budget),
                      ("accuracy_sweep", run_accuracy_sweep)):
        launches = run(dev)
        by_path[name] = launches["sum"]
        by_path_os[name] = launches["os_mask"] + launches["os_select"]
        torch.cuda.empty_cache()
    launches, launches_os = run_map_probes(dev)
    by_path["map_probe"] = launches["sum"]
    by_path_os["map_probe"] = launches["os_mask"] + launches["os_select"]
    by_path["frontier_coverage_probe_os"] = launches_os["sum"]
    by_path_os["frontier_coverage_probe_os"] = launches_os["os_mask"]
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = run_repeats(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    by_path["run_repeats"] = launches["sum"]
    by_path_os["run_repeats"] = launches["os_mask"] + launches["os_select"]
    log(f"phase 14 took {time.perf_counter() - t14:.1f} s")
    entry["launches_by_path"] = by_path
    entry_os["launches_by_path"] = by_path_os

    log(f"chip_smoke.py total wall {time.perf_counter() - t_start:.1f} s "
        f"(from the build)")
    log(json.dumps({"kalman_scan": kalman}))
    log(json.dumps({"kernels": [entry, entry_os]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
