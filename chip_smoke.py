"""Drive the PyTorch port (sonar_slam_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases 1-3 run first, then phase 10,
which times a kernel call; then phases 13, 14, 16 and 17 each run in a
process of their own (``python3 chip_smoke.py phase-13``, ``phase-14``,
``phase-16`` and ``phase-17``: they read nothing of the other phases,
phases 13 and 16 simulate phase 4's survey anew; their logs are relayed at
the end) beside phases 4-9, 11-12 and 15, in order, in this one. Any failure raises and the script exits non-zero
without printing the result line:

1. device: a CUDA card is required (there is no CPU fallback); prints
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build: compiles the CFAR kernels (kernels/csrc/cfar.cu) and the Kalman
   filter kernel (kernels/csrc/kalman.cu) with nvcc and the LZ4 decoder
   (io/csrc/lz4.cpp) with the host C++ compiler;
3. kernels against plain versions, on the same simulated full-geometry
   pings: two stacks of 128 pings of 512 x 256 (pings 0-127 and 128-255).
   The sum kernel at (128, 512, 256) SOCA with edge extension and the
   intensity gate at 65, with and without the threshold map, plus CA, GOCA
   and the strict edge at (4, 96, 40); the OS mask path (mask only, the
   feature path's call) and the OS threshold path (the selection kernel)
   at (128, 512, 256), extend, gate 65, ranks 10, 0 and 39, plus ranks 0,
   10 and 39 with both edges at (4, 96, 40), on the float pings and on an
   integer-valued copy; the selection kernel with tau 0 and -1, and on a
   ragged (3, 97, 37) stack with NaN and infinities; the sum kernel with
   the strict edge at (128, 512, 256), SOCA, gate 65 (the parity lanes'
   call, phase 16) on both stacks, its border rows undetected
   (``check_strict``). Masks and thresholds must be equal bit for bit. Times by CUDA events after warm-up,
   alternating between the two stacks (so no launch reads its input from
   L2), in the order plain, kernel, kernel, plain; then the threshold path,
   a call whose gate no pixel passes (no window arithmetic: the tile's
   floor), and one PyTorch call that computes the window statistic alone
   as a yardstick (``conv2d`` for the sums, ``kthvalue`` for OS, at
   ranks 10 and 0). Each kernel's
   bound is its bytes (one image read, one mask write) over the card's
   memory rate, or its operations over the float32 rate if that is larger.
   Then the Kalman filter kernel against the event loop on the card, on
   the same codes and measurements of phase 4's survey with a 200 Hz IMU
   (100,320 events), twice bit for bit, timed by CUDA events; its bound is
   its own dependent chain at latencies measured on the card by probe
   kernels (a barrier step, an FMA, a division, a shuffle); see
   ``check_kalman_kernel``;
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
   (tests/golden/small_norefine_traj.npz, and
   tests/golden/small_norefine_traj_port_dr_rows.npz: JAX fed the card's
   own dead-reckoning poses); see ``check_small``;
7. reference, refinement on: the small configuration with refinement
   against the JAX package's results (tests/golden/small_traj.npz, and
   tests/golden/small_traj_port_dr_rows.npz: JAX fed the card's own
   dead-reckoning poses), twice; see ``check_small_refine``;
8. the FOG-gyro front end: phase 4's survey and configuration through
   ``replay(frontend="dr_gyro")``, with the launch counters reset just
   before. Checks the odometry at the pings and the keyframe pings against
   the JAX package's (tests/golden/full_frontends_odometry.npz), at least one
   CFAR launch, all of the sum kernel, and the keyframes, loops and ATE
   below, exactly; see ``run_frontend_path``;
9. the Kalman front end: the same with ``frontend="kalman"`` (DR-basis
   aggregation off: the Kalman filter gives no basis integrals) and the
   default Kalman configuration adapted to the 50 Hz IMU, the same checks,
   and one launch of the filter kernel (none on the gyro path); then the
   Kalman scan alone, timed, and once more under ``torch.profiler`` to
   count its kernel launches, the filter kernel once a scan;
10. bench.py's dual-sonar lane (bench.py:792-953): ``replay(use_vertical=True)``
   at its configuration, twice, with the counters reset before each. Checks
   (a) the vertical launch's mask against the plain version bit for bit and
   against the JAX mask (tests/golden/dual_lane.npz) up to pixels within a
   relative 1e-5 of their threshold, and times that call; (b) the fusion
   stage on the golden's JAX inputs against its JAX outputs; (c) the lane's
   keyframes against the JAX result's and bench.py's ``dual_sonar`` numbers,
   its z RMSE within DUAL_Z_BAND_M of the JAX result's; see ``run_dual_lane``.

11. the LZ4 decoder: 8 MB of phase 4's pings, gamma-quantized to 8 bits,
   as LZ4 frames (as rendered, and gated at 65 so that they compress),
   decoded by the compiled decoder and by the pure-Python one, byte-equal,
   each rate logged (``check_lz4_decoder``); then the bag seam: a small
   simulated survey with its pings quantized to
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
   before: (a) ``cli.sweep --simulate`` at its default 64 lanes, one
   lane-batched scan (one CFAR launch for the whole sweep; lanes 0-7 held
   to their pins; lanes 0, 7 and 63 bit for bit with a lone ``slam_scan``
   of their params, pinned, and so within 0.5 cm of its ATE; the batched
   scan's kernel launches a keyframe step at 64 lanes at most twice those
   at one lane, under ``torch.profiler``), (b) ``cli.two_robot_demo``
   (one launch a robot), (c)
   ``cli.sharded_replay --max-keyframes 1024 --capacity-check --duration 60`` (the
   replay at capacity 1024 against capacity 128; one launch a replay), each
   with its
   wall time and peak memory, and the keyframes, loops and ATE below,
   exactly; (d) a full-width point-to-line sweep: 8 lanes of (a)'s grid
   over the full configuration (DR-basis aggregation off) on phase 4's
   survey in one ``parallel.sweep_scan`` (one CFAR launch for the frames;
   finite poses; lanes 0 and 7 bit for bit with a lone ``slam_scan`` and
   pinned; launches a keyframe step at 8 lanes at most twice one lane's,
   over the first 16 keyframes; wall time, per-lane seconds and peak
   memory logged); (e) the robot axis at full width: robot A on phase 4's
   survey, robot B on the same SimConfig with seed 1 at phase pi, under
   (d)'s configuration, as lanes of one batched
   ``parallel.multi_robot_scan`` (one CFAR launch a robot for the frames;
   finite poses; each robot lane bit for bit with its lone ``slam_scan``
   and pinned; launches a keyframe step at two robots at most 1.5x one
   robot's over the first 16 keyframes; the batched 8 x 8 proposal search
   bit for bit with its loop; PCM and the merge pinned; ``wall_s`` of the
   batched scan and of the loop of lone scans, and peak memory, logged);
   see ``run_sweep``, ``run_two_robot``, ``run_sharded``,
   ``run_full_sweep`` and ``run_full_robots``;
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
   ``run_multi_seed`` to ``run_repeats``;
15. the node API: (a) phase 4's survey through ``dead_reckoning_step``
   one tick a call, each pose read back to the host, against
   ``dead_reckoning_scan`` on the card (positions within DR_STEP_ATOL_M,
   the same keyframes), with the per-tick latency and launches logged;
   (b) ``Smoother``'s loop-closure and marginal-covariance cases against
   the CPU; (c) ``slam_scan`` against ``slam_scan_padded`` on phase 6's
   keyframes with an interior slot invalid, bit for bit; (d)
   ``voxel_downsample_with_keys`` and ``density_filter`` on phase 4's
   first keyframe clouds against the CPU; see ``run_dr_node`` to
   ``run_cloud_api``;
16. bench.py's reference-faithful parity lanes (``cli.parity_lane``,
   bench.py:693-790) on phase 4's survey: the faithful lane (strict-edge
   CFAR without the corroboration gate, icp.yaml's point-to-point ICP, 30
   NSSM starts whose MCD mean is the loop transform, NSSM at every
   keyframe) cold and warm, the SSM-only lane and odometry mode, with the
   launch counters reset just before. Checks one sum-kernel launch a lane,
   finite poses, odometry mode on dead reckoning with no loop, the faithful
   and SSM-only lanes worse than dead reckoning (the faithful lane at least
   PARITY_COLLAPSE_FACTOR times phase 4's ATE), the cold and warm faithful
   runs bit for bit, and each lane's keyframes, loops and ATE below,
   exactly; logs bench.py's ``parity`` dict; see ``run_parity``;
17. the device axis (``parallel/mesh.py``) over two ranks, each its own
   process on ``cuda:(rank % cards)`` (both on one card here), gathers
   over gloo, each path against its one-process run in the same phase
   with the launch counters reset just before (the ranks' launches added
   to this process's counters): (a) ``cli.sweep --lanes 64 --devices 2``
   (32 lanes a rank, one CFAR launch a rank), all 64 lanes bit for bit with
   the one-process ``cli.sweep`` and phase 13a's pins; (b)
   ``cli.two_robot_demo --devices 2`` (one robot a rank), both robots bit
   for bit with the one-process batched scan and phase 13b's pins; (c)
   ``cli.sharded_replay --max-keyframes 1024 --devices 2 --check
   --duration 60``: the refinement's fan-outs sharded, the same keyframes
   and loops as the one-process replay, max |dpose| under 1e-5 m (whether
   bit for bit logged), phase 13c's pins, one CFAR launch a rank counted
   apart from the one-process replay's; (d) the three keyframe-axis
   functions at K 1024, N 256, W 3 over two ranks, equal to the unsharded
   calls; wall times, each rank's peak MiB and the spawn time logged; see
   ``run_mesh_sweep`` to ``run_mesh_kf``.

The second-to-last line is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py survey-bag`` runs one measurement instead, on the
host alone: phase 4's survey as lz4 ROS bags through ``cli.convert_bag``
with each LZ4 decoder (``run_survey_bag``).
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
# phase 3: the Kalman filter kernel against its plain version, the event
# loop, on phase 4's survey with the Kalman cell's 200 Hz IMU (100,320
# events). States the stream observes (through an H, or through A from an
# observed one) agree within tests/test_torch_kalman_cuda.py's tolerances.
# Three it does not (x and y, which only integrate the velocities, and the
# yaw rate, which only the FOG observes) are float32 accumulations over the
# whole survey: the loop itself, on the card as on the CPU, lands up to
# 7.95e-3 m (on 214 m) and, in P[11, 11], 0.63 (on 960) from a float64 run
# of it on the CPU. There the kernel's gap to the loop must stay within
# KALMAN_UNOBSERVED_FACTOR times the loop's own gap to that float64 run
# (two float32 roundings of the same recursion, each about as far from the
# exact value). On an H100 80GB HBM3 (700 W) the kernel reads 0.0 from the
# loop on the observed states and at most 2.3e-10 on x and y.
KALMAN_IMU_RATE = 200.0
KALMAN_RTOL = KALMAN_ATOL = 1e-5
KALMAN_P_ATOL = 1e-7
KALMAN_UNOBSERVED = (0, 1, 11)
KALMAN_UNOBSERVED_FACTOR = 2.0
# the kernel's dependent chain (kernels/csrc/kalman.cu): barrier-separated
# steps an event, and the float32 operations in line between them (FMAs,
# adds and multiplies; one division and one shuffle an event besides), an
# IMU event and any other event run
KALMAN_CHAIN = {"imu": (4, 74), "other": (2, 49)}
# phase 10: the card's z RMSE within this of the JAX result's (the port on
# the CPU lands 0.0 m from it, tests/test_torch_dual_lane.py), and the JAX
# package's lane on a TPU (BENCH_r05.json), printed for scale only
DUAL_Z_BAND_M = 5e-3
BENCH_R05_DUAL = {"z_rmse_cm": 4.15, "z_points": 922}
# phase 12: the CLI on phase 4's survey with the YAML configuration
# (keyframes, loops, ATE m and deg, rounded as for phase 4): the port's own
# result on an H100 80GB HBM3 (700 W) since dead reckoning scans rows; no
# JAX run of this configuration at full size exists. The keyframes are
# phase 4's (the gate sees the same odometry and thresholds). Phases 12,
# 13a, 13b and 14c-14e were re-pinned when the DR scan became rows: their
# ill-conditioned loops turn its float32-ulp odometry move into other
# results (old and new values: PERF.md section 6).
CLI_EXPECTED = (73, 31, 0.2589, 0.661)
# phase 12: the grid the CLI builds keyframe by keyframe against a full
# repaint, as a share of the observed cells whose method-1 value may differ
# (each keyframe's cells are divided exactly in the one and by the
# reciprocal in the other; on the CPU none of 30,444 and 6 of 31,136
# differ, tests/test_torch_cli.py and tests/test_torch_occupancy.py)
CLI_REPAINT_SHARE = 0.002
# phase 13: the port's own results on an H100 80GB HBM3 (700 W), as for
# phases 4 and 12 (no JAX run of these on a card exists; on the CPU the three
# CLIs are held to the JAX scripts at shorter durations by
# tests/test_torch_{parallel,multi_robot,sharded_replay}.py): the sweep's
# (keyframes, loops per lane, best ATE m), the two-robot demo's (keyframes,
# loops, proposals, PCM accepts, clique size, merged ATE m rounded to 0.1
# mm) and the large-capacity replay's (keyframes, loops, ATE m)
SWEEP_LANES = 64
# 13a: lanes 0-7 of the 64-lane batched sweep, the 8 combinations of the
# 8-lane loop of lone scans this phase ran before, with its pin
SWEEP_EXPECTED = (19, [5, 5, 5, 5, 9, 9, 9, 9], 0.2429)
# 13a: the lanes held bit for bit against a lone slam_scan of their params,
# each lane's (loops, ATE m); and the band a lane's ATE must keep to its
# lone scan's (bits keep it at 0)
SWEEP_LONE_LANES = (0, 7, 63)
SWEEP_LONE_EXPECTED = {0: (5, 0.2883), 7: (9, 0.2429), 63: (9, 0.262)}
SWEEP_ATE_BAND_M = 0.005
# 13a: the batched scan's kernel launches a keyframe step at 64 lanes may
# be at most this many times those at one lane
SWEEP_LAUNCH_RATIO = 2.0
# 13d: a full-width point-to-line sweep: FULL_SWEEP_LANES lanes of
# cli.sweep's grid over full_config's params on phase 4's survey; the
# lanes held bit for bit against a lone slam_scan, each lane's pinned
# (keyframes, loops, ATE m), the port's own result on an H100 80GB HBM3
# (700 W); the launches a step counted on the first FULL_SWEEP_PREFIX
# keyframes
FULL_SWEEP_LANES = 8
FULL_SWEEP_LONE_LANES = (0, 7)
FULL_SWEEP_LONE_EXPECTED = {0: (73, 7, 0.1069), 7: (73, 6, 0.099)}
FULL_SWEEP_PREFIX = 16
TWO_ROBOT_EXPECTED = ([18, 19], [9, 4], 5, 4, 4, 0.0746)
# 13e: the robot axis at full width: robot A on phase 4's survey, robot B
# on the same SimConfig with seed 1 at phase pi, under full_sweep_config's
# dims and params, as lanes of one batched multi_robot_scan; each robot's
# (keyframes, loops, ATE m) and the merge's (proposals, PCM accepts,
# clique, merged ATE m), the port's own results on an H100 80GB HBM3
# (700 W); the launches a step counted on the first FULL_ROBOTS_PREFIX
# keyframes of each robot, at two robots at most ROBOT_LAUNCH_RATIO times
# those at one
FULL_ROBOTS_EXPECTED = {0: (73, 8, 0.0978), 1: (71, 5, 0.1859)}
FULL_ROBOTS_MERGE_EXPECTED = (2, 2, 2, 0.3011)
FULL_ROBOTS_PREFIX = 16
ROBOT_LAUNCH_RATIO = 1.5
SHARDED_EXPECTED = (13, 4, 0.0496)
# phase 13c replays a 60 s survey: on the card the 90 s default's loops
# are ill-conditioned in the capacity (K 1024 closes 9 loops, K 128 eight;
# python tests/test_torch_sharded_replay.py cuda), so --capacity-check would fail
# there; at 60 s the two capacities agree within 1.9e-6 m
SHARDED_DURATION = "60"
# phase 14: the accuracy CLIs. The pins are the port's own results on
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
    "A_full_pipeline": {"ate_cm": 3.06, "dr_ate_cm": 3.68, "keyframes": 19,
                        "loops": 9},
    "B_noiseless_sensors": {"ate_cm": 1.62, "dr_ate_cm": 1.33,
                            "keyframes": 18, "loops": 9},
    "C_gt_features": {"ate_cm": 2.52, "dr_ate_cm": 3.68, "keyframes": 19,
                      "loops": 11},
    "D_noiseless_gt_features": {"ate_cm": 1.46, "dr_ate_cm": 1.33,
                                "keyframes": 18, "loops": 9}}
# 14d: cli.accuracy_sweep (small, 1 seed): (label, ATE cm, loops), ranked
ACCURACY_SWEEP_EXPECTED = [
    ("baseline r1 (.5/.5/.5)", 2.74, 10), ("feat.25 (.25/.5/.5)", 3.02, 7),
    ("agg.25 (.25/.25/.5)", 3.47, 9), ("no-subbin (.5/.5/.5)", 7.07, 10),
    ("noise.25 (.25/.25/.25)", 8.23, 7), ("noise.35 (.25/.25/.35)", 8.38, 8),
    ("fine (.125/.25/.25) 2xpts", 10.88, 11)]
# 14e: cli.map_probe (small) and cli.frontier_coverage_probe --alg OS
# (small): their whole reports
MAP_PROBE_EXPECTED = {
    "config": "small", "n_cells": 1708, "n_truth": 988, "precision@0.4": 0.802,
    "recall@0.4": 0.713, "recall@0.8": 0.732,
    "d_truth_q_m": {"50": 0.12, "75": 1.33, "90": 5.89, "95": 9.94, "99": 11.73,
                    "100": 12.17},
    "d_cell_q_m": {"50": 0.21, "75": 0.36, "90": 0.52, "95": 0.65, "99": 0.88,
                   "100": 1.1},
    "d_cell_mean_m": 0.26, "d_truth_mean_m": 1.57, "feat_recall@0.4": 0.894,
    "d_truth_feat_q_m": {"50": 0.09, "75": 0.19, "90": 0.43, "95": 0.98,
                         "99": 2.52, "100": 7.78}}
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
# phase 16: bench.py's reference-faithful parity lanes (cli/parity_lane.py)
# on phase 4's survey. No JAX run of this path on this bag exists; each
# lane's (keyframes, loops, ATE m, ATE deg) is the port's own first result on
# an H100 80GB HBM3 (700 W), held exactly (0.1 mm, 0.001 deg). The faithful
# lane is chaotic by mechanism (tests/test_parity.py): its guards are
# directional, worse than dead reckoning and at least PARITY_COLLAPSE_FACTOR
# times phase 4's production ATE; odometry mode must reproduce dead
# reckoning within PARITY_ODOMETRY_ATOL_M with no loop
PARITY_EXPECTED = {"faithful": (73, 21, 3.402, 10.718),
                   "ssm_only": (73, 0, 4.7035, 7.955),
                   "odometry": (73, 0, 0.4017, 0.252)}
PARITY_COLLAPSE_FACTOR = 5.0
PARITY_ODOMETRY_ATOL_M = 1e-3
# the JAX package's state array layout (sonar_slam_tpu/io/state.py)
# phase 17: the device axis (parallel/mesh.py) over MESH_RANKS ranks, which
# share cuda:0 on a one-card machine; each path is held to its one-process
# run in this phase, and to phase 13's pins. 17c's bound is the JAX
# script's (scripts/sharded_replay.py: sharded within 1e-5 m of one device).
# 17d: the keyframe-axis functions at (K, N, W).
MESH_RANKS = 2
MESH_KF_SHAPE = (1024, 256, 3)
MESH_TIMEOUT_S = 600.0

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


def window_weight(t: int, g: int, device):
    """``conv2d`` weights of a pixel's two training windows along the rows:
    output channel 0 sums rows r - t - g ... r - g - 1, channel 1 rows
    r + g + 1 ... r + t + g (the sum kernel's library yardstick)."""
    import torch

    hw = t + g
    weight = torch.zeros((2, 1, 2 * hw + 1, 1), device=device)
    weight[0, 0, :t] = 1.0
    weight[1, 0, hw + g + 1:] = 1.0
    return weight


def time_sum_kernel(stacks, edge: str, lib_stacks) -> dict:
    """The sum kernel's SOCA call at (train 20, guard 5, gate 65) with
    ``edge``, timed by CUDA events over the two alternating ``stacks``:
    plain, kernel, kernel, plain (mask only), then with the threshold map,
    with a gate no pixel passes (no window arithmetic: the tile's floor),
    and ``conv2d`` of ``window_weight`` on ``lib_stacks`` (the window sums
    alone). The mask's bound counts the gated pixels of the rows that may
    detect; the threshold map needs every such pixel's sums. Logs and
    returns the times, bounds and shares."""
    import torch.nn.functional as F
    from sonar_slam_torch.kernels.cfar_cuda import (cfar_detect, cfar_plain,
                                                    valid_rows)
    from sonar_slam_torch.kernels.cfar_factors import threshold_factor_soca

    imgs = stacks[0]
    t, g, gate = 20, 5, 65.0
    tau = threshold_factor_soca(40, 0.1)
    weight = window_weight(t, g, imgs.device)

    def kern(x):
        cfar_detect(x, t, g, tau, "SOCA", gate, edge)

    def plain(x):
        cfar_plain(x, t, g, tau, "SOCA", gate, edge)

    p1 = cuda_time_ms(plain, stacks)
    k1 = cuda_time_ms(kern, stacks)
    k2 = cuda_time_ms(kern, stacks)
    p2 = cuda_time_ms(plain, stacks)
    kt = cuda_time_ms(lambda x: cfar_detect(
        x, t, g, tau, "SOCA", gate, edge, with_threshold=True), stacks)
    floor = cuda_time_ms(
        lambda x: cfar_detect(x, t, g, tau, "SOCA", 1e30, edge), stacks)
    lib = cuda_time_ms(lambda x: F.conv2d(x, weight), lib_stacks)
    ms = min(k1, k2)
    rows = valid_rows(imgs.shape[1], t, g, edge, imgs.device)
    bound_ms, bound_by = bound(imgs, 2 * t * gated_pixels(imgs[:, rows], gate))
    thr_bound, thr_by = bound(imgs, 2 * t * imgs[:, rows].numel(),
                              with_threshold=True)
    log(f"cfar SOCA {edge} {tuple(imgs.shape)} mask only ms: kernel {k1} "
        f"{k2}, plain {p1} {p2}; with the threshold map {kt} (bound "
        f"{thr_bound} ({thr_by}), share {thr_bound / kt}); with a gate no "
        f"pixel passes (no window arithmetic) {floor}; conv2d window sums "
        f"{lib}; bound {bound_ms} ({bound_by}), share {bound_ms / ms}")
    return {"ms": ms, "plain_ms": min(p1, p2), "bound_ms": bound_ms,
            "bound_by": bound_by, "roofline_share": bound_ms / ms,
            "library_ms": lib, "floor_ms": floor, "ms_with_threshold": kt,
            "bound_ms_with_threshold": thr_bound,
            "bound_by_with_threshold": thr_by,
            "roofline_share_with_threshold": thr_bound / kt}


def gated_pixels(imgs, gate: float) -> int:
    """Pixels over the intensity gate: the ones whose window arithmetic the
    mask needs (extend edge, so every row may detect)."""
    return int((imgs > gate).sum())


# latency probes for the Kalman kernel's bound: one block of the kernel's
# 160 threads passing values through shared memory a barrier a step, and
# dependent chains of one float32 operation in one warp
LATENCY_PROBE_SRC = r"""
#include <cuda_runtime.h>
constexpr int THREADS = 160;
constexpr int UNROLL = 16;

// a step of kalman.cu's chain: read another thread's value from shared
// memory, one FMA, write it to the other buffer, a barrier
__global__ void step_probe(int reps, float* out) {
  __shared__ float buf[2][THREADS];
  const int t = threadIdx.x;
  buf[0][t] = t * 1e-3f;
  __syncthreads();
  int cur = 0;
  float v = 0.0f;
  for (int r = 0; r < reps; ++r) {
    v = fmaf(buf[cur][(t + 1) % THREADS], 0.999f, 1e-3f);
    buf[cur ^ 1][t] = v;
    __syncthreads();
    cur ^= 1;
  }
  out[t] = v;
}

template <int OP>
__global__ void chain_probe(int reps, float* out) {
  float v = 1.0f + threadIdx.x * 1e-3f;
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (OP == 0) v = fmaf(v, 0.9999f, 1.0001f);
      else if (OP == 1) v = 1.0001f / v;
      else v = __shfl_xor_sync(0xffffffffu, v, 1);
    }
  }
  out[threadIdx.x] = v;
}

// which: 0 the step, 1 an FMA, 2 a division, 3 a shuffle; returns
// cudaGetLastError()
extern "C" int latency_probe_launch(int which, int reps, float* out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) step_probe<<<1, THREADS, 0, s>>>(reps, out);
  else if (which == 1) chain_probe<0><<<1, 32, 0, s>>>(reps / UNROLL, out);
  else if (which == 2) chain_probe<1><<<1, 32, 0, s>>>(reps / UNROLL, out);
  else chain_probe<2><<<1, 32, 0, s>>>(reps / UNROLL, out);
  return (int)cudaGetLastError();
}
"""


def measure_latencies(dev, reps: int = 1 << 18) -> dict:
    """The latencies the Kalman kernel's chain is made of, in ns, by CUDA
    events: a barrier step (``step_ns``), a dependent FMA, division and
    shuffle. Each is the time of ``2 * reps`` less that of ``reps``, over
    ``reps``, so the launch drops out; the least of three."""
    import ctypes

    import torch
    from sonar_slam_torch.kernels import nvcc_build

    work = tempfile.mkdtemp(prefix="latency_probe_")
    try:
        src = os.path.join(work, "latency_probe.cu")
        with open(src, "w") as f:
            f.write(LATENCY_PROBE_SRC)
        lib = ctypes.CDLL(nvcc_build.build(src, "liblatency_probe"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    fn = lib.latency_probe_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(160, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev)

    def ms(which, n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = fn(which, n, out.data_ptr(), stream.cuda_stream)
        end.record()
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"latency probe {which}: CUDA error {err}")
        return start.elapsed_time(end)

    got = {}
    for which, name in enumerate(("step_ns", "fma_ns", "div_ns", "shfl_ns")):
        ms(which, reps)  # warm-up
        got[name] = min((ms(which, 2 * reps) - ms(which, reps)) * 1e6 / reps
                        for _ in range(3))
    log(f"latencies on the card (ns): {json.dumps(got)}")
    return got


def kalman_chain_ms(codes, lat: dict) -> float:
    """Least ms ``kalman_filter_kernel`` could take for the events of
    ``codes`` (a host array) by its own dependent chain (``KALMAN_CHAIN``)
    at the latencies ``lat`` (``measure_latencies``): each barrier step
    costs ``step_ns``, which holds one FMA, and each further operation in
    line an FMA; a division and a shuffle an event."""
    import numpy as np

    n_imu = int(np.count_nonzero(codes == 0))
    n_other = int(np.count_nonzero((codes >= 1) & (codes <= 3)))
    total = 0.0
    for n, (steps, ops) in ((n_imu, KALMAN_CHAIN["imu"]),
                            (n_other, KALMAN_CHAIN["other"])):
        total += n * (steps * lat["step_ns"] + (ops - steps) * lat["fma_ns"]
                      + lat["div_ns"] + lat["shfl_ns"])
    return total * 1e-6


def check_kalman_kernel(sim, dev) -> dict:
    """``kalman_filter_kernel`` against its plain version, the event loop
    of ``estimators/kalman.py`` on the card, on the same codes and prepared
    measurements: phase 4's survey with the Kalman cell's 200 Hz IMU (its
    navigation streams, which do not depend on the pings; one ping in 100
    s), through ``default_kalman_config``. Holds the kernel's state after
    every IMU event, final state and covariance to the loop's (see
    KALMAN_RTOL and KALMAN_UNOBSERVED_FACTOR), its event count, and two
    runs to each other bit for bit; times the kernel (the least of three)
    and the loop once by CUDA events. The bound is the kernel's own chain
    at the card's measured latencies (``kalman_chain_ms``); its bytes, far
    below, are logged beside it. Returns the kernel table entry."""
    import dataclasses

    import numpy as np
    import torch
    from sonar_slam_torch.estimators import kalman as te
    from sonar_slam_torch.io.simulate import simulate_bag
    from sonar_slam_torch.kernels import kalman_cuda
    from sonar_slam_torch.pipeline import default_kalman_config, kalman_events
    from sonar_slam_torch.utils.timing import to_device

    bag = simulate_bag(dataclasses.replace(sim, imu_rate=KALMAN_IMU_RATE,
                                           sonar_rate=0.01))
    cfg = default_kalman_config(bag.imu_time, dev)
    _, types, z = kalman_events(bag, cfg.use_gyro)
    _, zp, dvl_ok, codes = te._prepare(types, to_device(z, dev), cfg)
    zp = zp.contiguous()
    sensors = [(H.contiguous(), R.contiguous()) for H, R in te._sensors(cfg)]
    T, ran_want = len(types), int(dvl_ok.sum())

    def kernel():
        return kalman_cuda.kalman_filter(codes, zp, cfg.A_imu.contiguous(),
                                         cfg.Q.contiguous(), sensors)

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    first = kernel()
    again, _ = timed(kernel)
    times = [timed(kernel)[1] for _ in range(3)]
    ms = min(times)
    bitwise = all(torch.equal(a, b) for a, b in zip(first, again))
    plain, plain_ms = timed(lambda: te._filter_loop(types, dvl_ok, zp, cfg))
    cpu64 = cfg._replace(**{k: v.cpu().double() for k, v in
                            cfg._asdict().items()
                            if isinstance(v, torch.Tensor)})
    exact = te._filter_loop(types, dvl_ok, zp.cpu().double(), cpu64)
    x, P, hist, yaw_gyro, count = (t.cpu() for t in first)
    lx, lP, lhist, lyaw = (t.cpu() for t in plain)
    ran = int(count)
    imu = types == te.EVENT_IMU
    obs = [i for i in range(12) if i not in KALMAN_UNOBSERVED]
    un = list(KALMAN_UNOBSERVED)

    def gap(a, b):
        return float((a.double() - b.double()).abs().max())

    def close(a, b, atol):
        return bool(((a.double() - b.double()).abs()
                     <= atol + KALMAN_RTOL * b.double().abs()).all())

    observed_ok = (close(hist[imu][:, obs], lhist[imu][:, obs], KALMAN_ATOL)
                   and close(x[obs], lx[obs], KALMAN_ATOL)
                   and close(P[obs][:, obs], lP[obs][:, obs], KALMAN_P_ATOL)
                   and close(yaw_gyro, lyaw, KALMAN_ATOL))
    err = max(gap(hist[imu][:, obs], lhist[imu][:, obs]),
              gap(x[obs], lx[obs]), gap(yaw_gyro, lyaw))
    p_err = gap(P[obs][:, obs], lP[obs][:, obs])
    # the unobserved states: each state's series and final value, and each
    # covariance row that touches them
    ehist, ex, eP = exact[2], exact[0], exact[1]
    ratios = {}
    for i in un:
        pairs = {f"hist[{i}]": (hist[imu][:, i], lhist[imu][:, i],
                                ehist[imu][:, i]),
                 f"x[{i}]": (x[i], lx[i], ex[i]),
                 f"P[{i}, :]": (P[i], lP[i], eP[i])}
        for name, (k, l, e) in pairs.items():
            ratios[name] = {"kernel_loop": gap(k, l), "loop_exact": gap(l, e),
                            "kernel_exact": gap(k, e)}
    unobserved_ok = all(
        r["kernel_loop"] <= KALMAN_UNOBSERVED_FACTOR * r["loop_exact"]
        + KALMAN_ATOL for r in ratios.values())

    codes_h = codes.cpu().numpy()
    n_imu = int(imu.sum())
    lat = measure_latencies(dev)
    bound_ms = kalman_chain_ms(codes_h, lat)
    # bytes: each event's code and measurement read, the outputs zeroed
    # (the state history and the FOG yaw) and the state written after each
    # IMU event
    nbytes = T * (1 + 12) + T * 48 + 4 * (T + 1) + n_imu * 48
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    log(f"kalman filter kernel, {T} events ({n_imu} IMU, {T - ran_want} "
        f"gated): ran {ran}; kernel ms {times} (bit for bit in two runs: "
        f"{bitwise}), the loop on the card {plain_ms} ms; observed states "
        f"max abs gap {err}, their covariance {p_err} (within tolerance: "
        f"{observed_ok}); unobserved states {json.dumps(ratios)} (within "
        f"{KALMAN_UNOBSERVED_FACTOR}x the loop's own gap: {unobserved_ok}); "
        f"bound {bound_ms} ms (latency; bytes {bytes_ms} ms), share "
        f"{bound_ms / ms}; {ms * 1e3 / T} us an event")
    if ran != ran_want or not bitwise:
        raise RuntimeError(f"Kalman kernel ran {ran} of {ran_want} events, "
                           f"bit for bit in two runs: {bitwise}")
    if not (observed_ok and unobserved_ok):
        raise RuntimeError("Kalman kernel disagrees with its plain version")
    return {"name": "kalman_filter_kernel (one block, the whole event stream)",
            "route": "cuda",
            "source": "sonar_slam_torch/kernels/csrc/kalman.cu",
            "replaces": "none (sonar_slam_tpu/estimators/kalman.py::"
                        "kalman_scan runs the stream as one lax.scan)",
            "events": T, "imu_events": n_imu, "launches": 0,
            "max_abs_err": err, "covariance_max_abs_err": p_err,
            "unobserved": ratios, "ms": ms, "plain_ms": plain_ms,
            "us_per_event": ms * 1e3 / T, "bound_ms": bound_ms,
            "bound_by": "latency", "roofline_share": bound_ms / ms,
            "bytes_bound_ms": bytes_ms, "latencies_ns": lat}


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
    padded = [F.pad(x[:, None], (0, 0, hw, hw), mode="replicate")
              for x in stacks]
    sums = F.conv2d(padded[0], window_weight(t, g, imgs.device))
    lead, lag = _window_sums(imgs, t, g)
    conv_err = max(float((sums[:, 0] - lead).abs().max()),
                   float((sums[:, 1] - lag).abs().max()))
    log(f"conv2d window sums against the in-order sums: max abs diff "
        f"{conv_err} (sums up to {float(lead.max())})")
    del sums, lead, lag
    return {"name": "cfar_sum_kernel (CA/SOCA/GOCA, fused intensity gate)",
            "route": "cuda",
            "source": "sonar_slam_torch/kernels/csrc/cfar.cu",
            "replaces": "sonar_slam_tpu/kernels/cfar_pallas.py:32",
            "launches": 0, "max_abs_err": thr_err,
            **time_sum_kernel(stacks, "extend", padded),
            "library_call": "torch.nn.functional.conv2d, window sums only"}


def check_strict(stacks) -> dict:
    """The sum kernel with the strict edge at the feature path's shape
    (128, 512, 256), SOCA, gate 65: the call of the parity lanes' front end
    (phase 16). Rows [0, t+g) and [R-t-g, R) never detect; the 64-row tiles
    straddle those bands. On both stacks the mask (mask-only call and
    threshold call) and the threshold map must equal the plain version's bit
    for bit. Timed as the extend row (``check_kernel``); the bound counts
    the gated pixels of the interior rows, the yardstick is ``conv2d``
    without padding (the interior rows' window sums). Returns the row for
    the kernel table entry."""
    import torch
    from sonar_slam_torch.kernels.cfar_cuda import (cfar_detect, cfar_plain,
                                                    valid_rows)
    from sonar_slam_torch.kernels.cfar_factors import threshold_factor_soca

    t, g, gate = 20, 5, 65.0
    tau = threshold_factor_soca(40, 0.1)
    thr_err = 0.0
    for i, imgs in enumerate(stacks):
        det_k, thr_k = cfar_detect(imgs, t, g, tau, "SOCA", gate, "strict",
                                   with_threshold=True)
        det_m = cfar_detect(imgs, t, g, tau, "SOCA", gate, "strict")
        det_p, thr_p = cfar_plain(imgs, t, g, tau, "SOCA", gate, "strict")
        torch.cuda.synchronize()
        rows = valid_rows(imgs.shape[1], t, g, "strict", imgs.device)
        mismatch = int((det_k != det_p).sum()) + int((det_m != det_p).sum())
        border = int(det_k[:, ~rows].sum()) + int(det_m[:, ~rows].sum())
        err = float((thr_k - thr_p).abs().max())
        bitwise = bool(torch.equal(thr_k, thr_p))
        log(f"cfar SOCA strict {tuple(imgs.shape)} stack {i}: mask mismatches "
            f"{mismatch} of {2 * det_p.numel()}, detections {int(det_p.sum())}, "
            f"border-row detections {border}, threshold max abs err {err} "
            f"(bitwise equal: {bitwise})")
        if mismatch or border or not bitwise:
            raise RuntimeError("strict-edge CFAR kernel disagrees with its "
                               "plain version")
        thr_err = max(thr_err, err)
        del det_k, thr_k, det_m, det_p, thr_p
    return {"shape": list(stacks[0].shape), "edge": "strict", "gate": gate,
            "max_abs_err": thr_err,
            **time_sum_kernel(stacks, "strict", [x[:, None] for x in stacks])}


def check_os_kernel(stacks):
    """The two OS kernels against their plain version; returns the kernel
    table entry.

    The mask path (``cfar_os_mask_kernel``: mask only, tau > 0, the feature
    path's call) must give the plain version's mask bit for bit; the
    threshold path (``cfar_os_kernel``, the exact selection from a sorted
    sliding window) its mask and threshold map. Both on the float pings and
    on an integer-valued copy, at (128, 512, 256) with ranks 10 (the main
    path's call), 0 and 39 and at (4, 96, 40), which crosses both border
    bands, with ranks 0, 10 and 39; then the threshold path with tau 0 and
    -1 at (128, 512, 256), and on a ragged (3, 97, 37) stack with NaN, +inf
    and -inf pixels at ranks 0, 10 and 39, both edges, with and without the
    gate."""
    import torch
    from sonar_slam_torch.kernels.cfar_cuda import cfar_detect, cfar_os_plain
    from sonar_slam_torch.kernels.cfar_factors import threshold_factor_os

    imgs = stacks[0]
    t, g, gate, rank = 20, 5, 65.0, 10
    tau = threshold_factor_os(40, rank, 0.1)
    small = imgs[:4, :96, :40].contiguous()
    cases = [(imgs, k, "extend") for k in (rank, 0, 39)] + [
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

    # the threshold path alone: tau <= 0 (no mask kernel takes it), and a
    # ragged stack with NaN and infinities
    def equal_nan(a, b):
        return bool(((a == b) | (a.isnan() & b.isnan())).all())

    for tau_x in (0.0, -1.0):
        dk, tk = cfar_detect(imgs, t, g, tau_x, "OS", gate, "extend",
                             with_threshold=True, rank=rank)
        dp, tp = cfar_os_plain(imgs, t, g, rank, tau_x, gate, "extend")
        torch.cuda.synchronize()
        ok = torch.equal(dk, dp) and torch.equal(tk, tp)
        log(f"cfar OS threshold path tau {tau_x} rank {rank} "
            f"{tuple(imgs.shape)}: bitwise equal {ok}")
        if not ok:
            raise RuntimeError(f"OS selection kernel disagrees (tau {tau_x})")
        del dk, tk, dp, tp
    ragged = imgs[:3, :97, :37].clone()
    ragged[0, 3, 1] = float("nan")
    ragged[1, 50, 36] = float("inf")
    ragged[2, 10, 5] = float("-inf")
    ragged[2, 20:30, 7] = 5.0
    for k in (0, 10, 39):
        for edge in ("strict", "extend"):
            for gate_x in (None, gate):
                dk, tk = cfar_detect(ragged, t, g, tau, "OS", gate_x, edge,
                                     with_threshold=True, rank=k)
                dp, tp = cfar_os_plain(ragged, t, g, k, tau, gate_x, edge)
                torch.cuda.synchronize()
                if not (torch.equal(dk, dp) and equal_nan(tk, tp)):
                    raise RuntimeError(f"OS selection kernel disagrees on the "
                                       f"ragged stack ({edge}, rank {k}, "
                                       f"gate {gate_x})")
    log("cfar OS threshold path on (3, 97, 37) with NaN and inf, ranks 0, 10, "
        "39, both edges, with and without the gate: bitwise equal")

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
    # the same call at another rank takes cfar_os_window_kernel (one sorted
    # array of 40, read at a run-time rank)
    kt0 = cuda_time_ms(lambda x: cfar_detect(
        x, t, g, tau, "OS", gate, "extend", with_threshold=True, rank=0),
        stacks)
    kn = cuda_time_ms(kern_no_gate, stacks)
    floor = cuda_time_ms(lambda x: cfar_detect(x, t, g, tau, "OS", 1e30,
                                               "extend", rank=rank), stacks)
    same_bytes = cuda_time_ms(lambda x: x > gate, stacks)
    lib = cuda_time_ms(library, windows, reps=4, warmup=1)
    # the rank-0 call's yardstick: the smallest of each window
    lib0 = cuda_time_ms(lambda w: torch.kthvalue(w, 1, dim=-1), windows,
                        reps=4, warmup=1)
    del windows
    ms = min(k1, k2)
    bound_ms, bound_by = bound(imgs, 2 * t * gated_pixels(imgs, gate))
    # with the threshold map every pixel needs its k-th smallest of 2 * t
    # cells: at least 2 * t - 1 comparisons
    thr_bound, thr_by = bound(imgs, (2 * t - 1) * imgs.numel(),
                              with_threshold=True)
    log(f"cfar OS threshold path (cfar_os_split_kernel, rank 10) {kt} ms, "
        f"bound {thr_bound} ({thr_by}), share {thr_bound / kt}, "
        f"torch.kthvalue {lib} ms ({lib / kt:.1f}x the kernel's time); rank 0 "
        f"(cfar_os_window_kernel) {kt0} ms, torch.kthvalue rank 0 {lib0} ms")
    log(f"cfar OS extend rank 10 {tuple(imgs.shape)} ms: mask path {k1} {k2}, "
        f"plain {p1} {p2}; threshold path (selection) {kt}; mask path "
        f"without the gate (every warp on the strip path) {kn}; with a gate "
        f"no pixel passes (no window arithmetic) {floor}; imgs > gate (the "
        f"same bytes in one elementwise call) {same_bytes}; "
        f"torch.kthvalue on the "
        f"window stack {lib}; bound {bound_ms} ({bound_by}), share "
        f"{bound_ms / ms}")
    return {"name": "cfar_os_mask_kernel (OS mask path, exact rank count, "
                    "fused intensity gate; threshold path cfar_os_kernel: "
                    "a sorted sliding window down each column)",
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
            "ms_with_threshold_rank0": kt0, "library_ms_rank0": lib0,
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
    _check_pin("OS path (keyframes, loops, ATE m, ATE deg, map)",
               (nk, nl, round(ate, 4), round(ate_deg, 3),
                {k: mm[k] for k in OS_MAP}),
               (FULL_KEYFRAMES, OS_LOOPS, OS_ATE_M, OS_ATE_DEG, OS_MAP))
    return mask_launches


def check_small(dev):
    """bench.py --small (refinement off) on the card, checked by stage.

    The first loop of this survey (keyframe 8 against keyframe 0) is
    ill-conditioned: all 12 starts of its multi-start ICP end with the same
    25 inliers, spread over 2.3 m, and the first start's solution can move
    by 0.78 m when the inputs move by a few microns. The JAX package itself,
    fed the port's dead-reckoning poses (at most 1.7e-5 m from its own),
    ends up 0.17 m from its own result. So the card is held to two JAX
    results: the JAX package's own (tests/golden/small_norefine_traj.npz)
    and the JAX scan fed the card's own dead-reckoning poses
    (tests/golden/small_norefine_traj_port_dr_rows.npz, made from phase 7's
    hex dump: ``python tests/test_torch_slam.py``).

    The card's whole replay must give the JAX keyframes, the loop count and
    a trajectory within SCAN_ATOL_M of one of the two JAX results, and an
    ATE within SMALL_ATE_BAND_M of the JAX result's, either way. Each stage is
    held tightly to the port's CPU run on the same inputs (the feature
    clouds, and the SLAM scan fed the CPU's feature clouds). A second replay
    on the card, after the allocator's free memory is filled with NaN, must
    repeat the first bit for bit. Returns the SLAM scan's inputs on the card
    (keyframes, params, dims) for phase 15c.
    """
    import numpy as np
    import torch
    from sonar_slam_torch.io.simulate import simulate_bag
    from sonar_slam_torch.pipeline import ate_heading_deg, ate_rmse, replay
    from sonar_slam_torch.slam import KeyframeInput, slam_scan

    sim, dims, params_on, fcfg = small_config(seed=0)
    bag = simulate_bag(sim)
    ref = np.load(os.path.join(HERE, "tests", "golden", "small_norefine_traj.npz"))
    rows = np.load(os.path.join(HERE, "tests", "golden",
                                "small_norefine_traj_port_dr_rows.npz"))
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
    card_errs = [(float(np.abs(gpu.trajectory - r["trajectory"]).max()),
                  int(r["num_loops"])) for r in (ref, rows)]
    log(f"small config vs JAX: trajectory max abs diff CPU port {jax_err} m, "
        f"card {card_errs[0][0]} m (to the JAX result on the card's odometry "
        f"{card_errs[1][0]} m, {card_errs[1][1]} loops); first loop (keyframe "
        f"8 to 0) CPU {c.loops_tf[0].tolist()} card {g.loops_tf[0].tolist()}; "
        f"loops JAX {int(ref['num_loops'])} CPU {c.num_loops} card "
        f"{g.num_loops}; ATE m/deg JAX {ates[0]} CPU {ates[1]} card {ates[2]}")
    if (jax_err > SCAN_ATOL_M
            or not any(err <= SCAN_ATOL_M and loops == g.num_loops
                       for err, loops in card_errs)
            or abs(ates[2][0] - ates[0][0]) > SMALL_ATE_BAND_M):
        raise RuntimeError("small-config replay disagrees with the JAX results")
    return frames, params_on(dev), dims


def check_small_refine(dev):
    """bench.py --small with refinement on (tests/test_golden.py's
    configuration) on the card, twice, against the JAX package's results.

    The survey's ill-conditioned first loop (see ``check_small``) shows here
    too: the JAX package on its own dead reckoning logs 9 loops
    (tests/golden/small_traj.npz), and a float32-ulp move of the odometry
    moves its result by millimetres to centimetres. The second JAX result is
    the JAX package fed the card's own dead-reckoning poses at the keyframes
    (tests/golden/small_traj_port_dr_rows.npz, made from the hex dump this
    check logs: ``python tests/test_torch_replay_refine.py``). So the card
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
            for name in ("small_traj.npz", "small_traj_port_dr_rows.npz")}
    t0 = time.perf_counter()
    gpu = replay(bag, fcfg, params_on(dev), dims, dev)
    wall = time.perf_counter() - t0
    torch.full((1 << 28,), float("nan"), device=dev)  # freed, stays cached
    again = replay(bag, fcfg, params_on(dev), dims, dev)
    repeat = float(np.abs(again.trajectory - gpu.trajectory).max())
    dr = gpu.carry.dr_poses3.cpu().numpy().astype("<f4")
    log(f"small config with refinement, the card's dead-reckoning poses at the "
        f"keyframe slots, {dr.shape} float32 little-endian hex: {dr.tobytes().hex()}")
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
    card result. Returns the sum kernel's and the Kalman filter kernel's
    launch counts of the run (the Kalman path launches the filter once, a
    dead-reckoning path never)."""
    import dataclasses

    import numpy as np
    import torch
    from sonar_slam_torch.kernels import cfar_cuda, kalman_cuda
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
    kalman_cuda.kalman_filter.launches = 0
    t0 = time.perf_counter()
    res = replay(bag, fcfg, params, dims, dev, frontend=frontend)
    wall = time.perf_counter() - t0
    launches = cfar_cuda.cfar_detect.launches
    sum_launches = cfar_cuda.cfar_detect.kernel_launches["sum"]
    filter_launches = kalman_cuda.kalman_filter.launches
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
        f"launches {launches}, of them the sum kernel {sum_launches}; Kalman "
        f"filter kernel launches {filter_launches}")
    if not np.isfinite(res.trajectory).all():
        raise RuntimeError(f"{frontend} path: trajectory not finite")
    if sum_launches < 1 or sum_launches != launches:
        raise RuntimeError(f"{frontend} path made {launches} CFAR launches, "
                           f"{sum_launches} of the sum kernel")
    if filter_launches != (frontend == "kalman"):
        raise RuntimeError(f"{frontend} path launched the Kalman filter "
                           f"kernel {filter_launches} times")
    if not kf_ok or pos_err > ODO_POS_ATOL_M or ang_err > ODO_ANG_ATOL:
        raise RuntimeError(f"{frontend} path: odometry or keyframes differ "
                           f"from the JAX package's")
    got = (res.num_keyframes, nl, round(ate, 4), round(ate_deg, 3))
    _check_pin(f"{frontend} path (keyframes, loops, ATE m, ATE deg)", got,
               FRONTEND_EXPECTED[frontend])
    return sum_launches, filter_launches


def time_kalman_scan(bag, dev) -> dict:
    """The Kalman front end alone on the card: its wall time (twice) and,
    under ``torch.profiler``, its kernel launches; the filter kernel must
    launch once a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sonar_slam_torch.kernels import kalman_cuda
    from sonar_slam_torch.pipeline import odometry

    kalman_cuda.kalman_filter.launches = 0
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
    filter_launches = kalman_cuda.kalman_filter.launches
    n_events = len(bag.imu_time) + len(bag.dvl_time) + len(bag.depth_time)
    out = {"wall_s": walls, "launch_calls": names,
           "launches": sum(names.values()), "events": n_events,
           "filter_launches": filter_launches}
    log(f"kalman scan on the card ({n_events} events): wall s {walls}, kernel "
        f"launch calls under torch.profiler {json.dumps(names)}, Kalman "
        f"filter kernel launches in the 3 calls {filter_launches}")
    if filter_launches != 3:
        raise RuntimeError(f"3 Kalman scans launched the filter kernel "
                           f"{filter_launches} times")
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
    weight = window_weight(t, g, dev)
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


def gamma_quantize(images, gamma: int = 127):
    """The sonar's gamma compression of float pings to 8 bits, the wire's
    quantization (``cli.convert_bag.gamma_decompress`` inverts it)."""
    import numpy as np

    x = np.clip(np.asarray(images, np.float64) / 255.0, 0.0, 1.0)
    return np.round(255.0 * x ** (gamma / 255.0)).astype(np.uint8)


def check_lz4_decoder(bag, pings: int = 64, per_frame: int = 8) -> dict:
    """Phase 11's decoder check: LZ4 frames (``per_frame`` pings each) of
    phase 4's first ``pings`` pings, gamma-quantized to 8 bits, decoded by
    the compiled decoder and by the pure-Python one, which must give the
    same bytes. The simulator's speckle leaves those bytes incompressible,
    so the compressor stores every block raw; the same pings with every
    pixel at or under the intensity gate (65) set to 0 compress, and their
    frames take the block decoder. Returns the rates in MB/s of decoded
    bytes for both, measured on this machine's host CPU."""
    import numpy as np
    from sonar_slam_torch.io import lz4

    quantized = gamma_quantize(bag.ping_images[:pings])
    gated = np.where(bag.ping_images[:pings] > 65.0, quantized, 0).astype(np.uint8)
    out = {}
    for name, raw in (("pings", quantized), ("gated pings", gated)):
        chunks = [raw[i:i + per_frame].tobytes()
                  for i in range(0, pings, per_frame)]
        t0 = time.perf_counter()
        frames = [lz4.compress_frame(c) for c in chunks]
        t_compress = time.perf_counter() - t0
        total = sum(map(len, chunks))

        def rate(decode, reps):
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                got = [decode(f) for f in frames]
                best = min(best, time.perf_counter() - t0)
            if got != chunks:
                raise RuntimeError(f"{decode.__name__} does not give the "
                                   f"{name}' bytes back")
            return total / best / 1e6

        compiled = rate(lz4.decompress_frame, 5)
        plain = rate(lz4.decompress_frame_plain, 1)
        ratio = total / sum(map(len, frames))
        log(f"lz4 {name}: {total} bytes in {len(frames)} frames (ratio "
            f"{ratio:.3f}, Python compressor {t_compress:.1f} s); decoded MB/s "
            f"(host CPU): compiled {compiled:.1f}, pure Python {plain:.2f}, "
            f"{compiled / plain:.1f}x; byte-equal")
        if compiled < 50 * plain:
            raise RuntimeError(f"the compiled LZ4 decoder is under 50x the "
                               f"pure-Python one on the {name}")
        out[name] = {"bytes": total, "frames": len(frames), "ratio": ratio,
                     "compiled_mb_s": compiled, "plain_mb_s": plain}
    return out


def write_lz4_bag(bag, path: str, gamma: int = 127,
                  chunk_size: int | None = None):
    """Writes ``bag`` as an lz4-chunked ROS bag with raw 8-bit pings (the
    IMU yaw as a quaternion, the DVL, the depth and the gamma-quantized
    pings, each message stamped as the sensors' nodes stamp it), in one
    chunk or in chunks of ``chunk_size`` bytes. Returns the quantized
    pings, the quaternions, the bearings in hundredths of a degree, the
    range resolution and the number of messages."""
    import struct

    import numpy as np
    from sonar_slam_torch.io.rosbag import ROS_TOPICS, write_bag

    imgs_q = gamma_quantize(bag.ping_images, gamma)
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
    write_bag(path, conns, msgs, compression="lz4", chunk_size=chunk_size)
    return imgs_q, quats, cdeg, res, len(msgs)


def run_bag_seam(dev, work: str) -> int:
    """Phase 11: a small survey through a genuine lz4 bag, ``cli.convert_bag``
    and ``cli.replay`` on the card, against ``pipeline.replay`` of the same
    quantized arrays in process. Returns the CLI run's sum-kernel launches."""
    import numpy as np
    import torch
    from sonar_slam_torch.cli import convert_bag
    from sonar_slam_torch.cli import replay as replay_cli
    from sonar_slam_torch.io.config import load_feature_config, load_slam_config
    from sonar_slam_torch.io.rosbag import _quat_to_rpy
    from sonar_slam_torch.io.simulate import SimConfig, SyntheticBag, simulate_bag
    from sonar_slam_torch.kernels import cfar_cuda
    from sonar_slam_torch.pipeline import replay
    from sonar_slam_torch.slam.sonar import SonarGeometry

    # tests/test_torch_cli.py's survey: 13 keyframes and 4 loops
    sim = SimConfig(duration=40.0, speed=0.5, sonar_rate=1.0, num_ranges=96,
                    num_bearings=48, loop_radius=2.5, imu_rate=20.0, seed=2)
    bag = simulate_bag(sim)
    gamma = 127
    bag_path = os.path.join(work, "seam.bag")
    bundle = os.path.join(work, "seam.npz")
    t0 = time.perf_counter()
    imgs_q, quats, cdeg, res, n_msgs = write_lz4_bag(bag, bag_path, gamma)
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
    log(f"bag seam: {n_msgs} messages, lz4 bag {os.path.getsize(bag_path)} "
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
    _check_pin("cli.replay (keyframes, loops, ATE m, ATE deg)", got,
               CLI_EXPECTED)
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


def _launches(fn) -> int:
    """Kernel launch calls (``cudaLaunchKernel``, ``cuLaunchKernel``) of ``fn()``,
    counted in ``torch.profiler``'s raw CUDA trace (its ``key_averages``
    takes longer than the run over 10^5 launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if "LaunchKernel" in e.name() or e.name().startswith("cuLaunch"))


def run_sweep(dev) -> dict:
    """Phase 13a: ``cli.sweep --simulate`` at its default 64 lanes, one
    lane-batched scan. Returns its launches by kernel."""
    import numpy as np
    import torch
    from sonar_slam_torch.cli import sweep as sweep_cli
    from sonar_slam_torch.parallel import stack_params, sweep_scan
    from sonar_slam_torch.parallel.sweep import lane_params
    from sonar_slam_torch.pipeline import ate_rmse
    from sonar_slam_torch.slam import slam_scan

    run, took, peak, launches = _counted(lambda: sweep_cli.main(
        ["--simulate", "--lanes", str(SWEEP_LANES)]))
    rep = run.report
    nk = rep["keyframes"]
    log(f"cli.sweep --lanes {SWEEP_LANES}: whole CLI {took:.2f} s, wall_s "
        f"{rep['wall_s']}, compile_s {rep['compile_s']}, lane_seconds_per_lane "
        f"{rep['lane_seconds_per_lane']}, peak memory {peak:.1f} MiB, CFAR "
        f"launches {launches}; loops per lane {rep['loops_per_lane']}, best "
        f"lane {rep['best_lane']} ATE {rep['best_ate_m']} m, median "
        f"{rep['median_ate_m']} m")
    if not np.isfinite(run.carry.poses.cpu().numpy()).all():
        raise RuntimeError("cli.sweep: poses not finite")
    if launches["sum"] != 1 or sum(launches.values()) != 1:
        raise RuntimeError(f"cli.sweep made CFAR launches {launches}, expected "
                           "one of the sum kernel")
    _check_pin("cli.sweep lanes 0-7 (keyframes, loops per lane, best ATE m)",
               (nk, rep["loops_per_lane"][:8], round(min(run.ates[:8]), 4)),
               SWEEP_EXPECTED)
    for i in SWEEP_LONE_LANES:
        t0 = time.perf_counter()
        c1, _ = slam_scan(run.frames, lane_params(run.params, i), run.dims)
        torch.cuda.synchronize()
        lone_s = time.perf_counter() - t0
        lane = _lane(run.carry, i)
        same = _bit_equal(lane, c1)
        dpose = (lane.poses - c1.poses)[:nk].abs().max().item()
        lone_ate = ate_rmse(c1.poses.cpu().numpy()[:nk], run.truth)
        log(f"cli.sweep lane {i} against a lone slam_scan ({lone_s:.2f} s): "
            f"bit for bit {same}, max |dpose| {dpose:.3e} m, keyframes "
            f"{int(lane.num_kf)} and {c1.num_kf}, loops {int(lane.num_loops)} "
            f"and {c1.num_loops}, ATE {run.ates[i]:.4f} and {lone_ate:.4f} m")
        if abs(run.ates[i] - lone_ate) > SWEEP_ATE_BAND_M:
            raise RuntimeError(f"cli.sweep: lane {i}'s ATE is more than "
                               f"{SWEEP_ATE_BAND_M} m from its lone scan's")
        if not same:
            raise RuntimeError(f"cli.sweep: lane {i} differs from a lone scan")
        _check_pin(f"cli.sweep lane {i} (loops, ATE m)",
                   (c1.num_loops, round(lone_ate, 4)), SWEEP_LONE_EXPECTED[i])
    one = stack_params([lane_params(run.params, 0)])
    per_step = {}
    for name, params in (("B=1", one), (f"B={SWEEP_LANES}", run.params)):
        n = _launches(lambda: sweep_scan(run.frames, params, run.dims))
        per_step[name] = n / nk
    ratio = per_step[f"B={SWEEP_LANES}"] / per_step["B=1"]
    log(f"cli.sweep: kernel launches a keyframe step {json.dumps(per_step)}, "
        f"ratio {ratio:.3f}")
    if ratio > SWEEP_LAUNCH_RATIO:
        raise RuntimeError(f"cli.sweep: {SWEEP_LANES} lanes launch {ratio:.2f} "
                           f"times one lane's kernels a step")
    return launches


def full_sweep_config(seed: int = 0):
    """Phase 13d's configuration: ``full_config`` with DR-basis aggregation
    off (the JAX package's ``sweep_scan`` passes no basis; DVL-scale
    estimation reads none and stays on)."""
    import dataclasses

    sim, dims, params, fcfg = full_config(seed)
    return (sim, dataclasses.replace(dims, aggregate_with_dr_basis=False),
            params, fcfg)


def run_full_sweep(bag, dev) -> dict:
    """Phase 13d: ``parallel.sweep_scan`` of FULL_SWEEP_LANES lanes of
    ``cli.sweep``'s grid over ``full_sweep_config`` on phase 4's survey,
    the frames built as ``scripts/sweep.py`` builds them (the keyframe gate
    on the base params, one CFAR launch over the keyframe pings). Lanes
    FULL_SWEEP_LONE_LANES bit for bit with a lone ``slam_scan``, within
    SWEEP_ATE_BAND_M of its ATE and pinned; launches a keyframe step at all
    lanes at most SWEEP_LAUNCH_RATIO times one lane's. Returns the CFAR
    launches by kernel."""
    import numpy as np
    import torch
    from sonar_slam_torch.cli.sweep import build_frames, lane_grid
    from sonar_slam_torch.parallel import stack_params, sweep_scan
    from sonar_slam_torch.parallel.sweep import lane_params
    from sonar_slam_torch.pipeline import ate_rmse
    from sonar_slam_torch.slam import slam_scan

    t_phase = time.perf_counter()
    _, dims, params_on, fcfg = full_sweep_config(0)
    base = params_on(dev)
    (frames, kf_idx), _, _, launches = _counted(
        lambda: build_frames(bag, base, dims, fcfg, dev))
    if launches["sum"] != 1 or sum(launches.values()) != 1:
        raise RuntimeError(f"full sweep frames made CFAR launches {launches}, "
                           "expected one of the sum kernel")
    _, lanes = lane_grid(base, FULL_SWEEP_LANES)
    stacked = stack_params(lanes)
    (carry, _), wall, peak, _ = _counted(
        lambda: sweep_scan(frames, stacked, dims))
    nk = int(carry.num_kf[0])
    poses = carry.poses.cpu().numpy()[:, :nk]
    if not np.isfinite(poses).all():
        raise RuntimeError("full sweep: poses not finite")
    truth = bag.true_pose_at_ping[kf_idx][:nk]
    ates = [ate_rmse(p, truth) for p in poses]
    log(f"full point-to-line sweep, {FULL_SWEEP_LANES} lanes: wall_s "
        f"{wall:.3f}, lane_seconds_per_lane {wall / FULL_SWEEP_LANES:.4f}, "
        f"peak memory {peak:.1f} MiB; {nk} keyframes, loops per lane "
        f"{carry.num_loops.tolist()}, ATE per lane m "
        f"{[round(a, 4) for a in ates]}")
    for i in FULL_SWEEP_LONE_LANES:
        t0 = time.perf_counter()
        c1, _ = slam_scan(frames, lane_params(stacked, i), dims)
        torch.cuda.synchronize()
        lone_s = time.perf_counter() - t0
        lane = _lane(carry, i)
        same = _bit_equal(lane, c1)
        dpose = (lane.poses - c1.poses)[:nk].abs().max().item()
        lone_ate = ate_rmse(c1.poses.cpu().numpy()[:nk], truth)
        log(f"full sweep lane {i} against a lone slam_scan ({lone_s:.2f} s): "
            f"bit for bit {same}, max |dpose| {dpose:.3e} m, loops "
            f"{int(lane.num_loops)} and {c1.num_loops}, ATE {ates[i]:.4f} and "
            f"{lone_ate:.4f} m")
        if abs(ates[i] - lone_ate) > SWEEP_ATE_BAND_M:
            raise RuntimeError(f"full sweep: lane {i}'s ATE is more than "
                               f"{SWEEP_ATE_BAND_M} m from its lone scan's")
        if not same:
            raise RuntimeError(f"full sweep: lane {i} differs from a lone scan")
        _check_pin(f"full sweep lane {i} (keyframes, loops, ATE m)",
                   (c1.num_kf, c1.num_loops, round(lone_ate, 4)),
                   FULL_SWEEP_LONE_EXPECTED[i])
    K = frames.valid.shape[0]
    prefix = frames._replace(valid=frames.valid & (
        torch.arange(K, device=dev) < FULL_SWEEP_PREFIX))
    steps = min(nk, FULL_SWEEP_PREFIX)
    per_step = {}
    for name, params in (("B=1", stack_params(lanes[:1])),
                         (f"B={FULL_SWEEP_LANES}", stacked)):
        per_step[name] = _launches(
            lambda: sweep_scan(prefix, params, dims)) / steps
    ratio = per_step[f"B={FULL_SWEEP_LANES}"] / per_step["B=1"]
    log(f"full sweep: kernel launches a keyframe step over the first {steps} "
        f"keyframes {json.dumps(per_step)}, ratio {ratio:.3f}; phase 13d "
        f"{time.perf_counter() - t_phase:.1f} s")
    if ratio > SWEEP_LAUNCH_RATIO:
        raise RuntimeError(f"full sweep: {FULL_SWEEP_LANES} lanes launch "
                           f"{ratio:.2f} times one lane's kernels a step")
    return launches


def run_full_robots(bag, dev) -> dict:
    """Phase 13e: the robot axis at full width. Robot A takes phase 4's
    survey, robot B the same SimConfig with seed 1 at phase pi (as
    ``cli.two_robot_demo`` offsets its second robot), each robot's frames
    built as the demo builds them (one sum-kernel launch a robot), under
    ``full_sweep_config``'s dims and params. ``multi_robot_scan`` runs both
    as lanes of one batched scan: finite poses, each robot lane bit for bit
    with its lone ``slam_scan`` (the loop's) and pinned; launches a step at
    two robots at most ROBOT_LAUNCH_RATIO times one robot's over the first
    FULL_ROBOTS_PREFIX keyframes; the batched proposal search at the
    demo's 8 x 8 candidates and 128 Sobol samples bit for bit with its
    loop; then PCM and the merge, pinned. Logs ``wall_s`` of the batched
    scan and of the loop, peak MiB and the phase's seconds. Returns the
    CFAR launches by kernel."""
    import dataclasses

    import numpy as np
    import torch
    from sonar_slam_torch.cli.sweep import build_frames
    from sonar_slam_torch.cli.two_robot_demo import (candidates,
                                                     dr_start_pose,
                                                     merge_surveys,
                                                     proposal_search)
    from sonar_slam_torch.io.simulate import simulate_bag
    from sonar_slam_torch.parallel.multi_robot import (
        multi_robot_scan, propose_interrobot_loops,
        propose_interrobot_loops_loop)
    from sonar_slam_torch.pipeline import ate_rmse
    from sonar_slam_torch.slam import KeyframeInput, slam_scan

    t_phase = time.perf_counter()
    sim, dims, params_on, fcfg = full_sweep_config(0)
    params = params_on(dev)
    t0 = time.perf_counter()
    bags = [bag, simulate_bag(dataclasses.replace(sim, seed=1, phase=np.pi))]
    sim_s = time.perf_counter() - t0
    built, _, _, launches = _counted(
        lambda: [build_frames(b, params, dims, fcfg, dev) for b in bags])
    if launches["sum"] != 2 or sum(launches.values()) != 2:
        raise RuntimeError(f"full robots' frames made CFAR launches {launches}, "
                           "expected two of the sum kernel")
    frames = KeyframeInput(*(None if f[0] is None else torch.stack(f)
                             for f in zip(*(b[0] for b in built))))
    (carries, outputs), wall, peak, _ = _counted(
        lambda: multi_robot_scan(frames, params, dims))
    nk = carries.num_kf.tolist()
    truths = [bags[r].true_pose_at_ping[built[r][1]][:nk[r]] for r in range(2)]
    poses = [carries.poses[r, :nk[r]].cpu().numpy() for r in range(2)]
    if not all(np.isfinite(p).all() for p in poses):
        raise RuntimeError("full robots: poses not finite")
    ates = [ate_rmse(poses[r], truths[r]) for r in range(2)]
    log(f"full robot axis, 2 robots batched: wall_s {wall:.3f}, peak memory "
        f"{peak:.1f} MiB; keyframes {nk}, loops {carries.num_loops.tolist()}, "
        f"ATE m {[round(a, 4) for a in ates]}; robot B simulated in "
        f"{sim_s:.1f} s")
    loop_wall = 0.0
    for r in range(2):
        lone_in = KeyframeInput(*(None if x is None else x[r] for x in frames))
        (c1, o1), lone_s, _, _ = _counted(lambda: slam_scan(lone_in, params,
                                                            dims))
        loop_wall += lone_s
        same = (_bit_equal(_lane(carries, r), c1)
                and _bit_equal(_lane(outputs, r), o1))
        log(f"full robot {r} against a lone slam_scan ({lone_s:.2f} s): bit "
            f"for bit {same}, keyframes {nk[r]} and {c1.num_kf}, loops "
            f"{int(carries.num_loops[r])} and {c1.num_loops}")
        if not same:
            raise RuntimeError(f"full robots: robot {r} differs from its lone "
                               "scan")
        _check_pin(f"full robot {r} (keyframes, loops, ATE m)",
                   (c1.num_kf, c1.num_loops, round(ates[r], 4)),
                   FULL_ROBOTS_EXPECTED[r])
    log(f"full robot axis: wall_s batched {wall:.3f}, loop of lone scans "
        f"{loop_wall:.3f}, ratio {wall / loop_wall:.3f}")

    K = frames.valid.shape[1]
    prefix = frames._replace(valid=frames.valid & (
        torch.arange(K, device=dev) < FULL_ROBOTS_PREFIX))
    steps = min(min(nk), FULL_ROBOTS_PREFIX)
    one = KeyframeInput(*(None if x is None else x[:1] for x in prefix))
    per_step = {"B=1": _launches(lambda: multi_robot_scan(one, params, dims))
                / steps,
                "B=2": _launches(lambda: multi_robot_scan(prefix, params, dims))
                / steps}
    ratio = per_step["B=2"] / per_step["B=1"]
    log(f"full robot axis: kernel launches a keyframe step over the first "
        f"{steps} keyframes {json.dumps(per_step)}, ratio {ratio:.3f}")
    if ratio > ROBOT_LAUNCH_RATIO:
        raise RuntimeError(f"full robots: two robots launch {ratio:.2f} times "
                           "one robot's kernels a step")

    starts = [dr_start_pose(b, dev) for b in bags]
    cand = [candidates(carries, r, starts[r], dev) for r in range(2)]
    search = proposal_search(dev)
    batched, t_batched, _, _ = _counted(
        lambda: propose_interrobot_loops(cand[0], cand[1], **search))
    loop, t_loop, _, _ = _counted(
        lambda: propose_interrobot_loops_loop(cand[0], cand[1], **search))
    same = all(_bit_equal(x, y) for x, y in zip(batched, loop))
    log(f"full robot proposals, 8 x 8 candidates, 128 Sobol samples: batched "
        f"{t_batched:.3f} s, loop {t_loop:.3f} s, bit for bit {same}, "
        f"{int(batched[1].sum())} pass")
    if not same:
        raise RuntimeError("full robots: the batched proposals differ from "
                           "the loop's")
    run = merge_surveys(bags, built, carries, dev)
    if not np.isfinite(run.merged_poses).all():
        raise RuntimeError("full robots: merged poses not finite")
    _check_pin("full robot merge (proposals, PCM accepts, clique, merged ATE "
               "m)", (run.proposals, run.accepted, run.clique,
                      round(run.ate_joint_m, 4)), FULL_ROBOTS_MERGE_EXPECTED)
    log(f"phase 13e {time.perf_counter() - t_phase:.1f} s")
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
    """Phase 13c: ``cli.sharded_replay --max-keyframes 1024 --capacity-check
    --duration 60``. Returns its launches by kernel."""
    from sonar_slam_torch.cli import sharded_replay

    run, took, _, launches = _counted(lambda: sharded_replay.main(
        ["--max-keyframes", "1024", "--capacity-check", "--duration",
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


def run_parity(bag, dev) -> dict:
    """Phase 16: ``cli.parity_lane.run_parity_lanes`` at the full
    configuration on phase 4's survey: the faithful lane cold and warm, the
    SSM-only lane and odometry mode. Checks one CFAR launch a lane, all of
    the sum kernel (strict edge); finite poses; odometry mode within
    PARITY_ODOMETRY_ATOL_M of the dead-reckoning keyframe poses with no
    loop; the SSM-only and faithful lanes' ATE above dead reckoning's, the
    faithful lane's at least PARITY_COLLAPSE_FACTOR times phase 4's; the
    faithful lane's cold and warm runs equal bit for bit; each lane's
    keyframes, loops and ATE pinned. First, the lanes' odometry (plain dead
    reckoning) against bench.py's stage 1 (the full-DR lane of the scan with
    the DVL basis lanes), bit for bit. Logs bench.py's parity dict with the
    peak MiB and the phase's seconds. Returns the CFAR launches by
    kernel."""
    import numpy as np
    import torch
    from sonar_slam_torch.cli.parity_lane import (loop_errors,
                                                  run_parity_lanes,
                                                  truth_at_keyframes)
    from sonar_slam_torch.pipeline import ate_heading_deg, ate_rmse, odometry

    _, plain, _ = odometry(bag, dev)
    _, stage1, _ = odometry(bag, dev, basis=True)
    if not torch.equal(plain, stage1):
        raise RuntimeError(
            "parity lanes: plain dead reckoning parts from bench.py's stage 1 "
            f"by {float((plain - stage1).abs().max())} m")
    log(f"parity lanes: plain dead reckoning equals bench.py's stage 1 (the "
        f"basis scan's full lane) bit for bit over {plain.shape[0]} ticks")
    del plain, stage1

    run, took, peak, launches = _counted(
        lambda: run_parity_lanes(bag, True, dev))
    log(json.dumps({"parity": run.parity, "peak_mib": peak,
                    "phase_s": took}))
    for name, n in run.launches.items():
        if n["sum"] != 1 or sum(n.values()) != 1:
            raise RuntimeError(f"parity lane {name} made CFAR launches {n}, "
                               "expected one of the sum kernel")
    _sum_only("phase 16", launches, len(run.launches))
    ate, dr_ate, pins = {}, {}, {}
    for name, res in (("faithful_cold", run.cold), *run.lanes.items()):
        truth = truth_at_keyframes(res, bag)
        ate[name] = ate_rmse(res.trajectory, truth)
        dr_ate[name] = ate_rmse(res.dr_trajectory, truth)
        deg = ate_heading_deg(res.trajectory, truth)
        errs = loop_errors(res, bag)
        log(f"parity lane {name}: {res.num_keyframes} keyframes, "
            f"{res.carry.num_loops} loops (largest loop error "
            f"{errs.max() if len(errs) else None} m), ATE {ate[name]} m / "
            f"{deg} deg, DR ATE {dr_ate[name]} m, stages s "
            f"{json.dumps(res.stage_s)}")
        if not np.isfinite(res.trajectory).all():
            raise RuntimeError(f"parity lane {name}: trajectory not finite")
        pins[name] = (res.num_keyframes, res.carry.num_loops,
                      round(ate[name], 4), round(deg, 3))
    odo = run.lanes["odometry"]
    dev_m = run.parity["odometry_max_dev_m"]
    if dev_m >= PARITY_ODOMETRY_ATOL_M or odo.carry.num_loops != 0:
        raise RuntimeError(f"odometry mode: {dev_m} m from dead reckoning, "
                           f"{odo.carry.num_loops} loops")
    for name in ("ssm_only", "faithful"):
        if not ate[name] > dr_ate[name]:
            raise RuntimeError(f"parity lane {name}: ATE {ate[name]} m not "
                               f"above dead reckoning's {dr_ate[name]} m")
    if ate["faithful"] < PARITY_COLLAPSE_FACTOR * FULL_ATE_M:
        raise RuntimeError(f"faithful lane: ATE {ate['faithful']} m, expected "
                           f">= {PARITY_COLLAPSE_FACTOR} x {FULL_ATE_M} m")
    cold, warm = run.cold, run.lanes["faithful"]
    if not (_bit_equal(tuple(cold.carry), tuple(warm.carry))
            and np.array_equal(cold.keyframe_ping_idx, warm.keyframe_ping_idx)
            and np.array_equal(cold.trajectory.view(np.uint32),
                               warm.trajectory.view(np.uint32))):
        raise RuntimeError("faithful lane: the cold and warm runs differ")
    log("parity lanes: the faithful lane's cold and warm runs are equal bit "
        "for bit")
    for name in run.lanes:
        _check_pin(f"parity lane {name} (keyframes, loops, ATE m, ATE deg)",
                   pins[name], PARITY_EXPECTED[name])
    return launches


def _mesh_launches(name: str, launches: dict, expected: int):
    if launches["sum"] != expected or sum(launches.values()) != expected:
        raise RuntimeError(f"{name} made CFAR launches {launches}, expected "
                           f"{expected}, all of the sum kernel")


def run_mesh_sweep(dev) -> dict:
    """Phase 17a: ``cli.sweep --simulate --lanes 64`` in this process, then
    with ``--devices MESH_RANKS`` (each rank its own preprocessing, one CFAR
    launch a rank, and a block of lanes): every lane bit for bit with the
    one-process sweep, phase 13a's pins on the mesh run; both ``wall_s``,
    each rank's peak MiB and the spawn time logged. Returns the mesh run's
    launches by kernel."""
    from sonar_slam_torch.cli import sweep as sweep_cli

    argv = ["--simulate", "--lanes", str(SWEEP_LANES)]
    one, took1, _, _ = _counted(lambda: sweep_cli.main(argv))
    run, took, _, launches = _counted(lambda: sweep_cli.main(
        argv + ["--devices", str(MESH_RANKS)]))
    rep = run.report
    equal = [_bit_equal(_lane(run.carry, i), _lane(one.carry, i))
             for i in range(SWEEP_LANES)]
    log(f"mesh cli.sweep --lanes {SWEEP_LANES} --devices {MESH_RANKS} "
        f"({rep['ranks_per_card']} ranks a card): whole CLI {took:.2f} s "
        f"(one process {took1:.2f} s), wall_s {rep['wall_s']} (one process "
        f"{one.report['wall_s']}), compile_s {rep['compile_s']} (one process "
        f"{one.report['compile_s']}), spawn to every rank ready "
        f"{run.spawn_s:.2f} s, peak MiB a rank {run.rank_peak_mib} (one "
        f"process {one.rank_peak_mib}), CFAR launches {launches}; lanes bit "
        f"for bit with the one-process sweep {sum(equal)}/{SWEEP_LANES}")
    if not all(equal) or not _bit_equal(run.carry, one.carry):
        raise RuntimeError("mesh cli.sweep: lanes "
                           f"{[i for i, e in enumerate(equal) if not e]} "
                           "differ from the one-process sweep")
    _check_pin("mesh cli.sweep lanes 0-7 (keyframes, loops per lane, best "
               "ATE m)", (rep["keyframes"], rep["loops_per_lane"][:8],
                          round(min(run.ates[:8]), 4)), SWEEP_EXPECTED)
    _mesh_launches("mesh cli.sweep", launches, MESH_RANKS)
    return launches


def run_mesh_two_robot(dev) -> dict:
    """Phase 17b: ``cli.two_robot_demo`` in this process, then with
    ``--devices MESH_RANKS`` (one robot a rank; each rank builds both
    robots' frames, two CFAR launches a rank): each robot's carry bit for
    bit with the one-process batched scan, phase 13b's pins on the mesh
    run. Returns the mesh run's launches by kernel."""
    from sonar_slam_torch.cli import two_robot_demo

    one, took1, _, _ = _counted(lambda: two_robot_demo.main([]))
    run, took, _, launches = _counted(lambda: two_robot_demo.main(
        ["--devices", str(MESH_RANKS)]))
    equal = [_bit_equal(_lane(run.carries, r), _lane(one.carries, r))
             for r in range(2)]
    log(f"mesh cli.two_robot_demo --devices {MESH_RANKS}: whole CLI "
        f"{took:.2f} s (one process {took1:.2f} s), scan wall_s "
        f"{run.scan_wall_s:.3f} (one process {one.scan_wall_s:.3f}), CFAR "
        f"launches {launches}; robots bit for bit with the one-process scan "
        f"{equal}")
    if not all(equal):
        raise RuntimeError("mesh cli.two_robot_demo: a robot differs from the "
                           "one-process scan")
    _check_pin("mesh cli.two_robot_demo (keyframes, loops, proposals, PCM "
               "accepts, clique, merged ATE m)",
               (run.keyframes, run.loops, run.proposals, run.accepted,
                run.clique, round(run.ate_joint_m, 4)), TWO_ROBOT_EXPECTED)
    _mesh_launches("mesh cli.two_robot_demo", launches, 2 * MESH_RANKS)
    return launches


def run_mesh_sharded(dev) -> dict:
    """Phase 17c: ``cli.sharded_replay --max-keyframes 1024 --devices
    MESH_RANKS --check --duration 60`` (the CLI holds the sharded replay to
    the one-process replay: the same keyframes and loops, max |dpose| under
    the JAX script's 1e-5 m); logs whether it is bit for bit; phase 13c's
    pins on the sharded replay. Returns the sharded replay's launches by
    kernel (one a rank; the one-process replay's are checked apart)."""
    from sonar_slam_torch.cli import sharded_replay

    run, took, _, launches = _counted(lambda: sharded_replay.main(
        ["--max-keyframes", "1024", "--devices", str(MESH_RANKS), "--check",
         "--duration", SHARDED_DURATION]))
    res, one = run.result, run.one_process
    log(f"mesh cli.sharded_replay --devices {MESH_RANKS} --check: whole CLI "
        f"{took:.2f} s; sharded wall {run.wall_s:.2f} s, rank 0 peak "
        f"{run.peak_mib:.1f} MiB, stages s {json.dumps(res.stage_s)}; one "
        f"process wall {one.wall_s:.2f} s, stages s "
        f"{json.dumps(one.result.stage_s)}; max |dpose| "
        f"{run.one_process_dpose:.3e} m, bit for bit {run.bit_for_bit}; CFAR "
        f"launches of the ranks {run.launches}, of the whole CLI {launches}")
    _check_pin("mesh cli.sharded_replay (keyframes, loops, ATE m)",
               (res.num_keyframes, res.carry.num_loops, round(run.ate_m, 4)),
               SHARDED_EXPECTED)
    _mesh_launches("mesh cli.sharded_replay", run.launches, MESH_RANKS)
    _mesh_launches("mesh cli.sharded_replay with its check", launches,
                   MESH_RANKS + 1)
    return run.launches


def mesh_kf_inputs(device, seed: int = 0):
    """Phase 17d's keyframe axis at MESH_KF_SHAPE: tests/test_parallel.py's
    case scaled to K keyframes of N points and a window of W, the first
    two thirds of the keyframes candidates."""
    import numpy as np
    import torch

    K, N, W = MESH_KF_SHAPE
    r = np.random.default_rng(seed)
    poses = np.stack([np.linspace(0, 600, K), 40 * np.sin(np.linspace(0, 6, K)),
                      np.linspace(0, 12, K)], -1).astype(np.float32)
    covs = np.tile(np.eye(3, dtype=np.float32)[None] * np.float32(1e-3),
                   (K, 1, 1))
    arrays = (r.uniform(0, 20, size=(K, N, 2)).astype(np.float32),
              r.random((K, N)) > 0.2, poses, np.arange(K) < 2 * K // 3,
              poses[K // 2:K // 2 + W], covs[:W], np.array([True, True, False]))
    return [torch.as_tensor(a, device=device) for a in arrays]


def mesh_kf_calls(device, mesh=None) -> dict:
    """The three keyframe-axis functions on ``mesh_kf_inputs``."""
    import numpy as np
    from sonar_slam_torch.parallel import keyframe_shard as tks

    args = mesh_kf_inputs(device)
    gate = (30.0, float(np.radians(65.0)))
    return {"transform": tks.transform_clouds_sharded(args[0], args[2], mesh),
            "gate": tks.nssm_gate_sharded(*args, *gate, mesh=mesh),
            "select": tks.nssm_target_select_sharded(*args, *gate, mesh=mesh)}


def mesh_kf_rank(mesh):
    """Phase 17d on one rank; rank 0's results."""
    out = mesh_kf_calls(mesh.device, mesh)
    return out if mesh.rank == 0 else None


def run_mesh_kf(dev) -> None:
    """Phase 17d: ``transform_clouds_sharded``, ``nssm_gate_sharded`` and
    ``nssm_target_select_sharded`` at MESH_KF_SHAPE over MESH_RANKS ranks,
    exactly the unsharded calls on the card."""
    import torch
    from sonar_slam_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    got = spawn(mesh_kf_rank, MESH_RANKS, axis="kf", timeout_s=MESH_TIMEOUT_S)
    took = time.perf_counter() - t0
    want = mesh_kf_calls(dev)
    torch.cuda.synchronize()
    equal = {name: _bit_equal(got[name], want[name]) for name in want}
    sel = want["gate"][0]
    log(f"mesh keyframe_shard at (K, N, W) {MESH_KF_SHAPE} over {MESH_RANKS} "
        f"ranks ({took:.2f} s with the spawn): equal to the unsharded calls "
        f"{equal}; {int(sel.sum())} of {sel.numel()} points gated, target "
        f"{int(want['select'][2])}")
    if not all(equal.values()):
        raise RuntimeError(f"mesh keyframe_shard differs from the unsharded "
                           f"calls: {equal}")


def run_mesh(dev) -> tuple[dict, dict]:
    """Phase 17: the device axis over MESH_RANKS ranks, each path against
    its one-process run. Returns (sum-kernel launches, OS launches) by
    path."""
    import torch

    by_path, by_path_os = {}, {}
    for name, run in (("mesh_sweep", run_mesh_sweep),
                      ("mesh_two_robot", run_mesh_two_robot),
                      ("mesh_sharded_replay", run_mesh_sharded)):
        launches = run(dev)
        by_path[name] = launches["sum"]
        by_path_os[name] = launches["os_mask"] + launches["os_select"]
        torch.cuda.empty_cache()
    run_mesh_kf(dev)
    return by_path, by_path_os


def run_survey_bag() -> int:
    """Phase 4's survey (2,398 pings of 512 x 256) written as an lz4 ROS bag
    in rosbag's 768 kB chunks, each one LZ4 frame, then converted by
    ``cli.convert_bag`` with the compiled LZ4 decoder and with the
    pure-Python one (``io/lz4.py``'s plain version, patched into the bag
    reader); the bundles must be array-equal. Once with the
    pings as rendered and once gated (every pixel at or under 65 set to 0).
    Host time only; run on the card's machine as ``python3 chip_smoke.py
    survey-bag``."""
    import numpy as np

    sys.path.insert(0, HERE)
    from sonar_slam_torch.cli import convert_bag
    from sonar_slam_torch.io import lz4, lz4_lib, rosbag
    from sonar_slam_torch.io.simulate import simulate_bag

    log(f"built {os.path.relpath(lz4_lib.build(), HERE)}")
    sim = full_config(seed=0)[0]
    t0 = time.perf_counter()
    bag = simulate_bag(sim)
    log(f"simulated {len(bag.ping_time)} pings {bag.ping_images.shape[1:]} "
        f"in {time.perf_counter() - t0:.1f} s")
    # as rendered (incompressible speckle: the blocks are stored raw), and
    # gated as check_lz4_decoder gates them (compressible)
    gated = bag._replace(ping_images=np.where(
        bag.ping_images > 65.0, bag.ping_images, 0.0).astype(np.float32))
    work = tempfile.mkdtemp(prefix="chip_smoke_bag_")
    report = {}
    try:
        for label, survey in (("pings", bag), ("gated pings", gated)):
            path = os.path.join(work, "survey.bag")
            t0 = time.perf_counter()
            n_pings = write_lz4_bag(survey, path, chunk_size=768 * 1024)[0].nbytes
            log(f"{label}: wrote an lz4 bag of {os.path.getsize(path)} bytes, "
                f"{n_pings} bytes of pings, in {time.perf_counter() - t0:.1f} s "
                f"(the Python compressor)")
            times = {}
            for name, decode in (("compiled", lz4.decompress_frame),
                                 ("plain", lz4.decompress_frame_plain)):
                rosbag.lz4_decompress = decode
                out = os.path.join(work, f"{name}.npz")
                t0 = time.perf_counter()
                convert_bag.main([path, "--out", out])
                times[name] = time.perf_counter() - t0
                log(f"{label}: cli.convert_bag with the {name} decoder "
                    f"{times[name]:.2f} s")
            rosbag.lz4_decompress = lz4.decompress_frame
            with np.load(os.path.join(work, "compiled.npz")) as a, \
                    np.load(os.path.join(work, "plain.npz")) as b:
                if sorted(a.files) != sorted(b.files) or not all(
                        np.array_equal(a[k], b[k]) for k in a.files):
                    raise RuntimeError(f"{label}: the two decoders' bundles "
                                       f"differ")
                if a["ping_images"].shape[0] != len(survey.ping_time):
                    raise RuntimeError(f"{label}: the bundle lost pings")
            report[label] = {"bag_bytes": os.path.getsize(path),
                             "ping_bytes": n_pings, "convert_s": times}
        log(json.dumps({"survey_bag": report}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


# phase 15: the node API. Dead reckoning one tick a call adds in the JAX
# package's order; the scan adds as cumulative sums, so their positions lie
# within the scan's accepted gap (tests/test_torch_estimators.py), which
# tests/test_torch_node_api.py holds on phase 4's survey on the CPU (5.1e-5
# m there); depth and attitude within float32 rounding
DR_STEP_ATOL_M, DR_STEP_ZRPY_ATOL = 2e-4, 1e-6
# the Smoother on the card against the CPU; the keyed downsampling's
# centroids on the card against the CPU
SMOOTHER_ATOL, CENTROID_ATOL_M = 1e-5, 1e-6
# phase 4's first keyframe clouds, as SLAM.get_points(return_keys=True)
# gathers them
NODE_CLOUD_KEYFRAMES = 8


def dr_node_inputs(bag):
    """A survey as the dead-reckoning node sees it: its synchronized ticks
    (on the host), and the pings' pairing with them (tick index, paired,
    ping times) for the keyframe gate."""
    import numpy as np
    import torch
    from sonar_slam_torch.io.dataset import (SensorStreams, build_dr_ticks,
                                             match_pings_to_ticks)

    bundle = build_dr_ticks(SensorStreams(
        imu_time=bag.imu_time, imu_rpy=bag.imu_rpy, dvl_time=bag.dvl_time,
        dvl_vel=bag.dvl_vel, depth_time=bag.depth_time, depth=bag.depth),
        torch.device("cpu"))
    tick_idx, sync_ok = match_pings_to_ticks(bag.ping_time, bundle.tick_time)
    return (bundle.ticks, tick_idx, sync_ok,
            np.asarray(bag.ping_time, np.float32))


def dr_node_keyframes(poses3, node, params):
    """The keyframe pings ``replay``'s gate picks from DR poses at the ticks
    (the pings paired with a tick are the candidates)."""
    import numpy as np
    import torch
    from sonar_slam_torch.geometry import pose3_to_pose2
    from sonar_slam_torch.slam import select_keyframes

    _, tick_idx, sync_ok, ping_time = node
    poses3 = torch.as_tensor(poses3).cpu()
    mask = select_keyframes(torch.as_tensor(ping_time),
                            pose3_to_pose2(poses3[torch.as_tensor(tick_idx)]),
                            torch.as_tensor(sync_ok), params)
    return np.nonzero(mask.numpy())[0]


def step_dead_reckoning(ticks, config, dev):
    """``dead_reckoning_step`` over a tick stream on ``dev``, one tick a call,
    each pose read back to the host as the node publishes it: (poses (T, 6)
    float32, each tick's host-clock seconds)."""
    import numpy as np
    from sonar_slam_torch.estimators import dead_reckoning_init, dead_reckoning_step

    cols = tuple(c.to(dev) for c in ticks)
    state = dead_reckoning_init(dev)
    T = cols[0].shape[0]
    poses, took = np.zeros((T, 6), np.float32), []
    for i in range(T):
        t0 = time.perf_counter()
        state, pose = dead_reckoning_step(state, tuple(c[i] for c in cols),
                                          config)
        poses[i] = pose.cpu().numpy()
        took.append(time.perf_counter() - t0)
    return poses, took


def run_dr_node(node, params, dev) -> dict:
    """Phase 15a: phase 4's survey through ``dead_reckoning_step`` on the
    card, one tick a call, against ``dead_reckoning_scan`` on the card: the
    positions within DR_STEP_ATOL_M, depth and attitude within
    DR_STEP_ZRPY_ATOL, the same keyframes (FULL_KEYFRAMES) from the gate.
    Logs the per-tick latency, the launches per tick and the gap."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sonar_slam_torch.estimators import DRConfig, DRTicks, dead_reckoning_scan

    cfg = DRConfig(roll_offset=0.0)  # replay's configuration
    ticks = node[0]
    scan = dead_reckoning_scan(DRTicks(*(c.to(dev) for c in ticks)), cfg).cpu()
    steps, took = step_dead_reckoning(ticks, cfg, dev)
    steps = torch.as_tensor(steps)
    gap = float((steps[:, :2] - scan[:, :2]).abs().max())
    rest = float((steps[:, 2:] - scan[:, 2:]).abs().max())
    kf = [dr_node_keyframes(p, node, params) for p in (steps, scan)]
    n = 100
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_dead_reckoning(DRTicks(*(c[:n] for c in ticks)), cfg, dev)
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()
             if "LaunchKernel" in e.key or e.key.startswith("cuLaunch")}
    ms = np.asarray(took) * 1e3
    out = {"ticks": len(took), "median_ms": float(np.median(ms)),
           "p99_ms": float(np.percentile(ms, 99)),
           "launches_per_tick": sum(calls.values()) / n, "launch_calls": calls,
           "xy_gap_m": gap, "other_gap": rest,
           "keyframes": [len(k) for k in kf]}
    log(f"phase 15a dead_reckoning_step on the card: {json.dumps(out)}")
    if gap > DR_STEP_ATOL_M or rest > DR_STEP_ZRPY_ATOL:
        raise RuntimeError("per-tick dead reckoning disagrees with the scan")
    if not (np.array_equal(kf[0], kf[1]) and len(kf[0]) == FULL_KEYFRAMES):
        raise RuntimeError("per-tick dead reckoning gives other keyframes")
    return out


def smoother_cases(dev) -> list:
    """tests/test_torch_node_api.py's loop-closure and marginal-covariance
    cases through ``Smoother`` on ``dev``: their estimates and marginal
    covariances as host arrays."""
    import numpy as np
    import torch
    from sonar_slam_torch.geometry import se2_between, se2_compose
    from sonar_slam_torch.graph import GraphConfig, Smoother

    cfg = GraphConfig(max_poses=16, max_factors=64, gn_iters=8)
    rng = np.random.default_rng(11)
    loop = Smoother(cfg, dev)
    loop.add_prior([0, 0, 0], [0.01, 0.01, 0.001])
    loop.insert(0, [0, 0, 0])
    step = torch.tensor([2.0, 0.0, np.pi / 2])
    truth, guess = [torch.zeros(3)], [torch.zeros(3)]
    for k in range(4):
        truth.append(se2_compose(truth[-1], step))
        noisy = step + torch.as_tensor(rng.normal(scale=[0.1, 0.1, 0.03],
                                                  size=3).astype(np.float32))
        loop.add_odometry(k, k + 1, noisy, [0.2, 0.2, 0.05])
        guess.append(se2_compose(guess[-1], noisy))
        loop.insert(k + 1, guess[-1])
    loop.add_odometry(0, 4, se2_between(truth[0], truth[4]),
                      [0.01, 0.01, 0.001])
    chain = Smoother(cfg, dev)
    chain.add_prior([0, 0, 0], [0.1, 0.1, 0.01])
    chain.insert(0, [0, 0, 0])
    for k in range(3):
        chain.add_odometry(k, k + 1, [1.0, 0.0, 0.0], [0.2, 0.2, 0.02])
        chain.insert(k + 1, [k + 1.0, 0.0, 0.0])
    out = []
    for s in (loop, chain):
        out.append(s.update().cpu().numpy())
        out += [s.marginal_covariance(k).cpu().numpy() for k in (0, 3)]
    return out


def run_smoother(dev) -> float:
    """Phase 15b: ``Smoother`` on the card against the CPU, within
    SMOOTHER_ATOL. Returns the largest difference."""
    import numpy as np
    import torch

    err = max(float(np.abs(a - b).max()) for a, b in
              zip(smoother_cases(dev), smoother_cases(torch.device("cpu"))))
    log(f"phase 15b Smoother, loop closure and marginal covariances, card vs "
        f"CPU: max abs diff {err}")
    if not err <= SMOOTHER_ATOL:
        raise RuntimeError("Smoother on the card differs from the CPU")
    return err


def run_padded_scan(frames, params, dims) -> None:
    """Phase 15c: ``slam_scan`` against ``slam_scan_padded`` on the card, on
    the small configuration's keyframes (refinement off) with an interior
    slot made invalid: carry and outputs bit for bit."""
    import torch
    from sonar_slam_torch.slam.core import slam_scan, slam_scan_padded

    valid = frames.valid.clone()
    valid[5] = False
    frames = frames._replace(valid=valid)
    c_pad, o_pad = slam_scan_padded(frames, params, dims)
    c_new, o_new = slam_scan(frames, params, dims)
    ok = _bit_equal(tuple(c_pad), tuple(c_new)) and _bit_equal(tuple(o_pad),
                                                                tuple(o_new))
    log(f"phase 15c slam_scan vs slam_scan_padded on the card (small config, "
        f"{int(valid.sum())} of {valid.numel()} slots, slot 5 invalid): "
        f"{c_new.num_kf} keyframes, {c_new.num_loops} loops, bit for bit {ok}")
    if not ok or c_new.num_kf != int(valid.sum()):
        raise RuntimeError("slam_scan differs from slam_scan_padded on the card")


def run_cloud_api(clouds, dev) -> dict:
    """Phase 15d: ``voxel_downsample_with_keys`` and ``density_filter`` on
    phase 4's first keyframe clouds in the world frame, keyed by keyframe,
    on the card against the CPU: keys and masks equal, centroids within
    CENTROID_ATOL_M."""
    import math

    import torch
    from sonar_slam_torch.cloud import (VoxelGridSpec, density_filter,
                                        voxel_downsample_with_keys)
    from sonar_slam_torch.geometry import se2_transform_points

    points, pmasks, poses = clouds
    K, P = pmasks.shape
    world = se2_transform_points(points, poses).reshape(-1, 2)
    mask = pmasks.reshape(-1)
    keys = torch.arange(K, dtype=torch.int32).repeat_interleave(P)
    lo = torch.floor(world[mask].min(dim=0).values) - 1.0
    hi = torch.ceil(world[mask].max(dim=0).values) + 1.0
    res = 0.5
    spec = VoxelGridSpec(x0=float(lo[0]), y0=float(lo[1]), resolution=res,
                         nx=math.ceil(float(hi[0] - lo[0]) / res),
                         ny=math.ceil(float(hi[1] - lo[1]) / res))
    got = []
    for d in (dev, torch.device("cpu")):
        args = (world.to(d), mask.to(d))
        got.append([t.cpu() for t in (
            *voxel_downsample_with_keys(*args, keys.to(d), spec, 1024),
            density_filter(*args, 6, 1.0, 200.0))])
    (gc, gk, gm, gd), (cc, ck, cm, cd) = got
    out = {"points": int(mask.sum()), "cells": int(gm.sum()),
           "centroid_max_abs_diff_m": float((gc - cc).abs().max()),
           "keys_equal": bool(torch.equal(gk, ck)),
           "masks_equal": bool(torch.equal(gm, cm) and torch.equal(gd, cd)),
           "density_kept": int(gd.sum())}
    log(f"phase 15d voxel_downsample_with_keys and density_filter, card vs "
        f"CPU: {json.dumps(out)}")
    if not (out["keys_equal"] and out["masks_equal"]
            and out["centroid_max_abs_diff_m"] <= CENTROID_ATOL_M):
        raise RuntimeError("keyed downsampling or the density filter differs "
                           "on the card")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a card")
    if not os.path.isdir(os.path.join(HERE, "sonar_slam_torch")):
        raise RuntimeError("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, HERE)
    from sonar_slam_torch.io.simulate import simulate_bag
    from sonar_slam_torch.kernels import cfar_cuda

    # 1) device
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2) build: the CFAR and Kalman kernels with nvcc, the LZ4 decoder with
    # the host C++ compiler
    from sonar_slam_torch.io import lz4_lib
    from sonar_slam_torch.kernels import kalman_cuda

    t_start = time.perf_counter()
    lib = cfar_cuda.build()
    log(f"built {os.path.relpath(lib, HERE)} in {time.perf_counter() - t_start:.2f} s")
    t0 = time.perf_counter()
    lib = kalman_cuda.build()
    log(f"built {os.path.relpath(lib, HERE)} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    lib = lz4_lib.build()
    log(f"built {os.path.relpath(lib, HERE)} in {time.perf_counter() - t0:.2f} s")

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
    entry["strict"] = check_strict(stacks)
    entry_os = check_os_kernel(stacks)
    del stacks
    torch.cuda.empty_cache()
    entry_kalman = check_kalman_kernel(sim, dev)

    # 10) bench.py's dual-sonar lane, before any other process shares the
    # card: it times its vertical call
    by_path = {"dual": run_dual_lane(dev, entry)}

    # 13, 14, 16, 17) the parallel/ entry points, the accuracy CLIs, the
    # parity lanes and the device axis, each in a process of its own beside
    # phases 4-9, 11-12 and 15 (they read nothing of the other phases)
    workers = [PhaseWorker(phase) for phase in ("13", "14", "16", "17")]
    try:
        kalman, lz4_rates, node_api = run_main_phases(
            bag, dev, dims, params_on, fcfg, entry, entry_os, entry_kalman,
            by_path)
        del bag
        done = [w.result() for w in workers]
    finally:
        for w in workers:
            w.stop()
    by_path_os = {"os": entry_os["launches"]}
    for sums, os_launches in done:
        by_path.update(sums)
        by_path_os.update(os_launches)
    entry["launches_by_path"] = by_path
    entry["strict"]["launches_by_path"] = {
        "parity_lanes": by_path["parity_lanes"]}
    entry_os["launches_by_path"] = by_path_os

    log(f"chip_smoke.py total wall {time.perf_counter() - t_start:.1f} s "
        f"(from the build)")
    log(json.dumps({"kalman_scan": kalman}))
    log(json.dumps({"lz4_decoder": lz4_rates}))
    log(json.dumps({"node_api": node_api}))
    log(json.dumps({"kernels": [entry, entry_os, entry_kalman]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_main_phases(bag, dev, dims, params_on, fcfg, entry, entry_os,
                    entry_kalman, by_path):
    """Phases 4-9, 11-12 and 15, in the main process beside phases 13 and
    14's: records the main path's launches into the kernels' entries and
    each path's into ``by_path`` (the CFAR kernels') and the Kalman entry's
    ``launches_by_path``. Returns (the Kalman scan's numbers, the LZ4
    decoder's rates, phase 15's numbers)."""
    import numpy as np
    import torch
    from sonar_slam_torch.kernels import cfar_cuda, kalman_cuda
    from sonar_slam_torch.pipeline import ate_heading_deg, ate_rmse, replay

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
    _check_pin("replay (keyframes, loops, ATE m, ATE deg)",
               (res.num_keyframes, res.carry.num_loops, round(ate, 4),
                round(ate_deg, 3)),
               (FULL_KEYFRAMES, FULL_LOOPS, FULL_ATE_M, FULL_ATE_DEG))
    entry["launches"] = sum_launches
    # phase 15's inputs: the survey's DR ticks and the first keyframe clouds
    node = dr_node_inputs(bag)
    n = NODE_CLOUD_KEYFRAMES
    clouds = (res.carry.points[:n].cpu(), res.carry.pmasks[:n].cpu(),
              torch.as_tensor(res.trajectory[:n]))
    del res

    # 5) the OS slice: bench.py's whole full pipeline with the OS detector
    entry_os["launches"] = run_os_path(bag, dev)

    # 6) small configuration, refinement off: the card against the port on
    # the CPU (which the CPU tests hold to the JAX package) and against the
    # JAX result
    small = check_small(dev)

    # 7) small configuration, refinement on, against the JAX result
    check_small_refine(dev)

    # 8-9) the FOG-gyro and Kalman front ends on phase 4's survey
    by_path["soca"] = entry["launches"]
    filter_by_path = {}
    for frontend in ("dr_gyro", "kalman"):
        by_path[frontend], filter_by_path[frontend] = run_frontend_path(
            bag, dev, frontend)
    kalman = time_kalman_scan(bag, dev)
    filter_by_path["time_kalman_scan"] = kalman["filter_launches"]
    entry_kalman["launches"] = filter_by_path["kalman"]
    entry_kalman["launches_by_path"] = filter_by_path
    torch.cuda.empty_cache()

    # 11-12) the command-line path: a bag through convert_bag and the
    # replay CLI, then the CLI on phase 4's survey
    lz4_rates = check_lz4_decoder(bag)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        by_path["cli_bag_seam"] = run_bag_seam(dev, work)
        by_path["cli_full"] = run_cli_full(bag, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # 15) the node API: dead reckoning one tick a call, the Smoother, the
    # padded SLAM scan, keyed downsampling and the density filter
    t15 = time.perf_counter()
    node_api = {"dead_reckoning_step": run_dr_node(node, params, dev),
                "smoother_max_abs_diff": run_smoother(dev)}
    run_padded_scan(*small)
    node_api["clouds"] = run_cloud_api(clouds, dev)
    log(f"phase 15 took {time.perf_counter() - t15:.1f} s")
    return kalman, lz4_rates, node_api


def run_parallel_entry_points(bag, dev) -> tuple[dict, dict]:
    """Phase 13: the sweep, the two-robot merge, the replay at keyframe
    capacity 1024, the full-width point-to-line sweep and the full-width
    robot axis on phase 4's survey. Returns (sum-kernel launches, OS
    launches) by path."""
    import torch

    by_path, by_path_os = {}, {}
    for name, run in (("sweep", run_sweep), ("two_robot", run_two_robot),
                      ("sharded_replay", run_sharded),
                      ("full_sweep", lambda d: run_full_sweep(bag, d)),
                      ("full_robots", lambda d: run_full_robots(bag, d))):
        launches = run(dev)
        by_path[name] = launches["sum"]
        by_path_os[name] = launches["os_mask"] + launches["os_select"]
        torch.cuda.empty_cache()
    return by_path, by_path_os


def run_accuracy_clis(dev) -> tuple[dict, dict]:
    """Phase 14: the production SOCA + refinement path and the y-scale lane
    at full width, then the small harnesses, each with the launch counters
    reset just before. Returns (sum-kernel launches, OS launches) by
    path."""
    import torch

    by_path, by_path_os = {}, {}
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
    return by_path, by_path_os


PHASE_RESULT = "launches by path: "


class PhaseWorker:
    """``python3 chip_smoke.py phase-<phase>`` (13, 14, 16 or 17) in a process of
    its own (the kernels already built), its output kept in temporary files
    until :meth:`result`, which relays it and returns the phase's launches
    by path, or raises if the process failed. :meth:`stop` ends the process
    if it is still running."""

    def __init__(self, phase: str):
        self.phase = phase
        self.t0 = time.perf_counter()
        self.out = tempfile.TemporaryFile(mode="w+")
        self.err = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), f"phase-{phase}"],
            stdout=self.out, stderr=self.err, cwd=HERE)

    def result(self) -> tuple[dict, dict]:
        rc = self.proc.wait()
        log(f"phase {self.phase}'s log (its process collected "
            f"{time.perf_counter() - self.t0:.1f} s after it started):")
        self.out.seek(0)
        self.err.seek(0)
        lines = self.out.read().splitlines()
        err = self.err.read()
        sys.stderr.write(err)
        done = [ln for ln in lines if ln.startswith(PHASE_RESULT)]
        for ln in lines:
            if not ln.startswith(PHASE_RESULT):
                log(ln)
        if rc != 0 or len(done) != 1:
            raise RuntimeError(f"phase {self.phase}'s process exited {rc}: "
                               f"{err[-3000:]}")
        res = json.loads(done[0][len(PHASE_RESULT):])
        return res["sum"], res["os"]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()
        self.err.close()


def phase_main(phase: str) -> int:
    """Phase 13, 14, 16 or 17 alone, on the card, in the process that ``main``
    starts: prints the phase's launches by path as its last line."""
    import torch

    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    if phase in ("13", "16"):
        from sonar_slam_torch.io.simulate import simulate_bag

        bag = simulate_bag(full_config(seed=0)[0])
    if phase == "13":
        by_path = run_parallel_entry_points(bag, dev)
    elif phase == "17":
        by_path = run_mesh(dev)
    elif phase == "16":
        launches = run_parity(bag, dev)
        by_path = ({"parity_lanes": launches["sum"]},
                   {"parity_lanes": launches["os_mask"] + launches["os_select"]})
    else:
        by_path = run_accuracy_clis(dev)
    log(f"phase {phase} took {time.perf_counter() - t0:.1f} s in a process "
        "of its own")
    print(PHASE_RESULT + json.dumps({"sum": by_path[0], "os": by_path[1]}),
          flush=True)
    return 0


if __name__ == "__main__":
    arg = " ".join(sys.argv[1:])
    sys.exit(run_survey_bag() if arg == "survey-bag" else
             phase_main(arg[6:]) if arg in ("phase-13", "phase-14", "phase-16",
                                            "phase-17")
             else main())
