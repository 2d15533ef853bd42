"""Error-budget decomposition of the synthetic-benchmark ATE.

Counterpart of ``scripts/error_budget.py``, with its flags, printed lines and
JSON keys. Four lanes decompose the end-to-end ATE:

  A  full pipeline            (sensor noise + feature noise + estimation)
  B  noiseless sensors        (feature noise + estimation)
  C  ground-truth features    (sensor noise + estimation)
  D  noiseless + GT features  (estimation machinery floor)

plus the raw dead-reckoning ATE (what SLAM must beat) and the per-point
feature fidelity RMS (the render/quantization floor feeding ICP). The
production configurations (``setups``, ``bench_params``, ``bench_rparams``)
are bench.py's, field for field; the other accuracy CLIs import them from
here.

It runs on the CUDA card unless ``--cpu`` is given; without a card it exits
with an error rather than run on the CPU. ``main`` returns the report for
in-process callers.

Usage: python -m sonar_slam_torch.cli.error_budget [--full] [--seed N]
                                                   [--out FILE] [--cpu]
"""

from __future__ import annotations

import argparse
import json
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from . import device_from_args


class ErrorBudgetRun(NamedTuple):
    """What ``main`` computed, for callers that run it in process."""

    report: dict  # as written to ``--out``


def icp_prod():
    """bench.py's production ICP: point-to-line, 12 iterations."""
    from ..cloud import ICPConfig

    return ICPConfig(max_iterations=12, min_diff_rot=1e-3,
                     min_diff_trans=1e-2, point_to_line=True,
                     outlier_max_dist=0.5)


def setups(full: bool):
    """Production configs (kept in sync with bench.py): (SimConfig,
    SlamDims, keyframe translation)."""
    from ..io.simulate import SimConfig
    from ..slam import SlamDims

    if full:
        sim = SimConfig(duration=480.0, speed=0.5, sonar_rate=5.0,
                        num_ranges=512, num_bearings=256, loop_radius=18.0,
                        imu_rate=50.0)
        dims = SlamDims(max_keyframes=128, max_points=256,
                        target_capacity=1024, nssm_cov_samples=12,
                        ssm_sobol=64, nssm_sobol=512, max_loops=128,
                        gn_iters=3, icp=icp_prod(),
                        nssm_target_window=2, nssm_pair_refine=True,
                        pair_refine_max_dt=0.35, pair_refine_max_dr=0.07,
                        pair_refine_min_inliers=25,
                        nssm_reinit_after_select=True, aggregate_with_dr=True,
                        aggregate_with_dr_basis=True,
                        estimate_dvl_scale=True,
                        refine_iters=2, refine_sweep=True, refine_chain=True,
                        refine_final_sweep=True,
                        refine_scale_from_chain=True, refine_sweep_budget=0,
                        refine_scale_basis=True, refine_incremental=True)
        kf_t = 3.0
    else:
        sim = SimConfig(duration=90.0, speed=0.5, sonar_rate=1.0,
                        num_ranges=192, num_bearings=96, loop_radius=10.0,
                        imu_rate=20.0)
        dims = SlamDims(max_keyframes=32, max_points=128, target_capacity=512,
                        nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=128,
                        max_loops=32, gn_iters=3, icp=icp_prod(),
                        nssm_target_window=2, nssm_pair_refine=True,
                        pair_refine_max_dt=0.35, pair_refine_max_dr=0.07,
                        pair_refine_min_inliers=25,
                        refine_iters=2, refine_sweep=True, refine_chain=True)
        kf_t = 2.0
    return sim, dims, kf_t


def bench_rparams(full: bool, device):
    """Refinement params matching bench.py: the full config tightens the
    consensus-prune gates with its finer sonar bins."""
    from ..slam import RefineParams

    rp = RefineParams.default(device)
    if full:
        rp = rp._replace(prune_max_dt=float(np.float32(0.18)),
                         prune_max_dr=float(np.float32(0.06)),
                         sweep_min_inliers=15)
    return rp


def bench_params(dims, kf_t, full: bool, device):
    from ..slam import SlamParams

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return SlamParams.default(dims, device)._replace(
        keyframe_translation=float(np.float32(kf_t)),
        ssm_min_points=20,
        nssm_min_points=50 if full else 20,
        fuse_odometry=True,
        use_best_start_tf=True,
        nssm_every=5 if full else 1,
        odom_sigmas=vec([0.05, 0.05, 0.01]),
        icp_odom_sigmas=vec([0.2, 0.2, 0.1] if full else [0.3, 0.3, 0.1]),
    )


def gt_features(bag, sim, dims, rng):
    """Ground-truth feature clouds: visible world points in the TRUE body
    frame, voxel-thinned to the cloud capacity — zero render/detector error.
    Host arrays (pings, max_points, 2) and (pings, max_points); ``rng`` is
    consumed ping by ping where a ping sees more than ``max_points``."""
    N = dims.max_points
    pts_all = np.zeros((len(bag.ping_time), N, 2), np.float32)
    mask_all = np.zeros((len(bag.ping_time), N), bool)
    for i, pose in enumerate(bag.true_pose_at_ping):
        c, s = np.cos(pose[2]), np.sin(pose[2])
        rel = bag.world_points - pose[:2]
        lx = c * rel[:, 0] + s * rel[:, 1]
        ly = -s * rel[:, 0] + c * rel[:, 1]
        r = np.hypot(lx, ly)
        b = np.arctan2(ly, lx)
        vis = ((r > 0.5) & (r < sim.max_range * 0.98)
               & (b > bag.geometry.bearings[0]) & (b < bag.geometry.bearings[-1]))
        P = np.stack([lx[vis], ly[vis]], -1)
        # voxel-thin at the feature resolution so densities match the
        # real frontend's output
        if len(P):
            key = np.round(P / 0.5).astype(np.int64)
            _, keep = np.unique(key[:, 0] * 100003 + key[:, 1],
                                return_index=True)
            P = P[np.sort(keep)]
        if len(P) > N:
            P = P[rng.permutation(len(P))[:N]]
        pts_all[i, : len(P)] = P
        mask_all[i, : len(P)] = True
    return pts_all, mask_all


def replay_gt_features(bag, sim, params, dims, kf_t, rng, device):
    """Replay using GT feature clouds but the bag's (noisy or not) odometry,
    refined with ``RefineParams.default``. Returns (ATE m, DR ATE m,
    keyframes, loops)."""
    from ..estimators import DRConfig, dead_reckoning_scan
    from ..geometry import pose3_to_pose2
    from ..io.dataset import SensorStreams, build_dr_ticks, match_pings_to_ticks
    from ..pipeline import ate_rmse
    from ..slam import (KeyframeInput, RefineParams, refine_loops,
                        select_keyframes, slam_scan)

    streams = SensorStreams(
        imu_time=bag.imu_time, imu_rpy=bag.imu_rpy, dvl_time=bag.dvl_time,
        dvl_vel=bag.dvl_vel, depth_time=bag.depth_time, depth=bag.depth)
    bundle = build_dr_ticks(streams, device)
    dr3 = dead_reckoning_scan(bundle.ticks, DRConfig(roll_offset=0.0))
    tick_idx, sync_ok = match_pings_to_ticks(bag.ping_time, bundle.tick_time)
    ping_dr3 = dr3[torch.as_tensor(tick_idx, device=device)]
    ping_time = torch.as_tensor(np.asarray(bag.ping_time, np.float32),
                                device=device)
    kf_mask = select_keyframes(ping_time, pose3_to_pose2(ping_dr3),
                               torch.as_tensor(sync_ok, device=device), params)
    kf_idx = np.nonzero(kf_mask.cpu().numpy())[0][: dims.max_keyframes]
    K = dims.max_keyframes
    valid = np.zeros(K, bool)
    valid[: len(kf_idx)] = True
    sel = np.concatenate([kf_idx, np.zeros(K - len(kf_idx), np.int64)])
    pts, masks = gt_features(bag, sim, dims, rng)
    valid_t = torch.as_tensor(valid, device=device)
    frames = KeyframeInput(
        time=ping_time[torch.as_tensor(sel, device=device)],
        dr_pose3=ping_dr3[torch.as_tensor(sel, device=device)],
        points=torch.as_tensor(pts[sel], device=device),
        pmask=torch.as_tensor(masks[sel], device=device) & valid_t[:, None],
        valid=valid_t,
    )
    carry, _ = slam_scan(frames, params, dims)
    if dims.refine_iters > 0:
        carry = refine_loops(carry, params, RefineParams.default(device), dims)
    nk = carry.num_kf
    truth = bag.true_pose_at_ping[kf_idx][:nk]
    return (ate_rmse(carry.poses[:nk].cpu().numpy(), truth),
            ate_rmse(carry.dr_poses[:nk].cpu().numpy(), truth),
            nk, carry.num_loops)


def feature_rms(bag, fc, geom, device):
    """RMS and median distance (m) from the detected feature points of about
    12 pings, placed by the true pose, to the nearest true scatterer (the
    ones within 1 m). Each ping is one ``extract_batch`` call on a one-ping
    stack."""
    from ..slam import FeatureExtractor

    ex = FeatureExtractor(fc, geom, device)
    errs = []
    for i in range(0, len(bag.ping_images), max(1, len(bag.ping_images) // 12)):
        pts, mask = ex.extract_batch(
            torch.as_tensor(bag.ping_images[i: i + 1], device=device))
        pts = pts[0].cpu().numpy()[mask[0].cpu().numpy()]
        pose = bag.true_pose_at_ping[i]
        c, s = np.cos(pose[2]), np.sin(pose[2])
        P = np.stack([pose[0] + c * pts[:, 0] - s * pts[:, 1],
                      pose[1] + s * pts[:, 0] + c * pts[:, 1]], -1)
        d = np.sqrt(((P[:, None, :] - bag.world_points[None]) ** 2).sum(-1)).min(1)
        errs.append(d[d < 1.0])
    d = np.concatenate(errs)
    return float(np.sqrt((d ** 2).mean())), float(np.median(d))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sonar_slam_torch.cli.error_budget",
        description="Decompose the synthetic-benchmark ATE into four lanes "
                    "on a CUDA card (or the CPU).")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the CUDA card)")
    return ap


def main(argv=None) -> ErrorBudgetRun:
    args = _parser().parse_args(argv)
    device = device_from_args(args.cpu, "error budget")

    from ..io.simulate import simulate_bag
    from ..pipeline import ate_rmse, replay
    from ..slam import FeatureConfig

    sim, dims, kf_t = setups(args.full)
    sim = replace(sim, seed=args.seed)
    sim_clean = replace(sim, dvl_noise=0.0, dvl_scale_bias=0.0,
                        imu_yaw_noise=0.0, imu_yaw_drift=0.0,
                        gyro_noise=0.0)
    params = bench_params(dims, kf_t, args.full, device)
    fc = FeatureConfig(max_points=dims.max_points)
    rng = np.random.default_rng(123)
    report = {}

    bag = simulate_bag(sim)
    bag_clean = simulate_bag(sim_clean)

    rms, med = feature_rms(bag, fc, bag.geometry, device)
    report["feature_rms_cm"] = round(rms * 100, 2)
    report["feature_median_cm"] = round(med * 100, 2)
    print(f"feature fidelity: RMS {rms*100:.2f} cm, median {med*100:.2f} cm",
          flush=True)

    def lane(name, bag_, gt_feat):
        if gt_feat:
            ate, dr_ate, nk, nl = replay_gt_features(
                bag_, sim, params, dims, kf_t, rng, device)
        else:
            res = replay(bag_, fc, params, dims, device)
            truth = bag_.true_pose_at_ping[res.keyframe_ping_idx][: res.num_keyframes]
            ate = ate_rmse(res.trajectory, truth)
            dr_ate = ate_rmse(res.dr_trajectory, truth)
            nk, nl = res.num_keyframes, res.carry.num_loops
        report[name] = {"ate_cm": round(ate * 100, 2),
                        "dr_ate_cm": round(dr_ate * 100, 2),
                        "keyframes": nk, "loops": nl}
        print(f"{name:34s} ATE {ate*100:6.2f} cm (DR {dr_ate*100:6.2f}) "
              f"kf={nk} loops={nl}", flush=True)

    lane("A_full_pipeline", bag, False)
    lane("B_noiseless_sensors", bag_clean, False)
    lane("C_gt_features", bag, True)
    lane("D_noiseless_gt_features", bag_clean, True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return ErrorBudgetRun(report=report)


if __name__ == "__main__":
    main()
