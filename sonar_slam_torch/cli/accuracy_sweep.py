"""Accuracy sweep: end-to-end synthetic ATE vs the resolution/noise knobs.

Counterpart of ``scripts/accuracy_sweep.py``, with its flags, printed lines
and JSON keys. It replays the benchmark configs (its own ``small_setup`` and
``full_setup``, which differ from ``cli.error_budget.setups``: fewer loop
slots, no DVL basis, no refinement) across a grid of (frontend resolution,
SLAM aggregation resolution, point_noise, sub-bin refinement) and reports
keyframe ATE per variant, optionally over several simulator seeds.

It runs on the CUDA card unless ``--cpu`` is given; without a card it exits
with an error rather than run on the CPU. ``main`` returns the ranked
results for in-process callers.

Usage: python -m sonar_slam_torch.cli.accuracy_sweep [--full] [--seeds N]
                                                     [--out FILE] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from . import device_from_args
from .error_budget import icp_prod


class AccuracySweepRun(NamedTuple):
    """What ``main`` computed, for callers that run it in process."""

    results: list  # the rows as written to ``--out``, ranked by mean ATE


def small_setup():
    """Production small config (mirrors bench.py --small)."""
    from ..io.simulate import SimConfig
    from ..slam import SlamDims

    sim = SimConfig(duration=90.0, speed=0.5, sonar_rate=1.0, num_ranges=192,
                    num_bearings=96, loop_radius=10.0, imu_rate=20.0)
    dims = SlamDims(max_keyframes=32, max_points=128, target_capacity=512,
                    nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=128,
                    max_loops=16, gn_iters=3, icp=icp_prod(),
                    nssm_target_window=2, nssm_pair_refine=True,
                    pair_refine_max_dt=0.35, pair_refine_max_dr=0.07,
                    pair_refine_min_inliers=25)
    return sim, dims, 2.0


def full_setup():
    """Production full config (mirrors bench.py)."""
    from ..io.simulate import SimConfig
    from ..slam import SlamDims

    sim = SimConfig(duration=480.0, speed=0.5, sonar_rate=5.0, num_ranges=512,
                    num_bearings=256, loop_radius=18.0, imu_rate=50.0)
    dims = SlamDims(max_keyframes=128, max_points=256, target_capacity=1024,
                    nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=512,
                    max_loops=32, gn_iters=3, icp=icp_prod(),
                    nssm_target_window=2, nssm_pair_refine=True,
                    pair_refine_max_dt=0.35, pair_refine_max_dr=0.07,
                    pair_refine_min_inliers=25,
                    nssm_reinit_after_select=True, aggregate_with_dr=True,
                    estimate_dvl_scale=True)
    return sim, dims, 3.0


def run_variant(bag, dims, kf_translation, feat_res, slam_res, point_noise,
                subbin, device, max_points=None, target_capacity=None):
    """One replay of ``bag`` under a variant: (ATE m, DR ATE m, keyframes,
    loops)."""
    from ..pipeline import ate_rmse, replay
    from ..slam import FeatureConfig, SlamParams

    if max_points is not None:
        dims = replace(dims, max_points=max_points)
    if target_capacity is not None:
        dims = replace(dims, target_capacity=target_capacity)
    dims = replace(dims, point_resolution=slam_res)
    params = SlamParams.default(dims, device)._replace(
        keyframe_translation=float(np.float32(kf_translation)),
        ssm_min_points=20,
        nssm_min_points=20,
        fuse_odometry=True,
        odom_sigmas=torch.tensor([0.05, 0.05, 0.01], device=device),
        icp_odom_sigmas=torch.tensor([0.3, 0.3, 0.03], device=device),
        point_resolution=float(np.float32(slam_res)),
        point_noise=float(np.float32(point_noise)),
    )
    fc = FeatureConfig(max_points=dims.max_points, resolution=feat_res,
                       subbin=subbin)
    res = replay(bag, fc, params, dims, device)
    truth = bag.true_pose_at_ping[res.keyframe_ping_idx][: res.num_keyframes]
    ate = ate_rmse(res.trajectory, truth)
    dr_ate = ate_rmse(res.dr_trajectory, truth)
    return ate, dr_ate, res.num_keyframes, res.carry.num_loops


VARIANTS = [
    # (label, feat_res, slam_res, point_noise, subbin, max_points, capacity)
    ("baseline r1 (.5/.5/.5)", 0.5, 0.5, 0.5, True, None, None),
    ("no-subbin (.5/.5/.5)", 0.5, 0.5, 0.5, False, None, None),
    ("feat.25 (.25/.5/.5)", 0.25, 0.5, 0.5, True, None, None),
    ("agg.25 (.25/.25/.5)", 0.25, 0.25, 0.5, True, None, None),
    ("noise.25 (.25/.25/.25)", 0.25, 0.25, 0.25, True, None, None),
    ("fine (.125/.25/.25) 2xpts", 0.125, 0.25, 0.25, True, 2, 2),
    ("noise.35 (.25/.25/.35)", 0.25, 0.25, 0.35, True, None, None),
]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sonar_slam_torch.cli.accuracy_sweep",
        description="Replay the benchmark config under a grid of resolution "
                    "and noise variants on a CUDA card (or the CPU).")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the CUDA card)")
    return ap


def main(argv=None) -> AccuracySweepRun:
    args = _parser().parse_args(argv)
    device = device_from_args(args.cpu, "accuracy sweep")

    from ..io.simulate import simulate_bag

    sim, dims, kf_t = (full_setup if args.full else small_setup)()
    results = []
    for label, fr, sr, pn, sb, mp, cap in VARIANTS:
        mp = dims.max_points * mp if mp else None
        cap = dims.target_capacity * cap if cap else None
        ates, drs, loops = [], [], []
        for seed in range(args.seeds):
            bag = simulate_bag(replace(sim, seed=seed))
            t0 = time.time()
            ate, dr_ate, nk, nl = run_variant(
                bag, dims, kf_t, fr, sr, pn, sb, device, mp, cap)
            ates.append(ate); drs.append(dr_ate); loops.append(nl)
            print(f"{label:28s} seed={seed} ATE={ate*100:6.2f} cm "
                  f"(DR {dr_ate*100:6.2f}) kf={nk} loops={nl} "
                  f"[{time.time()-t0:.0f}s]", flush=True)
        results.append({
            "label": label, "feat_res": fr, "slam_res": sr,
            "point_noise": pn, "subbin": sb,
            "ate_cm": [round(a * 100, 2) for a in ates],
            "dr_ate_cm": [round(a * 100, 2) for a in drs],
            "loops": loops,
            "mean_ate_cm": round(float(np.mean(ates)) * 100, 2),
        })
    results.sort(key=lambda r: r["mean_ate_cm"])
    print("\n=== ranked ===")
    for r in results:
        print(f"{r['mean_ate_cm']:7.2f} cm  {r['label']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return AccuracySweepRun(results=results)


if __name__ == "__main__":
    main()
