"""Hyperparameter sweep: replay one bag under many SLAM configs.

Counterpart of ``scripts/sweep.py``, BASELINE.json's headline sweep ("64
CFAR/ICP hyperparameter configs replayed in parallel over the bag"). The
shared preprocessing (dead reckoning, the base config's keyframe gate, one
batched CFAR launch over the keyframe pings) runs once; then
``parallel.sweep_scan`` replays the keyframes under every lane of a 4 x 4 x
4 grid (point noise x ICP odometry sigma scale x SSM rotation gate), wrapped
to ``--lanes``. All lanes run as one lane-batched scan on one device, each
keyframe step advancing every lane (``slam/lanes.py``). With ``--devices D``
(D > 1, dividing ``--lanes``) D ranks each run the preprocessing and scan a
block of ``--lanes / D`` lanes over a mesh (``parallel/mesh.py``; ranks
share cards where D exceeds the cards, the gathers go over gloo), as the
script shards its lanes over a config mesh. The sweep runs twice:
``compile_s`` is the first run's wall time and ``wall_s`` the second's, each
ended by a device sync. Prints (and with ``--out`` writes) the script's
JSON report, with ``devices`` and, over ranks, ``ranks_per_card`` (null
for CPU ranks); on a card it also logs each rank's peak device memory to
stderr.

It runs on the CUDA card unless ``--cpu`` is given; without a card it exits
with an error rather than run on the CPU.

Usage:
  python -m sonar_slam_torch.cli.sweep --simulate --lanes 64 --out sweep.json
  python -m sonar_slam_torch.cli.sweep --simulate --lanes 64 --devices 2
  python -m sonar_slam_torch.cli.sweep --file survey.npz --lanes 16 --cpu
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import device_from_args, sync


class SweepRun(NamedTuple):
    """What ``main`` computed, for callers that run it in process."""

    report: dict
    frames: object  # KeyframeInput shared by the lanes
    params: object  # SlamParams stacked over the lanes
    dims: object  # SlamDims
    carry: object  # SlamCarry stacked over the lanes (the second sweep's)
    ates: list  # each lane's ATE, m
    truth: object  # the keyframes' true poses (keyframes, 3)
    rank_peak_mib: list | None  # each rank's peak device memory (card only)
    spawn_s: float | None  # from the spawn until every rank was ready


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sonar_slam_torch.cli.sweep",
        description="Replay one bag under a grid of SLAM configs on a CUDA "
                    "card (or the CPU).")
    ap.add_argument("--file", help=".npz bag bundle")
    ap.add_argument("--simulate", action="store_true")
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks to shard the lanes over, one process each "
                         "(ranks share cards where there are more ranks "
                         "than cards)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the CUDA card)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--duration", type=float, default=90.0)
    return ap


def small_dims_params(device, **params_over):
    """The scripts' small configuration: SlamDims for 32 keyframes of 128
    points, and the default params with a 2 m keyframe gate and 20-point
    minimums, plus ``params_over``."""
    from ..cloud import ICPConfig
    from ..slam import SlamDims, SlamParams

    dims = SlamDims(max_keyframes=32, max_points=128, target_capacity=512,
                    nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=128,
                    max_loops=16, gn_iters=3,
                    icp=ICPConfig(min_diff_rot=1e-3, min_diff_trans=1e-2))
    params = SlamParams.default(dims, device)._replace(
        keyframe_translation=float(np.float32(2.0)), ssm_min_points=20,
        nssm_min_points=20, **params_over)
    return dims, params


def build_frames(bag, params, dims, feature_config, device):
    """The shared preprocessing: dead reckoning at the pings, the keyframe
    gate under ``params``, the first ``max_keyframes`` keyframes' features
    in one batch. Returns (KeyframeInput padded to ``max_keyframes``, the
    keyframes' ping indices)."""
    from ..geometry import pose3_to_pose2
    from ..io.dataset import match_pings_to_ticks
    from ..pipeline import odometry
    from ..slam import FeatureExtractor, KeyframeInput, select_keyframes

    tick_time, dr3, _ = odometry(bag, device)
    tick_idx, sync_ok = match_pings_to_ticks(bag.ping_time, tick_time)
    ping_dr3 = dr3[torch.as_tensor(tick_idx, device=device)]
    ping_time = torch.as_tensor(np.asarray(bag.ping_time, np.float32),
                                device=device)
    kf_mask = select_keyframes(ping_time, pose3_to_pose2(ping_dr3),
                               torch.as_tensor(sync_ok, device=device), params)
    K = dims.max_keyframes
    kf_idx = np.nonzero(kf_mask.cpu().numpy())[0][:K]
    valid = torch.arange(K, device=device) < len(kf_idx)
    sel_np = np.concatenate([kf_idx, np.zeros(K - len(kf_idx), np.int64)])
    sel = torch.as_tensor(sel_np, device=device)
    ext = FeatureExtractor(feature_config, bag.geometry, device)
    pts, masks = ext.extract_batch(torch.as_tensor(bag.ping_images[sel_np],
                                                   device=device))
    frames = KeyframeInput(time=ping_time[sel], dr_pose3=ping_dr3[sel],
                           points=pts, pmask=masks & valid[:, None],
                           valid=valid)
    return frames, kf_idx


def sim_config(duration: float, **over):
    """The scripts' small survey: 192 x 96 pings at 1 Hz around a 10 m loop."""
    from ..io.simulate import SimConfig

    return SimConfig(duration=duration, speed=0.5, sonar_rate=1.0,
                     num_ranges=192, num_bearings=96, loop_radius=10.0,
                     imu_rate=20.0, **over)


def lane_grid(base, lanes: int):
    """The sweep's lanes: the 4 x 4 x 4 grid of (point noise, ICP odometry
    sigma scale, SSM rotation gate) over ``base``, wrapped to ``lanes``.
    Returns (the grid's combinations, one SlamParams a lane)."""
    noises = [0.3, 0.4, 0.5, 0.6]
    sig_scales = [0.5, 1.0, 1.5, 2.0]
    rot_gates = [np.radians(20), np.radians(30), np.radians(45), np.radians(60)]
    combos = list(itertools.product(noises, sig_scales, rot_gates))
    combos = (combos * ((lanes + len(combos) - 1) // len(combos)))[:lanes]
    return combos, [
        base._replace(point_noise=float(np.float32(n)),
                      icp_odom_sigmas=base.icp_odom_sigmas * s,
                      ssm_max_rotation=float(np.float32(r)))
        for (n, s, r) in combos
    ]


def sweep_inputs(device, lanes: int, duration: float = 90.0, file=None,
                 **dims_over):
    """What :func:`main` sweeps: (the bag, SlamDims, the lane grid's
    combinations, the stacked params, the shared KeyframeInput, the
    keyframes' ping indices). ``dims_over`` replaces SlamDims fields."""
    import dataclasses

    from ..io.simulate import simulate_bag
    from ..parallel import stack_params
    from ..slam import FeatureConfig

    if file:
        from .replay import load_npz_bag

        bag = load_npz_bag(file, 0.0, 0.0)
    else:
        bag = simulate_bag(sim_config(duration))
    dims, base = small_dims_params(device)
    dims = dataclasses.replace(dims, **dims_over)
    combos, lane_list = lane_grid(base, lanes)
    # shared preprocessing (config-independent up to the keyframe gate, which
    # uses the base config's gates so all lanes share the same keyframes —
    # like the reference harness replaying the same bag)
    frames, kf_idx = build_frames(
        bag, base, dims, FeatureConfig(max_points=dims.max_points), device)
    return bag, dims, combos, stack_params(lane_list), frames, kf_idx


def main(argv=None) -> SweepRun:
    args = _parser().parse_args(argv)
    device = device_from_args(args.cpu, "sweep")
    if args.devices > 1:
        from ..parallel.mesh import check_divisible, spawn

        check_divisible(args.lanes, args.devices, "--lanes")
        return spawn(_sweep_rank, args.devices, args, time.time(),
                     cpu=args.cpu)
    return _sweep(args, device)


def _sweep_rank(mesh, args, spawned_at: float):
    """One rank of ``--devices``: the whole sweep over its block of lanes;
    rank 0's SweepRun (the others return None)."""
    run = _sweep(args, mesh.device, mesh, time.time() - spawned_at)
    return run if mesh.rank == 0 else None


def _sweep(args, device, mesh=None, ready_s: float = 0.0) -> SweepRun:
    from ..parallel import sweep_scan
    from ..parallel.mesh import gather, ranks_per_card
    from ..pipeline import ate_rmse

    bag, dims, combos, stacked, frames, kf_idx = sweep_inputs(
        device, args.lanes, args.duration,
        None if args.simulate else args.file)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    sweep_scan(frames, stacked, dims, mesh)
    sync(device)
    compile_s = time.time() - t0
    t0 = time.time()
    carry, _ = sweep_scan(frames, stacked, dims, mesh)
    sync(device)
    wall = time.time() - t0
    peak = (torch.cuda.max_memory_allocated(device) / 2**20
            if device.type == "cuda" else float("nan"))
    per_rank = torch.tensor([[peak, ready_s]], dtype=torch.float64)
    if mesh is not None:
        per_rank = gather(per_rank, mesh)
        if mesh.rank != 0:
            return None

    nk = int(carry.num_kf[0])
    truth = bag.true_pose_at_ping[kf_idx][:nk]
    poses = carry.poses.cpu().numpy()
    ates = [ate_rmse(poses[i][:nk], truth) for i in range(args.lanes)]
    loops = carry.num_loops.cpu().numpy()
    best = int(np.argmin(ates))
    report = {
        "lanes": args.lanes,
        "devices": args.devices,
        **({"ranks_per_card": ranks_per_card(args.devices, args.cpu)}
           if mesh is not None else {}),
        "keyframes": nk,
        "wall_s": round(wall, 3),
        "compile_s": round(compile_s, 1),
        "lane_seconds_per_lane": round(wall / args.lanes, 4),
        "best_lane": best,
        "best_config": {
            "point_noise": float(combos[best][0]),
            "icp_sigma_scale": float(combos[best][1]),
            "ssm_max_rotation_deg": float(np.degrees(combos[best][2])),
        },
        "best_ate_m": round(ates[best], 4),
        "median_ate_m": round(float(np.median(ates)), 4),
        "loops_per_lane": [int(x) for x in loops],
    }
    print(json.dumps(report, indent=2))
    rank_peak = None
    if device.type == "cuda":
        rank_peak = [round(float(x), 1) for x in per_rank[:, 0]]
        print(f"peak device memory a rank {rank_peak} MiB "
              f"({torch.cuda.get_device_name(device)})", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return SweepRun(report=report, frames=frames, params=stacked, dims=dims,
                    carry=carry, ates=ates, truth=truth,
                    rank_peak_mib=rank_peak,
                    spawn_s=float(per_rank[:, 1].max()) if mesh else None)


if __name__ == "__main__":
    main()
