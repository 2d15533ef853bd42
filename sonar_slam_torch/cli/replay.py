"""Offline replay of a survey bundle: the reference's ``slam.launch
file:=<bag>``.

Counterpart of ``scripts/replay.py``, with every flag of it. The "bag" is an
.npz bundle (``cli.convert_bag`` from a ROS bag, or ``cli.simulate_bag``) or
a synthetic survey (``--simulate``), replayed by ``pipeline.replay`` with the
configuration of the YAML files (``io.config``). It writes, into ``--out``:

* ``trajectory.npz``: ``states`` (the reference's structured state array,
  ``io.state.STATE_DTYPE``), ``trajectory``, ``dr_trajectory``,
  ``keyframe_times``, ``loops_i`` and ``loops_j``;
* ``slam_carry.npz``: the final carry (``io.state.save_checkpoint``);
* ``occupancy.npz``: ``occ`` (method 1 of the grid built keyframe by
  keyframe) and, with ``--intensity``, ``intensity``; ``--no-map`` skips it;
* with ``--save-submaps``, ``step-<K-1>-submaps.npz`` (``save_submaps``);
* with ``--plot``, ``trajectory.png`` (matplotlib, imported only then).

It runs on the CUDA card unless ``--cpu`` is given; without a card it exits
with an error rather than run on the CPU.

Usage:
  python -m sonar_slam_torch.cli.replay --simulate --duration 240 --out out/
  python -m sonar_slam_torch.cli.replay --file bag.npz --start 10 --duration 60 --out out/
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from ..io.simulate import SimConfig, SyntheticBag, simulate_bag
from ..slam.sonar import SonarGeometry
from . import device_from_args


class ReplayRun(NamedTuple):
    """What ``main`` computed, for callers that run it in process."""

    result: object  # pipeline.ReplayResult
    dims: object  # SlamDims
    states: np.ndarray  # STATE_DTYPE
    ate_m: float
    wall_s: float
    mapping: object | None  # MappingState of the grid built keyframe by keyframe
    model: object | None  # SubmapModel
    mapping_s: float | None  # the mapping loop's seconds, ended by a device sync


def load_npz_bag(path: str, start: float, duration: float) -> SyntheticBag:
    """A bundle (``SyntheticBag`` layout), cropped to [start, start +
    duration] (``duration`` 0: to the end)."""
    end = start + duration if duration > 0 else np.inf
    with np.load(path, allow_pickle=False) as d:

        def crop(tname, *names):
            t = d[tname]
            sel = (t >= start) & (t <= end)
            return (t[sel],) + tuple(d[n][sel] for n in names)

        imu_t, imu_rpy = crop("imu_time", "imu_rpy")
        dvl_t, dvl_vel = crop("dvl_time", "dvl_vel")
        dep_t, depth = crop("depth_time", "depth")
        gyr_t = gyr_d = None
        if "gyro_time" in d and len(d["gyro_time"]):
            gyr_t, gyr_d = crop("gyro_time", "gyro_delta")
        png_t, imgs, truth = crop("ping_time", "ping_images", "true_pose_at_ping")
        geom = SonarGeometry(
            num_ranges=int(d["num_ranges"]),
            num_bearings=int(d["num_bearings"]),
            range_resolution=float(d["range_resolution"]),
            bearings=d["bearings"],
        )
        world = (d["world_points"] if "world_points" in d
                 else np.zeros((0, 2), np.float32))
    return SyntheticBag(
        imu_time=imu_t, imu_rpy=imu_rpy, dvl_time=dvl_t, dvl_vel=dvl_vel,
        depth_time=dep_t, depth=depth, ping_time=png_t, ping_images=imgs,
        true_pose_at_ping=truth, geometry=geom, world_points=world,
        gyro_time=gyr_t, gyro_delta=gyr_d,
    )


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sonar_slam_torch.cli.replay",
        description="Replay a survey bundle on a CUDA card (or the CPU).")
    ap.add_argument("--file", help=".npz bag bundle")
    ap.add_argument("--simulate", action="store_true")
    ap.add_argument("--start", type=float, default=0.0)
    ap.add_argument("--duration", type=float, default=0.0, help="0 = all")
    ap.add_argument("--out", default="replay_out")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the CUDA card)")
    ap.add_argument("--slam-config", default=None)
    ap.add_argument("--feature-config", default=None)
    ap.add_argument("--max-keyframes", type=int, default=128)
    ap.add_argument("--no-map", action="store_true")
    ap.add_argument("--intensity", action="store_true",
                    help="also export the average-intensity map")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--save-submaps", action="store_true",
                    help="write the per-submap debug dump (step-N-submaps.npz)")
    ap.add_argument("--p2l", action="store_true",
                    help="point-to-line ICP minimizer")
    ap.add_argument("--icp-max-dist", type=float, default=None,
                    help="override the ICP correspondence radius")
    ap.add_argument("--no-subbin", action="store_true",
                    help="disable sub-bin peak refinement in the frontend")
    ap.add_argument("--refine", type=int, default=0, metavar="N",
                    help="post-convergence loop re-registration sweeps "
                         "(slam/refine.py); 0 disables")
    ap.add_argument("--refine-sweep", action="store_true",
                    help="also run the proximity loop sweep during --refine")
    return ap


def main(argv=None) -> ReplayRun:
    ap = _parser()
    args = ap.parse_args(argv)
    device = device_from_args(args.cpu, "replay")

    from ..io.config import load_feature_config, load_slam_config
    from ..io.state import get_states, save_checkpoint
    from ..kernels.cfar_cuda import cfar_detect
    from ..pipeline import ate_rmse, replay
    from ..utils import CodeTimer, loginfo

    if args.simulate:
        bag = simulate_bag(SimConfig(duration=args.duration or 240.0))
    elif args.file:
        bag = load_npz_bag(args.file, args.start, args.duration)
    else:
        ap.error("need --file or --simulate")

    params, dims, _ = load_slam_config(
        args.slam_config, dims_overrides={"max_keyframes": args.max_keyframes},
        device=device)
    if args.p2l or args.icp_max_dist is not None:
        icp_over = {}
        if args.p2l:
            icp_over["point_to_line"] = True
        if args.icp_max_dist is not None:
            icp_over["outlier_max_dist"] = args.icp_max_dist
        dims = dataclasses.replace(dims, icp=dims.icp._replace(**icp_over))
    feat = load_feature_config(args.feature_config, max_points=dims.max_points)
    if args.no_subbin:
        feat = feat._replace(subbin=False)
    if args.refine > 0:
        dims = dataclasses.replace(dims, refine_iters=args.refine,
                                   refine_sweep=args.refine_sweep)

    with CodeTimer("replay", sync=device) as span:
        res = replay(bag, feat, params, dims, device)
    wall = span.took

    os.makedirs(args.out, exist_ok=True)
    states = get_states(res.carry, dims)
    nl = res.carry.num_loops
    loops_i = res.carry.loops_i[:nl].cpu().numpy().astype(np.int32)
    loops_j = res.carry.loops_j[:nl].cpu().numpy().astype(np.int32)
    with open(os.path.join(args.out, "trajectory.npz"), "wb") as f:
        np.savez(f, states=states, trajectory=res.trajectory,
                 dr_trajectory=res.dr_trajectory,
                 keyframe_times=res.keyframe_times, loops_i=loops_i,
                 loops_j=loops_j)
    save_checkpoint(os.path.join(args.out, "slam_carry.npz"), res.carry)

    truth = bag.true_pose_at_ping[res.keyframe_ping_idx]
    ate = ate_rmse(res.trajectory, truth)
    loginfo(
        f"{res.num_keyframes} keyframes, {nl} loops, "
        f"ATE {ate*100:.1f} cm, wall {wall:.1f}s "
        f"({(bag.ping_time[-1]-bag.ping_time[0])/max(wall,1e-9):.1f}x real-time)"
    )
    # the launch counters count this process's card launches (none on the
    # CPU); a process that runs one replay logs the replay's own
    loginfo(f"stages s {json.dumps(res.stage_s)} on {device}, CFAR launches "
            f"{json.dumps(cfar_detect.kernel_launches)}")

    mst = model = mapping_s = None
    if not args.no_map:
        from ..mapping import (MappingConfig, SubmapModel, add_keyframe,
                               intensity_grid, mapping_init,
                               occupancy_grid_method1, save_submaps,
                               submap_intensity)

        mcfg = MappingConfig(max_keyframes=dims.max_keyframes)
        model = SubmapModel(mcfg, bag.geometry, device)
        mst = mapping_init(mcfg, model)
        kf_int = torch.zeros((mcfg.max_keyframes, model.sonar_xy.shape[0]),
                             device=device)
        with CodeTimer("mapping", sync=device) as span:
            for k in range(res.num_keyframes):
                mst = add_keyframe(mst, k, res.trajectory[k],
                                   res.carry.points[k], res.carry.pmasks[k],
                                   model)
                if args.intensity:
                    ping = torch.as_tensor(
                        bag.ping_images[res.keyframe_ping_idx[k]], device=device)
                    kf_int[k] = submap_intensity(ping, model)
            arts = {"occ": occupancy_grid_method1(mst, model).cpu().numpy()}
            if args.intensity:
                arts["intensity"] = intensity_grid(mst, model, kf_int).cpu().numpy()
        mapping_s = span.took
        loginfo(f"mapping {res.num_keyframes} keyframes: {mapping_s:.3f} s")
        with open(os.path.join(args.out, "occupancy.npz"), "wb") as f:
            np.savez_compressed(f, **arts)
        if args.save_submaps:
            save_submaps(os.path.join(
                args.out, f"step-{res.num_keyframes - 1}-submaps.npz"),
                mcfg, mst, model)

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from ..utils.viz import plot_constraints, plot_trajectory

        fig, ax = plt.subplots(figsize=(8, 8))
        plot_trajectory(truth, ax=ax, color_by_index=False, color="k",
                        label="truth")
        plot_trajectory(res.dr_trajectory, ax=ax, color_by_index=False,
                        color="orange", label="dead reckoning")
        plot_constraints(res.trajectory, loops_i, loops_j, ax=ax)
        ax.legend()
        ax.set_aspect("equal")
        fig.savefig(os.path.join(args.out, "trajectory.png"), dpi=120)
        loginfo(f"wrote {args.out}/trajectory.png")

    return ReplayRun(result=res, dims=dims, states=states, ate_m=ate,
                     wall_s=wall, mapping=mst, model=model, mapping_s=mapping_s)


if __name__ == "__main__":
    main()
