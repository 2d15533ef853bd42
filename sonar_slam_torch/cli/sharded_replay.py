"""Replay at a large keyframe capacity: the keyframe-axis scale path.

Counterpart of ``scripts/sharded_replay.py``. It runs the full production
pipeline (simulate -> DR -> features -> SLAM scan -> loop refinement with
the sweep and the chain) at a keyframe capacity chosen to exercise the scale
axis (default 1024, far beyond the survey's real keyframe count: the padded
slots still flow through every K-wide step as masked work, as a long survey
would use the capacity).

With ``--devices D`` (D > 1) the refinement's registration fan-outs are
sharded over D ranks (``pipeline.replay(mesh=...)``, ``parallel/mesh.py``):
each rank is a process of its own on its card (ranks share cards where D
exceeds the cards; the gathers go over gloo) that simulates the survey and
runs the replay, replicated up to the refinement, as the script shards them
over an n-device mesh. K = 1024 is exercised by the K-wide work of every
keyframe step: the NSSM gate over K x N points, the transforms of all K
clouds, and the dense (3K)² Gauss-Newton system.

``--check`` (with ``--devices`` 2 or more) is the script's check: the same
replay in this one process at the same capacity must give the same
keyframes and loop count, and poses within ``MESH_ATOL_M`` (the script's
bound); it also says whether the two are bit for bit. ``--capacity-check`` replays the same survey at capacity
128 and requires the same keyframes, the same loop count and the trajectory
within ``CAPACITY_ATOL_M``.

It runs on the CUDA card unless ``--cpu`` is given; without a card it exits
with an error rather than run on the CPU.

Usage:
  python -m sonar_slam_torch.cli.sharded_replay --max-keyframes 1024 --devices 2 --check
  python -m sonar_slam_torch.cli.sharded_replay --max-keyframes 1024 --capacity-check
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from . import device_from_args, sync

CHECK_KEYFRAMES = 128
# the trajectory at two capacities: the padded slots change the order of the
# Gauss-Newton system's sums (tests/test_torch_sharded_replay.py measures
# the gap in both packages)
CAPACITY_ATOL_M = 1e-4
# the sharded replay against the one-process replay (scripts/sharded_replay.py)
MESH_ATOL_M = 1e-5


class ShardedRun(NamedTuple):
    """What ``main`` computed, for callers that run it in process."""

    result: object  # pipeline.ReplayResult at K = --max-keyframes
    ate_m: float
    wall_s: float
    peak_mib: float | None  # peak device memory of the replay (card only)
    check: object | None  # ShardedRun of the replay at CHECK_KEYFRAMES
    max_dpose: float | None  # largest |pose difference| against the check
    one_process: object | None  # the one-process replay's ShardedRun (--check)
    one_process_dpose: float | None  # largest |pose difference| against it
    bit_for_bit: bool | None  # trajectory and carry poses equal to it
    launches: dict | None  # CFAR launches by kernel of this replay alone
    # (every rank's with --devices), the checks' replays left out


def config(max_keyframes: int, device):
    """The script's production configuration at capacity ``max_keyframes``:
    (SlamDims, SlamParams, FeatureConfig)."""
    from ..cloud import ICPConfig
    from ..slam import FeatureConfig, SlamDims, SlamParams

    icp_prod = ICPConfig(max_iterations=12, min_diff_rot=1e-3,
                         min_diff_trans=1e-2, point_to_line=True,
                         outlier_max_dist=0.5)
    dims = SlamDims(
        max_keyframes=max_keyframes, max_points=128, target_capacity=512,
        nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=128,
        max_loops=32, gn_iters=3, icp=icp_prod,
        nssm_target_window=2, nssm_pair_refine=True,
        pair_refine_max_dt=0.35, pair_refine_max_dr=0.07,
        pair_refine_min_inliers=25,
        refine_iters=2, refine_sweep=True, refine_chain=True,
    )

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    params = SlamParams.default(dims, device)._replace(
        keyframe_translation=float(np.float32(2.0)), ssm_min_points=20,
        nssm_min_points=20, fuse_odometry=True, use_best_start_tf=True,
        odom_sigmas=vec([0.05, 0.05, 0.01]),
        icp_odom_sigmas=vec([0.3, 0.3, 0.1]))
    return dims, params, FeatureConfig(max_points=128)


def _run(bag, max_keyframes: int, device, mesh=None) -> ShardedRun:
    from ..pipeline import ate_rmse, replay

    dims, params, fc = config(max_keyframes, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    res = replay(bag, fc, params, dims, device, mesh=mesh)
    sync(device)
    wall = time.time() - t0
    peak = (torch.cuda.max_memory_allocated(device) / 2**20
            if device.type == "cuda" else None)
    truth = bag.true_pose_at_ping[res.keyframe_ping_idx][: res.num_keyframes]
    return ShardedRun(result=res, ate_m=ate_rmse(res.trajectory, truth),
                      wall_s=wall, peak_mib=peak, check=None, max_dpose=None,
                      one_process=None, one_process_dpose=None,
                      bit_for_bit=None, launches=None)


def _launches() -> dict:
    """The CFAR launch counters by kernel, as they stand."""
    from ..kernels.cfar_cuda import cfar_detect

    return dict(cfar_detect.kernel_launches)


def _rank(mesh, max_keyframes: int, duration: float):
    """One rank of ``--devices``: the survey simulated and replayed with the
    refinement sharded over the mesh; rank 0's ShardedRun (the others
    return None)."""
    from ..io.simulate import simulate_bag
    from .sweep import sim_config

    run = _run(simulate_bag(sim_config(duration)), max_keyframes, mesh.device,
               mesh)
    return run if mesh.rank == 0 else None


def _against(res, r1) -> tuple[bool, float]:
    """Whether two replays have the same keyframes and loop count, and then
    their trajectories' largest |difference| (inf otherwise)."""
    same = (np.array_equal(res.keyframe_ping_idx, r1.keyframe_ping_idx)
            and res.carry.num_loops == r1.carry.num_loops)
    return same, (float(np.abs(res.trajectory - r1.trajectory).max())
                  if same else float("inf"))


def main(argv=None) -> ShardedRun:
    ap = argparse.ArgumentParser(
        prog="python -m sonar_slam_torch.cli.sharded_replay",
        description="Replay at a large keyframe capacity on a CUDA card (or "
                    "the CPU).")
    ap.add_argument("--max-keyframes", type=int, default=1024)
    ap.add_argument("--duration", type=float, default=90.0)
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks to shard the refinement over, one process "
                         "each (ranks share cards where there are more "
                         "ranks than cards)")
    ap.add_argument("--check", action="store_true",
                    help="hold the sharded replay to the one-process "
                         "replay at the same capacity (needs --devices 2 "
                         "or more)")
    ap.add_argument("--capacity-check", action="store_true",
                    help=f"hold the replay to the same replay at capacity "
                         f"{CHECK_KEYFRAMES}")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the CUDA card)")
    args = ap.parse_args(argv)
    if args.check and args.devices < 2:
        raise ValueError("--check holds the sharded replay to the one-process "
                         "replay: it needs --devices 2 or more")
    device = device_from_args(args.cpu, "replay")

    from ..io.simulate import simulate_bag
    from ..slam.refine import check_mesh_dims
    from .sweep import sim_config

    if args.devices > 1:
        # here, before any rank starts (a rank's replay checks it too)
        check_mesh_dims(config(args.max_keyframes, device)[0], args.devices)
    # the ranks simulate the survey themselves
    bag = (simulate_bag(sim_config(args.duration))
           if args.devices == 1 or args.check or args.capacity_check else None)
    before = _launches()
    if args.devices > 1:
        from ..parallel.mesh import spawn

        run = spawn(_rank, args.devices, args.max_keyframes, args.duration,
                    cpu=args.cpu, axis="kf")
    else:
        run = _run(bag, args.max_keyframes, device)
    after = _launches()
    run = run._replace(launches={k: after[k] - before[k] for k in after})
    res = run.result
    peak = "" if run.peak_mib is None else f", peak {run.peak_mib:.1f} MiB"
    ranks = f" over {args.devices} ranks" if args.devices > 1 else ""
    print(f"sharded replay: K-capacity {args.max_keyframes} on {device}"
          f"{ranks}, {res.num_keyframes} real keyframes, loops "
          f"{res.carry.num_loops}, ATE {run.ate_m*100:.2f} cm, wall "
          f"{run.wall_s:.1f}s (incl compile){peak}")

    if args.check:
        one = _run(bag, args.max_keyframes, device)
        r1 = one.result
        same, d = _against(res, r1)
        bits = (same and np.array_equal(res.trajectory, r1.trajectory)
                and torch.equal(res.carry.poses.cpu(), r1.carry.poses.cpu()))
        print(f"equality against the one-process replay: {r1.num_keyframes} "
              f"keyframes, loops {r1.carry.num_loops}, wall "
              f"{one.wall_s:.1f}s; max |dpose| = {d:.3e}, bit for bit {bits}")
        if not same or not d < MESH_ATOL_M:
            raise SystemExit(f"equality check FAILED: keyframes and loops "
                             f"equal {same}, max |dpose| {d:.3e} (allowed "
                             f"< {MESH_ATOL_M})")
        print("equality check PASSED")
        run = run._replace(one_process=one, one_process_dpose=d,
                           bit_for_bit=bits)

    if args.capacity_check:
        ref = _run(bag, CHECK_KEYFRAMES, device)
        r1 = ref.result
        same, d = _against(res, r1)
        peak = "" if ref.peak_mib is None else f", peak {ref.peak_mib:.1f} MiB"
        print(f"capacity check against K-capacity {CHECK_KEYFRAMES}: "
              f"{r1.num_keyframes} keyframes, loops {r1.carry.num_loops}, "
              f"ATE {ref.ate_m*100:.2f} cm, wall {ref.wall_s:.1f}s{peak}; "
              f"max |dpose| = {d:.3e}")
        if not same or d > CAPACITY_ATOL_M:
            raise SystemExit(f"capacity check FAILED: keyframes and loops "
                             f"equal {same}, max |dpose| {d:.3e} (allowed "
                             f"{CAPACITY_ATOL_M})")
        print("capacity check PASSED")
        run = run._replace(check=ref, max_dpose=d)
    return run


if __name__ == "__main__":
    main()
