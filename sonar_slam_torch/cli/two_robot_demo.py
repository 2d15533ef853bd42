"""Two-robot SLAM end to end: survey -> exchange -> PCM-vet -> merged graph.

Counterpart of ``scripts/two_robot_demo.py``:

1. two robots survey the same basin on opposite phases of the loop (shared
   world, independent sensor noise),
2. each runs the complete SLAM scan independently (``multi_robot_scan``:
   each robot a lane of one lane-batched scan on one device; with
   ``--devices 2`` one robot a rank, each rank its own process and card,
   ranks sharing cards where there are fewer, the carries all-gathered
   over gloo, as the JAX package gives each robot its own mesh lane; the
   line that reports it ends with the scan's ``wall_s``, host seconds
   ended by a device sync),
3. candidate keyframe summaries are exchanged (the ISAM2Update analog),
4. all-pairs NSSM-style registration proposes inter-robot transforms (the
   64 pairs' Sobol searches in one batched search, their ICPs in one batch),
5. PCM vets the proposal set (pairwise-consistency max clique),
6. accepted proposals become between-factors in one merged pose graph,
   re-optimized jointly; both trajectories are verified against ground truth.

The script's ``use_pallas="never"`` has no counterpart: on a card the
port's feature extractor always runs the CUDA sum kernel (one launch a
robot), on the CPU its plain version. ``matplotlib`` is imported only for
``--plot``. It runs on the CUDA card unless ``--cpu`` is given; without a
card it exits with an error rather than run on the CPU.

Usage: python -m sonar_slam_torch.cli.two_robot_demo [--duration 90] [--plot out.png] [--devices 2] [--cpu]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from . import device_from_args, sync


class TwoRobotRun(NamedTuple):
    """What ``main`` computed, for callers that run it in process."""

    keyframes: list  # per robot
    loops: list  # per robot
    proposals: int  # pairs passing ICP + overlap
    accepted: int  # PCM-accepted proposals
    clique: int  # PCM clique size
    ate_joint_m: float  # merged, after one joint SE(2) alignment
    merged_poses: np.ndarray  # (nk_a + nk_b, 3)
    scan_wall_s: float  # the batched two-robot scan, ended by a device sync
    carries: object  # the robots' scanned SlamCarry, stacked on the robot axis


def dr_start_pose(bag, device):
    """Each robot's DR frame is anchored at its (known) deployment pose —
    the shared-world-frame assumption of the reference's rov_id design."""
    return torch.as_tensor(bag.true_pose_at_ping[0], dtype=torch.float32,
                           device=device)


def robot_inputs(device, duration: float, robots: int = 2, **dims_over):
    """The demo's surveys and configuration: robot r surveys the basin with
    sensor seed r + 1 at loop phase 2 pi r / ``robots`` (the demo's two: 0
    and pi), under the scripts' small dims (``dims_over`` replaces SlamDims
    fields) and the demo's params. Returns (bags, dims, params, each
    robot's (KeyframeInput, keyframe pings), the inputs stacked on the
    robot axis)."""
    from ..io.simulate import simulate_bag
    from ..slam import FeatureConfig, KeyframeInput
    from .sweep import build_frames, sim_config, small_dims_params

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    sim0 = sim_config(duration, world_seed=42)
    bags = [simulate_bag(replace(sim0, seed=r + 1, phase=2 * np.pi * r / robots))
            for r in range(robots)]
    dims, params = small_dims_params(
        device, fuse_odometry=True, odom_sigmas=vec([0.05, 0.05, 0.01]),
        icp_odom_sigmas=vec([0.3, 0.3, 0.03]))
    dims = replace(dims, **dims_over)
    fc = FeatureConfig(max_points=dims.max_points)
    built = [build_frames(b, params, dims, fc, device) for b in bags]
    stacked = KeyframeInput(*(None if f[0] is None else torch.stack(f)
                              for f in zip(*(b[0] for b in built))))
    return bags, dims, params, built, stacked


def main(argv=None) -> TwoRobotRun:
    ap = argparse.ArgumentParser(
        prog="python -m sonar_slam_torch.cli.two_robot_demo",
        description="Two robots survey one basin; merge their pose graphs on "
                    "PCM-vetted inter-robot loops, on a CUDA card (or the CPU).")
    ap.add_argument("--duration", type=float, default=90.0)
    ap.add_argument("--plot", default="")
    ap.add_argument("--min-pcm", type=int, default=2)
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks to scan the robots on, one process each "
                         "(ranks share cards where there are more ranks "
                         "than cards)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the CUDA card)")
    args = ap.parse_args(argv)
    device = device_from_args(args.cpu, "two-robot demo")
    if args.devices > 1:
        from ..parallel.mesh import check_divisible, spawn

        check_divisible(2, args.devices, "the robot count")
        return spawn(_demo_rank, args.devices, args, cpu=args.cpu,
                     axis="robot")
    return _demo(args, device)


def _demo_rank(mesh, args):
    """One rank of ``--devices``: its robots' scans, then (rank 0) the
    merge; rank 0's TwoRobotRun (the others return None)."""
    return _demo(args, mesh.device, mesh)


def _demo(args, device, mesh=None):
    from ..parallel.multi_robot import multi_robot_scan

    bags, dims, params, built, frames2 = robot_inputs(device, args.duration)

    # 1-2) per-robot SLAM, both robots as lanes of one batched scan (with a
    # mesh, each rank's robots, gathered)
    sync(device)
    t0 = time.perf_counter()
    carries, _ = multi_robot_scan(frames2, params, dims, mesh)
    sync(device)
    wall = time.perf_counter() - t0
    if mesh is not None and mesh.rank != 0:
        return None
    nk = [int(carries.num_kf[r]) for r in range(2)]
    loops = [int(carries.num_loops[r]) for r in range(2)]
    print(f"robot surveys done: keyframes={nk}, loops={loops}, "
          f"wall_s {wall:.3f}")
    return merge_surveys(bags, built, carries, device, args.min_pcm,
                         args.plot)._replace(scan_wall_s=wall)


P_CAND = 8  # candidate keyframes a robot offers


def candidates(carries, r: int, start, device):
    """Robot r's P_CAND candidate keyframe summaries, evenly spaced over its
    keyframes, posed in the shared deployment frame (``start``: its DR
    frame's pose there)."""
    from ..geometry import se2_compose
    from ..parallel.multi_robot import KeyframeSummary

    nk = int(carries.num_kf[r])
    kt = torch.as_tensor(np.linspace(0, nk - 1, P_CAND).astype(int),
                         device=device)
    return KeyframeSummary(
        robot_id=torch.full((P_CAND,), r, dtype=torch.int64, device=device),
        key=kt,
        pose=se2_compose(start, carries.poses[r][kt]),
        cov=carries.covs[r][kt],
        points=carries.points[r][kt],
        pmask=carries.pmasks[r][kt],
    )


def proposal_search(device) -> dict:
    """The all-pairs registration's search and gates (keyword arguments of
    ``propose_interrobot_loops`` after the two summaries): 128 Sobol
    samples in a +-2 m, +-0.4 rad box, point-to-line ICP with a tight
    correspondence gate (the round-2 error budget showed point-to-point at
    loose radius drags partial-overlap registrations), 60 points of
    overlap."""
    from ..cloud import ICPConfig
    from ..slam.scan_matching import sobol_unit_samples

    return dict(
        sobol_samples=torch.as_tensor(sobol_unit_samples(128), device=device),
        bounds=torch.tensor([2.0, 2.0, 0.4], dtype=torch.float32, device=device),
        point_noise=0.5, min_overlap=60,
        icp_config=ICPConfig(min_diff_rot=1e-3, min_diff_trans=1e-2,
                             point_to_line=True, outlier_max_dist=0.75))


def merge_surveys(bags, built, carries, device, min_pcm: int = 2,
                  plot: str = "") -> TwoRobotRun:
    """Steps 3-6 on two robots' scanned carries (stacked on the robot axis):
    exchange, proposals, PCM, the merged graph and its scores. Returns the
    TwoRobotRun (``scan_wall_s`` 0.0: the caller timed the scan)."""
    from ..geometry import se2_between, se2_compose
    from ..graph.factor_graph import GraphConfig, optimize, sigmas_to_sqrt_info
    from ..parallel.multi_robot import (
        merge_pose_graphs,
        propose_interrobot_loops,
        vet_interrobot_loops,
    )
    from ..pipeline import ate_rmse

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    def host(x):
        return x.detach().cpu().numpy()

    nk = [int(carries.num_kf[r]) for r in range(2)]
    loops = [int(carries.num_loops[r]) for r in range(2)]

    # each robot's poses are in its OWN DR frame (anchored at its start);
    # re-anchor to the shared deployment frame for exchange guesses
    starts = [dr_start_pose(b, device) for b in bags]

    # 3) exchange candidate keyframe summaries
    cand = [candidates(carries, r, starts[r], device) for r in range(2)]

    # 4) all-pairs registration (A candidates x B candidates)
    tfs, ok, ov = propose_interrobot_loops(cand[0], cand[1],
                                           **proposal_search(device))
    tfs, ok, ov = host(tfs), host(ok), host(ov)
    n_prop = int(ok.sum())
    print(f"proposals: {n_prop}/{ok.size} pairs pass ICP+overlap")

    # keep the best proposals (by overlap), up to 6 total
    Q = 6
    flat = [(ov[a, b], a, b) for a in range(P_CAND) for b in range(P_CAND)
            if ok[a, b]]
    flat.sort(reverse=True)
    flat = flat[:Q]
    if not flat:
        raise SystemExit("no inter-robot proposals survived gating")
    key_a, key_b = host(cand[0].key), host(cand[1].key)
    qa = np.array([key_a[a] for _, a, _ in flat], np.int32)
    qb = np.array([key_b[b] for _, _, b in flat], np.int32)
    # the registration transform relates the two LOCAL clouds, so it is
    # frame-independent — valid as a between measurement in any common frame
    qtf = np.stack([tfs[a, b] for _, a, b in flat])
    # honest registration uncertainty: inter-robot matches are partial-
    # overlap registrations, not odometry — weight them accordingly
    qcov = np.tile(np.diag([0.15, 0.15, 0.02]) ** 2,
                   (len(flat), 1, 1)).astype(np.float32)

    # 5) PCM vetting (poses in each robot's own frame: cycle uses relative
    # poses only)
    pose_a, pose_b = host(cand[0].pose), host(cand[1].pose)
    a_poses = np.stack([pose_a[a] for _, a, _ in flat])
    b_poses = np.stack([pose_b[b] for _, _, b in flat])
    accept, size = vet_interrobot_loops(
        vec(a_poses), vec(b_poses), vec(qtf), vec(qcov),
        torch.ones(len(flat), dtype=torch.bool, device=device),
        min_pcm=min_pcm)
    accept = host(accept)
    print(f"PCM: accepted {int(np.sum(accept))}/{len(flat)} proposals "
          f"(clique size {int(size)})")

    def between(a, b):  # in float32, as the script's jnp arrays are
        return host(se2_between(torch.as_tensor(np.asarray(a, np.float32)),
                                torch.as_tensor(np.asarray(b, np.float32))))

    # diagnostic: proposal transform error vs ground truth
    for q, (_, a, b) in enumerate(flat):
        ta = bags[0].true_pose_at_ping[built[0][1][int(qa[q])]]
        tb = bags[1].true_pose_at_ping[built[1][1][int(qb[q])]]
        e = between(ta, tb) - qtf[q]
        e[2] = (e[2] + np.pi) % (2 * np.pi) - np.pi
        print(f"  prop {q} ({int(qa[q])},{int(qb[q])}) ov={flat[q][0]} "
              f"err={np.hypot(e[0], e[1])*100:6.2f} cm "
              f"{np.degrees(abs(e[2])):5.2f} deg accept={bool(accept[q])}")
    if not accept.any():
        raise SystemExit("PCM rejected all inter-robot proposals")

    # 6) merged graph: express both graphs in the WORLD frame first (fold
    # each robot's start pose into its poses), then merge + optimize
    def world_graph(r):
        g = type(carries.graph)(*(f[r] for f in carries.graph))
        return g._replace(poses=se2_compose(starts[r], g.poses),
                          prior_pose=se2_compose(starts[r], g.prior_pose))

    ga, gb = world_graph(0), world_graph(1)
    merged_cfg = GraphConfig(
        max_poses=sum(nk),
        max_factors=int(ga.num_factors) + int(gb.num_factors) + Q + 2,
        gn_iters=8)
    # the known relative deployment (both robots launched at surveyed poses)
    # anchors B's first keyframe too — without it B's far-from-link keyframes
    # inherit B's full internal drift
    dep_z = se2_between(starts[0], starts[1])
    merged = merge_pose_graphs(ga, nk[0], gb, nk[1], qa, qb, qtf, qcov,
                               accept, merged_cfg, deployment_z=dep_z,
                               deployment_sqrt_info=sigmas_to_sqrt_info(
                                   vec([0.1, 0.1, 0.02])))
    merged = optimize(merged, merged_cfg)

    # verify against ground truth. Gauge note: each solo trajectory carries
    # its own anchor (start-pose/DR-yaw) error, and the merged graph places
    # BOTH robots in A's gauge — so the meaningful merged metric is the ATE
    # after ONE joint SE(2) alignment of the combined trajectory, plus the
    # gauge-free cross-robot relative-pose error the merge is supposed to
    # establish.
    poses = host(merged.poses)
    truths = [bags[r].true_pose_at_ping[built[r][1]][: nk[r]] for r in range(2)]
    both = np.concatenate([poses[: nk[0]], poses[nk[0]: nk[0] + nk[1]]])
    ate_joint = ate_rmse(both, np.concatenate(truths))
    solo_poses = [host(carries.poses[r][: nk[r]]) for r in range(2)]
    solo = [ate_rmse(solo_poses[r], truths[r]) for r in range(2)]

    # cross-robot relative error: between(A_k, B_j) vs truth — the quantity
    # the merge establishes. Compare against the PRE-merge baseline (solo
    # trajectories anchored at their known deployment poses), and report the
    # linked pairs separately (far-away pairs also carry each robot's own
    # internal drift, which inter-robot factors cannot remove).
    pre_world = [host(se2_compose(starts[r], carries.poses[r][: nk[r]]))
                 for r in range(2)]

    def cross_rmse(pa, pb):
        errs = []
        for k in range(0, nk[0], 4):
            for j in range(0, nk[1], 4):
                est = between(pa[k], pb[j])
                tru = between(truths[0][k], truths[1][j])
                errs.append(np.hypot(*(tru - est)[:2]))
        return float(np.sqrt(np.mean(np.square(errs))))

    rel_pre = cross_rmse(pre_world[0], pre_world[1])
    rel_post = cross_rmse(poses[: nk[0]], poses[nk[0]: nk[0] + nk[1]])
    linked = []
    for q in range(len(flat)):
        if accept[q]:
            est = between(poses[int(qa[q])], poses[nk[0] + int(qb[q])])
            ta = bags[0].true_pose_at_ping[built[0][1][int(qa[q])]]
            tb = bags[1].true_pose_at_ping[built[1][1][int(qb[q])]]
            linked.append(np.hypot(*(between(ta, tb) - est)[:2]))
    print(f"merged: joint-aligned ATE {ate_joint*100:.2f} cm "
          f"(solo per-robot aligned: {solo[0]*100:.2f} / {solo[1]*100:.2f} cm)")
    print(f"cross-robot relative RMSE: pre-merge {rel_pre*100:.2f} cm -> "
          f"post-merge {rel_post*100:.2f} cm; at the {len(linked)} linked "
          f"pairs {np.sqrt(np.mean(np.square(linked)))*100:.2f} cm")

    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 7))
        ax.plot(*bags[0].world_points.T, ".", ms=1, color="0.8", label="world")
        for r, color in ((0, "tab:blue"), (1, "tab:orange")):
            sl = slice(0, nk[0]) if r == 0 else slice(nk[0], nk[0] + nk[1])
            ax.plot(poses[sl, 0], poses[sl, 1], "-o", ms=3, color=color,
                    label=f"robot {'AB'[r]} merged")
            ax.plot(truths[r][:, 0], truths[r][:, 1], "--", color=color,
                    alpha=0.5)
        for q in range(len(flat)):
            if accept[q]:
                pa = poses[int(qa[q])]
                pb = poses[nk[0] + int(qb[q])]
                ax.plot([pa[0], pb[0]], [pa[1], pb[1]], "r-", lw=0.8)
        ax.legend()
        ax.set_aspect("equal")
        fig.savefig(plot, dpi=120)
        print(f"plot: {plot}")

    return TwoRobotRun(keyframes=nk, loops=loops, proposals=n_prop,
                       accepted=int(np.sum(accept)), clique=int(size),
                       ate_joint_m=ate_joint, merged_poses=poses,
                       scan_wall_s=0.0, carries=carries)


if __name__ == "__main__":
    main()
