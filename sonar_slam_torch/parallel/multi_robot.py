"""Multi-robot SLAM: keyframe summaries, inter-robot loops and the merged
pose graph.

Counterpart of ``sonar_slam_tpu/parallel/multi_robot.py``. The reference
reserves hooks for multi-robot SLAM (the dormant ``ISAM2Update`` message,
``rov_id`` frame prefixes); the JAX package maps each robot to a mesh lane
and exchanges compact keyframe summaries (pose, covariance, downsampled
cloud) with ``all_gather``. Here every robot is a lane of one lane-batched
scan on one device (``slam/lanes.py``, each lane with its own keyframe
stream, as the JAX package's lanes are), and the "exchange" is the stacked
summary itself; with a mesh (``parallel/mesh.py``) each rank scans its
contiguous block of robots so, and the carries and the summaries are
all-gathered over the ranks. Inter-robot loop closures then
run like NSSM: the P·Q pairs' Sobol global initializations in one batched
search and their ICPs in one batch, vetted by PCM, merged into one graph.
Each robot lane, and each pair's search, equals its lone call (bit for bit
on a CUDA card, within rounding on the CPU); ``multi_robot_scan_loop`` and
``propose_interrobot_loops_loop`` are the plain versions, one robot and one
pair after another.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cloud import ICPConfig, count_overlap, icp_pairs
from ..geometry import se2_between, se2_compose, se2_inverse, se2_transform_points
from ..graph.factor_graph import (add_between, cov_to_sqrt_info, graph_init,
                                  set_pose_estimate)
from ..graph.pcm import pcm_select
from ..slam.core import KeyframeInput, slam_scan
from ..slam.lanes import slam_scan_lanes
from ..slam.scan_matching import global_initialize, global_initialize_lanes
from .mesh import Mesh, check_axis, check_divisible, gather, shard
from .sweep import stack_lanes, stack_params


class KeyframeSummary(NamedTuple):
    """The ISAM2Update-analog wire format (one keyframe per robot)."""

    robot_id: torch.Tensor  # int
    key: torch.Tensor  # int keyframe index on its owner
    pose: torch.Tensor  # (3,)
    cov: torch.Tensor  # (3, 3)
    points: torch.Tensor  # (N, 2) downsampled local cloud
    pmask: torch.Tensor  # (N,)


def exchange_keyframes(summary: KeyframeSummary, mesh: Mesh | None = None,
                       axis: str | None = None) -> KeyframeSummary:
    """Every robot's latest keyframe summary, gathered. Without a mesh the
    gathered table (R, ...) is the stacked summary itself, returned as is.
    With ``mesh`` (``axis``: its axis, or None for it) each rank passes the
    summaries of the robots it owns, its block (R / size, ...) of the robot
    axis, and every rank gets the whole table (R, ...) in rank order."""
    if mesh is None:
        return summary
    check_axis(mesh, axis)
    return gather(summary, mesh)


def merge_interrobot_factors(own: KeyframeSummary, gathered: KeyframeSummary,
                             point_noise: float = 0.5, min_overlap: int = 30,
                             icp_config: ICPConfig = ICPConfig()):
    """Match our submap against every gathered neighbor submap, in one ICP
    batch over the R neighbours.

    Returns per-neighbor (transform (R, 3), ok (R,), overlap (R,)): candidate
    BetweenFactor measurements own.key -> neighbor.key, for robots != self.
    """
    R = gathered.pose.shape[0]
    guess = se2_between(own.pose, gathered.pose)
    tgt = own.points.expand(R, -1, -1)
    tmask = own.pmask.expand(R, -1)
    res = icp_pairs(gathered.points, gathered.pmask, tgt, tmask, guess,
                    icp_config)
    # overlap evaluated after registration, as in SLAM.get_overlap
    moved = se2_transform_points(gathered.points, res.pose)
    ov = count_overlap(moved, gathered.pmask, tgt, tmask, point_noise)
    ok = res.ok & (ov >= min_overlap) & (gathered.robot_id != own.robot_id)
    return res.pose, ok, ov


# ----------------------------------------------------------------------
# end-to-end two-robot merge: propose -> PCM-vet -> insert -> optimize
# ----------------------------------------------------------------------


def multi_robot_scan(frames_stacked: KeyframeInput, params, dims,
                     mesh: Mesh | None = None, axis: str | None = None):
    """Run every robot's full SLAM scan as a lane of one lane-batched scan.

    ``frames_stacked``: a KeyframeInput with a leading robot axis R, each
    robot's own keyframe stream (its own keyframe count and valid slots).
    Each robot runs the complete SSM/NSSM/PCM scan independently under the
    shared ``params`` (robots don't communicate during the survey; exchange
    happens afterwards). With ``mesh`` (``axis``: its axis, or None for it;
    R divisible by its size) every rank passes all R streams, scans its
    contiguous block of robots, and the carries and outputs are
    all-gathered. Returns (carries, outputs) stacked on the robot axis, as
    ``sweep_scan`` stacks its lanes: robot r's equal to ``slam_scan`` of
    its own stream."""
    R = frames_stacked.points.shape[0]
    if mesh is None:
        return slam_scan_lanes(frames_stacked, stack_params([params] * R),
                               dims)
    check_axis(mesh, axis)
    check_divisible(R, mesh.size, "the robot count")
    lanes = stack_params([params] * (R // mesh.size))
    return gather(slam_scan_lanes(shard(frames_stacked, mesh), lanes, dims),
                  mesh)


def multi_robot_scan_loop(frames_stacked: KeyframeInput, params, dims):
    """The plain version of :func:`multi_robot_scan`: each robot's
    ``slam_scan``, one robot after another, stacked by ``stack_lanes``."""
    R = frames_stacked.points.shape[0]
    runs = [slam_scan(KeyframeInput(*(None if x is None else x[r]
                                      for x in frames_stacked)), params, dims)
            for r in range(R)]
    dev = frames_stacked.points.device
    return (stack_lanes([c for c, _ in runs], dev),
            stack_lanes([o for _, o in runs], dev))


def propose_interrobot_loops(own: KeyframeSummary, other: KeyframeSummary,
                             sobol_samples: torch.Tensor, bounds: torch.Tensor,
                             point_noise: float = 0.5, min_overlap: int = 30,
                             icp_config: ICPConfig = ICPConfig()):
    """All-pairs inter-robot loop proposal.

    ``own`` holds robot A's P candidate keyframes, ``other`` robot B's Q.
    For every (a, b) pair, an NSSM-style global init (a Sobol search of
    ``sobol_samples`` (S, 3) within +-``bounds`` (3,) around the
    shared-world-frame relative pose, one guess) then ICP: the P·Q Sobol
    searches in one lane-batched search, the registrations in one batch.
    Pair (a, b) equals its lone ``global_initialize`` and ICP. Returns
    per-pair (tf (P, Q, 3): measurement a-local -> b, ok (P, Q), overlap (P,
    Q))."""
    P, Q = own.pose.shape[0], other.pose.shape[0]
    PQ = P * Q
    clouds = _pair_clouds(own, other)
    tgt_pose = own.pose.repeat_interleave(Q, dim=0)
    gi = global_initialize_lanes(
        *clouds, other.pose.repeat(P, 1), tgt_pose, bounds.expand(PQ, -1),
        sobol_samples.expand(PQ, -1, -1),
        torch.full((PQ,), point_noise, dtype=torch.float32,
                   device=own.pose.device), 1)
    guesses = se2_between(tgt_pose, gi.guess_poses[:, 0])
    return _register_pairs(clouds, guesses, (P, Q), point_noise, min_overlap,
                           icp_config)


def propose_interrobot_loops_loop(own: KeyframeSummary, other: KeyframeSummary,
                                  sobol_samples: torch.Tensor,
                                  bounds: torch.Tensor, point_noise: float = 0.5,
                                  min_overlap: int = 30,
                                  icp_config: ICPConfig = ICPConfig()):
    """The plain version of :func:`propose_interrobot_loops`: each pair's
    ``global_initialize`` in a host loop, then the same ICP batch."""
    P, Q = own.pose.shape[0], other.pose.shape[0]
    guesses = []
    for a in range(P):
        for b in range(Q):
            gi = global_initialize(
                other.points[b], other.pmask[b], own.points[a], own.pmask[a],
                other.pose[b], own.pose[a], bounds, sobol_samples,
                point_noise, 1)
            guesses.append(gi.guesses_vs(own.pose[a])[0])
    return _register_pairs(_pair_clouds(own, other), torch.stack(guesses),
                           (P, Q), point_noise, min_overlap, icp_config)


def _pair_clouds(own: KeyframeSummary, other: KeyframeSummary):
    """The P·Q pairs' clouds, pair a * Q + b registering ``other``'s b (the
    source) onto ``own``'s a: (source, mask, target, mask)."""
    P, Q = own.pose.shape[0], other.pose.shape[0]
    return (other.points.repeat(P, 1, 1), other.pmask.repeat(P, 1),
            own.points.repeat_interleave(Q, dim=0),
            own.pmask.repeat_interleave(Q, dim=0))


def _register_pairs(clouds, guesses, shape, point_noise, min_overlap,
                    icp_config):
    """The P·Q pairs' ICPs in one batch and their overlap gate: (tf, ok,
    overlap), each shaped ``shape`` (P, Q)."""
    P, Q = shape
    src, smask, tgt, tmask = clouds
    res = icp_pairs(src, smask, tgt, tmask, guesses, icp_config)
    moved = se2_transform_points(src, res.pose)
    ov = count_overlap(moved, smask, tgt, tmask, point_noise)
    ok = res.ok & (ov >= min_overlap)
    return res.pose.reshape(P, Q, 3), ok.reshape(P, Q), ov.reshape(P, Q)


def vet_interrobot_loops(a_poses, b_poses, tfs, covs, valid, min_pcm: int = 2):
    """PCM over inter-robot proposals: a_poses (Q, 3) robot A's pose of each
    proposal (A frame), b_poses (Q, 3) robot B's (B frame), tfs (Q, 3) the
    measured a-local -> b transforms, covs (Q, 3, 3), valid (Q,). The
    consistency cycle only uses relative poses within each robot, so each
    robot's poses in its own frame compose correctly. Returns (accept (Q,),
    clique size)."""
    return pcm_select(b_poses, a_poses, tfs, covs, valid, min_pcm)


def merge_pose_graphs(graph_a, nk_a: int, graph_b, nk_b: int, a_keys, b_keys,
                      tfs, covs, accept, merged_config, deployment_z=None,
                      deployment_sqrt_info=None):
    """Merge two robots' pose graphs into one (B keys offset by ``nk_a``).

    a_keys, b_keys (Q,): each accepted proposal's keyframe on robot A and
    on robot B; tfs (Q, 3) the measured a-local -> b transforms; covs (Q, 3,
    3); accept (Q,) from ``vet_interrobot_loops``. Robot A keeps its prior
    (the gauge anchor); robot B's own prior is dropped: B is anchored
    through the accepted inter-robot factors, plus optionally a between
    factor ``deployment_z`` (3,) on the two first keyframes, the known
    relative deployment. B's initial values are re-expressed in A's frame
    through the first accepted proposal. Host-side assembly on graph A's
    device; returns an optimizable GraphState."""
    dev = graph_a.poses.device

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    def host(x):
        return torch.as_tensor(x).cpu().numpy()

    accept_np = host(accept)
    if not accept_np.any():
        raise ValueError("no accepted inter-robot loops to merge on")
    a_keys, b_keys, tfs, covs = host(a_keys), host(b_keys), t(tfs), t(covs)
    first = int(np.argmax(accept_np))
    a0, b0 = int(a_keys[first]), int(b_keys[first])
    # world-A pose of B keyframe b0 = pose_A(a0) ∘ tf0  =>  frame map
    # T_AB = pose_A(a0) ∘ tf0 ∘ pose_B(b0)⁻¹
    t_ab = se2_compose(se2_compose(graph_a.poses[a0], tfs[first]),
                       se2_inverse(graph_b.poses[b0]))

    st = graph_init(merged_config, dev)
    st = st._replace(prior_pose=graph_a.prior_pose,
                     prior_sqrt_info=graph_a.prior_sqrt_info)
    for k in range(nk_a):
        st = set_pose_estimate(st, k, graph_a.poses[k])
    for k in range(nk_b):
        st = set_pose_estimate(st, nk_a + k, se2_compose(t_ab, graph_b.poses[k]))

    # robot A factors verbatim; robot B factors re-indexed by +nk_a
    for g, off in ((graph_a, 0), (graph_b, nk_a)):
        for f in range(int(g.num_factors)):
            st = add_between(st, int(g.f_i[f]) + off, int(g.f_j[f]) + off,
                             g.f_z[f], g.f_sqrt_info[f],
                             robust=bool(g.f_robust[f]),
                             scaled=bool(g.f_scaled[f]))
    # accepted inter-robot between-factors
    for q in np.nonzero(accept_np)[0]:
        st = add_between(st, int(a_keys[q]), nk_a + int(b_keys[q]), tfs[q],
                         cov_to_sqrt_info(covs[q]))
    if deployment_z is not None:
        st = add_between(st, 0, nk_a, t(deployment_z), t(deployment_sqrt_info))
    return st
