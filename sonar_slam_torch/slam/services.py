"""Exploration-facing query services over the smoother state.

Counterpart of ``sonar_slam_tpu/slam/services.py``:

* ``predict_slam_update``: for each candidate future odometry chain, the
  trajectory and terminal marginal covariance after extending the factor
  graph with it, the information-gain primitive of exploration planners;
* ``query_pose_uncertainty``: the current marginal covariances of a set of
  keys.

Where the JAX package vmaps over candidate paths and keys, the paths run as
one batch of graphs (``optimize_batch``) and the keys share one
factorization.
"""

from __future__ import annotations

import torch
from torch.func import vmap

from ..geometry import se2_compose
from ..graph import GraphState
from ..graph.factor_graph import (
    marginal_covariance,
    optimize_batch,
    sigmas_to_sqrt_info,
)
from .core import SlamCarry, SlamDims


def predict_slam_update(carry: SlamCarry, dims: SlamDims,
                        candidate_odometry: torch.Tensor,
                        odom_sigmas: torch.Tensor):
    """Predicted poses and terminal covariance for each candidate path.

    ``candidate_odometry`` (P, S, 3) holds P paths of S steps: each appends S
    odometry factors from the latest keyframe, chains their poses as initial
    estimates, re-optimizes, and reports the predicted poses (P, S, 3) and
    the terminal marginal covariance (P, 3, 3). Needs S free keyframe slots
    and S free factor slots."""
    gcfg = dims.graph_config()
    g = carry.graph
    dev = g.poses.device
    P, S = candidate_odometry.shape[:2]
    nk = carry.num_kf
    nf = int(g.num_factors)
    if nk + S > gcfg.max_poses or nf + S > g.f_i.shape[0]:
        raise ValueError(f"{S} predicted steps do not fit the graph's free "
                         "keyframe or factor slots")
    sq = sigmas_to_sqrt_info(odom_sigmas.to(torch.float32))
    keys = torch.arange(nk, nk + S, device=dev)
    slots = torch.arange(nf, nf + S, device=dev)

    def batch(x):
        return x.expand(P, *x.shape).clone()

    st = GraphState(*[batch(x) for x in g])
    pose = st.poses[:, nk - 1]
    for s in range(S):
        pose = se2_compose(pose, candidate_odometry[:, s])
        st.poses[:, nk + s] = pose
    st.f_i[:, slots] = keys - 1
    st.f_j[:, slots] = keys
    st.f_z[:, slots] = candidate_odometry.to(torch.float32)
    st.f_sqrt_info[:, slots] = sq
    st.f_robust[:, slots] = False
    st.f_scaled[:, slots] = False
    st = st._replace(num_factors=st.num_factors + S,
                     num_poses=torch.clamp(st.num_poses, min=nk + S))

    st = optimize_batch(st, gcfg)
    last = torch.tensor([nk + S - 1], device=dev)
    cov = vmap(lambda one: marginal_covariance(one, last, gcfg)[0])(st)
    return st.poses[:, nk:nk + S], cov


def query_pose_uncertainty(carry: SlamCarry, dims: SlamDims,
                           keys: torch.Tensor) -> torch.Tensor:
    """(M, 3, 3) marginal covariances of keyframe ``keys`` (M,)."""
    return marginal_covariance(carry.graph, keys.reshape(-1), dims.graph_config())
