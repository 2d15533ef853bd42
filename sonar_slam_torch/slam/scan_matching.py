"""Sobol global initialization and the robust multi-start covariance.

Counterpart of ``sonar_slam_tpu/slam/scan_matching.py``:

* ``global_initialize`` scores S Sobol pose perturbations by overlap count
  (one masked distance reduce per sample, in chunks of samples), sorts them
  by cost with a stable sort (the JAX ``argsort`` is stable and the costs are
  small integers, so ties are common) and epsilon-dedups them into
  multi-start ICP guesses;
* ``estimate_pose_covariance`` is the deterministic FastMCD-style robust
  mean and covariance of the multi-start solutions.

The Sobol samples come from scipy on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cloud.knn import BIG, _gate, pairwise_sq_dists, sq32
from ..geometry import se2_between, se2_compose, se2_rotmat, se2_transform_points
from ..graph.factor_graph import cholesky_nan
from ..utils.timing import host_read

# Sobol samples scored per chunk: bounds the (chunk * N, M) distance matrix
_COST_CHUNK = 64
# the lane-batched scoring's budget for one chunk's distance blocks, in
# bytes: (lane, sample) pairs are scored this many bytes at a time
LANE_COST_BUDGET = 1 << 30


def sobol_unit_samples(n: int, dim: int = 3, seed: int = 0) -> np.ndarray:
    """Deterministic (unscrambled) Sobol points in [0, 1]^dim."""
    from scipy.stats import qmc

    s = qmc.Sobol(d=dim, scramble=False, seed=seed)
    return s.random(n).astype(np.float32)


def match_count_costs(source_points, source_mask, target_points, target_mask,
                      source_pose, target_pose, deltas, point_noise: float):
    """Cost of every candidate perturbation (S, 3) of ``source_pose``: minus
    the number of source points within ``point_noise`` of a target point.
    Returns (costs (S,), transforms (S, 3) target -> sampled source)."""
    sample_source_pose = se2_compose(source_pose, deltas)
    transforms = se2_between(target_pose, sample_source_pose)
    masked = target_mask[None, :]
    gate = sq32(point_noise)
    counts = []
    for i in range(0, transforms.shape[0], _COST_CHUNK):
        tf = transforms[i: i + _COST_CHUNK]
        moved = se2_transform_points(source_points, tf)  # (c, N, 2)
        c, N = moved.shape[:2]
        d2 = pairwise_sq_dists(moved.reshape(c * N, 2), target_points)
        d2 = torch.where(masked, d2, torch.full_like(d2, BIG))
        near = (torch.min(d2, dim=-1).values <= gate).reshape(c, N)
        counts.append(torch.sum(near & source_mask[None, :], dim=-1))
    return -torch.cat(counts).to(torch.float32), transforms


def match_count_costs_lanes(source_points, source_mask, target_points,
                            target_mask, source_pose, target_pose, deltas,
                            point_noise):
    """:func:`match_count_costs` over B sweep lanes: source shared ([N, 2],
    [N]) or per lane ([B, N, 2], [B, N]), targets [B, M, 2], poses (B, 3),
    deltas (B, S, 3), per-lane radii ``point_noise`` (B,). The (lane,
    sample) pairs are scored in chunks of :data:`LANE_COST_BUDGET` bytes of
    distance blocks, so the number of chunks hardly grows with B. Lane b
    equals the lone call's (costs (B, S), transforms (B, S, 3))."""
    B, S = deltas.shape[:2]
    N, M = source_points.shape[-2], target_points.shape[-2]
    sample_source_pose = se2_compose(source_pose[:, None], deltas)
    transforms = se2_between(target_pose[:, None], sample_source_pose)
    gate = _gate(point_noise, transforms[..., 0])  # (B, 1)
    lane = torch.arange(B, device=deltas.device).repeat_interleave(S)
    src = source_points if source_points.ndim == 2 else source_points[lane]
    smask = source_mask if source_mask.ndim == 1 else source_mask[lane]
    tf = transforms.reshape(B * S, 3)
    pairs = max(1, LANE_COST_BUDGET // (N * M * 4))
    counts = []
    for i in range(0, B * S, pairs):
        sl = slice(i, i + pairs)
        moved = se2_transform_points(src if src.ndim == 2 else src[sl],
                                     tf[sl])  # (c, N, 2)
        d2 = pairwise_sq_dists(moved, target_points[lane[sl]])
        d2 = torch.where(target_mask[lane[sl]][:, None, :], d2,
                         torch.full_like(d2, BIG))
        near = torch.min(d2, dim=-1).values <= gate.reshape(B)[lane[sl], None]
        counts.append(torch.sum(near & (smask if smask.ndim == 1
                                        else smask[sl]), dim=-1))
    costs = -torch.cat(counts).to(torch.float32).reshape(B, S)
    return costs, transforms


class GlobalInitResult(NamedTuple):
    best_delta: torch.Tensor  # (3,)
    best_cost: torch.Tensor  # scalar
    guess_poses: torch.Tensor  # (G, 3) deduped sampled source poses, best first
    guess_mask: torch.Tensor  # (G,)

    def guesses_vs(self, target_pose: torch.Tensor) -> torch.Tensor:
        """ICP initial transforms relative to a target pose."""
        return se2_between(target_pose, self.guess_poses)


def global_initialize(source_points, source_mask, target_points, target_mask,
                      source_pose, target_pose, bounds, unit_samples,
                      point_noise: float, num_guesses: int,
                      dedup_eps: float = 0.01) -> GlobalInitResult:
    """Sobol global search in +-``bounds`` plus the guess list: the
    cost-sorted samples, each kept iff no better-ranked sample lies within
    ``dedup_eps``, compacted to the first ``num_guesses``."""
    deltas = (2.0 * unit_samples - 1.0) * bounds[None, :]
    deltas = torch.cat([torch.zeros((1, 3), dtype=deltas.dtype,
                                    device=deltas.device), deltas], dim=0)
    costs, _ = match_count_costs(source_points, source_mask, target_points,
                                 target_mask, source_pose, target_pose, deltas,
                                 point_noise)
    order = torch.sort(costs, stable=True).indices
    sample_poses = se2_compose(source_pose, deltas)
    sorted_poses = sample_poses[order]
    best = host_read(int, order[0])

    S = sorted_poses.shape[0]
    rel = se2_between(sorted_poses[:, None, :], sorted_poses[None, :, :])
    dist = torch.linalg.vector_norm(rel, dim=-1)
    ar = torch.arange(S, device=deltas.device)
    causal_close = (dist < dedup_eps) & (ar[:, None] < ar[None, :])
    keeps = ~torch.any(causal_close, dim=0)
    total = torch.sum(keeps.to(torch.int64))

    G = num_guesses
    kept_rank = torch.cumsum(keeps.to(torch.int64), dim=0) - 1
    # the JAX scatter drops out-of-range slots (mode="drop"): mask the slots
    # first, sending dropped rows to a spare row that is cut off after
    slot = torch.where(keeps & (kept_rank < G), kept_rank,
                       torch.full_like(kept_rank, G))
    out = torch.zeros((G + 1, 3), dtype=torch.float32, device=deltas.device)
    out.index_put_((slot,), sorted_poses.to(torch.float32))
    guess_mask = torch.arange(G, device=deltas.device) < torch.clamp(total, max=G)
    return GlobalInitResult(best_delta=deltas[best], best_cost=costs[best],
                            guess_poses=out[:G], guess_mask=guess_mask)


def global_initialize_lanes(source_points, source_mask, target_points,
                            target_mask, source_pose, target_pose, bounds,
                            unit_samples, point_noise, num_guesses: int,
                            dedup_eps: float = 0.01) -> GlobalInitResult:
    """:func:`global_initialize` over B sweep lanes (operands as
    :func:`match_count_costs_lanes` takes them; bounds (B, 3), unit samples
    (B, S, 3)). Returns the GlobalInitResult with a leading lane axis; lane
    b equals the lone call's."""
    B = bounds.shape[0]
    dev = bounds.device
    lanes = torch.arange(B, device=dev)[:, None]
    deltas = (2.0 * unit_samples - 1.0) * bounds[:, None, :]
    deltas = torch.cat([torch.zeros((B, 1, 3), dtype=deltas.dtype,
                                    device=dev), deltas], dim=1)
    costs, _ = match_count_costs_lanes(source_points, source_mask,
                                       target_points, target_mask, source_pose,
                                       target_pose, deltas, point_noise)
    order = torch.sort(costs, dim=-1, stable=True).indices
    sample_poses = se2_compose(source_pose[:, None], deltas)
    sorted_poses = sample_poses[lanes, order]
    best = order[:, 0]

    S = sorted_poses.shape[1]
    rel = se2_between(sorted_poses[:, :, None, :], sorted_poses[:, None, :, :])
    dist = torch.linalg.vector_norm(rel, dim=-1)
    ar = torch.arange(S, device=dev)
    causal_close = (dist < dedup_eps) & (ar[:, None] < ar[None, :])
    keeps = ~torch.any(causal_close, dim=1)
    total = torch.sum(keeps.to(torch.int64), dim=-1)

    G = num_guesses
    kept_rank = torch.cumsum(keeps.to(torch.int64), dim=-1) - 1
    slot = torch.where(keeps & (kept_rank < G), kept_rank,
                       torch.full_like(kept_rank, G))
    out = torch.zeros((B, G + 1, 3), dtype=torch.float32, device=dev)
    out.index_put_((lanes.expand(B, S), slot), sorted_poses.to(torch.float32))
    guess_mask = (torch.arange(G, device=dev)
                  < torch.clamp(total, max=G)[:, None])
    return GlobalInitResult(best_delta=deltas[lanes[:, 0], best],
                            best_cost=costs[lanes[:, 0], best],
                            guess_poses=out[:, :G], guess_mask=guess_mask)


def max_eig_2x2(m: torch.Tensor) -> torch.Tensor:
    """Largest eigenvalue of a symmetric 2x2, closed form."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 1, 1]
    h = 0.5 * (a + c)
    d = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    return h + d


def _logdet_psd_3x3(m: torch.Tensor) -> torch.Tensor:
    """log det via Cholesky; non-PD inputs map to +inf."""
    d = torch.diagonal(cholesky_nan(m), dim1=-2, dim2=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.clamp(d, min=1e-20)), dim=-1)
    return torch.where(torch.isnan(logdet), torch.full_like(logdet, float("inf")),
                       logdet)


def estimate_pose_covariance(samples, sample_mask, support_fraction: float = 0.8,
                             c_steps: int = 8, num_starts: int = 8):
    """Robust mean + covariance of pose samples (G, 3): ``num_starts``
    strided 4-sample starts plus the full-sample start, each refined by
    C-steps over the h = ceil(0.8 n) closest samples; the start with the
    smallest covariance log-det wins. Returns (mean (3,), cov (3, 3), n)."""
    G = samples.shape[0]
    dev = samples.device
    maskf = sample_mask.to(torch.float32)
    n = torch.sum(sample_mask.to(torch.int64))
    h = torch.ceil(support_fraction * n.to(torch.float32)).to(torch.int64)
    ridge = 1e-9 * torch.eye(3, device=dev)

    def mean_cov(w):  # w (P, G)
        wsum = torch.clamp(torch.sum(w, dim=-1), min=1.0)
        mu = torch.sum(samples[None] * w[..., None], dim=1) / wsum[:, None]
        c = samples[None] - mu[:, None]
        d = c * w[..., None]
        cov = torch.matmul(d.transpose(-1, -2), c) / wsum[:, None, None]
        return mu, cov

    valid_idx = torch.sort((~sample_mask).to(torch.int64), stable=True).indices
    nmax = torch.clamp(n, min=1)
    starts = []
    for s in range(num_starts):
        picks = valid_idx[(s + torch.arange(4, device=dev) * num_starts) % nmax]
        w = torch.zeros(G, device=dev)
        host_read(w.__setitem__, picks, 1.0)
        starts.append(w * maskf)
    starts.append(maskf)
    w = torch.stack(starts)  # (P, G)

    kth = host_read(int, torch.clamp(h - 1, 0, G - 1))
    for _ in range(c_steps):
        mu, cov = mean_cov(w)
        inv, _ = torch.linalg.inv_ex(cov + ridge)
        c = samples[None] - mu[:, None]
        md = torch.einsum("pgi,pij,pgj->pg", c, inv, c)
        md = torch.where(sample_mask[None], md, torch.full_like(md, 1e30))
        thresh = torch.sort(md, dim=-1).values[:, kth]
        w = (md <= thresh[:, None]).to(torch.float32) * maskf
    mu, cov = mean_cov(w)
    logdet = _logdet_psd_3x3(cov + ridge)
    dets = torch.where(torch.sum(w, dim=-1) >= h.to(torch.float32), logdet,
                       torch.full_like(logdet, 1e30))
    best = host_read(int, torch.argmin(dets))
    return mu[best], cov[best], n


def estimate_pose_covariance_lanes(samples, sample_mask,
                                   support_fraction: float = 0.8,
                                   c_steps: int = 8, num_starts: int = 8):
    """:func:`estimate_pose_covariance` over B sweep lanes: samples (B, G,
    3), mask (B, G). Returns (mean (B, 3), cov (B, 3, 3), n (B,)); lane b
    equals the lone call's."""
    B, G = samples.shape[:2]
    dev = samples.device
    lanes = torch.arange(B, device=dev)
    maskf = sample_mask.to(torch.float32)
    n = torch.sum(sample_mask.to(torch.int64), dim=-1)
    h = torch.ceil(support_fraction * n.to(torch.float32)).to(torch.int64)
    ridge = 1e-9 * torch.eye(3, device=dev)

    def mean_cov(w):  # w (B, P, G)
        wsum = torch.clamp(torch.sum(w, dim=-1), min=1.0)
        mu = torch.sum(samples[:, None] * w[..., None], dim=2) / wsum[..., None]
        c = samples[:, None] - mu[:, :, None]
        d = c * w[..., None]
        cov = torch.matmul(d.transpose(-1, -2), c) / wsum[..., None, None]
        return mu, cov

    valid_idx = torch.sort((~sample_mask).to(torch.int64), dim=-1,
                           stable=True).indices
    nmax = torch.clamp(n, min=1)
    starts = []
    for s in range(num_starts):
        pos = (s + torch.arange(4, device=dev) * num_starts) % nmax[:, None]
        picks = torch.gather(valid_idx, 1, pos)
        w = torch.zeros(B, G, device=dev)
        w[lanes[:, None], picks] = 1.0
        starts.append(w * maskf)
    starts.append(maskf)
    w = torch.stack(starts, dim=1)  # (B, P, G)

    kth = torch.clamp(h - 1, 0, G - 1)
    for _ in range(c_steps):
        mu, cov = mean_cov(w)
        inv, _ = torch.linalg.inv_ex(cov + ridge)
        c = samples[:, None] - mu[:, :, None]
        md = torch.einsum("bpgi,bpij,bpgj->bpg", c, inv, c)
        md = torch.where(sample_mask[:, None], md, torch.full_like(md, 1e30))
        srt = torch.sort(md, dim=-1).values
        thresh = torch.gather(srt, 2, kth[:, None, None].expand(B, srt.shape[1], 1))
        w = (md <= thresh).to(torch.float32) * maskf[:, None]
    mu, cov = mean_cov(w)
    logdet = _logdet_psd_3x3(cov + ridge)
    dets = torch.where(torch.sum(w, dim=-1) >= h.to(torch.float32)[:, None],
                       logdet, torch.full_like(logdet, 1e30))
    best = torch.argmin(dets, dim=-1)
    return mu[lanes, best], cov[lanes, best], n


def localize_covariance(cov: torch.Tensor, mean_pose: torch.Tensor) -> torch.Tensor:
    """Unrotate a sample covariance into the local frame of the mean pose
    (batched over leading dims)."""
    R = se2_rotmat(mean_pose[..., 2])
    top = torch.matmul(R.transpose(-1, -2), cov[..., :2, :])
    out = torch.cat([top, cov[..., 2:, :]], dim=-2)
    left = torch.matmul(out[..., :, :2], R)
    return torch.cat([left, out[..., :, 2:]], dim=-1)


def localize_covariance_lanes(cov: torch.Tensor,
                              mean_pose: torch.Tensor) -> torch.Tensor:
    """:func:`localize_covariance` of one covariance a lane, cov (B, 3, 3)
    and mean (B, 3): lane b equals the lone call's, whose two products are
    each lane's own calls (cuBLAS picks its kernel by the batch)."""
    R = se2_rotmat(mean_pose[..., 2])
    top = torch.stack([torch.matmul(r.transpose(-1, -2), c[:2, :])
                       for r, c in zip(R, cov)])
    out = torch.cat([top, cov[..., 2:, :]], dim=-2)
    left = torch.stack([torch.matmul(o[:, :2], r) for o, r in zip(out, R)])
    return torch.cat([left, out[..., :, 2:]], dim=-1)


def apply_covariance_floor(cov: torch.Tensor, icp_odom_sigmas: torch.Tensor):
    """If det(cov) < det(diag(sigmas)^2) use the fixed model (batched over
    leading dims; sigmas (3,), or (B, 3) for B lanes' covariances (B, 3,
    3)). Returns (cov, used_floor)."""
    default = torch.diag_embed(icp_odom_sigmas ** 2)
    small = torch.linalg.det(cov) < torch.linalg.det(default)
    return torch.where(small[..., None, None], default, cov), small
