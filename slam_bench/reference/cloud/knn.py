"""Brute-force nearest-neighbour matching for small masked clouds.

Counterpart of ``sonar_slam_tpu/cloud/knn.py``. Sonar feature clouds hold
10^2-10^3 points, so a pairwise-distance matrix (inner-product expansion,
one fp32 matmul) with an argmin beats any tree. Every function broadcasts
over leading batch dimensions.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1e30


def sq32(x: float) -> float:
    """``x * x`` rounded as float32 arithmetic rounds it (the JAX package
    squares its float32 gate radii in float32)."""
    x32 = np.float32(x)
    return float(x32 * x32)


def _gate(max_dist, like: torch.Tensor):
    """The squared radius, :func:`sq32` of a float, or of a float32 tensor
    of per-lane radii (B,) for lane-batched operands (B, ...): the float32
    product rounds as :func:`sq32` rounds it, shaped to broadcast against
    ``like``."""
    if not isinstance(max_dist, torch.Tensor):
        return sq32(max_dist)
    g = max_dist * max_dist
    return g.reshape(g.shape + (1,) * (like.ndim - g.ndim))


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances [..., N, M] between a [..., N, D] and b [..., M, D],
    clamped at 0 against cancellation."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    ab = torch.matmul(a, b.transpose(-1, -2))
    d2 = a2 + b2.transpose(-1, -2) - 2.0 * ab
    return torch.clamp(d2, min=0.0)


def nn_match(
    ref_points: torch.Tensor,
    ref_mask: torch.Tensor,
    query_points: torch.Tensor,
    query_mask: torch.Tensor,
    max_dist: float,
):
    """Nearest reference point for each query point; queries with none
    within ``max_dist`` (or masked out) get index -1. Returns (indices int64
    [..., M], squared distances [..., M]). ``max_dist`` is a float, or a
    float32 tensor (B,) of per-lane radii for operands with a leading lane
    axis."""
    d2 = pairwise_sq_dists(query_points, ref_points)
    d2 = torch.where(ref_mask[..., None, :], d2, torch.full_like(d2, BIG))
    best, idx = torch.min(d2, dim=-1)
    ok = query_mask & (best <= _gate(max_dist, best))
    return torch.where(ok, idx, torch.full_like(idx, -1)), best


def count_overlap(
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    radius: float,
) -> torch.Tensor:
    """Number of source points with a target neighbour within ``radius``
    (a float, or per-lane radii as :func:`nn_match` takes them)."""
    idx, _ = nn_match(target_points, target_mask, source_points, source_mask,
                      radius)
    return torch.sum(idx != -1, dim=-1)
