"""Radius outlier removal and the kNN density gate (counterpart of
``sonar_slam_tpu/cloud/filters.py``)."""

from __future__ import annotations

import math

import torch

from .knn import pairwise_sq_dists, sq32
from .voxel import top_k_stable


def remove_outlier(
    points: torch.Tensor,
    mask: torch.Tensor,
    radius: float,
    min_points: int,
) -> torch.Tensor:
    """Keep points with >= ``min_points`` masked neighbours within ``radius``
    (the point counts itself, as PCL's radius search does). Points stay in
    place; the result is the updated mask. Broadcasts over batch dims."""
    d2 = pairwise_sq_dists(points, points)
    within = (d2 <= sq32(radius)) & mask[..., None, :]
    counts = torch.sum(within & mask[..., :, None], dim=-1)
    return mask & (counts >= min_points)


def density_filter(
    points: torch.Tensor,
    mask: torch.Tensor,
    knn: int,
    min_density: float,
    max_density: float,
) -> torch.Tensor:
    """Keep points whose local 2-D density ``knn / (pi r_k^2)`` lies in
    [``min_density``, ``max_density``], r_k being the distance to the
    ``knn``-th masked neighbour (the point itself is the 0th), as
    ``pcl.density_filter`` estimates it. The result is the updated mask."""
    d2 = pairwise_sq_dists(points, points)
    d2 = torch.where(mask[..., None, :], d2, torch.full_like(d2, math.inf))
    neg_top, _ = top_k_stable(-d2, knn + 1)
    rk2 = -neg_top[..., -1]
    density = knn / torch.clamp(math.pi * rk2, min=1e-12)
    return mask & (density >= min_density) & (density <= max_density)
