"""Radius outlier removal (counterpart of
``sonar_slam_tpu/cloud/filters.py``)."""

from __future__ import annotations

import torch

from .knn import pairwise_sq_dists, sq32


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


