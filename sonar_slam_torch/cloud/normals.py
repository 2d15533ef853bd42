"""Closed-form 2-D surface normals for masked clouds (point-to-line ICP).

Counterpart of ``sonar_slam_tpu/cloud/normals.py``: the normal of a point is
the eigenvector of the smallest eigenvalue of the 2x2 scatter of its k
nearest masked neighbours within ``max_radius``; fewer than 3 usable
neighbours give a zero normal.
"""

from __future__ import annotations

import torch

from ..utils.timing import host_read
from .knn import BIG, pairwise_sq_dists


def estimate_normals(
    points: torch.Tensor,  # (..., M, 2)
    mask: torch.Tensor,  # (..., M)
    k: int = 8,
    max_radius: float = 2.0,
) -> torch.Tensor:
    """(..., M, 2) unit normals; zero rows mean "no reliable normal". A
    leading lane axis ([L, M, 2]) gives each lane's cloud its own normals."""
    d2 = pairwise_sq_dists(points, points)
    d2 = torch.where(mask[..., None, :], d2, torch.full_like(d2, BIG))
    d2 = d2.clone()
    d2.diagonal(dim1=-2, dim2=-1).fill_(BIG)
    # k nearest, ties toward the lower index (jax.lax.top_k of -d2)
    nd2, idx = torch.sort(d2, dim=-1, stable=True)
    nd2, idx = nd2[..., :k], idx[..., :k]
    w = ((nd2 <= max_radius**2) & mask[..., :, None]).to(points.dtype)
    if points.ndim == 2:
        nbr = points[idx]  # (M, k, 2)
    else:
        lanes = torch.arange(points.shape[0], device=points.device)
        nbr = points[lanes[:, None, None], idx]  # (L, M, k, 2)
    wsum = torch.sum(w, dim=-1)
    mu = torch.sum(nbr * w[..., None], dim=-2) / torch.clamp(wsum, min=1e-9)[..., None]
    d = (nbr - mu[..., None, :]) * w[..., None]
    a = torch.sum(d[..., 0] * d[..., 0], dim=-1)
    b = torch.sum(d[..., 0] * d[..., 1], dim=-1)
    c = torch.sum(d[..., 1] * d[..., 1], dim=-1)
    h = 0.5 * (a + c)
    r = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    lam = h - r
    v1 = torch.stack([b, lam - a], dim=-1)
    v2 = torch.stack([lam - c, b], dim=-1)
    use1 = torch.abs(lam - a) > torch.abs(lam - c)
    v = torch.where(use1[..., None], v1, v2)
    ex = host_read(torch.tensor, [1.0, 0.0], dtype=points.dtype,
                   device=points.device)
    ey = host_read(torch.tensor, [0.0, 1.0], dtype=points.dtype,
                   device=points.device)
    axis_n = torch.where((a < c)[..., None], ex, ey)
    v = torch.where((torch.abs(b) < 1e-12)[..., None], axis_n, v)
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    unit = v / torch.clamp(norm, min=1e-12)
    ok = (wsum >= 3) & mask
    return torch.where(ok[..., None], unit, torch.zeros_like(unit))
