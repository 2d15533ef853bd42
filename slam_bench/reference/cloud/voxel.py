"""Voxel-grid downsampling with fixed output capacity.

Counterpart of ``sonar_slam_tpu/cloud/voxel.py``: bin points on a regular
grid over a static extent, emit one centroid per occupied cell, densest cells
first. ``jax.lax.top_k`` breaks count ties toward the lower cell id, and hit
counts are small integers, so ties at the capacity cut decide which cells are
kept: a stable descending sort reproduces that order exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class VoxelGridSpec:
    """Static voxel-grid geometry: origin (x0, y0), cell size, grid dims."""

    x0: float
    y0: float
    resolution: float
    nx: int
    ny: int

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny


def top_k_stable(values: torch.Tensor, k: int):
    """``jax.lax.top_k`` semantics: the k largest along the last axis, ties
    toward the lower index."""
    score, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return score[..., :k], idx[..., :k]


def _cell_ids(points, mask, spec: VoxelGridSpec):
    ix = torch.floor((points[..., 0] - spec.x0) / spec.resolution).to(torch.int64)
    iy = torch.floor((points[..., 1] - spec.y0) / spec.resolution).to(torch.int64)
    inside = (ix >= 0) & (ix < spec.nx) & (iy >= 0) & (iy < spec.ny)
    ok = mask & inside
    ids = torch.where(ok, iy * spec.nx + ix, torch.full_like(ix, spec.num_cells))
    return ids, ok


def _scatter_sum(n: int, ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Per-cell sums. ``index_put_`` with ``accumulate`` sorts the indices on
    the card and adds in that order, so repeated runs give the same bits
    (``index_add_`` adds with float atomics in a varying order)."""
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_put_((ids,), vals, accumulate=True)


def _binned(points, mask, spec: VoxelGridSpec, max_out: int, conf=None):
    """Voxel centroids of (L, P, 2) clouds, one grid per lane: each lane's
    cell ids are offset into a table of its own, so a lane's sums are the
    ones it would get alone (added in the same order)."""
    L = points.shape[0]
    ids, ok = _cell_ids(points, mask, spec)
    n = spec.num_cells + 1
    flat = (ids + n * torch.arange(L, device=ids.device)[:, None]).reshape(-1)
    w = ok.to(points.dtype)

    def per_cell(vals):  # (L, P, ...) -> (L, cells, ...) without the spare
        sums = _scatter_sum(L * n, flat, vals.reshape((-1,) + vals.shape[2:]))
        return sums.reshape((L, n) + vals.shape[2:])[:, :-1]

    sums = per_cell(points * w[..., None])
    counts = per_cell(w)
    csum = None if conf is None else per_cell(w * conf.to(points.dtype))
    score, cell_idx = top_k_stable(counts, max_out)
    out_mask = score > 0
    lanes = torch.arange(L, device=ids.device)[:, None]
    denom = torch.clamp(counts[lanes, cell_idx], min=1.0)
    centroids = sums[lanes, cell_idx] / denom[..., None]
    centroids = torch.where(out_mask[..., None], centroids,
                            torch.zeros_like(centroids))
    out_conf = None
    if csum is not None:
        out_conf = torch.where(out_mask, csum[lanes, cell_idx] / denom,
                               torch.zeros_like(denom))
    return centroids, out_mask, out_conf


def voxel_downsample(points, mask, spec: VoxelGridSpec, max_out: int):
    """(points [N, 2], mask [N]) -> centroids of occupied cells
    (out_points [max_out, 2], out_mask [max_out]). A leading lane axis
    ([L, N, 2], [L, N]) bins each lane on its own grid, each lane's sums
    those it would get alone."""
    if points.ndim == 3:
        return _binned(points, mask, spec, max_out)[:2]
    centroids, out_mask, _ = _binned(points[None], mask[None], spec, max_out)
    return centroids[0], out_mask[0]


def voxel_downsample_with_conf(points, mask, conf, spec: VoxelGridSpec,
                               max_out: int):
    """Like :func:`voxel_downsample`, also carrying the mean per-point
    confidence of each cell: (out_points, out_mask, out_conf). A leading lane
    axis ([L, N, 2], [L, N], [L, N]) bins each lane on its own grid."""
    if points.ndim == 2:
        return tuple(o[0] for o in _binned(points[None], mask[None], spec,
                                           max_out, conf[None]))
    return _binned(points, mask, spec, max_out, conf)


