"""Dual-sonar (horizontal + vertical) 3-D point fusion.

Counterpart of ``sonar_slam_tpu/slam/dual_sonar.py``, both of its paths:

* the production path: ``beam_floor_samples`` takes one intensity-weighted
  range centroid per vertical beam, ``accumulate_elevation`` adds the
  samples of every keyframe into a global ``ElevationGrid`` through the
  optimized poses, and ``lift_from_grid`` gives a height to every
  horizontal point the grid covers (``fuse_frames_global`` chains them);
* the legacy per-frame path: ``elevation_profile`` mean-bins one frame's
  detections into z(x) and ``fuse_vertical`` lifts that frame's cloud from
  it (``fuse_frames`` over a batch).

Every function takes a leading frame axis where the JAX package vmaps. The
scatter-adds go through ``index_put_(accumulate=True)`` over the samples
that carry weight only: it adds in the samples' order, so the sums repeat
bit for bit on the card (float atomics do not), and no masked sample joins
a long run of duplicate adds to a spare cell.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se2_transform_points
from .sonar import SonarGeometry


def vertical_cell_xz(geometry: SonarGeometry, device) -> torch.Tensor:
    """(R, C, 2) (x fwd, z down-positive) of each vertical-polar cell: the
    vertical fan's bearings are elevations."""
    r = geometry.ranges[:, None]
    e = geometry.bearings[None, :]
    return torch.as_tensor(
        np.stack([r * np.cos(e), r * np.sin(e)], axis=-1).astype(np.float32),
        device=device)


def _scatter_add(n: int, idx: torch.Tensor, vals: torch.Tensor,
                 keep: torch.Tensor) -> torch.Tensor:
    """(n,) float32 sums of ``vals[keep]`` at ``idx[keep]``, added in order."""
    out = torch.zeros(n, dtype=torch.float32, device=vals.device)
    return out.index_put_((idx[keep],), vals[keep], accumulate=True)


def elevation_profile(detections: torch.Tensor, geometry: SonarGeometry,
                      num_bins: int, max_x: float, min_count: int = 2):
    """Per-forward-distance height from vertical frames: ``detections``
    [..., R, C] bool gives (z [..., num_bins], valid [..., num_bins]), the
    mean z of the detections in each x bin of width ``max_x / num_bins``;
    bins with fewer than ``min_count`` detections are invalid."""
    lead = detections.shape[:-2]
    F = int(np.prod(lead)) if lead else 1
    cells = vertical_cell_xz(geometry, detections.device).reshape(-1, 2)
    x, z = cells[:, 0], cells[:, 1]
    bin_w = max_x / num_bins
    b = torch.clamp((x / bin_w).to(torch.int32), 0, num_bins - 1).to(torch.int64)
    mask = detections.reshape(F, -1)
    idx = (torch.arange(F, device=b.device)[:, None] * num_bins + b).reshape(-1)
    keep = mask.reshape(-1)
    zz = z.expand(F, -1).reshape(-1)
    sums = _scatter_add(F * num_bins, idx, zz, keep)
    counts = _scatter_add(F * num_bins, idx, torch.ones_like(zz), keep)
    zbar = sums / torch.clamp(counts, min=1.0)
    return (zbar.reshape(*lead, num_bins),
            (counts >= min_count).reshape(*lead, num_bins))


def fuse_vertical(h_points: torch.Tensor, h_mask: torch.Tensor,
                  profile_z: torch.Tensor, profile_valid: torch.Tensor,
                  max_x: float, max_bearing: float = float(np.radians(6.0))):
    """Lift horizontal clouds [..., N, 2] to 3-D with their frames' vertical
    profiles [..., B]: points within ``max_bearing`` of the body x-axis take
    the height of their range bin where it is valid, all others keep z = 0.
    Returns (points3d [..., N, 3], mask [..., N])."""
    B = profile_z.shape[-1]
    bin_w = max_x / B
    fwd = torch.linalg.norm(h_points, dim=-1)
    brg = torch.atan2(h_points[..., 1], torch.clamp(h_points[..., 0], min=1e-6))
    in_strip = torch.abs(brg) <= max_bearing
    b = torch.clamp((fwd / bin_w).to(torch.int32), 0, B - 1).to(torch.int64)
    zb = torch.take_along_dim(profile_z, b, dim=-1)
    ok = torch.take_along_dim(profile_valid, b, dim=-1) & in_strip
    z = torch.where(ok, zb, torch.zeros_like(zb))
    pts3 = torch.cat([h_points, z[..., None]], dim=-1)
    return torch.where(h_mask[..., None], pts3, torch.zeros_like(pts3)), h_mask


def fuse_frames(h_points: torch.Tensor, h_masks: torch.Tensor,
                v_detections: torch.Tensor, geometry_v: SonarGeometry,
                num_bins: int = 64):
    """The legacy per-frame path over a batch: (F, N, 2) clouds and (F, R,
    C) vertical masks -> (points3d (F, N, 3), mask (F, N))."""
    max_x = geometry_v.max_range
    z, ok = elevation_profile(v_detections, geometry_v, num_bins, max_x)
    return fuse_vertical(h_points, h_masks, z, ok, max_x)


class ElevationGrid(NamedTuple):
    """Seafloor height map fused from every keyframe's vertical fan: ``z``
    the weighted mean height per cell (meaningful where ``w > 0``), ``w``
    the accumulated sample weight, both (H, W)."""

    z: torch.Tensor
    w: torch.Tensor


class ElevationSpec(NamedTuple):
    x0: float
    y0: float
    resolution: float
    nx: int
    ny: int


def beam_floor_samples(v_img: torch.Tensor, v_det: torch.Tensor,
                       geometry: SonarGeometry, centroid_halfwin: int = 2,
                       noise_floor: float = 30.0, min_window_dets: int = 3):
    """One (x_fwd, z, weight) sample per vertical beam of frames [..., R,
    C]: the strongest detected row anchors a window of +-``centroid_halfwin``
    rows, whose intensity-weighted centroid (``noise_floor`` subtracted)
    gives the continuous range; ``x = r cos(phi)``, ``z = r sin(phi)``. A
    beam needs ``min_window_dets`` detected rows in its window. Returns (xz
    [..., C, 2], weight [..., C]), weight 0 where the beam saw nothing."""
    R = v_img.shape[-2]
    dev = v_img.device
    img = v_img.to(torch.float32)
    scored = torch.where(v_det, img, torch.zeros_like(img))
    best = torch.argmax(scored, dim=-2, keepdim=True)  # [..., 1, C]
    peak = torch.take_along_dim(scored, best, dim=-2)[..., 0, :]
    has = peak > 0.0

    offs = torch.arange(-centroid_halfwin, centroid_halfwin + 1, device=dev)
    rows = torch.clamp(best + offs[:, None], 0, R - 1)  # [..., W, C]
    win = torch.take_along_dim(img, rows, dim=-2)
    win = torch.clamp(win - noise_floor, min=0.0)
    wsum = torch.clamp(torch.sum(win, dim=-2), min=1e-6)
    row_c = torch.sum(win * rows.to(torch.float32), dim=-2) / wsum
    ndet = torch.sum(torch.take_along_dim(v_det, rows, dim=-2), dim=-2)
    has = has & (ndet >= min_window_dets)
    r = (row_c + 1.0) * geometry.range_resolution
    phi = torch.as_tensor(np.asarray(geometry.bearings, np.float32), device=dev)
    xz = torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
    w = torch.where(has, peak, torch.zeros_like(peak))
    return xz, w


def _cells(xy: torch.Tensor, spec: ElevationSpec):
    ix = torch.floor((xy[..., 0] - spec.x0) / spec.resolution).to(torch.int32)
    iy = torch.floor((xy[..., 1] - spec.y0) / spec.resolution).to(torch.int32)
    inside = (ix >= 0) & (ix < spec.nx) & (iy >= 0) & (iy < spec.ny)
    return ix.to(torch.int64), iy.to(torch.int64), inside


def accumulate_elevation(sample_xy: torch.Tensor, sample_z: torch.Tensor,
                         sample_w: torch.Tensor,
                         spec: ElevationSpec) -> ElevationGrid:
    """Add weighted height samples (S, 2), (S,), (S,) into the global grid;
    samples outside it or without weight add nothing."""
    ix, iy, inside = _cells(sample_xy, spec)
    keep = inside & (sample_w != 0)
    idx = iy * spec.nx + ix
    n = spec.nx * spec.ny
    zsum = _scatter_add(n, idx, sample_w * sample_z, keep)
    wsum = _scatter_add(n, idx, sample_w, keep)
    z = zsum / torch.clamp(wsum, min=1e-6)
    return ElevationGrid(z=z.reshape(spec.ny, spec.nx),
                         w=wsum.reshape(spec.ny, spec.nx))


def lift_from_grid(points_xy: torch.Tensor, grid: ElevationGrid,
                   spec: ElevationSpec):
    """Height at each global query (N, 2) from the weighted 3x3
    neighbourhood of its cell. Returns (z (N,), valid (N,)); z = 0 where no
    neighbouring cell holds data."""
    ix, iy, inside = _cells(points_xy, spec)
    zacc = torch.zeros(points_xy.shape[0], dtype=torch.float32,
                       device=points_xy.device)
    wacc = torch.zeros_like(zacc)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            cx = torch.clamp(ix + dx, 0, spec.nx - 1)
            cy = torch.clamp(iy + dy, 0, spec.ny - 1)
            w = grid.w[cy, cx]
            zacc = zacc + w * grid.z[cy, cx]
            wacc = wacc + w
    valid = inside & (wacc > 1e-6)
    z = torch.where(valid, zacc / torch.clamp(wacc, min=1e-6),
                    torch.zeros_like(zacc))
    return z, valid


def fuse_frames_global(h_points: torch.Tensor, h_masks: torch.Tensor,
                       v_imgs: torch.Tensor, v_dets: torch.Tensor,
                       poses: torch.Tensor, geometry_v: SonarGeometry,
                       spec: ElevationSpec):
    """The production dual-sonar fusion: per-beam floor samples of every
    keyframe -> the global elevation grid through the SLAM poses -> a height
    for every horizontal point the grid covers.

    Takes (F, N, 2) local clouds and their (F, N) masks, (F, R, C) vertical
    frames and detection masks and (F, 3) poses. Returns ``(points3d (F, N,
    3) local xyz, mask (F, N), floor3d (F, C, 3) local xyz of the per-beam
    samples, floor_w (F, C), ElevationGrid)``."""
    xz, w = beam_floor_samples(v_imgs, v_dets, geometry_v)  # (F, C, 2), (F, C)
    # the strip's points lie along body x: local (x_fwd, 0) -> global
    local_xy = torch.stack([xz[..., 0], torch.zeros_like(xz[..., 0])], dim=-1)
    gxy = se2_transform_points(local_xy, poses)
    grid = accumulate_elevation(gxy.reshape(-1, 2), xz[..., 1].reshape(-1),
                                w.reshape(-1), spec)

    h_global = se2_transform_points(h_points, poses)
    F, N = h_masks.shape
    z, zok = lift_from_grid(h_global.reshape(-1, 2), grid, spec)
    z = (z * zok).reshape(F, N)
    pts3 = torch.cat([h_points, z[..., None]], dim=-1)
    pts3 = torch.where(h_masks[..., None], pts3, torch.zeros_like(pts3))
    floor3d = torch.stack([xz[..., 0], torch.zeros_like(xz[..., 0]),
                           xz[..., 1]], dim=-1)
    return pts3, h_masks, floor3d, w, grid
