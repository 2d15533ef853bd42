"""Sonar feature extraction: polar pings -> masked 2-D point clouds.

Counterpart of ``sonar_slam_tpu/slam/frontend.py``:

1. CFAR detection (CA, SOCA, GOCA or OS) with the intensity gate
   ``img > threshold`` fused in. On a CUDA device it runs the hand-written
   kernels (``kernels/cfar_cuda.py``), on the CPU their plain PyTorch
   versions;
2. voxel binning of the detected cells through a static (voxel, group) cell
   table built once on the host, with intensity-weighted, sub-bin refined
   centroids, densest voxels first;
3. radius outlier removal;
4. optionally, the temporal corroboration gate against the neighbouring
   pings (:func:`corroborate`).

The frames go through in slices so the gathered (voxel, group) tables stay
within a fixed memory budget (at 512 x 256 one frame's table is 4232 x 1024).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cloud import remove_outlier, top_k_stable
from ..cloud.knn import pairwise_sq_dists
from ..geometry import se2_between, se2_transform_points
from ..kernels.cfar_cuda import cfar_detect
from ..kernels.cfar_factors import (
    threshold_factor_ca,
    threshold_factor_goca,
    threshold_factor_os,
    threshold_factor_soca,
)
from ..precision import pin_fp32
from .sonar import SonarGeometry

# elements of one gathered (frames, voxels, group) table per slice
_TABLE_BUDGET = 1 << 25


class FeatureConfig(NamedTuple):
    """feature.yaml semantics; same fields and defaults as the JAX package's
    ``FeatureConfig``."""

    cfar_edge: str = "extend"
    ntc: int = 40
    ngc: int = 10
    pfa: float = 0.1
    rank: int = 10
    alg: str = "SOCA"
    threshold: float = 65.0
    resolution: float = 0.5
    outlier_radius: float = 1.0
    outlier_min_points: int = 5
    skip: int = 1
    max_points: int = 256
    subbin: bool = True
    min_voxel_hits: int = 1
    corroborate: bool = False
    corroborate_rho: float = 0.3
    corroborate_both: bool = False


class StaticVoxelBinner:
    """Voxel downsampling for the static polar cell table: polar cell ->
    voxel is fixed per geometry, so binning is a gather + masked sum over a
    precomputed (num_voxels, group) index table and one stable top-k."""

    def __init__(self, cells_xy: np.ndarray, resolution: float,
                 x0: float, y0: float, nx: int, ny: int, device,
                 max_group: int = 1024, cell_valid: np.ndarray | None = None):
        n_cells = len(cells_xy)
        ix = np.floor((cells_xy[:, 0] - x0) / resolution).astype(np.int64)
        iy = np.floor((cells_xy[:, 1] - y0) / resolution).astype(np.int64)
        inside = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
        if cell_valid is not None:
            inside = inside & cell_valid
        vid = np.where(inside, iy * nx + ix, -1)
        used = np.unique(vid[vid >= 0])
        remap = {v: i for i, v in enumerate(used)}
        V = len(used)
        groups: list[list[int]] = [[] for _ in range(V)]
        for cell, v in enumerate(vid):
            if v >= 0:
                groups[remap[v]].append(cell)
        G = min(max(len(g) for g in groups), max_group)
        idx = np.full((V, G), n_cells, np.int64)  # sentinel -> padded False
        for i, g in enumerate(groups):
            take = g[:G]  # overflow cells dropped (closest-range voxels only)
            idx[i, : len(take)] = take
        self.dropped_cells = sum(max(0, len(g) - G) for g in groups)
        self.group_idx = torch.as_tensor(idx, device=device)
        padded_xy = np.concatenate([cells_xy, np.zeros((1, 2), np.float32)])
        self.group_xy = torch.as_tensor(padded_xy[idx], device=device)
        self.num_voxels = V
        self.num_cells = n_cells

    def __call__(self, flat_mask: torch.Tensor, max_out: int,
                 flat_weights: torch.Tensor | None = None,
                 flat_xy: torch.Tensor | None = None, min_hits: int = 1):
        """(B, num_cells) bool detections -> (points (B, max_out, 2), mask,
        conf). ``flat_weights`` makes the representatives weighted centroids
        (the ranking stays by hit count); ``flat_xy`` (B, num_cells, 2)
        overrides the static cell positions. ``conf`` is the voxel's hit
        count."""
        B = flat_mask.shape[0]
        dev = flat_mask.device
        pad_b = torch.zeros((B, 1), dtype=torch.bool, device=dev)
        hits = torch.cat([flat_mask, pad_b], dim=1)[:, self.group_idx]
        h = hits.to(torch.float32)
        counts = torch.sum(h, dim=2)
        if flat_weights is None:
            w = h
            wsum = counts
        else:
            pad_f = torch.zeros((B, 1), dtype=torch.float32, device=dev)
            wp = torch.cat([flat_weights.to(torch.float32), pad_f], dim=1)
            w = h * wp[:, self.group_idx]
            wsum = torch.sum(w, dim=2)
        if flat_xy is None:
            group_xy = self.group_xy.expand(B, -1, -1, -1)
        else:
            pad_xy = torch.zeros((B, 1, 2), dtype=torch.float32, device=dev)
            xyp = torch.cat([flat_xy.to(torch.float32), pad_xy], dim=1)
            group_xy = xyp[:, self.group_idx]
        sums = torch.sum(w[..., None] * group_xy, dim=2)  # (B, V, 2)
        score, vi = top_k_stable(counts, max_out)
        out_mask = score > max(min_hits, 1) - 0.5
        sel_sums = torch.gather(sums, 1, vi[..., None].expand(-1, -1, 2))
        sel_w = torch.gather(wsum, 1, vi)
        centroids = sel_sums / torch.clamp(sel_w, min=1e-6)[..., None]
        conf = torch.where(out_mask, score, torch.zeros_like(score))
        pts = torch.where(out_mask[..., None], centroids,
                          torch.zeros_like(centroids))
        return pts, out_mask, conf


class FeatureExtractor:
    """Static pieces (tau, voxel grid, cell tables) built once per
    (config, geometry, device)."""

    def __init__(self, config: FeatureConfig, geometry: SonarGeometry,
                 device: torch.device):
        pin_fp32()
        self.config = config
        self.geometry = geometry
        self.device = torch.device(device)
        taus = {
            "CA": lambda: threshold_factor_ca(config.ntc, config.pfa),
            "SOCA": lambda: threshold_factor_soca(config.ntc, config.pfa),
            "GOCA": lambda: threshold_factor_goca(config.ntc, config.pfa),
            "OS": lambda: threshold_factor_os(config.ntc, config.rank,
                                              config.pfa),
        }
        if config.alg not in taus:
            raise ValueError(f"unknown CFAR alg {config.alg}")
        self.tau = taus[config.alg]()

        cells_np = geometry.cell_points().reshape(-1, 2).astype(np.float32)
        self._cells = torch.as_tensor(cells_np, device=self.device)
        # sub-bin tables: metric displacement of each cell's point per +1 row
        # (radial) and per +1 column (tangential)
        Rn, Cn = geometry.num_ranges, geometry.num_bearings
        b = np.asarray(geometry.bearings, np.float64)
        db = np.gradient(b)
        ur = np.stack([np.cos(b), np.sin(b)], -1)
        ut = np.stack([-np.sin(b), np.cos(b)], -1)
        step_r = np.broadcast_to(ur[None], (Rn, Cn, 2)) * geometry.range_resolution
        step_c = (geometry.ranges[:, None, None] * db[None, :, None]) * ut[None]
        self._step_r = torch.as_tensor(
            step_r.reshape(-1, 2).astype(np.float32), device=self.device)
        self._step_c = torch.as_tensor(
            step_c.reshape(-1, 2).astype(np.float32), device=self.device)
        half_width = float(
            np.sin(geometry.horizontal_aperture / 2) * geometry.max_range)
        res = config.resolution
        # strict-edge CFAR never detects inside the border band: keep those
        # rows out of the binner tables
        if config.cfar_edge == "strict":
            hw = (config.ntc + config.ngc) // 2
            row_ok = np.zeros(geometry.num_ranges, bool)
            row_ok[hw: geometry.num_ranges - hw] = True
        else:
            row_ok = np.ones(geometry.num_ranges, bool)
        self._binner = StaticVoxelBinner(
            cells_np, res, x0=0.0, y0=-half_width,
            nx=int(np.ceil(geometry.max_range / res)) + 1,
            ny=int(np.ceil(2 * half_width / res)) + 1,
            device=self.device,
            cell_valid=np.repeat(row_ok, geometry.num_bearings),
        )
        table = self._binner.group_idx.numel()
        self.slice_frames = max(1, _TABLE_BUDGET // table)

    def detections(self, imgs: torch.Tensor) -> torch.Tensor:
        """CFAR + intensity-gate mask of (B, R, C) frames."""
        cfg = self.config
        imgs = imgs.to(torch.float32).contiguous()
        t, g = cfg.ntc // 2, cfg.ngc // 2
        return cfar_detect(imgs, t, g, self.tau, cfg.alg,
                           intensity_threshold=cfg.threshold,
                           edge=cfg.cfar_edge, rank=cfg.rank)

    def subbin_xy(self, imgs: torch.Tensor) -> torch.Tensor:
        """Refined per-cell positions (B, R*C, 2) by log-parabolic peak
        interpolation along range and bearing; offsets clipped to half a
        cell, zero on the image border."""
        B = imgs.shape[0]
        L = torch.log(torch.clamp(imgs, min=1.0))

        def peak_delta(axis: int) -> torch.Tensor:
            lm = torch.roll(L, 1, dims=axis)
            lp = torch.roll(L, -1, dims=axis)
            num = lm - lp
            den = lm + lp - 2.0 * L
            d = torch.where(den < -1e-6, num / (2.0 * den), torch.zeros_like(L))
            d = d.clone()
            if axis == 1:
                d[:, 0] = 0.0
                d[:, -1] = 0.0
            else:
                d[:, :, 0] = 0.0
                d[:, :, -1] = 0.0
            return torch.clamp(d, -0.5, 0.5).reshape(B, -1, 1)

        return self._cells + peak_delta(1) * self._step_r + peak_delta(2) * self._step_c

    def _extract_slice(self, imgs: torch.Tensor, peaks: torch.Tensor):
        cfg = self.config
        B = imgs.shape[0]
        pts, mask, conf = self._binner(
            peaks.reshape(B, -1), cfg.max_points, imgs.reshape(B, -1),
            self.subbin_xy(imgs) if cfg.subbin else None,
            min_hits=cfg.min_voxel_hits,
        )
        if cfg.outlier_min_points > 1:
            mask = remove_outlier(pts, mask, cfg.outlier_radius,
                                  cfg.outlier_min_points)
        return pts, mask, conf

    def extract_batch_conf(self, imgs: torch.Tensor):
        """(B, R, C) frames -> (points (B, N, 2), mask (B, N) bool,
        conf (B, N) f32), N = ``max_points``. One CFAR launch for the whole
        batch, then the binning in slices of ``slice_frames``."""
        imgs = imgs.to(device=self.device, dtype=torch.float32).contiguous()
        peaks = self.detections(imgs)
        outs = [
            self._extract_slice(imgs[i: i + self.slice_frames],
                                peaks[i: i + self.slice_frames])
            for i in range(0, imgs.shape[0], self.slice_frames)
        ]
        return tuple(torch.cat([o[k] for o in outs]) for k in range(3))

    def extract_batch(self, imgs: torch.Tensor):
        return self.extract_batch_conf(imgs)[:2]


def corroboration_gate(pts, masks, pose2, nb_pts, nb_masks, nb_pose2,
                       rho: float) -> torch.Tensor:
    """Per-point flags: a keyframe point is corroborated when the
    motion-compensated neighbour cloud has a masked point within ``rho``."""
    rel = se2_between(pose2, nb_pose2)
    q = se2_transform_points(nb_pts, rel)
    d2 = pairwise_sq_dists(pts, q)  # (K, N, M)
    d2 = torch.where(nb_masks[:, None, :], d2, torch.full_like(d2, float("inf")))
    return masks & (torch.min(d2, dim=-1).values < rho * rho)


def corroborate(pts, masks, pose2, neighbors, rho: float,
                both: bool = False) -> torch.Tensor:
    """Apply :func:`corroboration_gate` over several neighbour clouds
    ``(nb_pts, nb_masks, nb_pose2)``: keep points ANY neighbour corroborates,
    or EVERY neighbour with ``both``."""
    corr = None
    for nb_pts, nb_masks, nb_pose2 in neighbors:
        c = corroboration_gate(pts, masks, pose2, nb_pts, nb_masks, nb_pose2,
                               rho)
        corr = c if corr is None else ((corr & c) if both else (corr | c))
    return masks & corr
