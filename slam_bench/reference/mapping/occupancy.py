"""Submap-per-keyframe log-odds occupancy mapping, as the replay's mapping
stage (``pipeline.occupancy_map``) runs it.

Counterpart of ``sonar_slam_tpu/mapping/occupancy.py`` (the reference's
``Mapping`` / ``Submap``):

* each keyframe owns a log-odds image over a downsampled polar grid: feature
  hits splatted into polar cells, inflated with a separable Gaussian,
  normalized so a hit peaks at ``hit_prob``, clipped to [0.5, hit_prob], and
  every cell before the first hit along each beam marked ``miss_prob``;
* the global grid is the sum of every submap's log-odds through its current
  pose, keeping one polar cell per world cell and keyframe (the first),
  repainted whole (``render_global_logodds``);
* the export, method 1, maps log-odds to int8 occupancy 0..100.

The port's incremental API (one keyframe at a time, pose updates), method 2,
the intensity grid and the debug dumps are left out: no stage of the
reference uses them.

What differs from the JAX version, and why:

* the submaps of all keyframes are built in one batch (bench.py ``vmap``s
  the JAX function), and the splat of every keyframe is one batch too;
* divisions by constants are written out as XLA evaluates the JAX
  version's under ``jit``: a multiplication by the float32 reciprocal, so
  the CPU and the card give the same bits, and so the same cells;
* every sum over cells is ``index_put_(..., accumulate=True)`` over the
  kept cells only, which adds in index order on the card (float atomics
  would add in a varying order) and in input order on the CPU, as XLA's
  scatter-add does; the JAX version's ``.at[].max`` is
  ``scatter_reduce_("amax")``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..cloud import remove_outlier
from ..geometry import se2_rotmat
from ..precision import pin_fp32
from ..slam.sonar import SonarGeometry


def _recip(c: float) -> float:
    """The float32 reciprocal of a constant, as a Python float."""
    return float(np.float32(1.0) / np.float32(c))


def _div_recip(x: torch.Tensor, c) -> torch.Tensor:
    """``x / c`` as XLA compiles a division by a constant under ``jit``: a
    multiplication by the float32 reciprocal."""
    return x * _recip(c)


@dataclass(frozen=True)
class MappingConfig:
    """mapping.yaml semantics; the same fields and defaults as the JAX
    package's ``MappingConfig``."""

    x0: float = -100.0
    y0: float = -100.0
    width: float = 200.0
    height: float = 200.0
    resolution: float = 0.2
    hit_prob: float = 0.8
    miss_prob: float = 0.3
    inflation_angle: float = 0.04
    inflation_range: float = 0.4
    inflation_radius: float = 0.5  # method 2
    outlier_filter_radius: float = 5.0
    outlier_filter_min_points: int = 20
    min_translation: float = 0.5
    min_rotation: float = 0.015
    max_keyframes: int = 128

    @property
    def rows(self) -> int:
        return int(np.ceil(self.height / self.resolution))

    @property
    def cols(self) -> int:
        return int(np.ceil(self.width / self.resolution))


class SubmapModel:
    """Static per-geometry tables on ``device``: downsampled polar cell
    centres and the Gaussian inflation kernels."""

    def __init__(self, config: MappingConfig, geometry: SonarGeometry, device):
        pin_fp32()  # the inflation convolution in float32, not TF32
        self.config = config
        self.geometry = geometry
        self.device = torch.device(device)
        self.r_skip = max(
            1, int(np.floor(config.resolution / geometry.range_resolution)))
        bearing_arc = geometry.angular_resolution * geometry.max_range
        self.c_skip = max(1, int(np.floor(config.resolution / bearing_arc)))
        self.ranges = geometry.ranges[:: self.r_skip]
        self.bearings = geometry.bearings[:: self.c_skip]
        self.shape = (len(self.ranges), len(self.bearings))
        B, R = np.meshgrid(self.bearings, self.ranges)
        self.sonar_xy = torch.as_tensor(
            np.stack([np.cos(B) * R, np.sin(B) * R], -1).reshape(-1, 2)
            .astype(np.float32), device=self.device)  # (S, 2)

        hr = int(round(config.inflation_range / geometry.range_resolution
                       / self.r_skip))
        hc = int(round(config.inflation_angle / geometry.angular_resolution
                       / self.c_skip))
        kr = _gaussian_kernel(2 * hr + 1).astype(np.float32)
        kc = _gaussian_kernel(2 * hc + 1).astype(np.float32)
        self.kernel_r = torch.as_tensor(kr, device=self.device)
        self.kernel_c = torch.as_tensor(kc, device=self.device)
        self.hr, self.hc = hr, hc
        # normalization so an isolated hit peaks at hit_prob
        self.peak = float(kr[hr] * kc[hc])


def _gaussian_kernel(ksize: int) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, -1): sigma = 0.3((k-1)/2 - 1) + 0.8."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return k / k.sum()


class MappingState(NamedTuple):
    kf_logodds: torch.Tensor  # (K, S) per-keyframe submap log-odds
    kf_poses: torch.Tensor  # (K, 3)
    kf_valid: torch.Tensor  # (K,) bool
    num_kf: int
    grid: torch.Tensor  # (H, W) accumulated log-odds


def mapping_init(config: MappingConfig, model: SubmapModel) -> MappingState:
    K = config.max_keyframes
    S = model.sonar_xy.shape[0]
    dev = model.device
    return MappingState(
        kf_logodds=torch.zeros((K, S), device=dev),
        kf_poses=torch.zeros((K, 3), device=dev),
        kf_valid=torch.zeros(K, dtype=torch.bool, device=dev),
        num_kf=0,
        grid=torch.zeros((config.rows, config.cols), device=dev),
    )


def _sep_conv2(img: torch.Tensor, kr: torch.Tensor, kc: torch.Tensor) -> torch.Tensor:
    """Separable 2-D convolution with a zero border (cv2.BORDER_CONSTANT) of
    (B, R, C) images."""
    x = img[:, None]  # NCHW
    x = F.conv2d(x, kr.reshape(1, 1, -1, 1), padding=((kr.shape[0] - 1) // 2, 0))
    x = F.conv2d(x, kc.reshape(1, 1, 1, -1), padding=(0, (kc.shape[0] - 1) // 2))
    return x[:, 0]


def build_submap_logodds(points: torch.Tensor, pmask: torch.Tensor,
                         model: SubmapModel,
                         filter_outliers: bool = True) -> torch.Tensor:
    """The polar log-odds images of (B, N, 2) keyframe clouds (local frame)
    with masks (B, N), flattened to (B, S). Divides as the JAX version does
    under ``jit`` (bench.py's mapping stage)."""
    return _submap_logodds(points, pmask, model, filter_outliers, _div_recip)


def _submap_logodds(points, pmask, model: SubmapModel, filter_outliers: bool,
                    div) -> torch.Tensor:
    cfg = model.config
    geom = model.geometry
    R, C = model.shape
    B = points.shape[0]
    dev = points.device

    if filter_outliers and cfg.outlier_filter_min_points > 1:
        pmask = remove_outlier(points, pmask, cfg.outlier_filter_radius,
                               cfg.outlier_filter_min_points)

    # splat hits into the downsampled polar grid
    rng = torch.linalg.vector_norm(points, dim=-1)
    brg = torch.atan2(points[..., 1], points[..., 0])
    r_full = torch.clamp(torch.round(div(rng, geom.range_resolution) - 1)
                         .to(torch.int64), 0, geom.num_ranges - 1)
    b0 = float(geom.bearings[0])
    span = geom.bearings[-1] - geom.bearings[0]  # float32, as in the JAX version
    c_full = torch.clamp(
        torch.round(div(brg - b0, span) * (geom.num_bearings - 1))
        .to(torch.int64), 0, geom.num_bearings - 1)
    r = torch.clamp(r_full // model.r_skip, 0, R - 1)
    c = torch.clamp(c_full // model.c_skip, 0, C - 1)
    flat = (torch.arange(B, device=dev)[:, None] * (R * C) + r * C + c).reshape(-1)
    mask_img = torch.zeros(B * R * C, device=dev).scatter_reduce_(
        0, flat, pmask.to(torch.float32).reshape(-1), "amax").reshape(B, R, C)
    has_points = torch.any(pmask, dim=-1)

    # Gaussian inflation, normalized so a hit peaks at hit_prob, clipped to
    # [0.5, hit_prob]
    inflated = _sep_conv2(mask_img, model.kernel_r, model.kernel_c)
    inflated = div(inflated, model.peak / cfg.hit_prob)
    probs = torch.clamp(inflated, 0.5, cfg.hit_prob)

    # free-space carving: cells before the first hit of each beam -> miss;
    # beams without a hit are all miss, and so are frames without points
    hit = probs > 0.5
    first_hit = torch.argmax(hit.to(torch.uint8), dim=1)
    first_hit = torch.where(torch.any(hit, dim=1), first_hit,
                            torch.full_like(first_hit, R))
    rows = torch.arange(R, device=dev)[:, None]
    miss = torch.full_like(probs, cfg.miss_prob)
    probs = torch.where(rows < first_hit[:, None, :], miss, probs)
    probs = torch.where(has_points[:, None, None], probs, miss)
    return torch.logit(probs).reshape(B, R * C)


def _world_coords(model: SubmapModel, poses: torch.Tensor, div=_div_recip):
    """Continuous world-grid (row, col) of every polar cell through (K, 3)
    poses: (K, S) each."""
    cfg = model.config
    # one (S, 2) @ (2, 2K) product: each coordinate is the 2-term dot that
    # the unbatched product (and XLA's) rounds, where a batched product of
    # 2 x 2 matrices rounds differently on the CPU
    K = poses.shape[0]
    rot_t = se2_rotmat(poses[:, 2]).transpose(-1, -2)  # (K, 2 in, 2 out)
    xy = torch.matmul(model.sonar_xy, rot_t.permute(1, 0, 2).reshape(2, 2 * K))
    xy = xy.reshape(-1, K, 2).transpose(0, 1) + poses[:, None, :2]  # (K, S, 2)
    return (div(xy[..., 1] - cfg.y0, cfg.resolution),
            div(xy[..., 0] - cfg.x0, cfg.resolution))


def _world_cells(model: SubmapModel, poses: torch.Tensor, div=_div_recip):
    """World-grid (row, col, inside) of every polar cell through (K, 3)
    poses: (K, S) each."""
    cfg = model.config
    u, v = _world_coords(model, poses, div)
    r = torch.round(u).to(torch.int64)
    c = torch.round(v).to(torch.int64)
    inside = (r >= 0) & (r < cfg.rows) & (c >= 0) & (c < cfg.cols)
    return r, c, inside


def _dedup_first(cell_idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per row of (K, S) cell ids, keep the first occurrence (lowest source
    index) of each valid id (``np.unique(return_index=True)`` semantics)."""
    big = torch.iinfo(torch.int32).max
    key = torch.where(valid, cell_idx, torch.full_like(cell_idx, big))
    order = torch.sort(key, dim=-1, stable=True).indices  # first occ leads
    sorted_key = torch.gather(key, -1, order)
    first = torch.ones_like(valid)
    first[..., 1:] = sorted_key[..., 1:] != sorted_key[..., :-1]
    keep_sorted = first & (sorted_key != big)
    return torch.zeros_like(valid).scatter_(-1, order, keep_sorted)


def _splat(model: SubmapModel, poses, enabled, div=_div_recip):
    """Every keyframe's world-cell ids and which of its polar cells are kept
    after the dedup: each (K, S); ``enabled`` is (K,)."""
    r, c, inside = _world_cells(model, poses, div)
    idx = r * model.config.cols + c
    return idx, _dedup_first(idx, inside & enabled[:, None])


def render_global_logodds(state: MappingState, model: SubmapModel) -> torch.Tensor:
    """Full repaint: the sum of every valid submap through its current pose,
    (H, W) log-odds. Only the kept cells are scattered: the JAX version adds
    zeros for the others at cell 0, which changes no bit, and on the card
    the sorted accumulate would add that long run of duplicates one by one
    (0.45 s at the full config)."""
    cfg = model.config
    idx, keep = _splat(model, state.kf_poses, state.kf_valid)
    grid = torch.zeros(cfg.rows * cfg.cols, device=idx.device)
    grid.index_put_((idx[keep],), state.kf_logodds[keep], accumulate=True)
    return grid.reshape(cfg.rows, cfg.cols)


def occupancy_grid_method1(state: MappingState, model: SubmapModel,
                           frames: torch.Tensor | None = None) -> torch.Tensor:
    """Log-odds -> int8 occupancy 0..100 (unobserved cells, log-odds 0, read
    50). ``frames``, a (K,) bool mask, renders only those keyframes (the
    GetOccupancyMap service's subset)."""
    if frames is None:
        grid = state.grid
    else:
        frames = torch.as_tensor(frames, device=model.device)
        grid = render_global_logodds(
            state._replace(kf_valid=state.kf_valid & frames), model)
    probs = torch.sigmoid(grid)
    return torch.clamp(torch.round(100.0 * probs), 0, 100).to(torch.int8)


