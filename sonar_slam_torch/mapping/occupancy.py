"""Submap-per-keyframe log-odds occupancy mapping.

Counterpart of ``sonar_slam_tpu/mapping/occupancy.py`` (the reference's
``Mapping`` / ``Submap``):

* each keyframe owns a log-odds image over a downsampled polar grid: feature
  hits splatted into polar cells, inflated with a separable Gaussian,
  normalized so a hit peaks at ``hit_prob``, clipped to [0.5, hit_prob], and
  every cell before the first hit along each beam marked ``miss_prob``;
* the global grid is the sum of every submap's log-odds through its current
  pose, keeping one polar cell per world cell and keyframe (the first):
  built up one keyframe at a time (``add_keyframe``) or repainted whole
  (``render_global_logodds``, ``update_poses`` after loop closures);
* the exports: method 1 maps log-odds to int8 occupancy 0..100 (optionally
  for a subset of keyframes, and resampled: ``get_occupancy_map``), method 2
  projects the feature points and dilates them over the observed region,
  and the intensity grid averages the keyframes' pings per cell;
* ``grow`` pads the grid on the host and ``save_submaps`` writes the
  per-submap debug dump.

What differs from the JAX version, and why:

* the submaps of all keyframes are built in one batch (bench.py ``vmap``s
  the JAX function), and the splat of every keyframe is one batch too;
* divisions by constants are written out as XLA evaluates the JAX
  version's: under ``jit`` (the batch submaps, the repaint) a multiplication
  by the float32 reciprocal, op by op (``add_keyframe``, method 2, the
  intensity grid, which the JAX package does not compile whole) an exact
  division. Written out, they give the same bits on the CPU and the card,
  and so the same cells. So a keyframe's cells in ``add_keyframe`` and in a
  repaint can differ at a point on a rounding boundary, as in the JAX
  package;
* every sum over cells (the repaint, ``add_keyframe``'s add, the intensity
  sums and counts) is ``index_put_(..., accumulate=True)`` over the kept
  cells only, which adds in index order on the card (float atomics would add
  in a varying order) and in input order on the CPU, as XLA's scatter-add
  does; the JAX version's ``.at[].max`` is ``scatter_reduce_("amax")``;
* a grid built up by ``add_keyframe`` adds in insertion order and a repaint
  in keyframe order, so the two agree within float rounding, not bit for
  bit (as in the JAX package).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..cloud import remove_outlier
from ..geometry import se2_between, se2_rotmat
from ..precision import pin_fp32
from ..slam.sonar import SonarGeometry


def _recip(c: float) -> float:
    """The float32 reciprocal of a constant, as a Python float."""
    return float(np.float32(1.0) / np.float32(c))


def _div_recip(x: torch.Tensor, c) -> torch.Tensor:
    """``x / c`` as XLA compiles a division by a constant under ``jit``: a
    multiplication by the float32 reciprocal."""
    return x * _recip(c)


def _div_exact(x: torch.Tensor, c) -> torch.Tensor:
    """``x / c`` as XLA runs it op by op: an exact float32 division (by a
    tensor operand, which CUDA divides exactly, where it would multiply by
    the reciprocal of a Python number)."""
    return x / torch.full((), float(np.float32(c)), device=x.device)


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




def _pose_tensor(pose, device) -> torch.Tensor:
    """A pose (or poses) given as a tensor or an array, float32 on ``device``."""
    if not isinstance(pose, torch.Tensor):
        pose = torch.as_tensor(np.asarray(pose, np.float32))
    return pose.to(device=device, dtype=torch.float32)


def add_keyframe(state: MappingState, key, pose, points: torch.Tensor,
                 pmask: torch.Tensor, model: SubmapModel) -> MappingState:
    """Insert or overwrite keyframe ``key``'s submap from its (N, 2) cloud
    and add it to the grid at ``pose`` (3,). Returns a new state."""
    key = int(key)
    pose = _pose_tensor(pose, model.device)
    lo = _submap_logodds(points[None], pmask[None], model, True, _div_exact)
    idx, keep = _splat(model, pose[None],
                       torch.ones(1, dtype=torch.bool, device=model.device),
                       _div_exact)
    kf_logodds = state.kf_logodds.clone()
    kf_logodds[key] = lo[0]
    kf_poses = state.kf_poses.clone()
    kf_poses[key] = pose
    kf_valid = state.kf_valid.clone()
    kf_valid[key] = True
    grid = state.grid.clone()
    grid.view(-1).index_put_((idx[keep],), lo[keep], accumulate=True)
    return MappingState(kf_logodds=kf_logodds, kf_poses=kf_poses,
                        kf_valid=kf_valid, num_kf=max(state.num_kf, key + 1),
                        grid=grid)


def update_poses(state: MappingState, new_poses, model: SubmapModel) -> MappingState:
    """Repaint after loop closures: move the keyframes whose pose changed by
    more than ``min_translation`` or ``min_rotation`` to their (K, 3)
    ``new_poses`` and render the whole grid again."""
    cfg = model.config
    new_poses = _pose_tensor(new_poses, model.device)
    d = se2_between(state.kf_poses, new_poses)
    moved = ((torch.linalg.vector_norm(d[:, :2], dim=-1) > cfg.min_translation)
             | (torch.abs(d[:, 2]) > cfg.min_rotation))
    poses = torch.where((moved & state.kf_valid)[:, None], new_poses,
                        state.kf_poses)
    state = state._replace(kf_poses=poses)
    return state._replace(grid=render_global_logodds(state, model))


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


def resample_grid(grid: torch.Tensor, src_resolution: float,
                  dst_resolution: float) -> torch.Tensor:
    """Nearest-neighbour resample to a coarser resolution (the service's
    ``resolution``; dst >= src)."""
    if dst_resolution < src_resolution:
        raise ValueError("target resolution must be >= map resolution")
    ratio = src_resolution / dst_resolution
    H, W = grid.shape
    h, w = int(np.floor(H * ratio)), int(np.floor(W * ratio))
    r32 = np.float32(ratio)
    rr = np.clip((np.arange(h, dtype=np.float32) / r32).astype(np.int64), 0, H - 1)
    cc = np.clip((np.arange(w, dtype=np.float32) / r32).astype(np.int64), 0, W - 1)
    dev = grid.device
    return grid[torch.as_tensor(rr, device=dev)][:, torch.as_tensor(cc, device=dev)]


def get_occupancy_map(state: MappingState, model: SubmapModel,
                      frames: torch.Tensor | None = None,
                      resolution: float | None = None, method: int = 1,
                      points: torch.Tensor | None = None,
                      pmask: torch.Tensor | None = None):
    """The GetOccupancyMap service: occupancy of a keyframe subset (method
    1) or of projected points (method 2), at a requested resolution.
    Returns (int8 grid, resolution)."""
    if method == 1:
        occ = occupancy_grid_method1(state, model, frames)
    else:
        occ = occupancy_grid_method2(state, model, points, pmask)
    res = model.config.resolution
    if resolution is not None and resolution > 0 and abs(
            resolution - res) > res * 1e-1:
        occ = resample_grid(occ, res, resolution)
        res = resolution
    return occ, res


def occupancy_grid_method2(state: MappingState, model: SubmapModel,
                           points: torch.Tensor,
                           pmask: torch.Tensor) -> torch.Tensor:
    """Point-projection occupancy of (P, 2) global-frame points: -1 unknown,
    0 observed free (in any submap's footprint), 100 within the inflation
    radius of a projected point."""
    cfg = model.config
    dev = model.device
    n = cfg.rows * cfg.cols

    # observed: the cells any valid submap's footprint keeps
    idx, keep = _splat(model, state.kf_poses, state.kf_valid, _div_exact)
    free = torch.zeros(n, device=dev).scatter_reduce_(
        0, idx[keep], torch.ones(int(keep.sum()), device=dev), "amax")
    free = (free > 0).reshape(cfg.rows, cfg.cols)

    pmask = remove_outlier(points, pmask, cfg.outlier_filter_radius,
                           cfg.outlier_filter_min_points)
    r = torch.round(_div_exact(points[:, 1] - cfg.y0, cfg.resolution)).to(torch.int64)
    c = torch.round(_div_exact(points[:, 0] - cfg.x0, cfg.resolution)).to(torch.int64)
    ok = pmask & (r >= 0) & (r < cfg.rows) & (c >= 0) & (c < cfg.cols)
    occ_mask = torch.zeros(n, device=dev).scatter_reduce_(
        0, (r * cfg.cols + c)[ok], torch.ones(int(ok.sum()), device=dev),
        "amax").reshape(cfg.rows, cfg.cols)

    # ellipse (circular) dilation by a 0/1 convolution (cv2.dilate with
    # MORPH_ELLIPSE)
    hs = int(np.ceil(cfg.inflation_radius / cfg.resolution))
    y, x = np.mgrid[-hs:hs + 1, -hs:hs + 1]
    kernel = torch.as_tensor(
        ((x / max(hs, 1)) ** 2 + (y / max(hs, 1)) ** 2 <= 1.0 + 1e-6)
        .astype(np.float32), device=dev)
    dil = F.conv2d(occ_mask[None, None], kernel[None, None], padding=hs)[0, 0]

    out = torch.full((cfg.rows, cfg.cols), -1, dtype=torch.int8, device=dev)
    out[free] = 0
    out[dil > 0] = 100
    return out


def submap_intensity(img: torch.Tensor, model: SubmapModel) -> torch.Tensor:
    """A polar ping downsampled to the submap grid, flattened to (S,): the
    per-keyframe payload of ``intensity_grid``."""
    R, C = model.shape
    return img[::model.r_skip, ::model.c_skip][:R, :C].reshape(-1).to(torch.float32)


def intensity_grid(state: MappingState, model: SubmapModel,
                   kf_intensity: torch.Tensor) -> torch.Tensor:
    """Average-intensity map from (K, S) per-keyframe intensities: -1 where
    unobserved, else round(sum / 255 * 100 / count) over the kept cells."""
    cfg = model.config
    dev = model.device
    n = cfg.rows * cfg.cols
    idx, keep = _splat(model, state.kf_poses, state.kf_valid, _div_exact)
    cells = idx[keep]
    sums = torch.zeros(n, device=dev).index_put_(
        (cells,), kf_intensity.to(torch.float32)[keep], accumulate=True)
    counts = torch.zeros(n, device=dev).index_put_(
        (cells,), torch.ones(cells.shape[0], device=dev), accumulate=True)
    avg = torch.round(_div_exact(sums, 255.0) * 100.0 / torch.clamp(counts, min=1.0))
    out = torch.where(counts > 0, avg, torch.full_like(avg, -1.0)).to(torch.int8)
    return out.reshape(cfg.rows, cfg.cols)


def grow(config: MappingConfig, state: MappingState, pad_m: float = 50.0):
    """Pad the map by ``pad_m`` on all four sides (the reference's
    ``adjust_bounds`` steps). Returns (new config, new state)."""
    new_cfg = dataclasses.replace(
        config, x0=config.x0 - pad_m, y0=config.y0 - pad_m,
        width=config.width + 2 * pad_m, height=config.height + 2 * pad_m)
    pad = int(round(pad_m / config.resolution))
    grid = torch.zeros((new_cfg.rows, new_cfg.cols), dtype=state.grid.dtype,
                       device=state.grid.device)
    grid[pad:pad + config.rows, pad:pad + config.cols] = state.grid
    return new_cfg, state._replace(grid=grid)


def save_submaps(path: str, config: MappingConfig, state: MappingState,
                 model: SubmapModel) -> None:
    """The per-submap debug dump (the reference's ``save_submaps``): an npz
    with ``poses`` (K', 3) and ``logodds`` (K', S) of the valid keyframes,
    ``cell_xy`` (S, 2) the raster's local cell coordinates and ``map_size`` =
    (x0, y0, width, height, resolution)."""
    nk = int(state.num_kf)
    valid = state.kf_valid[:nk].cpu().numpy()
    with open(path, "wb") as f:
        np.savez_compressed(
            f,
            poses=state.kf_poses[:nk].cpu().numpy()[valid],
            logodds=state.kf_logodds[:nk].cpu().numpy()[valid],
            cell_xy=model.sonar_xy.cpu().numpy(),
            map_size=np.asarray([config.x0, config.y0, config.width,
                                 config.height, config.resolution], np.float32),
        )
