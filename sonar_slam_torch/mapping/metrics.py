"""Map accuracy metrics against simulator ground truth.

Counterpart of ``sonar_slam_tpu/mapping/metrics.py``, copied: it is host-side
numpy, and the copy keeps the JAX package's import chain out of the port.
Occupied-cell precision and recall against the observed subset of the true
walls, and the symmetric chamfer distance, after the same Umeyama SE(2)
alignment the ATE metric uses.
"""

from __future__ import annotations

import numpy as np


def _umeyama_se2(est_xy: np.ndarray, truth_xy: np.ndarray):
    """Best-fit rotation + translation mapping ``est_xy`` onto ``truth_xy``
    (no scale). Returns a callable ``xy -> aligned xy``."""
    n = min(len(est_xy), len(truth_xy))
    a, b = est_xy[:n], truth_xy[:n]
    am, bm = a.mean(0), b.mean(0)
    U, _, Vt = np.linalg.svd((a - am).T @ (b - bm))
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, d]) @ U.T
    return lambda xy: (R @ (np.asarray(xy) - am).T).T + bm


def observed_mask(
    world_points: np.ndarray,  # (W, 2) true scatterers, world frame
    truth_poses: np.ndarray,  # (K, 3) true keyframe poses, world frame
    max_range: float,
    half_aperture: float,
    range_margin: float = 0.98,
) -> np.ndarray:
    """True scatterers inside >= 1 keyframe's sonar FOV wedge.

    Only observed structure counts toward recall — walls the survey never
    imaged are not a mapping failure. Mirrors the simulator's visibility
    predicate (`io/simulate.py::render_ping`: range < 0.98 * max_range,
    bearing within the horizontal aperture).
    """
    seen = np.zeros(len(world_points), bool)
    for pose in truth_poses:
        c, s = np.cos(pose[2]), np.sin(pose[2])
        rel = world_points - pose[:2]
        lx = c * rel[:, 0] + s * rel[:, 1]
        ly = -s * rel[:, 0] + c * rel[:, 1]
        rng = np.hypot(lx, ly)
        brg = np.arctan2(ly, lx)
        seen |= (rng > 0.5) & (rng < max_range * range_margin) & (
            np.abs(brg) < half_aperture
        )
    return seen


def occupied_cell_centers(occ: np.ndarray, config, thresh: int = 55):
    """World-frame (map-frame) centers of occupied grid cells.

    The splat convention is ``row = round((y - y0) / res)`` (occupancy.py
    ``_world_cells``), so the cell center is ``y0 + row * res``.
    """
    rr, cc = np.nonzero(np.asarray(occ) > thresh)
    return np.stack(
        [config.x0 + cc * config.resolution, config.y0 + rr * config.resolution],
        -1,
    ).astype(np.float64)


def _nn_dists(a: np.ndarray, b: np.ndarray, chunk: int = 2048) -> np.ndarray:
    """Distance from each row of ``a`` to its nearest row of ``b``."""
    if len(a) == 0:
        return np.zeros(0)
    if len(b) == 0:
        return np.full(len(a), np.inf)
    out = np.empty(len(a))
    for i in range(0, len(a), chunk):
        d = np.linalg.norm(a[i : i + chunk, None, :] - b[None, :, :], axis=-1)
        out[i : i + chunk] = d.min(axis=1)
    return out


def map_metrics(
    occ: np.ndarray,  # (H, W) int occupancy 0..100 (method-1 export)
    config,  # MappingConfig (grid geometry)
    world_points: np.ndarray,  # (W, 2) true scatterers, world frame
    truth_kf_poses: np.ndarray,  # (K, 3) true poses at keyframes
    est_kf_poses: np.ndarray,  # (K, 3) estimated keyframe poses (SLAM frame)
    max_range: float,
    half_aperture: float,
    occupied_thresh: int = 55,
    tol: float | None = None,
) -> dict:
    """Occupied-cell precision/recall + chamfer vs the true walls.

    * precision: fraction of occupied cells within ``tol`` of an observed
      true scatterer (false walls hurt it),
    * recall: fraction of observed true scatterers within ``tol`` of an
      occupied cell (missed walls hurt it),
    * chamfer_cm: symmetric mean nearest-neighbor distance.

    ``tol`` defaults to 2 map cells (0.4 m at the 0.2 m grid) — the splat +
    Gaussian inflation (`mapping.py:209-216` semantics) widens every wall by
    about the inflation radius, which is representation, not error.
    """
    if tol is None:
        tol = 2.0 * config.resolution
    cells = occupied_cell_centers(occ, config, occupied_thresh)
    align = _umeyama_se2(
        np.asarray(est_kf_poses)[:, :2], np.asarray(truth_kf_poses)[:, :2]
    )
    cells_w = align(cells) if len(cells) else cells
    seen = observed_mask(
        np.asarray(world_points, np.float64), truth_kf_poses,
        max_range, half_aperture,
    )
    truth = np.asarray(world_points, np.float64)[seen]

    d_cell = _nn_dists(cells_w, truth)
    d_truth = _nn_dists(truth, cells_w)
    n_cells, n_truth = len(cells_w), len(truth)
    return {
        "occupied_cells": int(n_cells),
        "observed_truth_points": int(n_truth),
        "precision": round(float((d_cell <= tol).mean()), 3) if n_cells else None,
        "recall": round(float((d_truth <= tol).mean()), 3) if n_truth else None,
        "chamfer_cm": round(
            float((d_cell.mean() + d_truth.mean()) / 2.0) * 100, 1
        ) if n_cells and n_truth else None,
        "tol_m": tol,
    }
