"""Which frontend stage loses the far/wide wall structure the map misses?

Counterpart of ``scripts/frontier_coverage_probe.py``, with its flags
(``--full``, ``--alg``, ``--pfa``) and JSON keys. For every 5th ping of the
seed-0 survey (``cli.error_budget``'s sim config), count how many truth
scatterers inside THAT ping's FOV wedge are covered (within 0.4 m) by:

  A. raw CFAR+intensity detections (pre-voxel),
  B. the voxel top-k cloud (pre-outlier-removal),
  C. the final cloud (post outlier removal),

and the voxel-occupancy count vs the max_points capacity (is the
count-ranked top-k binding?). Each ping's detections are one
``FeatureExtractor.detections`` call on a one-ping stack: the CFAR kernel of
``--alg`` on a card (``cfar_os_mask_kernel`` for OS), its plain version on
the CPU.

It runs on the CUDA card unless ``--cpu`` is given; without a card it exits
with an error rather than run on the CPU. ``main`` returns the report for
in-process callers.

Usage: python -m sonar_slam_torch.cli.frontier_coverage_probe [--full]
           [--alg SOCA|OS|CA|GOCA] [--pfa P] [--cpu]
"""

from __future__ import annotations

import argparse
import json
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from . import device_from_args


class CoverageProbeRun(NamedTuple):
    """What ``main`` computed, for callers that run it in process."""

    report: dict  # as printed


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sonar_slam_torch.cli.frontier_coverage_probe",
        description="Coverage of the truth scatterers by each front-end "
                    "stage, on a CUDA card (or the CPU).")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--alg", default="SOCA")
    ap.add_argument("--pfa", type=float, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the CUDA card)")
    return ap


def main(argv=None) -> CoverageProbeRun:
    args = _parser().parse_args(argv)
    device = device_from_args(args.cpu, "coverage probe")
    full = args.full

    from ..cloud import remove_outlier
    from ..io.simulate import simulate_bag
    from ..slam import FeatureConfig, FeatureExtractor
    from .error_budget import setups

    sim0, dims, _ = setups(full)
    bag = simulate_bag(replace(sim0, seed=0))
    fc = FeatureConfig(max_points=dims.max_points, alg=args.alg)
    if args.pfa is not None:
        fc = fc._replace(pfa=args.pfa)
    ext = FeatureExtractor(fc, bag.geometry, device)
    geom = bag.geometry
    half_ap = 0.5 * float(geom.bearings[-1] - geom.bearings[0])

    # every ~5th ping as a pseudo-keyframe
    sel = np.arange(0, len(bag.ping_time), 5)
    world = bag.world_points.astype(np.float64)
    tol = 0.4

    def cover(local_pts, mask, wedge_truth_local):
        if not len(wedge_truth_local) or not mask.any():
            return 0.0
        p = local_pts[mask]
        d = np.linalg.norm(
            wedge_truth_local[:, None, :] - p[None, :, :], axis=-1
        ).min(1)
        return float((d <= tol).mean())

    stats = {"A_raw": [], "B_voxel": [], "C_final": [], "n_occupied_vox": [],
             "n_wedge_truth": []}
    miss_rng, hit_rng, miss_abs_brg, hit_abs_brg = [], [], [], []
    for k in sel:
        pose = bag.true_pose_at_ping[k]
        c, s = np.cos(pose[2]), np.sin(pose[2])
        rel = world - pose[:2]
        lx = c * rel[:, 0] + s * rel[:, 1]
        ly = -s * rel[:, 0] + c * rel[:, 1]
        rng = np.hypot(lx, ly)
        brg = np.arctan2(ly, lx)
        vis = (rng > 0.5) & (rng < geom.max_range * 0.98) & (
            np.abs(brg) < half_ap)
        wt = np.stack([lx[vis], ly[vis]], -1)
        stats["n_wedge_truth"].append(len(wt))

        img = torch.as_tensor(bag.ping_images[k: k + 1], dtype=torch.float32,
                              device=device)
        det_t = ext.detections(img)
        det = det_t[0].cpu().numpy()
        # raw detection points at exact cell centers (polar -> xy)
        rr, cc = np.nonzero(det)
        rho = (rr + 1) * geom.range_resolution
        beta = np.asarray(geom.bearings)[cc]
        raw = np.stack([rho * np.cos(beta), rho * np.sin(beta)], -1)
        stats["A_raw"].append(cover(raw, np.ones(len(raw), bool), wt))
        if len(wt) and len(raw):
            d = np.linalg.norm(
                wt[:, None, :] - raw[None, :, :], axis=-1).min(1)
            wr, wb = rng[vis], np.abs(brg[vis])
            miss_rng.extend(wr[d > tol]); hit_rng.extend(wr[d <= tol])
            miss_abs_brg.extend(np.rad2deg(wb[d > tol]))
            hit_abs_brg.extend(np.rad2deg(wb[d <= tol]))

        # voxel stage (pre-outlier): rebuild via binner
        flat = det_t.reshape(1, -1)
        pts, mask, conf = ext._binner(
            flat & (img.reshape(1, -1) > fc.threshold), fc.max_points,
            img.reshape(1, -1), None, min_hits=1)
        pts_n, mask_n = pts[0].cpu().numpy(), mask[0].cpu().numpy()
        stats["B_voxel"].append(cover(pts_n, mask_n, wt))
        stats["n_occupied_vox"].append(int(mask_n.sum()))

        mask2 = remove_outlier(pts, mask, fc.outlier_radius,
                               fc.outlier_min_points)[0].cpu().numpy()
        stats["C_final"].append(cover(pts_n, mask2, wt))

    out = {
        "config": "full" if full else "small",
        "max_points": fc.max_points,
        "kf_count": len(sel),
        "mean_wedge_truth": round(float(np.mean(stats["n_wedge_truth"])), 1),
        "mean_occupied_vox": round(
            float(np.mean(stats["n_occupied_vox"])), 1),
        "capacity_binding_frac": round(float(np.mean(
            np.asarray(stats["n_occupied_vox"]) >= fc.max_points)), 2),
        "coverage_A_raw": round(float(np.mean(stats["A_raw"])), 3),
        "coverage_B_voxel": round(float(np.mean(stats["B_voxel"])), 3),
        "coverage_C_final": round(float(np.mean(stats["C_final"])), 3),
        "alg": args.alg, "pfa": fc.pfa,
        "miss_range_med_m": round(float(np.median(miss_rng)), 1)
        if miss_rng else None,
        "hit_range_med_m": round(float(np.median(hit_rng)), 1)
        if hit_rng else None,
        "miss_absbrg_med_deg": round(float(np.median(miss_abs_brg)), 1)
        if miss_abs_brg else None,
        "hit_absbrg_med_deg": round(float(np.median(hit_abs_brg)), 1)
        if hit_abs_brg else None,
    }
    print(json.dumps(out, indent=1))
    return CoverageProbeRun(report=out)


if __name__ == "__main__":
    main()
