"""Decompose the map-metric shortfall: what drives recall and chamfer.

Counterpart of ``scripts/map_probe.py``, with its ``--full`` flag and its
JSON keys. It replays the production config (``cli.error_budget``'s), builds
the occupancy grid the way bench.py's mapping stage does
(``pipeline.occupancy_map``: every keyframe's submap log-odds in one batch,
the full repaint, the method-1 export), then reports the distance
distributions behind precision/recall/chamfer:

- d_truth quantiles (observed truth scatterer -> nearest occupied cell):
  separates "walls mapped but sparsely" (d ~ feature spacing) from
  "segments entirely missing" (d >> 1 m),
- d_cell quantiles (occupied cell -> nearest truth): how much far speckle
  cells inflate the chamfer mean,
- the same recall against the keyframes' feature points ("never featured").

It runs on the CUDA card unless ``--cpu`` is given; without a card it exits
with an error rather than run on the CPU. ``main`` returns the report for
in-process callers.

Usage: python -m sonar_slam_torch.cli.map_probe [--full] [--cpu]
"""

from __future__ import annotations

import argparse
import json
from dataclasses import replace
from typing import NamedTuple

import numpy as np

from . import device_from_args


class MapProbeRun(NamedTuple):
    """What ``main`` computed, for callers that run it in process."""

    report: dict  # as printed (the quantile keys as ints)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sonar_slam_torch.cli.map_probe",
        description="Replay the production config on a CUDA card (or the "
                    "CPU) and report the distances behind the map metrics.")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the CUDA card)")
    return ap


def main(argv=None) -> MapProbeRun:
    args = _parser().parse_args(argv)
    device = device_from_args(args.cpu, "map probe")
    full = args.full

    from ..io.simulate import simulate_bag
    from ..mapping.metrics import (_nn_dists, _umeyama_se2, observed_mask,
                                   occupied_cell_centers)
    from ..pipeline import occupancy_map, replay
    from ..slam import FeatureConfig
    from .error_budget import bench_params, bench_rparams, setups

    sim0, dims, kf_t = setups(full)
    params = bench_params(dims, kf_t, full, device)
    fc = FeatureConfig(max_points=dims.max_points, corroborate=full)
    bag = simulate_bag(replace(sim0, seed=0))
    res = replay(bag, fc, params, dims, device,
                 refine_params=bench_rparams(full, device))
    nk = res.num_keyframes
    truth_poses = bag.true_pose_at_ping[res.keyframe_ping_idx][:nk]

    occ, mcfg = occupancy_map(res.carry, bag.geometry, dims.max_keyframes)
    occ = occ.cpu().numpy()

    cells = occupied_cell_centers(occ, mcfg)
    align = _umeyama_se2(res.trajectory[:, :2], truth_poses[:, :2])
    cells_w = align(cells)
    seen = observed_mask(bag.world_points.astype(np.float64), truth_poses,
                         bag.geometry.max_range,
                         0.5 * (bag.geometry.bearings[-1]
                                - bag.geometry.bearings[0]))
    truth = bag.world_points.astype(np.float64)[seen]

    d_cell = _nn_dists(cells_w, truth)
    d_truth = _nn_dists(truth, cells_w)

    # how much of the miss is "never featured": nearest FEATURE point
    feats = []
    pm = res.carry.pmasks[:nk].cpu().numpy()
    pts = res.carry.points[:nk].cpu().numpy()
    for k in range(nk):
        p = pts[k][pm[k]]
        c, s = np.cos(res.trajectory[k, 2]), np.sin(res.trajectory[k, 2])
        R = np.array([[c, -s], [s, c]])
        feats.append(p @ R.T + res.trajectory[k, :2])
    feats = align(np.concatenate(feats))
    d_truth_feat = _nn_dists(truth, feats)

    q = [50, 75, 90, 95, 99, 100]
    out = {
        "config": "full" if full else "small",
        "n_cells": len(cells), "n_truth": len(truth),
        "precision@0.4": round(float((d_cell <= 0.4).mean()), 3),
        "recall@0.4": round(float((d_truth <= 0.4).mean()), 3),
        "recall@0.8": round(float((d_truth <= 0.8).mean()), 3),
        "d_truth_q_m": {p: round(float(np.percentile(d_truth, p)), 2)
                        for p in q},
        "d_cell_q_m": {p: round(float(np.percentile(d_cell, p)), 2)
                       for p in q},
        "d_cell_mean_m": round(float(d_cell.mean()), 2),
        "d_truth_mean_m": round(float(d_truth.mean()), 2),
        "feat_recall@0.4": round(float((d_truth_feat <= 0.4).mean()), 3),
        "d_truth_feat_q_m": {p: round(float(np.percentile(d_truth_feat, p)),
                                      2) for p in q},
    }
    print(json.dumps(out, indent=1))
    return MapProbeRun(report=out)


if __name__ == "__main__":
    main()
