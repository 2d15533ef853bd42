"""Lateral-rich DVL y-scale recovery lane.

Counterpart of ``scripts/yscale_lane.py``, with its flags (``--tpu`` has no
counterpart), printed lines and JSON keys. The production bench trajectory
is a ~4 deg crab where lateral body velocity is ~7% of forward, so the
y-axis DVL scale is unobservable there. This lane replays the FULL
production pipeline (``cli.error_budget``'s configs) on a 20 deg-crab survey
(lateral velocity ~36% of forward) over N seeds and scores per-axis scale
recovery end to end. ATE is reported too, but the lane's contract is scale
recovery: a 20 deg crab rotates the sonar FOV off the track tangent, which
degrades revisit co-visibility.

It runs on the CUDA card unless ``--cpu`` is given; without a card it exits
with an error rather than run on the CPU. ``main`` returns the summary for
in-process callers.

Usage: python -m sonar_slam_torch.cli.yscale_lane [--seeds 3] [--out FILE]
                                                  [--cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace
from typing import NamedTuple

import numpy as np

from . import device_from_args, sync


class YScaleRun(NamedTuple):
    """What ``main`` computed, for callers that run it in process."""

    summary: dict  # the printed JSON summary (``per_seed`` included)
    results: list  # pipeline.ReplayResult of each seed


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sonar_slam_torch.cli.yscale_lane",
        description="Replay the full production pipeline on a crabbing "
                    "survey on a CUDA card (or the CPU) and score the "
                    "per-axis DVL scale recovery.")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--crab", type=float, default=20.0)
    ap.add_argument("--min-hits", type=int, default=1,
                    help="FeatureConfig.min_voxel_hits (production: 1 — the "
                         "hard gate starves the count-priced gates)")
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the CUDA card)")
    return ap


def main(argv=None) -> YScaleRun:
    args = _parser().parse_args(argv)
    device = device_from_args(args.cpu, "y-scale lane")

    from ..io.simulate import simulate_bag
    from ..pipeline import ate_rmse, replay
    from ..slam import FeatureConfig
    from .error_budget import bench_params, bench_rparams, setups

    sim0, dims, kf_t = setups(True)
    sim0 = replace(sim0, crab_deg=args.crab)
    params = bench_params(dims, kf_t, True, device)
    fc = FeatureConfig(max_points=dims.max_points,
                       min_voxel_hits=max(args.min_hits, 1))
    rp = bench_rparams(True, device)

    per_seed, results = [], []
    for seed in range(args.seeds):
        bag = simulate_bag(replace(sim0, seed=seed))
        t0 = time.time()
        res = replay(bag, fc, params, dims, device, refine_params=rp)
        sync(device)
        wall = time.time() - t0
        nk = res.num_keyframes
        truth = bag.true_pose_at_ping[res.keyframe_ping_idx][:nk]
        est = 1.0 / np.exp(res.carry.graph.log_scale.cpu().numpy())
        true = np.asarray(bag.true_dvl_scale)[:2]
        rec = {
            "seed": seed,
            "crab_deg": args.crab,
            "est_scale_xy": [round(float(v), 5) for v in est],
            "true_scale_xy": [round(float(v), 5) for v in true],
            "x_err_pct": round(abs(float(est[0] - true[0])) * 100, 3),
            "y_err_pct": round(abs(float(est[1] - true[1])) * 100, 3),
            "ate_cm": round(ate_rmse(res.trajectory, truth) * 100, 2),
            "loops": res.carry.num_loops,
            "wall_s": round(wall, 1),
        }
        per_seed.append(rec)
        results.append(res)
        print(json.dumps(rec), flush=True)

    ye = np.array([r["y_err_pct"] for r in per_seed])
    xe = np.array([r["x_err_pct"] for r in per_seed])
    summary = {
        "lane": "yscale",
        "crab_deg": args.crab,
        "seeds": args.seeds,
        "y_err_pct": {"mean": round(float(ye.mean()), 3),
                      "max": round(float(ye.max()), 3)},
        "x_err_pct": {"mean": round(float(xe.mean()), 3),
                      "max": round(float(xe.max()), 3)},
        "per_seed": per_seed,
    }
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return YScaleRun(summary=summary, results=results)


if __name__ == "__main__":
    main()
