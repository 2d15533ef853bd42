"""Multi-seed accuracy statistics for the benchmark configs.

Counterpart of ``scripts/multi_seed.py``, with its flags (``--tpu`` has no
counterpart), printed lines and JSON keys. It replays the production config
(``cli.error_budget``'s ``setups``, ``bench_params`` and ``bench_rparams``:
bench.py's SOCA front end, refinement and point-to-line ICP) over N seeds
and reports the ATE / heading / loop-quality / DVL-scale-recovery
distributions as one JSON blob. The loop scores are bench.py's
(``pipeline.loop_metrics``).

It runs on the CUDA card unless ``--cpu`` is given; without a card it exits
with an error rather than run on the CPU. ``main`` returns the summary for
in-process callers.

Usage:
  python -m sonar_slam_torch.cli.multi_seed --full --seeds 5 [--out FILE]
  python -m sonar_slam_torch.cli.multi_seed --seeds 5 --cpu   # small config
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from . import device_from_args, sync


class MultiSeedRun(NamedTuple):
    """What ``main`` computed, for callers that run it in process."""

    summary: dict  # the printed JSON summary (``per_seed`` included)
    results: list  # pipeline.ReplayResult of each seed


def seed_record(seed, res, bag, dims, wall, sim_s) -> dict:
    """The script's per-seed record of one replay."""
    from ..geometry import se2_between
    from ..pipeline import ate_heading_deg, ate_rmse, loop_metrics

    nk = res.num_keyframes
    truth = bag.true_pose_at_ping[res.keyframe_ping_idx][:nk]
    nl = min(res.carry.num_loops, dims.max_loops)
    li = res.carry.loops_i[:nl].cpu().numpy()
    lj = res.carry.loops_j[:nl].cpu().numpy()
    ltf = res.carry.loops_tf[:nl].cpu().numpy()
    errs = [
        float(np.linalg.norm(z[:2] - se2_between(
            torch.as_tensor(truth[a]), torch.as_tensor(truth[b])).numpy()[:2]))
        for a, b, z in zip(li, lj, ltf)
    ]
    est_corr = np.exp(res.carry.graph.log_scale.cpu().numpy())
    lm = loop_metrics(res.carry, truth, dims.nssm_min_st_sep,
                      prox_radius=0.5 * dims.max_range)
    return {
        "seed": seed,
        "precision": lm["precision"],
        "recall": lm["recall"],
        "ate_cm": round(ate_rmse(res.trajectory, truth) * 100, 2),
        "dr_ate_cm": round(
            ate_rmse(res.dr_trajectory, truth) * 100, 2),
        "heading_deg": round(
            ate_heading_deg(res.trajectory, truth), 3),
        "keyframes": nk,
        "loops": nl,
        "loop_err_median_cm": round(
            float(np.median(errs)) * 100, 2) if errs else None,
        "est_dvl_scale_xy": [round(float(v), 5) for v in 1.0 / est_corr],
        "true_dvl_scale_xy": [
            round(float(v), 5)
            for v in np.asarray(bag.true_dvl_scale)[:2]],
        "wall_s": round(wall, 2),
        "sim_s": round(sim_s, 1),
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sonar_slam_torch.cli.multi_seed",
        description="Replay the production config over N seeds on a CUDA "
                    "card (or the CPU) and report the accuracy distributions.")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--out", default="")
    ap.add_argument("--corroborate", type=int, default=-1,
                    help="1/0 = force the temporal speckle gate on/off "
                         "(-1 = FeatureConfig default)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the CUDA card)")
    return ap


def main(argv=None) -> MultiSeedRun:
    args = _parser().parse_args(argv)
    device = device_from_args(args.cpu, "multi-seed replay")

    from ..io.simulate import simulate_bag
    from ..pipeline import replay
    from ..slam import FeatureConfig
    from .error_budget import bench_params, bench_rparams, setups

    sim0, dims, kf_t = setups(args.full)
    params = bench_params(dims, kf_t, args.full, device)
    fc = FeatureConfig(max_points=dims.max_points)
    if args.corroborate >= 0:
        fc = fc._replace(corroborate=bool(args.corroborate))

    per_seed, results = [], []
    for seed in range(args.seeds):
        sim = replace(sim0, seed=seed)
        t0 = time.time()
        bag = simulate_bag(sim)
        sim_s = time.time() - t0
        t0 = time.time()
        res = replay(bag, fc, params, dims, device,
                     refine_params=bench_rparams(args.full, device))
        sync(device)
        wall = time.time() - t0
        rec = seed_record(seed, res, bag, dims, wall, sim_s)
        per_seed.append(rec)
        results.append(res)
        print(json.dumps(rec), flush=True)

    ates = np.array([r["ate_cm"] for r in per_seed])
    hdgs = np.array([r["heading_deg"] for r in per_seed])
    scale_err = np.array([
        abs(r["est_dvl_scale_xy"][0] - r["true_dvl_scale_xy"][0])
        for r in per_seed
    ])
    recalls = np.array([r["recall"] for r in per_seed])
    precs = np.array([r["precision"] or 0.0 for r in per_seed])
    summary = {
        "config": "full" if args.full else "small",
        "seeds": args.seeds,
        "loop_precision_min": round(float(precs.min()), 3),
        "loop_recall": {"mean": round(float(recalls.mean()), 3),
                        "min": round(float(recalls.min()), 3)},
        "ate_cm": {"mean": round(float(ates.mean()), 2),
                   "median": round(float(np.median(ates)), 2),
                   "max": round(float(ates.max()), 2)},
        "heading_deg": {"mean": round(float(hdgs.mean()), 3),
                        "max": round(float(hdgs.max()), 3)},
        "scale_x_abs_err": {"mean": round(float(scale_err.mean()), 5),
                            "max": round(float(scale_err.max()), 5)},
        "per_seed": per_seed,
    }
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return MultiSeedRun(summary=summary, results=results)


if __name__ == "__main__":
    main()
