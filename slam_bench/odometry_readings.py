#!/usr/bin/env python3
"""Readings that set a cell's odometry limit, ``odom_gap_m``, and read the
heading that no limit of the ``replay`` driver compares (not run by the
benchmark's runs).

    python3 slam_bench/odometry_readings.py --workload <cell> --seeds 1,2 \
        [--out FILE]

For each seed, on the card, the cell's survey through its front end: the
plain reference's odometry in float32 (TF32 off), and against it, as
``drivers/replay.py::compare`` compares them (``odom_gap_m``, the widest gap
of x, y or z at a tick), and by ``heading_gap`` (``*_heading_rad``, the
widest gap of the yaw, wrapped):

* ``program``: the program's odometry (``pipeline.odometry``);
* ``witness``: the program's odometry with every value of the Kalman
  filter's input moved up by one unit in the last place (what a sound
  reordering of its float32 arithmetic may hand on): the lower reading;
* ``control``: the reference computed with TF32 matrix products, the
  nearest precision below the configuration's float32: the upper reading.

A limit lies between the two where the control reads above the witness.
Prints one JSON line a seed and appends it to ``--out``. The witness needs
``frontend="kalman"``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def heading_gap(a, b) -> float:
    """The widest gap of two headings, in radians, wrapped to [-pi, pi)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    d = np.remainder(a - b + math.pi, 2 * math.pi) - math.pi
    return float(np.max(np.abs(d))) if d.size else 0.0


def readings(cell, seed: int, dev) -> dict:
    import torch

    from slam_bench import simulate
    from slam_bench.harness import check, configs
    from slam_bench.harness.common import patched
    from slam_bench.reference import precision, stages
    from sonar_slam_torch import pipeline

    cfg = cell.config
    frontend = cfg["frontend"]
    bag = simulate.simulate_bag(configs.sim_config(cfg, seed))
    ref_built = configs.build(cfg, configs.reference_types(), dev)
    port_built = configs.build(cfg, configs.port_types(), dev)
    pbag = configs.with_geometry(bag, configs.port_types())
    rbag = configs.with_geometry(bag, configs.reference_types())
    out = {"workload": cell.name, "seed": seed, "seconds": {}}

    def reference(prec):
        precision.use(prec)
        try:
            t0 = time.time()
            _, poses, _ = stages.odometry(rbag, ref_built.dims, ref_built.dr,
                                          dev, frontend)
            poses = stages.host(poses)
            out["seconds"]["reference_" + prec] = time.time() - t0
            return poses
        finally:
            precision.use("float32")

    def program():
        t0 = time.time()
        _, poses, _ = pipeline.odometry(pbag, dev, frontend, port_built.dr)
        poses = poses.cpu().numpy()
        out["seconds"].setdefault("program", time.time() - t0)
        return poses

    def one_ulp_up(scan):
        def nudged(types, z, config):
            return scan(types, torch.nextafter(z, torch.full_like(z, math.inf)),
                        config)
        return nudged

    def gaps(name, poses):
        out[name] = check.max_abs(poses[:, :3], ref[:, :3])
        out[name + "_heading_rad"] = heading_gap(poses[:, 5], ref[:, 5])

    ref = reference("float32")
    gaps("program", program())
    with patched([(pipeline, "kalman_scan", one_ulp_up(pipeline.kalman_scan))]):
        gaps("witness", program())
    gaps("control", reference("tf32"))
    out["ticks"] = int(ref.shape[0])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    import run as bench_run

    cell = bench_run.Cell.find(bench_run.load_json("BENCHMARK.json"),
                               args.workload)
    if cell.config["frontend"] != "kalman":
        print("the witness moves the Kalman filter's input: the cell's front "
              "end is not kalman", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA card: the control computes in TF32", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    print(f"card: {bench_run.power_limit()}", flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = readings(cell, seed, dev)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    sys.path.insert(0, HERE)
    sys.exit(main())
