#!/usr/bin/env python3
"""Readings that set a cell's limits (not run by the benchmark's runs).

    python3 slam_bench/control.py --workload <cell> --seeds 1,2,3 \
        [--program] [--control] [--witness] [--out FILE]

For each seed, in one process: with ``--program``, one pass of the program
as the cell's driver runs it, held to the reference (the lower readings);
with ``--control``, the control in the program's place: the reference
computed with TF32 (the nearest precision below the configuration's
float32), held to the float32 reference (the upper readings); with
``--witness``, the float32 reference in the program's place with every SLAM
step computed from its carry moved by one ulp (what a sound reordering of
float32 sums hands on; ``check.witness_outputs``). Prints one JSON line a
reading and appends them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def readings(cell, seed: int, sides, dev, log):
    import torch

    from slam_bench import simulate
    from slam_bench.harness import check, configs

    import run as bench_run

    bag = simulate.simulate_bag(configs.sim_config(cell.config, seed))
    mod = bench_run.driver_module(cell)

    def program():
        driver = mod.Driver(cell.config, cell.traffic, bag, dev, seed)
        driver.window(0.0)
        prog = driver.outputs()
        del driver
        torch.cuda.empty_cache()
        return prog

    make = {"program": program,
            "control": lambda: check.control_outputs(
                mod, bag, cell.config, cell.traffic, dev, seed),
            "witness": lambda: check.witness_outputs(
                mod, bag, cell.config, cell.traffic, dev, seed)}
    for side in sides:
        t0 = time.time()
        numbers = check.run_reference(mod, make[side](), bag, cell.config,
                                      cell.traffic, dev)
        ok, _ = check.judge(numbers, cell.limits)
        line = {"workload": cell.name, "seed": seed, "side": side,
                "correct": ok, "seconds": time.time() - t0,
                "numbers": numbers}
        log(json.dumps(line))
        yield line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--witness", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    import run as bench_run

    cell = bench_run.Cell.find(bench_run.load_json("BENCHMARK.json"),
                               args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the control computes in TF32", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    print(f"card: {bench_run.power_limit()}", flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        sides = [s for s in ("program", "control", "witness")
                 if getattr(args, s)]
        for line in readings(cell, seed, sides, dev,
                             lambda m: print(m, flush=True)):
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
