"""Repeated-run benchmark harness: every bag replayed RUNS times under a
timeout, each run's artifacts kept for overlay plotting with
``cli.plot_runs``.

Counterpart of ``scripts/run_repeats.sh`` (the analog of the reference's
``run_bag.sh``: 10 runs per bag). It takes the same positional bags, and
``RUNS``, ``TIMEOUT`` (seconds) and ``OUTDIR`` from the environment with the
same defaults (10, 300, ``runs``); each can also be given as a flag. With no
bag it first writes a synthetic survey to ``OUTDIR/survey.npz``
(``cli.simulate_bag``'s defaults) unless that file exists. Each run is

    python -m sonar_slam_torch.cli.replay --file BAG --out OUTDIR/NAME_runI --no-map

in a subprocess under the timeout; as in the shell script, a run that fails
or times out does not stop the loop. ``--cpu`` is passed on to every run.
On a card the CFAR kernels are built once, here, before the first run, so
that no run compiles them.

It runs on the CUDA card unless ``--cpu`` is given; without a card it exits
with an error rather than run on the CPU. ``main`` returns each run's exit
code (``None`` for a run cut by the timeout) for in-process callers.

Usage: RUNS=10 python -m sonar_slam_torch.cli.run_repeats [bag.npz ...]
       python -m sonar_slam_torch.cli.run_repeats --runs 2 --outdir runs --cpu
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import NamedTuple

from . import device_from_args

# the directory that holds the sonar_slam_torch package, put on the runs'
# PYTHONPATH so that they import this copy of it from any working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class RepeatsRun(NamedTuple):
    """What ``main`` did, for callers that run it in process."""

    outdir: str
    runs: list  # (bag name, run index from 1, run directory, exit code or None)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sonar_slam_torch.cli.run_repeats",
        description="Replay each bag RUNS times with cli.replay, each run "
                    "in a subprocess under a timeout, on a CUDA card (or the "
                    "CPU).")
    ap.add_argument("bags", nargs="*", help=".npz bag bundles")
    ap.add_argument("--runs", type=int, default=int(os.environ.get("RUNS", 10)))
    ap.add_argument("--timeout", type=float,
                    default=float(os.environ.get("TIMEOUT", 300)))
    ap.add_argument("--outdir", default=os.environ.get("OUTDIR", "runs"))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the CUDA card)")
    return ap


def main(argv=None) -> RepeatsRun:
    args = _parser().parse_args(argv)
    device = device_from_args(args.cpu, "replay")
    if device.type == "cuda":
        from ..kernels.cfar_cuda import build

        build()
    os.makedirs(args.outdir, exist_ok=True)

    bags = list(args.bags)
    if not bags:
        bag = os.path.join(args.outdir, "survey.npz")
        if not os.path.isfile(bag):
            from . import simulate_bag

            simulate_bag.main(["--out", bag])
        bags = [bag]

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    runs = []
    for bag in bags:
        name = os.path.splitext(os.path.basename(bag))[0]
        for i in range(1, args.runs + 1):
            print(f"=== {name} run {i}/{args.runs} ===", flush=True)
            out = os.path.join(args.outdir, f"{name}_run{i}")
            cmd = [sys.executable, "-m", "sonar_slam_torch.cli.replay",
                   "--file", bag, "--out", out, "--no-map"]
            if args.cpu:
                cmd.append("--cpu")
            try:
                rc = subprocess.run(cmd, env=env, timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                print(f"{name} run {i} timed out after {args.timeout:g} s",
                      flush=True)
                rc = None
            runs.append((name, i, out, rc))
    print(f"done; overlay with: python -m sonar_slam_torch.cli.plot_runs "
          f"{args.outdir}")
    return RepeatsRun(outdir=args.outdir, runs=runs)


if __name__ == "__main__":
    main()
