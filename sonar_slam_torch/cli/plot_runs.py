"""Overlay repeated-run trajectories for visual regression checking, and
report whether the runs repeat.

Counterpart of ``scripts/plot_runs.py`` (the analog of the reference's
``plot_runs.py``, which overlays the 10 ``run_bag.sh`` trajectories into a
PDF), with its arguments and printed lines. It reads the ``trajectory`` of
every ``RUNS_DIR/*/trajectory.npz`` (``cli.replay`` writes it, e.g. through
``cli.run_repeats``), draws them into ``--out`` (default
``RUNS_DIR/overlay.pdf``) and prints the largest spread of any run from the
first. The spread alone is ``trajectory_spread``, which needs no
matplotlib; ``main`` imports matplotlib when it draws. Nothing here runs on
a card.

Usage: python -m sonar_slam_torch.cli.plot_runs [RUNS_DIR] [--out FILE]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import NamedTuple

import numpy as np


class PlotRunsRun(NamedTuple):
    """What ``main`` did, for callers that run it in process."""

    out: str  # the overlay written
    spread: float | None  # ``trajectory_spread`` of the runs


def trajectory_files(runs_dir: str) -> list[str]:
    return sorted(glob.glob(os.path.join(runs_dir, "*", "trajectory.npz")))


def trajectory_spread(files) -> float | None:
    """Largest absolute difference of any run's trajectory from the first
    one's; ``None`` with fewer than two runs or trajectories of different
    shapes."""
    trajs = [np.load(f)["trajectory"] for f in files]
    if len(trajs) > 1 and all(t.shape == trajs[0].shape for t in trajs[1:]):
        return max(float(np.abs(t - trajs[0]).max()) for t in trajs[1:])
    return None


def main(argv=None) -> PlotRunsRun:
    ap = argparse.ArgumentParser(
        prog="python -m sonar_slam_torch.cli.plot_runs",
        description="Overlay the trajectories of repeated replay runs.")
    ap.add_argument("runs_dir", nargs="?", default="runs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    files = trajectory_files(args.runs_dir)
    if not files:
        sys.exit(f"no trajectory.npz files under {args.runs_dir}")

    fig, ax = plt.subplots(figsize=(9, 9))
    for f in files:
        t = np.load(f)["trajectory"]
        ax.plot(t[:, 0], t[:, 1], lw=0.8, alpha=0.7,
                label=os.path.basename(os.path.dirname(f)))
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(f"{len(files)} replay runs")
    if len(files) <= 12:
        ax.legend(fontsize=7)
    out = args.out or os.path.join(args.runs_dir, "overlay.pdf")
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")

    # determinism report: identical runs must produce identical trajectories
    spread = trajectory_spread(files)
    if spread is not None:
        print(f"max trajectory spread across runs: {spread:.2e} "
              f"({'deterministic' if spread == 0 else 'non-deterministic'})")
    return PlotRunsRun(out=out, spread=spread)


if __name__ == "__main__":
    main()
