"""Command-line entry points, run as ``python -m sonar_slam_torch.cli.<name>``:

  simulate_bag    write a synthetic survey as an .npz bundle
  convert_bag     convert a ROS1 bag of the BlueROV topics into a bundle
  replay          replay a bundle (or a simulated survey) and write the
                  trajectory, the carry, the occupancy map and the submap dump
  sweep           replay one bag under a grid of SLAM configs
                  (``parallel.sweep_scan``) and report each lane's ATE
  two_robot_demo  two robots survey one basin; their graphs are merged on
                  PCM-vetted inter-robot loops (``parallel.multi_robot``)
  sharded_replay  replay at a large keyframe capacity (default 1024), with
                  ``--capacity-check`` against the same replay at
                  capacity 128

``sweep``, ``two_robot_demo`` and ``sharded_replay`` take ``--devices D``:
D ranks, one process each (``parallel/mesh.py``), share the lanes, the
robots or the refinement's fan-outs; ``sharded_replay --check`` holds that
to the one-process replay.

The accuracy harnesses, on bench.py's production configurations:

  error_budget    the ATE split into four lanes (sensor noise, feature
                  noise, estimation) plus the feature fidelity RMS
  multi_seed      the production replay over N seeds: ATE, heading, loop
                  precision and recall, DVL-scale recovery
  yscale_lane     the full pipeline on a 20 deg-crab survey: per-axis DVL
                  scale recovery
  accuracy_sweep  the ATE under a grid of resolution and noise variants
  map_probe       the distance distributions behind the map metrics
  frontier_coverage_probe
                  the truth scatterers each front-end stage keeps
  run_repeats     each bag replayed N times by ``cli.replay`` in
                  subprocesses under a timeout
  plot_runs       overlay of the repeated runs' trajectories and their
                  spread (matplotlib; the spread alone needs none)

Each runs on a CUDA card, or on the CPU with ``--cpu``; without a card and
without ``--cpu`` it exits with an error. ``plot_runs`` only reads files and
takes no ``--cpu``.
"""

import sys

import torch


def device_from_args(cpu: bool, what: str) -> torch.device:
    """The CPU with ``--cpu``, else the first CUDA card; exits with an error
    when there is no card (nothing falls back to the CPU)."""
    if cpu:
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda", 0)
    sys.exit(f"no CUDA device: the {what} runs on a card; pass --cpu to run "
             "it on the CPU")


def sync(device: torch.device):
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
