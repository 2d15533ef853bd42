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
                  ``--check`` against the same replay at capacity 128

Each runs on a CUDA card, or on the CPU with ``--cpu``; without a card and
without ``--cpu`` it exits with an error.
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
