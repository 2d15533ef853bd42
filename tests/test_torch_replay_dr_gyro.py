"""``replay(frontend="dr_gyro")``, dead reckoning with the FOG yaw, on
tests/test_frontends.py's small bag in both packages on the CPU: the same
keyframes, loop log and feature masks, the odometry at the ticks within
1e-4 m, and the trajectory against the JAX results (see
``test_torch_frontends.check_small_replay``).

Measured: the trajectory lies 1.5e-4 m from the JAX scan fed the port's
keyframe inputs and 2.6e-3 m from the JAX replay's own, whose odometry
differs from the port's by at most 5.7e-6 m (the cumulative sum gap of
ROADMAP queue 3): this survey's loops move the trajectory by millimetres
for microns of input, in either package.
"""

import torch

from test_torch_frontends import check_small_replay, small_replays

torch.set_num_threads(1)


def test_replay_matches_jax():
    check_small_replay(small_replays(frontend="dr_gyro"),
                       odo_atol=1e-4, scan_atol=5e-4, own_atol=5e-3)
