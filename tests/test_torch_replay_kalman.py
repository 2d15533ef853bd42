"""``replay(frontend="kalman")``, the Kalman filter with the default
configuration adapted to the bag's IMU rate, on tests/test_frontends.py's
small bag in both packages on the CPU: the same keyframes, loop log and
feature masks, the odometry at the ticks within 1e-4 m, and the trajectory
against the JAX results (see ``test_torch_frontends.check_small_replay``).

Measured: the trajectory lies 2.0e-6 m from the JAX scan fed the port's
keyframe inputs and 1.5e-5 m from the JAX replay's own; the odometry
differs by at most 2.1e-5 m.
"""

import torch

from test_torch_frontends import check_small_replay, small_replays

torch.set_num_threads(1)


def test_replay_matches_jax():
    check_small_replay(small_replays(frontend="kalman"),
                       odo_atol=1e-4, scan_atol=5e-4, own_atol=1e-4)
