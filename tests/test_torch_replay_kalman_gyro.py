"""``replay(frontend="kalman")`` with the FOG corrections (``use_gyro``), on
tests/test_frontends.py's small bag in both packages on the CPU: the same
keyframes, loop log and feature masks, the odometry at the ticks within
1e-4 m, and the trajectory against the JAX results (see
``test_torch_frontends.check_small_replay``).

Measured: the trajectory lies 4.0e-4 m from the JAX scan fed the port's
keyframe inputs and from the JAX replay's own.
"""

import torch

from test_torch_frontends import check_small_replay, small_replays

torch.set_num_threads(1)


def test_replay_matches_jax():
    check_small_replay(small_replays(frontend="kalman", kalman_gyro=True),
                       odo_atol=1e-4, scan_atol=1e-3, own_atol=1e-3)
