"""``replay(frontend="kalman")``, the Kalman filter with the default
configuration adapted to the bag's IMU rate, on tests/test_frontends.py's
small bag in both packages on the CPU: the same keyframes, loop log and
feature masks, the odometry at the ticks within 1e-4 m, and the trajectory
against the JAX results (see ``test_torch_frontends.check_small_replay``).

Measured: the trajectory lies 2.0e-6 m from the JAX scan fed the port's
keyframe inputs and 1.5e-5 m from the JAX replay's own; the odometry
differs by at most 2.1e-5 m.

Whether the SLAM ends better or worse than the odometry it starts from is
the reference algorithm's behaviour, and the port's follows it: on the small
bag both packages end better (ATE 0.0540 m against 0.0814 m for the
odometry at the keyframes). On the full survey the card's Kalman replay ends
worse (0.2283 m against 0.2139 m); that size does not run here.
``PYTHONPATH=. python tests/test_torch_replay_kalman.py`` replays the full
survey's streams with its pings rendered at 128 x 64 and 1 Hz (the small
configuration, 160 keyframe slots; about 20 minutes on the CPU) through
both front ends in both packages. Measured: ``kalman`` JAX 0.1963 m, port 0.1889 m against the
odometry's 0.2110 m; ``dr`` JAX 0.5211 m, port 0.4984 m against 0.4016 m,
both packages with the same keyframes (96 and 102) and loops (32): the JAX
package's own SLAM ends worse than its odometry there.
"""

import dataclasses

import pytest
import torch

from sonar_slam_torch.pipeline import ate_rmse
from test_torch_frontends import FULL_SIM, check_small_replay, small_replays

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def replays():
    return small_replays(frontend="kalman")


def test_replay_matches_jax(replays):
    check_small_replay(replays, odo_atol=1e-4, scan_atol=5e-4, own_atol=1e-4)


def _ates(bag, res):
    """(SLAM ATE, odometry ATE) at the keyframes."""
    truth = bag.true_pose_at_ping[res.keyframe_ping_idx][: res.num_keyframes]
    return ate_rmse(res.trajectory, truth), ate_rmse(res.dr_trajectory, truth)


def test_slam_against_its_odometry_as_the_reference(replays):
    bag, _, _, jres, tres = replays
    (j_slam, j_odo), (t_slam, t_odo) = _ates(bag, jres), _ates(bag, tres)
    assert (t_slam < t_odo) == (j_slam < j_odo)
    assert abs(t_odo - j_odo) < 1e-4 and abs(t_slam - j_slam) < 1e-4
    assert j_slam < j_odo


if __name__ == "__main__":
    import test_torch_frontends as T

    small = T.small_dims
    T.small_dims = lambda: dataclasses.replace(small(), max_keyframes=160,
                                               max_loops=32)
    sim = dict(FULL_SIM, sonar_rate=1.0, num_ranges=128, num_bearings=64,
               gyro_rate=20.0)
    for frontend in ("kalman", "dr"):
        bag, _, _, jres, tres = small_replays(sim=sim, frontend=frontend)
        for name, res in (("JAX", jres), ("port", tres)):
            slam, odo = _ates(bag, res)
            print(f"{frontend} {name}: {res.num_keyframes} keyframes, "
                  f"{int(res.carry.num_loops)} loops, ATE {slam:.4f} m, "
                  f"odometry {odo:.4f} m", flush=True)
