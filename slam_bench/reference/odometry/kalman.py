"""The Kalman node at the IMU messages, as ``pipeline.odometry`` runs it for
``frontend="kalman"`` (the reference's ``estimators/kalman.py``)."""

import numpy as np

from ..estimators.kalman import EVENT_IMU, kalman_node, kalman_yaml, merged_stream


def odometry(bag, dims, dr_config, dev):
    """(times of the IMU messages, poses3 (N_imu, 6) after each, None): the
    filter gives no DVL basis integrals. ``dt_imu`` is the bag's median IMU
    period."""
    times, types, z = merged_stream(bag)
    cfg = kalman_yaml(float(np.median(np.diff(bag.imu_time))))
    return times[types == EVENT_IMU], kalman_node(types, z, cfg, dev), None
