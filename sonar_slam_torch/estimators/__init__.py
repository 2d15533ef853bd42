"""Odometry front ends: dead reckoning (optionally FOG-yaw driven), the FOG
gyro integrator and the 12-state Kalman filter."""

from .dead_reckoning import (
    DRConfig,
    DRState,
    DRTicks,
    dead_reckoning_init,
    dead_reckoning_scan,
    dead_reckoning_step,
    dead_reckoning_with_basis_scan,
    dvl_basis_scan,
    prepare_imu_euler,
)
from .gyro import GyroConfig, gyro_integrate
from .kalman import (
    EVENT_DEPTH,
    EVENT_DVL,
    EVENT_GYRO,
    EVENT_IMU,
    KalmanConfig,
    KalmanState,
    kalman_init,
    kalman_scan,
)
