"""Odometry front ends. Only dead reckoning is ported so far; the Kalman
and FOG-gyro front ends are still to come."""

from .dead_reckoning import (
    DRConfig,
    DRTicks,
    dead_reckoning_scan,
    dead_reckoning_with_basis_scan,
    dvl_basis_scan,
)
