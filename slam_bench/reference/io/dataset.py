"""Host-side stream alignment (numpy), feeding the dead-reckoning pass.

Counterpart of ``sonar_slam_tpu/io/dataset.py`` on its numpy path: ticks
fire at DVL samples, each matched to the nearest IMU within ``imu_slop`` and
the last depth at or before it; pings pair with their nearest tick within
0.5 s.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..estimators.dead_reckoning import DRTicks


class SensorStreams(NamedTuple):
    """Raw time-sorted sensor arrays (host memory)."""

    imu_time: np.ndarray
    imu_rpy: np.ndarray
    dvl_time: np.ndarray
    dvl_vel: np.ndarray
    depth_time: np.ndarray
    depth: np.ndarray
    gyro_time: np.ndarray | None = None
    gyro_yaw: np.ndarray | None = None


class DRTickBundle(NamedTuple):
    ticks: DRTicks
    tick_time: np.ndarray  # (T,) host copy for ping matching


def _nearest(ref_times: np.ndarray, query_times: np.ndarray):
    """Index of the nearest ref time for each query; (idx, |dt|)."""
    if len(ref_times) == 0:
        return (
            np.zeros(len(query_times), np.int64),
            np.full(len(query_times), np.inf),
        )
    pos = np.searchsorted(ref_times, query_times)
    lo = np.clip(pos - 1, 0, len(ref_times) - 1)
    hi = np.clip(pos, 0, len(ref_times) - 1)
    pick_hi = np.abs(ref_times[hi] - query_times) < np.abs(
        ref_times[lo] - query_times
    )
    idx = np.where(pick_hi, hi, lo)
    return idx, np.abs(ref_times[idx] - query_times)


def _last_at_or_before(ref_times: np.ndarray, query_times: np.ndarray):
    """Index of the last ref time <= query; -1 when none."""
    if len(ref_times) == 0:
        return np.full(len(query_times), -1, np.int64)
    return np.searchsorted(ref_times, query_times, side="right") - 1


def build_dr_ticks(
    streams: SensorStreams,
    device: torch.device,
    imu_slop: float = 0.1,
    gyro_slop: float = 0.1,
) -> DRTickBundle:
    """Synchronize (IMU, DVL[, gyro], depth) into dead-reckoning ticks on
    ``device``. A missing depth or an IMU sample beyond the slop invalidates
    the tick."""
    t = streams.dvl_time
    imu_idx, imu_dt = _nearest(streams.imu_time, t)
    dep_idx = _last_at_or_before(streams.depth_time, t)
    valid = (imu_dt <= imu_slop) & (dep_idx >= 0)

    euler = streams.imu_rpy[imu_idx]
    depth = np.where(dep_idx >= 0, streams.depth[np.clip(dep_idx, 0, None)], 0.0)

    if streams.gyro_time is not None:
        g_idx, g_dt = _nearest(streams.gyro_time, t)
        gyro_yaw = streams.gyro_yaw[g_idx]
        valid = valid & (g_dt <= gyro_slop)
    else:
        gyro_yaw = np.zeros_like(t)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    ticks = DRTicks(
        time=f32(t),
        vel=f32(streams.dvl_vel),
        euler=f32(euler),
        gyro_yaw=f32(gyro_yaw),
        depth=f32(depth),
        valid=torch.as_tensor(np.asarray(valid), device=device),
    )
    return DRTickBundle(ticks=ticks, tick_time=t)


def match_pings_to_ticks(
    ping_times: np.ndarray,
    tick_times: np.ndarray,
    slop: float = 0.5,
):
    """Pair each sonar ping with its nearest DR tick. Returns (tick_idx (T,),
    valid (T,))."""
    idx, dt = _nearest(tick_times, ping_times)
    return idx, dt <= slop
