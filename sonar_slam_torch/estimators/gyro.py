"""Fiber-optic gyro delta-angle integrator.

Counterpart of ``sonar_slam_tpu/estimators/gyro.py``: each message's delta
angles are rotated by the gyro->sonar mount offset, the earth's rotation
rate (from the latitude) is added to the roll channel, and the angles are
integrated. The integral is a plain sum, so the whole stream is one matmul
and a cumulative sum. The sum runs in another order than the JAX package's
on the card, so the angles agree with it to float32 rounding of the sum.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GyroConfig(NamedTuple):
    offset_matrix: torch.Tensor  # (3, 3) gyro->sonar rotation, on the device
    latitude: float = 0.7106  # radians
    sensor_rate: float = 250.0
    roll0: float = math.pi / 2
    pitch0: float = 0.0
    yaw0: float = 0.0

    @property
    def earth_rate(self) -> float:
        """Earth rotation compensation per second: -15.04107 sin(latitude) /
        3600."""
        return -15.04107 * math.sin(self.latitude) / 3600.0


def gyro_integrate(deltas: torch.Tensor, config: GyroConfig) -> torch.Tensor:
    """Integrate (T, 3) delta-angle messages -> (T, 3) (yaw, pitch, roll)."""
    arr = torch.matmul(deltas, config.offset_matrix)
    d_roll = arr[:, 2] + config.earth_rate / config.sensor_rate
    # one scan of three rows: on a card a single long row is scanned by
    # CUB's decoupled look-back, whose float sums are associated in an order
    # that depends on timing; rows take ATen's row scan, the same every run
    sums = torch.cumsum(torch.stack([arr[:, 0], arr[:, 1], d_roll]), dim=1)
    yaw = config.yaw0 + sums[0]
    pitch = config.pitch0 + sums[1]
    roll = config.roll0 + sums[2]
    return torch.stack([yaw, pitch, roll], dim=-1)
