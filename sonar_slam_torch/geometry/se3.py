"""The two pose3 helpers the replay path needs.

Counterpart of ``pose3_make`` and ``pose3_to_pose2`` in
``sonar_slam_tpu/geometry/se3.py``. A pose3 is ``[..., 6] = (x, y, z, roll,
pitch, yaw)``; the smoother works in SE(2), so the dead-reckoning pose3 is
only built and projected.
"""

from __future__ import annotations

import torch

from .se2 import wrap_angle


def pose3_make(t: torch.Tensor, rpy: torch.Tensor) -> torch.Tensor:
    """Build a pose3 6-vector from translation [..., 3] and (roll, pitch, yaw)."""
    return torch.cat([t, rpy], dim=-1)


def pose3_to_pose2(p: torch.Tensor) -> torch.Tensor:
    """Project pose3 -> (x, y, wrapped yaw)."""
    return torch.stack([p[..., 0], p[..., 1], wrap_angle(p[..., 5])], dim=-1)
