"""Pose3 algebra on torch tensors.

Counterpart of ``sonar_slam_tpu/geometry/se3.py``. A pose3 is ``[..., 6] =
(x, y, z, roll, pitch, yaw)``; group operations go through rotation
matrices with gtsam's convention ``Rot3.Ypr(y, p, r) = Rz(y) @ Ry(p) @
Rx(r)``. Every function is batched over leading axes. The small matmuls run
in full float32 under ``precision.pin_fp32`` (no TF32), as the JAX package
pins ``Precision.HIGHEST``.
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


