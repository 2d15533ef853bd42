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


def _rot(a: torch.Tensor, axis: int) -> torch.Tensor:
    """[..., 3, 3] rotation by angle ``a`` about axis 0 (x), 1 (y) or 2 (z)."""
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    if axis == 0:
        rows = [[o, z, z], [z, c, -s], [z, s, c]]
    elif axis == 1:
        rows = [[c, z, s], [z, o, z], [-s, z, c]]
    else:
        rows = [[c, -s, z], [s, c, z], [z, z, o]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot3_ypr(yaw: torch.Tensor, pitch: torch.Tensor,
             roll: torch.Tensor) -> torch.Tensor:
    """gtsam.Rot3.Ypr: Rz(yaw) @ Ry(pitch) @ Rx(roll) -> [..., 3, 3]."""
    return torch.matmul(torch.matmul(_rot(yaw, 2), _rot(pitch, 1)),
                        _rot(roll, 0))


def rot3_to_ypr(R: torch.Tensor) -> torch.Tensor:
    """(roll, pitch, yaw) [..., 3] of a rotation matrix (gtsam's rpy)."""
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def rot3_compose(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    return torch.matmul(Ra, Rb)


def rot3_inverse(R: torch.Tensor) -> torch.Tensor:
    return R.transpose(-1, -2)


def pose3_make(t: torch.Tensor, rpy: torch.Tensor) -> torch.Tensor:
    """Build a pose3 6-vector from translation [..., 3] and (roll, pitch, yaw)."""
    return torch.cat([t, rpy], dim=-1)


def pose3_rotmat(p: torch.Tensor) -> torch.Tensor:
    return rot3_ypr(p[..., 5], p[..., 4], p[..., 3])


def _apply(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.matmul(R, t[..., None])[..., 0]


def pose3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ∘ b for pose3 6-vectors."""
    Ra, Rb = pose3_rotmat(a), pose3_rotmat(b)
    t = a[..., :3] + _apply(Ra, b[..., :3])
    return pose3_make(t, rot3_to_ypr(torch.matmul(Ra, Rb)))


def pose3_inverse(a: torch.Tensor) -> torch.Tensor:
    RaT = rot3_inverse(pose3_rotmat(a))
    return pose3_make(-_apply(RaT, a[..., :3]), rot3_to_ypr(RaT))


def pose3_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return pose3_compose(pose3_inverse(a), b)


def pose3_to_pose2(p: torch.Tensor) -> torch.Tensor:
    """Project pose3 -> (x, y, wrapped yaw)."""
    return torch.stack([p[..., 0], p[..., 1], wrap_angle(p[..., 5])], dim=-1)


def pose2_to_pose3(p2: torch.Tensor, z=0.0, roll=0.0, pitch=0.0) -> torch.Tensor:
    """Lift (x, y, yaw) -> pose3 carrying the given z, roll and pitch."""
    shape = p2[..., 0].shape

    def full(v):
        return torch.as_tensor(v, dtype=p2.dtype, device=p2.device).expand(shape)

    return torch.stack([p2[..., 0], p2[..., 1], full(z), full(roll),
                        full(pitch), p2[..., 2]], dim=-1)


def pose3_transform_points(points: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply pose3 ``p`` to local 3-D points [..., N, 3]."""
    R = pose3_rotmat(p)
    return torch.matmul(points, R.transpose(-1, -2)) + p[..., None, :3]
