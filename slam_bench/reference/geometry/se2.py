"""SE(2) pose algebra on torch tensors.

Counterpart of ``sonar_slam_tpu/geometry/se2.py``. A pose is a tensor
``[..., 3]`` holding ``(x, y, theta)``; every op broadcasts over leading
dimensions and follows gtsam's ``Pose2`` conventions:

* ``compose(a, b)`` = a ∘ b, ``between(a, b)`` = a⁻¹ ∘ b;
* ``expmap``/``logmap`` are the exact SE(2) maps with the V-matrix coupling;
* ``transform_points`` maps local points to the pose's parent frame.

The functions use only elementwise ops, so ``torch.func.jacfwd`` and
``torch.func.vmap`` differentiate and batch them (the factor graph does).
"""

from __future__ import annotations

import torch

_EPS = 1e-10


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def se2_rotmat(theta: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 2, 2] for heading theta [...]."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def se2_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ∘ b. Shapes [..., 3] -> [..., 3]."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    t = wrap_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, t], dim=-1)


def se2_inverse(a: torch.Tensor) -> torch.Tensor:
    """a⁻¹. Shapes [..., 3] -> [..., 3]."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(ca * a[..., 0] + sa * a[..., 1])
    y = -(-sa * a[..., 0] + ca * a[..., 1])
    return torch.stack([x, y, -a[..., 2]], dim=-1)


def se2_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a⁻¹ ∘ b — the transform taking frame a to frame b."""
    return se2_compose(se2_inverse(a), b)


def _v_coeffs(w: torch.Tensor):
    small = torch.abs(w) < _EPS
    w_safe = torch.where(small, torch.ones_like(w), w)
    sw, cw = torch.sin(w), torch.cos(w)
    # constants as tensors: forward-mode AD (torch.func.jacfwd) promotes the
    # tangent of ``0-d tensor * Python float`` to float64
    sixth = torch.full_like(w, 6.0)
    half = torch.full_like(w, 0.5)
    a = torch.where(small, 1.0 - w * w / sixth, sw / w_safe)
    b = torch.where(small, w * half, (1.0 - cw) / w_safe)
    return a, b


def se2_expmap(xi: torch.Tensor) -> torch.Tensor:
    """Exact SE(2) exponential map: xi = [vx, vy, omega] -> pose."""
    w = xi[..., 2]
    a, b = _v_coeffs(w)
    x = a * xi[..., 0] - b * xi[..., 1]
    y = b * xi[..., 0] + a * xi[..., 1]
    return torch.stack([x, y, wrap_angle(w)], dim=-1)


def se2_logmap(p: torch.Tensor) -> torch.Tensor:
    """Exact SE(2) logarithm map: pose -> [vx, vy, omega]."""
    w = wrap_angle(p[..., 2])
    a, b = _v_coeffs(w)
    det = a * a + b * b
    vx = (a * p[..., 0] + b * p[..., 1]) / det
    vy = (-b * p[..., 0] + a * p[..., 1]) / det
    return torch.stack([vx, vy, w], dim=-1)


def se2_retract(base: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """base ∘ Exp(xi) — the retraction the smoother uses."""
    return se2_compose(base, se2_expmap(xi))


def se2_transform_points(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Apply pose to local points [..., N, 2] -> parent-frame points."""
    R = se2_rotmat(pose[..., 2])
    t = pose[..., None, :2]
    return torch.matmul(points, R.transpose(-1, -2)) + t


