"""DVL + IMU + depth dead reckoning over the whole tick axis at once.

Counterpart of ``sonar_slam_tpu/estimators/dead_reckoning.py``. The JAX
version is a ``lax.scan`` over ~24,000 ticks (50 Hz, 480 s); a Python loop
per tick would be hundreds of thousands of launches. The recurrence needs no
loop, because its state is a function of the last usable tick:

* ``yaw0`` is the IMU yaw at the first valid tick (with ``use_gyro`` the
  heading is the tick's FOG yaw instead, and the roll carries no offset);
* a tick is usable when it is valid and at or after the first valid tick
  whose velocity passes the over-speed gate (an over-speed tick before
  initialization is dropped); the gate state ``prev_time``, ``prev_vel`` and
  the previous yaw are those of the last usable tick before it, found with a
  running maximum of indices (a forward fill);
* the velocity used at an over-speed tick is the last good one (again a
  forward fill);
* the position is a cumulative sum of the rotated trapezoidal increments,
  x and y of every lane scanned as rows of one ``torch.cumsum``.

The sums run in another order than the sequential float32 scan, so the
positions agree with it to float32 rounding of a 20 m-scale sum: within
2e-4 m over a few thousand ticks (``tests/test_torch_estimators.py``), with
the headings equal.

``dead_reckoning_step`` is the node itself, one synchronized tick at a time
(the JAX package's scan body): a vehicle's loop calls it per tick and
publishes each pose. It adds in the JAX package's own order, sequential
float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import pose3_make


class DRConfig(NamedTuple):
    """The fields of the JAX package's ``DRConfig`` that dead reckoning
    reads (its keyframe and warning fields are read by nothing)."""

    dvl_max_velocity: float = 1.0
    use_gyro: bool = False
    roll_offset: float = math.pi / 2


class DRTicks(NamedTuple):
    """Time-sorted synchronized sensor ticks (T, ...)."""

    time: torch.Tensor  # (T,) seconds
    vel: torch.Tensor  # (T, 3) DVL body velocities
    euler: torch.Tensor  # (T, 3) IMU (roll, pitch, yaw_raw)
    gyro_yaw: torch.Tensor  # (T,) FOG yaw (ignored unless use_gyro)
    depth: torch.Tensor  # (T,)
    valid: torch.Tensor  # (T,) bool


class DRState(NamedTuple):
    """The node's state between ticks (tensors on one device)."""

    pose: torch.Tensor  # (6,) pose3 (x, y, z, roll, pitch, yaw)
    prev_time: torch.Tensor
    prev_vel: torch.Tensor  # (3,)
    initialized: torch.Tensor  # bool
    yaw0: torch.Tensor
    yaw0_set: torch.Tensor  # bool
    error_timer: torch.Tensor  # seconds of over-speed DVL since the last good one


def dead_reckoning_init(device) -> DRState:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return DRState(pose=zeros(6), prev_time=zeros(), prev_vel=zeros(3),
                   initialized=zeros(dtype=torch.bool), yaw0=zeros(),
                   yaw0_set=zeros(dtype=torch.bool), error_timer=zeros())


def dead_reckoning_step(state: DRState, tick, config: DRConfig):
    """One synchronized tick ``(time, vel (3,), euler (3,), gyro_yaw, depth,
    valid)`` of tensors -> ``(state, pose3 (6,))``. The pose is emitted at
    every tick (it holds at an unusable one). Reads nothing back to the
    host."""
    time, vel, euler, gyro_yaw, depth, valid = tick
    valid = torch.as_tensor(valid, device=state.pose.device)

    # the yaw is zeroed at the first valid tick
    yaw0 = torch.where(state.yaw0_set, state.yaw0, euler[2])
    yaw0_set = state.yaw0_set | valid
    if config.use_gyro:
        yaw, roll = gyro_yaw, euler[0]
    else:
        yaw, roll = euler[2] - yaw0, config.roll_offset + euler[0]
    rpy = torch.stack([roll, euler[1], yaw])

    # DVL over-speed gate: reuse the last good velocity, run the error
    # timer; an over-speed tick before initialization is dropped
    over = torch.any(torch.abs(vel) > config.dvl_max_velocity)
    dt = torch.clamp(time - state.prev_time, min=0.0)
    error_timer = torch.where(over, state.error_timer + dt, torch.zeros_like(dt))
    vel_used = torch.where(over, state.prev_vel, vel)
    usable = valid & (state.initialized | ~over)

    # trapezoidal body-frame translation, rotated by the previous yaw
    dv = 0.5 * (vel_used + state.prev_vel) * dt
    cy, sy = torch.cos(state.pose[5]), torch.sin(state.pose[5])
    px = state.pose[0] + cy * dv[0] - sy * dv[1]
    py = state.pose[1] + sy * dv[0] + cy * dv[1]
    moved = pose3_make(torch.stack([px, py, depth]), rpy)
    first = pose3_make(torch.stack([0.0 * px, 0.0 * py, depth]), rpy)
    pose = torch.where(usable, torch.where(state.initialized, moved, first),
                       state.pose)

    new_state = DRState(
        pose=pose,
        prev_time=torch.where(usable, time, state.prev_time),
        prev_vel=torch.where(usable, vel_used, state.prev_vel),
        initialized=state.initialized | usable,
        yaw0=yaw0,
        yaw0_set=yaw0_set,
        error_timer=torch.where(usable, error_timer, state.error_timer),
    )
    return new_state, pose


def _last_le(flag: torch.Tensor) -> torch.Tensor:
    """Index of the last True at or before each position along the last
    axis; -1 where there is none."""
    T = flag.shape[-1]
    ar = torch.arange(T, device=flag.device).expand_as(flag)
    marked = torch.where(flag, ar, torch.full_like(ar, -1))
    return torch.cummax(marked, dim=-1).values


def _dr_lanes(ticks: DRTicks, config: DRConfig,
              vel_masks: torch.Tensor) -> torch.Tensor:
    """Dead reckoning of L lanes, lane l integrating ``vel * vel_masks[l]``:
    (L, T, 6) pose3 emitted at every tick."""
    time, euler, depth, valid = ticks.time, ticks.euler, ticks.depth, ticks.valid
    T = time.shape[0]
    dev = time.device
    L = vel_masks.shape[0]
    vel = ticks.vel[None] * vel_masks[:, None, :]  # (L, T, 3)
    ar = torch.arange(T, device=dev)

    if config.use_gyro:
        # the FOG yaw drives the heading; the roll carries no mount offset
        yaw = ticks.gyro_yaw
        roll = euler[:, 0]
    else:
        first_valid = torch.min(torch.where(valid, ar, torch.full_like(ar, T)))
        yaw0 = euler[torch.clamp(first_valid, max=T - 1), 2]
        yaw = euler[:, 2] - yaw0
        roll = config.roll_offset + euler[:, 0]
    rpy = torch.stack([roll, euler[:, 1], yaw], dim=-1)  # (T, 3)

    over = torch.any(torch.abs(vel) > config.dvl_max_velocity, dim=-1)  # (L, T)
    start = valid & ~over
    u0 = torch.min(torch.where(start, ar, torch.full_like(ar, T)), dim=-1).values
    usable = valid & (ar[None] >= u0[:, None])  # (L, T)

    lane = torch.arange(L, device=dev)[:, None]
    good_at = torch.clamp(_last_le(usable & ~over), min=0)
    vel_used = vel[lane, good_at]  # (L, T, 3)
    last_usable = _last_le(usable)
    prev = torch.cat([torch.full((L, 1), -1, dtype=last_usable.dtype, device=dev),
                      last_usable[:, :-1]], dim=1)
    has_prev = prev >= 0
    pidx = torch.clamp(prev, min=0)
    zero = torch.zeros((), dtype=time.dtype, device=dev)
    prev_time = torch.where(has_prev, time[pidx], zero)
    prev_vel = torch.where(has_prev[..., None], vel_used[lane, pidx], zero)
    prev_yaw = torch.where(has_prev, yaw[pidx], zero)

    dt = torch.clamp(time[None] - prev_time, min=0.0)
    dv = 0.5 * (vel_used + prev_vel) * dt[..., None]
    cy, sy = torch.cos(prev_yaw), torch.sin(prev_yaw)
    step = (usable & has_prev).to(time.dtype)
    # one scan of rows (x and y of every lane), the same bits every run on a
    # card (a single long row goes through CUB's timing-dependent look-back;
    # estimators/gyro.py)
    px, py = torch.cumsum(torch.stack([(cy * dv[..., 0] - sy * dv[..., 1]) * step,
                                       (sy * dv[..., 0] + cy * dv[..., 1]) * step]),
                          dim=-1)

    at = torch.clamp(last_usable, min=0)
    pose = pose3_make(torch.stack([px, py, depth[at]], dim=-1), rpy[at])
    started = (last_usable >= 0)[..., None]
    return torch.where(started, pose, torch.zeros_like(pose))


def dead_reckoning_scan(ticks: DRTicks, config: DRConfig) -> torch.Tensor:
    """Integrate a whole tick stream: (T, 6) pose3 at every tick."""
    ones = torch.ones((1, 3), dtype=ticks.vel.dtype, device=ticks.vel.device)
    return _dr_lanes(ticks, config, ones)[0]


def dead_reckoning_with_basis_scan(ticks: DRTicks, config: DRConfig):
    """Full dead reckoning and the two basis-integral lanes in one pass:
    (poses (T, 6), basis (T, 2, 2))."""
    masks = torch.tensor([[1.0, 1.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                         dtype=ticks.vel.dtype, device=ticks.vel.device)
    poses = _dr_lanes(ticks, config, masks)
    return poses[0], torch.stack([poses[1, :, :2], poses[2, :, :2]], dim=1)
