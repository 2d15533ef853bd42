"""12-state linear Kalman filter front end.

Counterpart of ``sonar_slam_tpu/estimators/kalman.py``. The state is (x, y,
z, roll, pitch, yaw) and their rates. Sensor events arrive in one
time-sorted stream: an IMU event predicts with ``A_imu`` and corrects with
``H_imu``, then integrates the filtered velocity into the pose; DVL, depth
and FOG events only correct. Event types: 0 = IMU (z = roll + offset,
pitch, yaw - yaw0), 1 = DVL (z = vx, vy, vz; skipped above
``dvl_max_velocity``), 2 = depth (z = depth, 0, 0), 3 = gyro (z =
mount-rotated delta yaw, 0, 0).

The JAX package runs the stream as one ``lax.scan``. Here the event types
live on the host, so the scan is a Python loop over events that branches on
the host and never reads the device:

* everything that does not depend on the filter state is computed before
  the loop for the whole stream: the IMU measurement with its offset and
  its yaw zeroed at the first IMU event, and the DVL over-speed gate (a
  gated event changes nothing and is skipped);
* the loop carries only ``x``, ``P`` and the FOG yaw (about sixteen small
  launches an event: ``A P Aᵀ + Q`` and ``H P Hᵀ + R`` through ``addmm``,
  the 3x3 inverse in closed form) and records ``x`` after each IMU event
  and the FOG yaw after each gyro event;
* the pose integral, which reads the filter but never feeds it, runs after
  the loop as cumulative sums over the recorded states.

The sums run in other orders than the sequential float32 scan, so the poses
agree with it to float32 rounding (``tests/test_torch_frontends.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

EVENT_IMU, EVENT_DVL, EVENT_DEPTH, EVENT_GYRO = 0, 1, 2, 3


def _eye_rows(n: int, rows) -> list:
    """(len(rows), n) selector: row i is 1 at column rows[i] (None: zeros)."""
    out = [[0.0] * n for _ in rows]
    for i, c in enumerate(rows):
        if c is not None:
            out[i][c] = 1.0
    return out


class KalmanConfig(NamedTuple):
    A_imu: torch.Tensor  # (12, 12) state transition
    Q: torch.Tensor  # (12, 12) process noise
    H_dvl: torch.Tensor  # (3, 12)
    R_dvl: torch.Tensor  # (3, 3)
    H_imu: torch.Tensor
    R_imu: torch.Tensor
    H_depth: torch.Tensor
    R_depth: torch.Tensor
    H_gyro: torch.Tensor
    R_gyro: torch.Tensor
    dt_imu: float = 0.005
    dvl_max_velocity: float = 1.0
    imu_offset: float = math.pi  # radians
    use_gyro: bool = False

    @staticmethod
    def default(device) -> "KalmanConfig":
        """The reference's kalman.yaml (what the JAX package's
        ``load_kalman_config()`` reads), written out here: a 200 Hz IMU,
        the DVL gate at 0.5 m/s and the IMU offset at 180 degrees."""
        dt = 0.005
        A = np.eye(12, dtype=np.float32)
        A[0, 6] = A[1, 7] = A[3, 9] = A[4, 10] = dt
        q = [1e-4, 0.01, 0.01, 0.1, 1e-4, 0.1, 1.5e-4, 9e-5, 0.1, 1e-3,
             0.01, 0.01]

        def t(m):
            return torch.as_tensor(np.asarray(m, np.float32), device=device)

        return KalmanConfig(
            A_imu=t(A), Q=t(np.diag(q)),
            H_dvl=t(_eye_rows(12, [6, 7, 8])), R_dvl=t(np.diag([1e-4, 1e-4, 1e-3])),
            H_imu=t(_eye_rows(12, [3, 4, 5])), R_imu=t(np.diag([0.01] * 3)),
            H_depth=t(_eye_rows(12, [2, None, None])),
            R_depth=t(np.diag([0.01] * 3)),
            H_gyro=t(_eye_rows(12, [11, None, None])),
            R_gyro=t(np.diag([1e-8] * 3)),
            dt_imu=dt, dvl_max_velocity=0.5, imu_offset=math.radians(180.0),
            use_gyro=False)


def _inv3(S: torch.Tensor) -> torch.Tensor:
    """Inverse of a 3x3 matrix by its adjugate: rows r0, r1, r2 give
    S⁻¹ = [r1×r2, r2×r0, r0×r1]ᵀ / det."""
    cof = torch.linalg.cross(S.roll(-1, 0), S.roll(1, 0), dim=-1)
    return cof.T / torch.dot(S[0], cof[0])


def kalman_scan(events_type: np.ndarray, events_z: torch.Tensor,
                config: KalmanConfig):
    """Run a merged sensor event stream through the filter.

    ``events_type`` (T,) int on the host, ``events_z`` (T, 3) float32 on the
    device. Returns ``(x, P, poses (T, 6))``: the final state and covariance,
    and the pose after every event, which changes on IMU events and holds
    elsewhere (zeros before the first IMU event).
    """
    cfg = config
    types = np.asarray(events_type)
    z = events_z
    dev, f32 = z.device, torch.float32
    T = len(types)
    imu_ev = np.nonzero(types == EVENT_IMU)[0]
    gyro_ev = np.nonzero(types == EVENT_GYRO)[0]

    # the IMU measurement: offset roll, yaw zeroed at the first IMU event
    z = z.clone()
    if len(imu_ev):
        zi = z[imu_ev]
        yaw0 = zi[0, 2]
        z[imu_ev] = torch.stack([zi[:, 0] + cfg.imu_offset, zi[:, 1],
                                 zi[:, 2] - yaw0], dim=-1)
    # the DVL over-speed gate reads z alone: decide it here, on the host
    dvl_ok = np.ones(T, bool)
    dvl_ev = np.nonzero(types == EVENT_DVL)[0]
    if len(dvl_ev):
        over = (z[dvl_ev].abs() > cfg.dvl_max_velocity).any(dim=-1)
        dvl_ok[dvl_ev] = ~over.cpu().numpy()

    sensors = {EVENT_IMU: (cfg.H_imu, cfg.R_imu),
               EVENT_DVL: (cfg.H_dvl, cfg.R_dvl),
               EVENT_DEPTH: (cfg.H_depth, cfg.R_depth),
               EVENT_GYRO: (cfg.H_gyro, cfg.R_gyro)}
    sensors = {k: (H, R, H.T.contiguous()) for k, (H, R) in sensors.items()}
    A, AT, Q = cfg.A_imu, cfg.A_imu.T.contiguous(), cfg.Q

    x = torch.zeros(12, dtype=f32, device=dev)
    P = torch.zeros((12, 12), dtype=f32, device=dev)
    hist = torch.zeros((T, 12), dtype=f32, device=dev)  # x after IMU events
    yaw_gyro = torch.zeros((T + 1,), dtype=f32, device=dev)  # after gyro events
    yg = yaw_gyro[T]
    zrows = z.unbind(0)
    for e in range(T):
        kind = int(types[e])
        if kind == EVENT_DVL and not dvl_ok[e]:
            continue
        if kind == EVENT_IMU:
            x = torch.mv(A, x)
            P = torch.addmm(Q, torch.mm(A, P), AT)
        H, R, HT = sensors[kind]
        S = torch.addmm(R, torch.mm(H, P), HT)
        K = torch.mm(torch.mm(P, HT), _inv3(S))
        y = torch.addmv(zrows[e], H, x, alpha=-1.0)
        if kind == EVENT_IMU:
            x = torch.addmv(x, K, y, out=hist[e])
        else:
            x = torch.addmv(x, K, y)
        P = torch.addmm(P, torch.mm(K, H), P, alpha=-1.0)
        if kind == EVENT_GYRO:
            # added in stream order, as the sequential scan adds
            yg = torch.add(yg, x[11], out=yaw_gyro[e])

    # the pose after each IMU event: velocity integrated over dt_imu, turned
    # by the previous pose's yaw (or by the FOG yaw integrated so far)
    poses = torch.zeros((T, 6), dtype=f32, device=dev)
    if len(imu_ev):
        xi = hist[imu_ev]
        if cfg.use_gyro:
            # the FOG yaw before each IMU event: after the last gyro event
            # before it (slot T holds the initial 0)
            g = np.searchsorted(gyro_ev, imu_ev) - 1
            g = np.where(g >= 0, gyro_ev[np.clip(g, 0, None)], T)
            yaw = yaw_gyro[torch.as_tensor(g, device=dev)]
            frame_yaw = yaw
        else:
            yaw = xi[:, 5]
            frame_yaw = torch.cat([torch.zeros(1, dtype=f32, device=dev),
                                   yaw[:-1]])
        tx, ty = xi[:, 6] * cfg.dt_imu, xi[:, 7] * cfg.dt_imu
        cy, sy = torch.cos(frame_yaw), torch.sin(frame_yaw)
        # one scan of two rows, the same bits every run on a card (a single
        # long row goes through CUB's timing-dependent look-back; gyro.py)
        px, py = torch.cumsum(torch.stack([cy * tx - sy * ty,
                                           sy * tx + cy * ty]), dim=1)
        pose_imu = torch.stack([px, py, 0.0 * px, xi[:, 3], xi[:, 4], yaw],
                               dim=-1)
        # forward fill: each event holds the pose of the last IMU event
        last = np.searchsorted(imu_ev, np.arange(T), side="right") - 1
        started = last >= 0
        poses[torch.as_tensor(np.nonzero(started)[0], device=dev)] = pose_imu[
            torch.as_tensor(last[started], device=dev)]
    return x, P, poses
