"""The port's Kalman scan as it stood before its spans and counters, frozen:
the tests hold the spanned ``estimators.kalman.kalman_scan`` to it bit for
bit on the CPU (``test_torch_trace.py``), and the CUDA kernel that runs the
filter on a card to it within float32 rounding
(``test_torch_trace_cuda.py``)."""

from __future__ import annotations

import numpy as np
import torch

from sonar_slam_torch.estimators.kalman import (
    EVENT_DEPTH,
    EVENT_DVL,
    EVENT_GYRO,
    EVENT_IMU,
    KalmanConfig,
    _inv3,
    kalman_init,
)


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

    x, P = kalman_init(dev)[:2]
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
