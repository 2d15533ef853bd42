"""The upstream Kalman node, one sensor event at a time.

The plain reference for ``frontend="kalman"``, written from the node
(jake3991/sonar-SLAM ``bruce_slam/src/bruce_slam/kalman.py``) and its
``bruce_slam/config/kalman.yaml``, not from the port. The node keeps a
12-state filter, (x, y, z, roll, pitch, yaw) and their rates, as a (12, 1)
column. Each IMU message predicts with ``A_imu`` and corrects with
``H_imu`` (``kalman.py:177-199``), then integrates the filtered velocity
over ``dt_imu`` into the pose, turned by the previous pose's yaw
(``:200-243``); each DVL and depth message corrects (``:138-175``), a DVL
message above ``dvl_max_velocity`` on any axis changing nothing. The
arithmetic is the node's, each product a matrix product:

    predict:  x = A x,  P = A P Aᵀ + Q
    correct:  K = P Hᵀ (H P Hᵀ + R)⁻¹,  x = x + K (z - H x),  P = P - K H P
    pose:     (x, y) = T (v dt, 1): the previous pose's transformFrom

A run with TF32 matrix products (the control) rounds the covariance and
gain products; the products with one column (the state, the pose) run in
full float32 whatever the setting (cuBLAS's matrix-vector kernels on an
H100).

Departures from the node, none of which changes the filter:

* no ROS: no subscribers, no tf and no publishing. The bag's IMU, DVL and
  depth streams are merged into one stream in a stable time order (IMU,
  then DVL, then depth on equal times) and run in a Python loop; the pose
  after each IMU message is kept;
* ``dt_imu`` and ``A_imu``'s four time entries are the bag's median IMU
  period (kalman.yaml's 0.005 s at 200 Hz, within float32 rounding), and
  ``imu_offset`` is 0: the simulated IMU is mounted upright, where the
  vehicle's sits at 180 degrees;
* no FOG: ``use_gyro`` is false, as in kalman.yaml, so no gyro message is
  read;
* the IMU yaw is measured from the first IMU message's yaw, and the pose's
  z is 0 (the depth is filtered in the state, not published in the pose).
"""

from __future__ import annotations

import numpy as np
import torch

EVENT_IMU, EVENT_DVL, EVENT_DEPTH = 0, 1, 2


def _rows(cols) -> list:
    """(3, 12): row i is 1 at column ``cols[i]`` (None: a row of zeros)."""
    return [[1.0 if c == j else 0.0 for j in range(12)] for c in cols]


def kalman_yaml(dt_imu: float) -> dict:
    """kalman.yaml's matrices and gate, with ``A_imu``'s time entries at
    ``dt_imu``, as float32 host arrays."""
    A = np.eye(12)
    for i, j in ((0, 6), (1, 7), (3, 9), (4, 10)):
        A[i, j] = dt_imu
    q = [1e-4, 0.01, 0.01, 0.1, 1e-4, 0.1, 1.5e-4, 9e-5, 0.1, 1e-3, 0.01,
         0.01]
    m = {"A_imu": A, "Q": np.diag(q),
         "H_imu": _rows([3, 4, 5]), "R_imu": np.diag([0.01] * 3),
         "H_dvl": _rows([6, 7, 8]), "R_dvl": np.diag([1e-4, 1e-4, 1e-3]),
         "H_depth": _rows([2, None, None]), "R_depth": np.diag([0.01] * 3)}
    out = {k: np.asarray(v, np.float32) for k, v in m.items()}
    out.update(dt_imu=dt_imu, dvl_max_velocity=0.5, imu_offset=0.0)
    return out


def merged_stream(bag):
    """(times, types, z (T, 3) float32) of the bag's IMU, DVL and depth
    messages in a stable time order. IMU z = (roll, pitch, yaw), DVL z =
    the body velocity, depth z = (depth, 0, 0)."""
    zeros = np.zeros_like(bag.depth)
    streams = [(bag.imu_time, EVENT_IMU, bag.imu_rpy),
               (bag.dvl_time, EVENT_DVL, bag.dvl_vel),
               (bag.depth_time, EVENT_DEPTH,
                np.stack([bag.depth, zeros, zeros], -1))]
    times = np.concatenate([t for t, _, _ in streams])
    types = np.concatenate([np.full(len(t), k, np.int32)
                            for t, k, _ in streams])
    z = np.concatenate([v for _, _, v in streams]).astype(np.float32)
    order = np.argsort(times, kind="stable")
    return times[order], types[order], z[order]


def kalman_node(types: np.ndarray, z: np.ndarray, cfg: dict, dev):
    """Run the stream ``types`` (T,), ``z`` (T, 3) through the node, one
    message at a time, on ``dev``: the pose3 (x, y, z, roll, pitch, yaw)
    after each IMU message, (N_imu, 6)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    A, Q = t(cfg["A_imu"]), t(cfg["Q"])
    sensors = {k: (t(cfg["H_" + n]), t(cfg["R_" + n])) for k, n in
               ((EVENT_IMU, "imu"), (EVENT_DVL, "dvl"), (EVENT_DEPTH, "depth"))}
    dt, gate = cfg["dt_imu"], cfg["dvl_max_velocity"]
    zdev = t(z)
    one, bottom = t([[1.0]]), t([0.0, 0.0, 1.0])

    x = torch.zeros((12, 1), dtype=torch.float32, device=dev)
    P = torch.zeros((12, 12), dtype=torch.float32, device=dev)
    # the pose in the plane as a homogeneous SE(2) matrix
    T = torch.eye(3, dtype=torch.float32, device=dev)
    imu_zero = None  # what an IMU measurement is read against
    xy, states = [], []
    for e, kind in enumerate(types):
        zc = zdev[e].reshape(3, 1)
        if kind == EVENT_DVL and np.any(np.abs(z[e]) > gate):
            continue
        if kind == EVENT_IMU:
            if imu_zero is None:
                # the roll's mount offset; the yaw of the first message
                imu_zero = torch.cat([t([[-cfg["imu_offset"]], [0.0]]),
                                      zc[2:3]])
            zc = zc - imu_zero
            x = A @ x
            P = A @ P @ A.T + Q
        H, R = sensors[int(kind)]
        K = P @ H.T @ torch.linalg.inv_ex(H @ P @ H.T + R).inverse
        x = x + K @ (zc - H @ x)
        P = P - K @ H @ P
        if kind == EVENT_IMU:
            # the velocity over dt_imu, a point in the previous pose's frame
            # (Pose2.transformFrom), is the new position; the yaw is the
            # filter's
            p = T @ torch.cat([x[6:8] * dt, one])
            c, s = torch.cos(x[5, 0]), torch.sin(x[5, 0])
            T = torch.stack([torch.stack([c, -s, p[0, 0]]),
                             torch.stack([s, c, p[1, 0]]), bottom])
            xy.append(p[:2, 0])
            states.append(x[3:6, 0])
    if not xy:
        return torch.zeros((0, 6), dtype=torch.float32, device=dev)
    xy, rpy = torch.stack(xy), torch.stack(states)
    return torch.cat([xy, torch.zeros_like(xy[:, :1]), rpy], dim=1)
