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
live on the host, and everything that does not depend on the filter state
is computed for the whole stream before the filter runs: the IMU
measurement with its offset and its yaw zeroed at the first IMU event, and
the DVL over-speed gate (a gated event changes nothing and is skipped). The
filter then carries only ``x``, ``P`` and the FOG yaw, and records ``x``
after each IMU event and the FOG yaw after each gyro event. Which filter
runs follows the stream's device:

* on a CUDA device, one launch of ``kalman_filter_kernel``
  (``kernels/kalman_cuda.py``, ``kernels/csrc/kalman.cu``) runs the whole
  stream, each event's type (or a skip code for a gated DVL event) uploaded
  beside it, and the host reads back only the kernel's count of the events
  it ran;
* on the CPU, the plain version: a Python loop over the events that
  branches on the host and never reads the device (``A P Aᵀ + Q`` and
  ``H P Hᵀ + R`` through ``addmm``, the 3x3 inverse in closed form).

The pose integral, which reads the filter but never feeds it, runs after
the filter as cumulative sums over the recorded states.

The three phases are the tracer's spans ``kalman.prepare``,
``kalman.filter`` and ``kalman.integrate`` (``utils/timing.py``); the
filter's span counts the events it ran, the DVL events its gate skipped
and the events the kernel ran (``count_filter_events``), and the host's
waits on the device go through ``host_read`` and ``to_device``.

The sums run in other orders than the sequential float32 scan, so the poses
agree with it to float32 rounding (``tests/test_torch_frontends.py``), and
the kernel agrees with the loop to float32 rounding
(``tests/test_torch_kalman_cuda.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import kalman_cuda
from ..utils.timing import CodeTimer, count_filter_events, host_read, to_device

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
            return to_device(np.asarray(m, np.float32), device)

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


class KalmanState(NamedTuple):
    """The filter's state (tensors on one device)."""

    x: torch.Tensor  # (12,)
    P: torch.Tensor  # (12, 12)
    pose: torch.Tensor  # (6,) pose3
    yaw_gyro: torch.Tensor  # the FOG yaw integrated so far
    imu_yaw0: torch.Tensor  # the first IMU event's yaw
    imu_yaw0_set: torch.Tensor  # bool


def kalman_init(device) -> KalmanState:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return KalmanState(x=zeros(12), P=zeros(12, 12), pose=zeros(6),
                       yaw_gyro=zeros(), imu_yaw0=zeros(),
                       imu_yaw0_set=zeros(dtype=torch.bool))


def _inv3(S: torch.Tensor) -> torch.Tensor:
    """Inverse of a 3x3 matrix by its adjugate: rows r0, r1, r2 give
    S⁻¹ = [r1×r2, r2×r0, r0×r1]ᵀ / det."""
    cof = torch.linalg.cross(S.roll(-1, 0), S.roll(1, 0), dim=-1)
    return cof.T / torch.dot(S[0], cof[0])


def _sensors(cfg: KalmanConfig) -> list:
    """The (H, R) pair of each event type, in the order of the type codes."""
    return [(cfg.H_imu, cfg.R_imu), (cfg.H_dvl, cfg.R_dvl),
            (cfg.H_depth, cfg.R_depth), (cfg.H_gyro, cfg.R_gyro)]


def _filter_loop(types: np.ndarray, dvl_ok: np.ndarray, z: torch.Tensor,
                 cfg: KalmanConfig):
    """The plain filter, an event at a time: ``(x, P, hist (T, 12), yaw_gyro
    (T + 1,))`` as :func:`kalman_cuda.kalman_filter` returns them, in
    ``z``'s dtype (``cfg``'s matrices in it too: float32 on the main path,
    float64 for an exact yardstick)."""
    dev, f32 = z.device, z.dtype
    T = len(types)
    sensors = {k: (H, R, H.T.contiguous())
               for k, (H, R) in enumerate(_sensors(cfg))}
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
    return x, P, hist, yaw_gyro


def _prepare(types: np.ndarray, z: torch.Tensor, cfg: KalmanConfig):
    """What the filter's input needs of the whole stream before the filter
    runs: ``(imu_t, z, dvl_ok, codes)``, the IMU events' indices on the
    device, the measurements with the IMU's offset roll and its yaw zeroed
    at the first IMU event, the DVL gate on the host ((T,) bool, true but
    for a DVL event over ``dvl_max_velocity``) and, on a CUDA device, the
    kernel's event codes (the type, or a skip for a gated event; None on
    the CPU)."""
    dev = z.device
    T = len(types)
    imu_ev = np.nonzero(types == EVENT_IMU)[0]
    imu_t = to_device(imu_ev, dev)
    # the IMU measurement: offset roll, yaw zeroed at the first IMU event
    z = z.clone()
    if len(imu_ev):
        zi = z[imu_t]
        yaw0 = zi[0, 2]
        z[imu_t] = torch.stack([zi[:, 0] + cfg.imu_offset, zi[:, 1],
                                zi[:, 2] - yaw0], dim=-1)
    # the DVL over-speed gate reads z alone: decide it here, on the host
    dvl_ok = np.ones(T, bool)
    dvl_ev = np.nonzero(types == EVENT_DVL)[0]
    if len(dvl_ev):
        over = (z[to_device(dvl_ev, dev)].abs()
                > cfg.dvl_max_velocity).any(dim=-1)
        dvl_ok[dvl_ev] = ~host_read(over.cpu).numpy()
    codes = None
    if dev.type == "cuda":
        if not np.isin(types, (EVENT_IMU, EVENT_DVL, EVENT_DEPTH,
                               EVENT_GYRO)).all():
            raise ValueError("unknown Kalman event type in the stream")
        codes = to_device(np.where(dvl_ok, types, kalman_cuda.EVENT_SKIP)
                          .astype(np.int8), dev)
    return imu_t, z, dvl_ok, codes


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

    with CodeTimer("kalman.prepare", silent=True):
        imu_t, z, dvl_ok, codes = _prepare(types, z, cfg)
    gated = int(np.count_nonzero(~dvl_ok))

    with CodeTimer("kalman.filter", silent=True):
        if dev.type == "cuda":
            x, P, hist, yaw_gyro, count = kalman_cuda.kalman_filter(
                codes, z.contiguous(), cfg.A_imu.contiguous(),
                cfg.Q.contiguous(),
                [(H.contiguous(), R.contiguous()) for H, R in _sensors(cfg)])
            # the span ends when the kernel has run all of the stream
            ran = host_read(int, count)
            if ran != T - gated:
                raise RuntimeError(f"the Kalman filter kernel ran {ran} "
                                   f"events of {T - gated}")
        else:
            x, P, hist, yaw_gyro = _filter_loop(types, dvl_ok, z, cfg)
            ran = 0
        count_filter_events(T - gated, gated, ran)

    # the pose after each IMU event: velocity integrated over dt_imu, turned
    # by the previous pose's yaw (or by the FOG yaw integrated so far)
    with CodeTimer("kalman.integrate", silent=True):
        poses = torch.zeros((T, 6), dtype=f32, device=dev)
        if len(imu_ev):
            xi = hist[imu_t]
            if cfg.use_gyro:
                # the FOG yaw before each IMU event: after the last gyro
                # event before it (slot T holds the initial 0)
                g = np.searchsorted(gyro_ev, imu_ev) - 1
                g = np.where(g >= 0, gyro_ev[np.clip(g, 0, None)], T)
                yaw = yaw_gyro[to_device(g, dev)]
                frame_yaw = yaw
            else:
                yaw = xi[:, 5]
                frame_yaw = torch.cat([torch.zeros(1, dtype=f32, device=dev),
                                       yaw[:-1]])
            tx, ty = xi[:, 6] * cfg.dt_imu, xi[:, 7] * cfg.dt_imu
            cy, sy = torch.cos(frame_yaw), torch.sin(frame_yaw)
            # one scan of two rows, the same bits every run on a card (a
            # single long row goes through CUB's timing-dependent look-back;
            # gyro.py)
            px, py = torch.cumsum(torch.stack([cy * tx - sy * ty,
                                               sy * tx + cy * ty]), dim=1)
            pose_imu = torch.stack([px, py, 0.0 * px, xi[:, 3], xi[:, 4],
                                    yaw], dim=-1)
            # forward fill: each event holds the pose of the last IMU event
            last = np.searchsorted(imu_ev, np.arange(T), side="right") - 1
            started = last >= 0
            poses[to_device(np.nonzero(started)[0], dev)] = pose_imu[
                to_device(last[started], dev)]
    return x, P, poses
