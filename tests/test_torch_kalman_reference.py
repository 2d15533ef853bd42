"""``pipeline.odometry(frontend="kalman")`` against the benchmark's plain
reference, ``slam_bench/reference/odometry/kalman.py``: the upstream Kalman
node one message at a time, its pose integrated inside the loop.

On seeded 60 s surveys with a 200 Hz IMU (kalman.yaml's ``dt_imu``) and a
50 Hz one, each holding depth messages and DVL messages over kalman.yaml's
0.5 m/s gate, the two agree on the IMU times and, within ``TOL_M`` and
``TOL_YAW``, on the position (x, y, z, as the benchmark's ``odom_gap_m``
compares it) and the heading at each of them. Nudged filters:

* ``one_ulp``: the program's filter input moved up by one unit in the last
  place, what a sound reordering of its float32 arithmetic may hand on;
  within both tolerances;
* ``dt_scaled``: the program's ``dt_imu`` and ``A_imu`` one part in 2^11
  off; the positions fall outside ``TOL_M``;
* ``tf32_products``: the reference itself, with the inputs of each of its
  matrix products rounded to TF32's 10 mantissa bits (round to nearest, as
  the card's TF32 products take them; matrix-vector products stay float32,
  as on the card), the benchmark's control emulated on the CPU. It stays
  within the positions' rounding, as on the card, and turns the heading
  past ``TOL_YAW``.

Tolerances: ``TOL_M`` = 5e-4 m. The port integrates the pose as a row scan
after the loop and the reference adds it one message at a time, so the
float32 sums of a path of about 30 m round in other orders (measured 2.9e-4
m at 200 Hz and 5.0e-5 m at 50 Hz, seed 7); the scaled ``dt`` moves
positions by centimetres. ``TOL_YAW`` = 1e-5 rad: the filter measures the
heading at every IMU message, so the two filters' headings stay within a
few ulps of a yaw of a few radians (measured 6e-8 and 4.8e-7 rad; an ulp is
2.4e-7 rad there); the emulated TF32 products turn it by 1.46e-3 rad at
both rates, as the card's control does (the limit lies between).
"""

import contextlib
import math
from unittest import mock

import numpy as np
import pytest
import torch

from slam_bench import simulate
from slam_bench.odometry_readings import heading_gap
from slam_bench.reference.odometry import kalman as reference
from sonar_slam_torch import pipeline

torch.set_num_threads(1)

TOL_M = 5e-4
TOL_YAW = 1e-5
SEED = 7


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def tf32_products():
    """Matrix-matrix products computed from TF32 inputs while the context
    lasts; matrix-vector products stay float32."""
    real = torch.Tensor.__matmul__

    def matmul(a, b):
        if a.dim() == 2 and b.dim() == 2 and b.shape[1] > 1:
            return real(tf32(a), tf32(b))
        return real(a, b)

    with mock.patch.object(torch.Tensor, "__matmul__", matmul):
        yield


def survey(imu_rate: float):
    return simulate.simulate_bag(simulate.SimConfig(
        duration=60.0, speed=0.5, imu_rate=imu_rate, sonar_rate=1.0,
        num_ranges=32, num_bearings=16, seed=SEED))


@contextlib.contextmanager
def nudged(nudge: str, cfg):
    """The Kalman configuration to run, with the program's filter nudged
    as ``nudge`` says while the context lasts."""
    if nudge == "one_ulp":
        real = pipeline.kalman_scan

        def scan(types, z, config):
            return real(types, torch.nextafter(
                z, torch.full_like(z, math.inf)), config)

        with mock.patch.object(pipeline, "kalman_scan", scan):
            yield cfg
    elif nudge == "dt_scaled":
        dt = cfg.dt_imu * (1.0 + 2.0 ** -11)
        A = cfg.A_imu.clone()
        A[0, 6] = A[1, 7] = A[3, 9] = A[4, 10] = dt
        yield cfg._replace(dt_imu=dt, A_imu=A)
    else:
        yield cfg


@pytest.fixture(scope="module")
def references():
    """{IMU rate: (bag, reference times, reference poses3)}."""
    out = {}
    for rate in (200.0, 50.0):
        bag = survey(rate)
        times, poses, basis = reference.odometry(bag, None, None,
                                                 torch.device("cpu"))
        assert basis is None
        out[rate] = (bag, times, poses.numpy())
    return out


@pytest.mark.parametrize("rate,nudge", [
    (200.0, "none"), (50.0, "none"), (200.0, "one_ulp"), (200.0, "dt_scaled"),
    (50.0, "dt_scaled"), (200.0, "tf32_products"), (50.0, "tf32_products")])
def test_odometry_against_the_sequential_reference(references, rate, nudge):
    bag, ref_times, ref = references[rate]
    # the stream holds what the filter branches on
    over = np.any(np.abs(bag.dvl_vel) > 0.5, axis=-1)
    assert 0 < over.sum() < len(over) and len(bag.depth_time) > 0
    if nudge == "tf32_products":
        with tf32_products():
            times, poses, _ = reference.odometry(bag, None, None,
                                                 torch.device("cpu"))
    else:
        cfg = pipeline.default_kalman_config(bag.imu_time, "cpu")
        with nudged(nudge, cfg) as cfg:
            times, poses, _ = pipeline.odometry(bag, "cpu", "kalman",
                                                kalman_config=cfg)
    poses = poses.numpy()
    assert np.array_equal(times, ref_times) and poses.shape == ref.shape
    gap = float(np.max(np.abs(poses[:, :3].astype(np.float64)
                              - ref[:, :3])))
    heading = heading_gap(poses[:, 5], ref[:, 5])
    if nudge == "dt_scaled":
        assert gap > 10 * TOL_M, gap
        return
    assert gap <= TOL_M, gap
    if nudge == "tf32_products":
        assert heading > 100 * TOL_YAW, heading
        return
    assert heading <= TOL_YAW, heading
    # roll and pitch are the filter's, equal within its rounding
    assert np.allclose(poses[:, 3:5], ref[:, 3:5], rtol=0, atol=TOL_YAW)
