"""``kalman_filter_kernel`` (``sonar_slam_torch/kernels/csrc/kalman.cu``)
against the plain event loop of ``estimators/kalman.py``.

Marked ``cuda``: they skip without a card (``PYTHONPATH=. python -m pytest
--noconftest -m cuda tests/test_torch_kalman_cuda.py`` on one). This file
imports no JAX.

* Random streams of all four event types, with and without the FOG,
  with DVL events over the gate, gyro events before the first IMU event,
  a stream with no IMU event, an empty one and one long enough to cross the
  kernel's chunks of staged events: the kernel and the loop on the same
  codes and measurements give the same state after every IMU event, final
  state and covariance, FOG yaw after every gyro event and event count; and
  ``kalman_scan`` on the card gives the CPU's poses.
* Two runs of the kernel are equal bit for bit.
* The wrapper refuses a wrong dtype, shape or device (on the CPU too).

Tolerances: the kernel sums the same products in another order than the
CPU's ``mm`` and contracts them into FMAs, so each event rounds differently
in the last bits. The filter damps such differences (the DVL, the IMU and
the depth observe all but the two position states, whose errors only add
up), so states and poses of order 1 agree within ``ATOL`` = 1e-5 and
``RTOL`` = 1e-5 (the JAX package's parity test holds the CPU loop to the
same ``x`` and poses, ``tests/test_torch_frontends.py``), and the
covariance within 1e-7 absolute and ``RTOL`` relative.
"""

import numpy as np
import pytest
import torch

from sonar_slam_torch.estimators import kalman as te
from sonar_slam_torch.kernels import kalman_cuda

ATOL = RTOL = 1e-5
P_ATOL = 1e-7

# name: (seed, events before the FOG is interleaved, use_gyro, variant)
STREAMS = {
    "imu_dvl_depth": (1, 700, False, None),
    "with_gyro": (1, 700, True, None),
    "gyro_before_imu": (2, 600, True, "gyro_first"),
    "no_imu": (3, 300, False, "no_imu"),
    "gyro_without_imu": (4, 300, True, "gyro_only"),
    "empty": (5, 0, False, None),
    "chunks": (6, 5000, False, None),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def stream(seed: int, n: int, use_gyro: bool, variant=None):
    """(types (T,) int32, z (T, 3) float32) of a merged stream: IMU, DVL and
    depth events at random, every seventh DVL event over the 0.5 m/s gate,
    with ``use_gyro`` a FOG event after each IMU event (two gyro
    corrections with no prediction between would cancel P[11, 11] down to
    its last bits, ``tests/test_torch_frontends.py``)."""
    rng = np.random.default_rng(seed)
    types = rng.choice(3, size=n).astype(np.int32)
    types[:min(n, 2)] = [2, 1][:min(n, 2)]  # corrections before any IMU event
    if variant in ("no_imu", "gyro_only"):
        types[types == te.EVENT_IMU] = te.EVENT_DEPTH
    if use_gyro:
        types = np.concatenate([[t, 3] if t == 0 else [t] for t in types])
        if variant == "gyro_first":
            types = np.concatenate([[3, 2, 3], types])
        if variant == "gyro_only":
            types = np.where(np.arange(len(types)) % 3 == 0, 3, types)
    types = np.asarray(types, np.int32)
    T = len(types)
    z = np.zeros((T, 3), np.float32)
    imu = types == 0
    z[imu] = np.stack([0.02 * rng.normal(size=imu.sum()),
                       0.02 * rng.normal(size=imu.sum()),
                       np.cumsum(0.01 * rng.normal(size=imu.sum())) + 0.4], -1)
    dvl = types == 1
    z[dvl] = [0.4, 0.0, 0.0] + 0.05 * rng.normal(size=(dvl.sum(), 3))
    z[np.nonzero(dvl)[0][::7], 0] = 0.8  # over the 0.5 m/s gate: skipped
    dep = types == 2
    z[dep, 0] = 5.0 + 0.01 * rng.normal(size=dep.sum())
    gyr = types == 3
    z[gyr, 0] = 1e-3 * rng.normal(size=gyr.sum())
    return types, z


def config(use_gyro: bool, device) -> te.KalmanConfig:
    return te.KalmanConfig.default(device)._replace(use_gyro=use_gyro)


def codes_of(types, z, cfg):
    """The kernel's codes: the type, or a skip for a DVL event over the
    gate (as ``kalman_scan`` gates its measurements)."""
    over = np.any(np.abs(z) > cfg.dvl_max_velocity, axis=-1)
    return np.where((types == te.EVENT_DVL) & over, kalman_cuda.EVENT_SKIP,
                    types).astype(np.int8)


def run_kernel(types, z, use_gyro, dev):
    cfg = config(use_gyro, dev)
    codes = torch.as_tensor(codes_of(types, z, cfg), device=dev)
    out = kalman_cuda.kalman_filter(codes, torch.as_tensor(z, device=dev),
                                    cfg.A_imu, cfg.Q, te._sensors(cfg))
    torch.cuda.synchronize(dev)
    return [t.cpu() for t in out]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_kernel_against_the_loop(card, name):
    seed, n, use_gyro, variant = STREAMS[name]
    types, z = stream(seed, n, use_gyro, variant)
    x, P, hist, yaw_gyro, count = run_kernel(types, z, use_gyro, card)
    cfg = config(use_gyro, "cpu")
    codes = codes_of(types, z, cfg)
    ok = codes != kalman_cuda.EVENT_SKIP
    lx, lP, lhist, lyaw = te._filter_loop(types, ok, torch.as_tensor(z), cfg)
    assert int(count) == int(ok.sum())
    torch.testing.assert_close(hist, lhist, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(x, lx, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(P, lP, rtol=RTOL, atol=P_ATOL)
    torch.testing.assert_close(yaw_gyro, lyaw, rtol=RTOL, atol=ATOL)
    # rows of other events are untouched
    assert not hist[types != te.EVENT_IMU].any()
    assert not yaw_gyro[np.r_[types != te.EVENT_GYRO, True]].any()
    if name == "with_gyro":
        assert lyaw.abs().max() > 0
    # the whole scan, measurement, gate and pose integral included
    _, _, poses = te.kalman_scan(types, torch.as_tensor(z, device=card),
                                 config(use_gyro, card))
    _, _, want = te.kalman_scan(types, torch.as_tensor(z), cfg)
    torch.testing.assert_close(poses.cpu(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit(card):
    types, z = stream(7, 3000, True)
    first = run_kernel(types, z, True, card)
    again = run_kernel(types, z, True, card)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    zc = torch.as_tensor(z, device=card)
    one = te.kalman_scan(types, zc, config(True, card))
    two = te.kalman_scan(types, zc, config(True, card))
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def _arguments(device):
    types, z = stream(8, 50, False)
    cfg = config(False, device)
    codes = torch.as_tensor(codes_of(types, z, cfg), device=device)
    return (codes, torch.as_tensor(z, device=device), cfg.A_imu, cfg.Q,
            te._sensors(cfg))


def _broken(args, which: str):
    codes, z, A, Q, pairs = args
    if which == "codes_int32":
        codes = codes.to(torch.int32)
    elif which == "z_float64":
        z = z.double()
    elif which == "z_short":
        z = z[:, :2]
    elif which == "z_rows":
        z = z[1:]
    elif which == "H_shape":
        pairs = [(pairs[0][0][:2], pairs[0][1])] + pairs[1:]
    elif which == "R_float64":
        pairs = pairs[:3] + [(pairs[3][0], pairs[3][1].double())]
    elif which == "three_sensors":
        pairs = pairs[:3]
    elif which == "A_on_cpu":
        A = A.cpu()
    elif which == "Q_strided":
        Q = Q.T
    return codes, z, A, Q, pairs


@pytest.mark.parametrize("which", ["codes_int32", "z_float64", "z_short",
                                   "z_rows", "H_shape", "R_float64",
                                   "three_sensors", "on_cpu"])
def test_wrapper_refuses_on_the_cpu(which):
    """Dtypes and shapes are checked before the device, so a CPU stream
    shows them; a CPU stream of the right ones is refused for its device."""
    before = kalman_cuda.kalman_filter.launches
    args = _broken(_arguments("cpu"), which)
    with pytest.raises((TypeError, ValueError)) as info:
        kalman_cuda.kalman_filter(*args)
    if which == "on_cpu":
        assert "device" in str(info.value)
    assert kalman_cuda.kalman_filter.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["codes_int32", "z_float64", "z_short",
                                   "H_shape", "R_float64", "A_on_cpu",
                                   "Q_strided"])
def test_wrapper_refuses_on_the_card(card, which):
    before = kalman_cuda.kalman_filter.launches
    args = _broken(_arguments(card), which)
    with pytest.raises((TypeError, ValueError)):
        kalman_cuda.kalman_filter(*args)
    assert kalman_cuda.kalman_filter.launches == before
