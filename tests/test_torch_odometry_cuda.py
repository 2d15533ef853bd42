"""The odometry front ends repeat bit for bit on a card.

On a card a cumulative sum over one long row goes through CUB's decoupled
look-back scan, in which a tile adds the partial sums of the tiles before it
in an order that depends on which of them have finished; ATen's row scan
walks each row in one block, in one order. A survey's gyro stream (24,000
samples) was integrated the first way, and one run on an H100 gave gyro
odometry 1.1e-4 m from the JAX package's where every other gave 9.0e-5 m,
which the ill-conditioned loops downstream turned into another ATE (no
other stage of that run moved; 300 back-to-back scans on an idle card did
not reproduce it). ``gyro_integrate``, the Kalman pose integral and
``dead_reckoning_scan`` (x and y of every lane) scan rows instead; an
hour's 18,000 DVL ticks, which span more of CUB's tiles than a 480 s
survey's 2,400, repeat too. On the CPU every scan is sequential, so the
rows give the bits the single row gave: dead reckoning's CPU output is
pinned bit for bit (``tests/golden/dr_small_survey.npz``) so that a change
of the card's scan cannot move it.

This file imports no JAX: ``python -m pytest --noconftest
tests/test_torch_odometry_cuda.py`` on a card; without one every test
skips. Run as a script on a card (``PYTHONPATH=. python
tests/test_torch_odometry_cuda.py``) it prints how often a single-row scan
and a two-row scan of the same numbers repeat their first result, and how
often dead reckoning repeats its own and how far it lies from the CPU's.
"""

import os

import numpy as np
import pytest
import torch

from sonar_slam_torch.estimators import (
    DRConfig,
    DRTicks,
    GyroConfig,
    dead_reckoning_scan,
    dead_reckoning_with_basis_scan,
    dvl_basis_scan,
    gyro_integrate,
)
from sonar_slam_torch.io.dataset import SensorStreams, build_dr_ticks
from sonar_slam_torch.io.simulate import SimConfig, simulate_bag
from sonar_slam_torch.pipeline import odometry

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dr_small_survey.npz")
# bench.py --small's survey (chip_smoke.small_config)
SMALL_SURVEY = SimConfig(duration=90.0, speed=0.5, sonar_rate=1.0,
                         num_ranges=192, num_bearings=96, loop_radius=10.0,
                         imu_rate=20.0, seed=0)

# bench.py's full survey, rendered at 64 x 32: the front ends read no ping,
# and the sensor streams do not depend on the image size
SURVEY = SimConfig(duration=480.0, speed=0.5, sonar_rate=5.0, num_ranges=64,
                   num_bearings=32, loop_radius=18.0, imu_rate=50.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the scans in question are the card's)")
    return torch.device("cuda", 0)


def _deltas(n: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.standard_normal((n, 3)) * 1e-3)
                           .astype(np.float32))


@pytest.mark.cuda
def test_gyro_integrate_repeats_bit_for_bit(card):
    cfg = GyroConfig(offset_matrix=torch.eye(3, device=card), latitude=0.0,
                     sensor_rate=50.0, roll0=0.0)
    deltas = _deltas(24000).to(card)
    first = gyro_integrate(deltas, cfg)
    for _ in range(200):
        assert torch.equal(gyro_integrate(deltas, cfg), first)


@pytest.mark.cuda
@pytest.mark.parametrize("frontend", ["dr_gyro", "kalman"])
def test_front_end_repeats_bit_for_bit(card, frontend):
    bag = simulate_bag(SURVEY)
    poses = [odometry(bag, card, frontend)[1] for _ in range(3)]
    assert all(torch.equal(p, poses[0]) for p in poses[1:])


def _long_ticks(n: int, device, seed: int = 0) -> DRTicks:
    """An hour of DVL ticks at 5 Hz: a wandering heading, speeds around
    0.5 m/s with a few over-speed glitches, some invalid ticks."""
    rng = np.random.default_rng(seed)
    time = (np.arange(n) * 0.2).astype(np.float32)
    vel = (rng.standard_normal((n, 3)) * 0.05
           + [0.5, 0.02, 0.0]).astype(np.float32)
    vel[rng.choice(n, 20, replace=False), 0] = 1.6
    euler = np.zeros((n, 3), np.float32)
    euler[:, :2] = rng.standard_normal((n, 2)) * 0.01
    euler[:, 2] = np.cumsum(rng.standard_normal(n) * 0.01)
    valid = np.ones(n, bool)
    valid[rng.choice(n, 50, replace=False)] = False
    arrs = {"time": time, "vel": vel, "euler": euler,
            "gyro_yaw": euler[:, 2].copy(),
            "depth": (2.0 + rng.standard_normal(n) * 0.01).astype(np.float32),
            "valid": valid}
    return DRTicks(**{k: torch.as_tensor(v, device=device)
                      for k, v in arrs.items()})


@pytest.mark.cuda
def test_dead_reckoning_on_an_hour_of_ticks_repeats_bit_for_bit(card):
    ticks = _long_ticks(18000, card)
    cfg = DRConfig(roll_offset=0.0)
    first = dead_reckoning_scan(ticks, cfg)
    for _ in range(200):
        assert torch.equal(dead_reckoning_scan(ticks, cfg), first)


def _small_survey_ticks():
    bag = simulate_bag(SMALL_SURVEY)
    return build_dr_ticks(SensorStreams(
        imu_time=bag.imu_time, imu_rpy=bag.imu_rpy, dvl_time=bag.dvl_time,
        dvl_vel=bag.dvl_vel, depth_time=bag.depth_time, depth=bag.depth),
        torch.device("cpu")).ticks


def _dr_outputs(ticks):
    poses, basis = dead_reckoning_with_basis_scan(ticks, DRConfig(roll_offset=0.0))
    return {"poses_roll0": dead_reckoning_scan(ticks, DRConfig(roll_offset=0.0)),
            "poses_default": dead_reckoning_scan(ticks, DRConfig()),
            "basis_poses": poses, "basis": basis}


def test_dead_reckoning_on_the_cpu_is_unchanged_bit_for_bit():
    """Dead reckoning and its basis lanes on the CPU give the stored bits
    (sequential sums), whatever form the card's scans take."""
    ticks = _small_survey_ticks()
    golden = np.load(GOLDEN)
    for name, got in _dr_outputs(ticks).items():
        assert np.array_equal(got.numpy(), golden[name]), name
    assert np.array_equal(dvl_basis_scan(ticks, DRConfig(roll_offset=0.0)).numpy(),
                          golden["basis"])


if __name__ == "__main__":
    dev = torch.device("cuda", 0)
    for n in (2400, 24000):
        x = _deltas(n)[:, 0].to(dev)
        one, rows = torch.cumsum(x, 0), torch.cumsum(torch.stack([x, x]), 1)
        d_one = sum(not torch.equal(torch.cumsum(x, 0), one)
                    for _ in range(300))
        d_rows = sum(not torch.equal(torch.cumsum(torch.stack([x, x]), 1),
                                     rows) for _ in range(300))
        print(f"{n} samples: a single-row scan differs from its first result "
              f"in {d_one} of 300 runs, a two-row scan in {d_rows} of 300; "
              f"the two forms {float((rows[0] - one).abs().max()):.3e} apart "
              f"({torch.cuda.get_device_name(0)})")
    # dead reckoning (its x and y scanned as rows), on an hour of ticks and
    # on the small survey's, against the CPU's sequential sums
    cfg = DRConfig(roll_offset=0.0)
    for name, ticks in (("18000 DR ticks", _long_ticks(18000, dev)),
                        ("the small survey's DR ticks", DRTicks(*(
                            v.to(dev) for v in _small_survey_ticks())))):
        cpu = dead_reckoning_scan(DRTicks(*(v.cpu() for v in ticks)), cfg)
        first = dead_reckoning_scan(ticks, cfg)
        diff = sum(not torch.equal(dead_reckoning_scan(ticks, cfg), first)
                   for _ in range(300))
        gap = float((first.cpu() - cpu)[:, :2].abs().max())
        print(f"{name}: dead reckoning differs from its first result in "
              f"{diff} of 300 runs; its positions lie {gap:.3e} m from the "
              f"CPU's")
