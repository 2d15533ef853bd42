"""The FOG-gyro and Kalman front ends repeat bit for bit on a card.

On a card a cumulative sum over one long row goes through CUB's decoupled
look-back scan, in which a tile adds the partial sums of the tiles before it
in an order that depends on which of them have finished; ATen's row scan
walks each row in one block, in one order. A survey's gyro stream (24,000
samples) was integrated the first way, and one run on an H100 gave gyro
odometry 1.1e-4 m from the JAX package's where every other gave 9.0e-5 m,
which the ill-conditioned loops downstream turned into another ATE (no
other stage of that run moved; 300 back-to-back scans on an idle card did
not reproduce it). ``gyro_integrate`` and the Kalman pose integral scan
rows instead. On the CPU every scan is sequential, so the rows give the
bits the single row gave.

This file imports no JAX: ``python -m pytest --noconftest
tests/test_torch_odometry_cuda.py`` on a card; without one every test
skips. Run as a script on a card (``PYTHONPATH=. python
tests/test_torch_odometry_cuda.py``) it prints how often a single-row scan
and a two-row scan of the same numbers repeat their first result.
"""

import numpy as np
import pytest
import torch

from sonar_slam_torch.estimators import GyroConfig, gyro_integrate
from sonar_slam_torch.io.simulate import SimConfig, simulate_bag
from sonar_slam_torch.pipeline import odometry

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
