"""The Kalman cell's run with its timed path broken underneath: ``correct``
must come out false for each fault, and true with none.

As ``test_bench_faults.py``, on the CPU with bench.py --small's survey and
dims and the full cell's limits, and with that file's SLAM-step and
feature-batch faults. The odometry's fault: the first DVL message that the
filter's gate passes taken out of the Kalman filter's stream, the pose
before it held in its place, so the positions after it drift from the
reference's. About 4 minutes on one core.
"""

import os
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_bench_faults import (  # noqa: E402
    SEED, bench_run, half_batch, small, unchanged_step)

from sonar_slam_torch import estimators, pipeline  # noqa: E402
from sonar_slam_torch.slam import core  # noqa: E402

CELL = "m750d_kalman_offline.replay"


def dropped_dvl():
    """The first DVL message the gate passes taken out of the Kalman
    filter's stream, and the pose before it held in its place."""
    real = pipeline.kalman_scan

    def scan(types, z, config):
        zh = z.cpu().numpy()
        e = next(i for i in np.nonzero(types == estimators.EVENT_DVL)[0]
                 if np.all(np.abs(zh[i]) <= config.dvl_max_velocity))
        keep = np.arange(len(types)) != e
        x, P, poses = real(types[keep], z[torch.as_tensor(keep)], config)
        return x, P, torch.cat([poses[:e], poses[e - 1:e], poses[e:]])

    return mock.patch.object(pipeline, "kalman_scan", scan)


FAULTS = {
    "none": None,
    "dvl_dropped": dropped_dvl,
    "step_unchanged": lambda: unchanged_step(core),
    "half_batch": half_batch,
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_kalman_fault_makes_the_run_incorrect(fault):
    torch.set_num_threads(2)
    make = FAULTS[fault]
    ctx = make() if make is not None else mock.patch.dict({})
    with ctx:
        out = bench_run.run(small.small_cell(CELL), SEED, 0.0, False,
                            torch.device("cpu"), time.time(),
                            log=lambda m: None)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"] is (fault == "none"), checks
    assert out["attempted"] == len(checks)
