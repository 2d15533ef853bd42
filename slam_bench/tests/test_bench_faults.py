"""The rest of a run with the timed path broken underneath: ``correct`` must
come out false for each fault a cell can have, and true with none.

The look for a card is skipped: each case drives ``run.run`` on the CPU with
bench.py --small's survey and dims (``small.py``) and the full cells'
limits. The faults: a SLAM step that returns its state unchanged; half of a
feature batch left out; an answer altered where it is produced (the
odometry, or a DR tick's pose). The cells run on one card, so no exchange
between cards can be left out. About 8 minutes on one core.
"""

import os
import sys
import time
from unittest import mock

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(BENCH_DIR))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(0, HERE)

import run as bench_run  # noqa: E402
import small  # noqa: E402
from sonar_slam_torch import estimators, pipeline, slam  # noqa: E402
from sonar_slam_torch.slam import core, frontend  # noqa: E402

SEED = 4294967311


def unchanged_step(owner):
    real = owner.keyframe_step

    def step(carry, frame, params, dims):
        _, out = real(carry, frame, params, dims)
        return carry, out

    return mock.patch.object(owner, "keyframe_step", step)


def half_batch():
    real = frontend.FeatureExtractor.extract_batch_conf

    def extract(self, imgs):
        pts, masks, conf = real(self, imgs)
        keep = torch.arange(masks.shape[0]) < (masks.shape[0] + 1) // 2
        return pts, masks & keep.to(masks.device)[:, None], conf

    return mock.patch.object(frontend.FeatureExtractor, "extract_batch_conf",
                             extract)


def altered_odometry():
    real = pipeline.odometry

    def odometry(*args, **kwargs):
        t, poses, basis = real(*args, **kwargs)
        return t, poses + torch.tensor([1e-3, 0, 0, 0, 0, 0]).to(poses), basis

    return mock.patch.object(pipeline, "odometry", odometry)


def altered_tick():
    real = estimators.dead_reckoning_step

    def step(state, tick, config):
        state, pose = real(state, tick, config)
        return state, pose + torch.tensor([0, 1e-3, 0, 0, 0, 0]).to(pose)

    return mock.patch.object(estimators, "dead_reckoning_step", step)


FAULTS = {
    "m750d_offline.replay": {
        "none": None,
        "step_unchanged": lambda: unchanged_step(core),
        "half_batch": half_batch,
        "answer_altered": altered_odometry,
    },
    "m750d_live.online": {
        "none": None,
        "step_unchanged": lambda: unchanged_step(slam),
        "half_batch": half_batch,
        "answer_altered": altered_tick,
    },
}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c, faults in FAULTS.items() for f in faults])
def test_fault_makes_the_run_incorrect(cell, fault):
    torch.set_num_threads(2)
    make = FAULTS[cell][fault]
    ctx = make() if make is not None else mock.patch.dict({})
    with ctx:
        out = bench_run.run(small.small_cell(cell), SEED, 0.0, False,
                            torch.device("cpu"), time.time(),
                            log=lambda m: None)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"] is (fault == "none"), checks
    assert out["attempted"] == len(checks)
