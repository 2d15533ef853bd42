"""The control on the card at a size a test run holds: the reference in the
program's place, computed in TF32 (the nearest precision below the
configurations' float32), must come out not correct against the float32
reference, on bench.py --small's survey and dims with the full cells'
limits; the program itself must come out correct there.

Marked ``cuda``: it skips without a card (the CPU has no TF32). On the card:
``python -m pytest --noconftest -m cuda slam_bench/tests`` from the
repository root. At the cells' own size the control is read by
``slam_bench/control.py --control``.
"""

import os
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(BENCH_DIR))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(0, HERE)

import run as bench_run  # noqa: E402
import small  # noqa: E402
from slam_bench import simulate  # noqa: E402
from slam_bench.harness import check, configs  # noqa: E402

CELLS = ("m750d_offline.replay", "m750d_live.online")
SEEDS = (4294967321, 4294967322, 4294967323)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control computes in TF32")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(cell, seed):
    dev = card()
    c = small.small_cell(cell)
    bag = simulate.simulate_bag(configs.sim_config(c.config, seed))
    mod = bench_run.driver_module(c)
    ctl = check.control_outputs(mod, bag, c.config, c.traffic, dev, seed)
    numbers = check.run_reference(mod, ctl, bag, c.config, c.traffic, dev)
    ok, _ = check.judge(numbers, c.limits)
    assert not ok, str(numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell):
    dev = card()
    out = bench_run.run(small.small_cell(cell), SEEDS[0], 0.0, False, dev,
                        time.time(), log=lambda m: None)
    assert out["correct"], str(out["checks"])
