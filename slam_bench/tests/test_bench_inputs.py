"""The benchmark's frozen inputs against what they were frozen from: the
simulator against the port's ``simulate_bag``, the configurations as data
against ``chip_smoke.py``'s builders (bench.py's full configuration)."""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from slam_bench import simulate  # noqa: E402
from slam_bench.harness import configs  # noqa: E402
from sonar_slam_torch.io import simulate as port_simulate  # noqa: E402


def load(name):
    with open(os.path.join(ROOT, "slam_bench", "configs", name + ".json")) as f:
        return json.load(f)


def test_frozen_simulator_is_bit_for_bit():
    kw = dict(duration=12.0, speed=0.5, sonar_rate=2.0, num_ranges=64,
              num_bearings=32, seed=4294967301, world_seed=0)
    ours = simulate.simulate_bag(simulate.SimConfig(**kw))
    port = port_simulate.simulate_bag(port_simulate.SimConfig(**kw))
    for name in port._fields:
        a, b = getattr(ours, name), getattr(port, name)
        if name == "geometry":
            assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
            for k, v in dataclasses.asdict(b).items():
                np.testing.assert_array_equal(getattr(a, k), v)
        elif b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
            assert np.asarray(a).dtype == np.asarray(b).dtype


def test_prefix_cuts_every_stream():
    bag = simulate.simulate_bag(simulate.SimConfig(
        duration=12.0, num_ranges=32, num_bearings=16, sonar_rate=2.0))
    cut = configs.prefix(bag, 6.0)
    assert cut.ping_time.max() <= 6.0 and cut.dvl_time.max() <= 6.0
    assert len(cut.ping_images) == len(cut.ping_time) == len(
        cut.true_pose_at_ping)
    assert len(cut.imu_rpy) == len(cut.imu_time) < len(bag.imu_time)


def same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_offline_config_is_benchs_full_configuration():
    sim, dims, params, fcfg, rparams = chip_smoke.full_os_config(7)
    cfg = load("m750d_offline")
    built = configs.build(cfg, configs.port_types(), "cpu")
    assert built.dims == dims
    want = params("cpu")
    for k in want._fields:
        assert same(getattr(built.params, k), getattr(want, k)), k
    assert built.features == fcfg._replace(alg="SOCA", rank=10)
    for k in built.refine_params._fields:
        assert same(getattr(built.refine_params, k),
                    getattr(rparams("cpu"), k)), k
    s = configs.sim_config(cfg, 7)
    for f in dataclasses.fields(sim):
        if f.name != "world_seed":
            assert getattr(s, f.name) == getattr(sim, f.name), f.name
    assert s.world_seed == 0


def test_live_config_is_the_full_config_without_basis_or_refinement():
    sim, dims, params, fcfg = chip_smoke.full_config(0)
    built = configs.build(load("m750d_live"), configs.port_types(), "cpu")
    assert built.dims == dataclasses.replace(dims,
                                             aggregate_with_dr_basis=False)
    assert built.dims.refine_iters == 0 and built.refine_params is None
    want = params("cpu")
    for k in want._fields:
        assert same(getattr(built.params, k), getattr(want, k)), k
    assert built.features == fcfg


def test_reference_builds_the_same_configuration():
    cfg = load("m750d_offline")
    port = configs.build(cfg, configs.port_types(), "cpu")
    ref = configs.build(cfg, configs.reference_types(), "cpu")
    assert dataclasses.asdict(port.dims) == dataclasses.asdict(ref.dims)
    for k in port.params._fields:
        assert same(getattr(port.params, k), getattr(ref.params, k)), k
