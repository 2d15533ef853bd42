"""The port's numpy host copies (simulator, sonar geometry, stream alignment,
CFAR threshold factors) give the same arrays as the JAX package's."""

import numpy as np
import pytest
import torch

import sonar_slam_tpu.io.dataset as jds
import sonar_slam_tpu.io.simulate as jsim
import sonar_slam_tpu.kernels.cfar_factors as jcf
import sonar_slam_torch.io.dataset as tds
import sonar_slam_torch.io.simulate as tsim
import sonar_slam_torch.kernels.cfar_factors as tcf

torch.set_num_threads(1)

SIM = dict(duration=30.0, speed=0.5, sonar_rate=1.0, num_ranges=64,
           num_bearings=32, loop_radius=8.0, imu_rate=20.0, seed=3)


@pytest.fixture(scope="module")
def bags():
    return (jsim.simulate_bag(jsim.SimConfig(**SIM)),
            tsim.simulate_bag(tsim.SimConfig(**SIM)))


def test_simulate_bag_array_equal(bags):
    jb, tb = bags
    for name in jb._fields:
        a, b = getattr(jb, name), getattr(tb, name)
        if name in ("geometry", "vertical_geometry"):
            continue
        if a is None:
            assert b is None, name
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=name)
    g, h = jb.geometry, tb.geometry
    assert (g.num_ranges, g.num_bearings, g.range_resolution) == (
        h.num_ranges, h.num_bearings, h.range_resolution)
    np.testing.assert_array_equal(h.bearings, g.bearings)
    np.testing.assert_array_equal(h.cell_points(), g.cell_points())


def test_dr_ticks_and_ping_matching(bags):
    jb, tb = bags
    kw = dict(imu_time=jb.imu_time, imu_rpy=jb.imu_rpy, dvl_time=jb.dvl_time,
              dvl_vel=jb.dvl_vel, depth_time=jb.depth_time, depth=jb.depth)
    jt = jds.build_dr_ticks(jds.SensorStreams(**kw))
    tt = tds.build_dr_ticks(tds.SensorStreams(**kw), torch.device("cpu"))
    for name in jt.ticks._fields:
        np.testing.assert_array_equal(getattr(tt.ticks, name).numpy(),
                                      np.asarray(getattr(jt.ticks, name)),
                                      err_msg=name)
    ji, jok = jds.match_pings_to_ticks(jb.ping_time, jt.tick_time)
    ti, tok = tds.match_pings_to_ticks(tb.ping_time, tt.tick_time)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tok, jok)


@pytest.mark.parametrize("ntc,pfa,rank", [(40, 0.1, 10), (20, 0.05, 7)])
def test_threshold_factors_equal(ntc, pfa, rank):
    assert tcf.threshold_factor_ca(ntc, pfa) == jcf.threshold_factor_ca(ntc, pfa)
    assert tcf.threshold_factor_soca(ntc, pfa) == jcf.threshold_factor_soca(ntc, pfa)
    assert tcf.threshold_factor_goca(ntc, pfa) == jcf.threshold_factor_goca(ntc, pfa)
    assert tcf.threshold_factor_os(ntc, rank, pfa) == jcf.threshold_factor_os(
        ntc, rank, pfa)
