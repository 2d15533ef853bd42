"""Dead reckoning and the keyframe gate: the port against the JAX scans.

The port's dead reckoning replaces the sequential float32 scan by forward
fills and a cumulative sum over the tick axis. Headings, depth and the gate
decisions are exact; positions agree to float32 rounding of a 20 m-scale
sum over a few thousand ticks: 2e-4 m.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.estimators as je
import sonar_slam_tpu.geometry as jg
import sonar_slam_tpu.io.dataset as jds
import sonar_slam_tpu.io.simulate as jsim
import sonar_slam_tpu.slam.core as jcore
import sonar_slam_torch.estimators as te
import sonar_slam_torch.slam.core as tcore
from sonar_slam_torch.convert import (
    dims_from_reference,
    dr_config_from_reference,
    params_from_reference,
)

torch.set_num_threads(1)
POS_ATOL = 2e-4


@pytest.fixture(scope="module")
def ticks():
    bag = jsim.simulate_bag(jsim.SimConfig(
        duration=300.0, speed=0.5, sonar_rate=1.0, num_ranges=32,
        num_bearings=16, loop_radius=10.0, imu_rate=20.0, dvl_rate=10.0))
    jt = jds.build_dr_ticks(jds.SensorStreams(
        imu_time=bag.imu_time, imu_rpy=bag.imu_rpy, dvl_time=bag.dvl_time,
        dvl_vel=bag.dvl_vel, depth_time=bag.depth_time, depth=bag.depth)).ticks
    arrs = {k: np.array(v) for k, v in jt._asdict().items()}
    rng = np.random.default_rng(0)
    T = len(arrs["time"])
    arrs["valid"][:3] = False  # ticks before the first valid one
    arrs["valid"][rng.choice(T, 40, replace=False)] = False
    over = rng.choice(np.arange(10, T), 30, replace=False)
    arrs["vel"][over, 0] = 1.7  # over-speed glitches reuse the last good velocity
    arrs["vel"][3, 0] = 2.0  # over-speed before initialization drops the tick
    return arrs


def _both(arrs):
    jt = je.DRTicks(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tt = te.DRTicks(**{k: torch.as_tensor(v) for k, v in arrs.items()})
    return jt, tt


@pytest.mark.parametrize("roll_offset", [0.0, np.pi / 2])
def test_dead_reckoning_scan(ticks, roll_offset):
    jt, tt = _both(ticks)
    jcfg = je.DRConfig(roll_offset=roll_offset)
    _, jp = je.dead_reckoning_scan(jt, jcfg)
    tp = te.dead_reckoning_scan(tt, dr_config_from_reference(jcfg)).numpy()
    jp = np.asarray(jp)
    np.testing.assert_allclose(tp[:, :2], jp[:, :2], atol=POS_ATOL)
    np.testing.assert_array_equal(tp[:, 2:], jp[:, 2:])


def test_dead_reckoning_with_basis(ticks):
    jt, tt = _both(ticks)
    cfg = dict(roll_offset=0.0)
    jp, jb = je.dead_reckoning_with_basis_scan(jt, je.DRConfig(**cfg))
    tp, tb = te.dead_reckoning_with_basis_scan(tt, te.DRConfig(**cfg))
    np.testing.assert_allclose(tp.numpy()[:, :2], np.asarray(jp)[:, :2], atol=POS_ATOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=POS_ATOL)
    np.testing.assert_allclose(te.dvl_basis_scan(tt, te.DRConfig(**cfg)).numpy(),
                               np.asarray(je.dvl_basis_scan(jt, je.DRConfig(**cfg))),
                               atol=POS_ATOL)


def test_select_keyframes(ticks):
    jt, _ = _both(ticks)
    _, jp = je.dead_reckoning_scan(jt, je.DRConfig(roll_offset=0.0))
    pose2 = np.asarray(jg.pose3_to_pose2(jp))
    times = ticks["time"]
    cand = ticks["valid"] & (np.arange(len(times)) % 2 == 0)
    jdims = jcore.SlamDims(max_keyframes=8, ssm_sobol=8, nssm_sobol=8)
    jparams = jcore.SlamParams.default(jdims)._replace(
        keyframe_translation=jnp.float32(2.0))
    jmask = np.asarray(jcore.select_keyframes(
        jnp.asarray(times), jnp.asarray(pose2), jnp.asarray(cand), jparams))
    params = params_from_reference(
        {k: np.asarray(v) for k, v in jparams._asdict().items()}, "cpu")
    tmask = tcore.select_keyframes(torch.as_tensor(times), torch.as_tensor(pose2),
                                   torch.as_tensor(cand), params).numpy()
    assert tmask.sum() > 10
    np.testing.assert_array_equal(tmask, jmask)
    assert dims_from_reference(jdims).graph_config().max_factors == \
        jdims.graph_config().max_factors


@pytest.mark.parametrize("basis", [False, True])
def test_dead_reckoning_use_gyro(ticks, basis):
    """The FOG yaw drives the heading and the roll carries no offset;
    positions within the cumulative sum's POS_ATOL, the rest equal."""
    arrs = dict(ticks)
    rng = np.random.default_rng(3)
    arrs["gyro_yaw"] = (np.cumsum(0.02 * rng.normal(size=len(arrs["time"])))
                        .astype(np.float32))
    jt, tt = _both(arrs)
    jcfg = je.DRConfig(roll_offset=np.pi / 2, use_gyro=True)
    tcfg = dr_config_from_reference(jcfg)
    assert tcfg.use_gyro
    if basis:
        jp, jb = je.dead_reckoning_with_basis_scan(jt, jcfg)
        tp, tb = te.dead_reckoning_with_basis_scan(tt, tcfg)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=POS_ATOL)
    else:
        _, jp = je.dead_reckoning_scan(jt, jcfg)
        tp = te.dead_reckoning_scan(tt, tcfg)
    jp, tp = np.asarray(jp), tp.numpy()
    np.testing.assert_allclose(tp[:, :2], jp[:, :2], atol=POS_ATOL)
    np.testing.assert_array_equal(tp[:, 2:], jp[:, 2:])
    used = arrs["valid"].copy()
    used[:4] = False  # tick 3 is dropped: over-speed before initialization
    np.testing.assert_array_equal(tp[used, 5], arrs["gyro_yaw"][used])
