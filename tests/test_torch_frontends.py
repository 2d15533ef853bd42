"""The FOG-gyro and Kalman odometry front ends: the port against the JAX
package on the same seeded inputs.

* ``gyro_integrate``: one matmul and cumulative sums; within 2e-6 rad over
  5,000 samples (the sums run in other orders).
* ``kalman_scan`` with the FOG: the reference's R_gyro of 1e-8 makes each
  gyro correction cancel P[11, 11] to about 1e-8 in float32, so a stream
  with two gyro events and no prediction between loses that entry to
  rounding in both packages; the streams here interleave them as a bag
  does.
* ``kalman_scan``: the filter state after every event agrees to float32
  rounding: x within 1e-5 and P within 1e-7 on a random stream. The pose
  integral is a cumulative sum where the JAX scan adds sequentially; over
  the full survey's 24,000 IMU events the positions differ by up to 2.1e-4
  m (measured), as the dead-reckoning sum does (ROADMAP queue 3); yaw,
  roll and pitch within 1e-6 rad.
* ``KalmanConfig.default``: equal, field by field, to what the JAX
  package's ``load_kalman_config()`` reads from kalman.yaml.
* The full configuration's odometry (tests/golden/full_frontends_odometry.npz,
  which chip_smoke.py holds the card to): the JAX ``dr_gyro`` and ``kalman``
  front ends at the 2,398 pings of bench.py's full survey, with the
  keyframe pings each gives. The streams do not depend on the image size, so
  the file is built from the survey rendered at 16 x 8 (the test checks
  that its streams equal those of the full 512 x 256 configuration). The
  port gives the same keyframes (73 with dr_gyro, 72 with kalman), and
  odometry at the pings within 3e-4 m and 1e-5 rad (measured: dr_gyro
  1.1e-4 m and 1.9e-6 rad, the FOG yaw summed over 24,000 samples; kalman
  2.1e-4 m and 3e-8 rad).

Regenerate the golden file with ``python tests/test_torch_frontends.py``.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.estimators as je
import sonar_slam_tpu.geometry as jg
import sonar_slam_tpu.io.dataset as jds
import sonar_slam_tpu.io.simulate as jsim
import sonar_slam_tpu.pipeline as jpipe
import sonar_slam_tpu.slam.core as jcore
from sonar_slam_tpu.io.config import load_kalman_config

import sonar_slam_torch.estimators as te
import sonar_slam_torch.io.simulate as tsim
import sonar_slam_torch.pipeline as tpipe
import sonar_slam_torch.slam.core as tcore
from sonar_slam_torch.convert import (
    gyro_config_from_reference,
    kalman_config_from_reference,
    params_from_reference,
)
from sonar_slam_torch.geometry import pose3_to_pose2
from sonar_slam_torch.io.dataset import match_pings_to_ticks

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "full_frontends_odometry.npz")
# bench.py's full survey (chip_smoke.full_config), rendered at 16 x 8
FULL_SIM = dict(duration=480.0, speed=0.5, sonar_rate=5.0, num_ranges=512,
                num_bearings=256, loop_radius=18.0, imu_rate=50.0, seed=0)
TINY = dict(num_ranges=16, num_bearings=8)
STREAMS = ("imu_time", "imu_rpy", "dvl_time", "dvl_vel", "depth_time", "depth",
           "gyro_time", "gyro_delta", "ping_time", "true_pose_at_ping")
ODO_POS_ATOL, ODO_ANG_ATOL = 3e-4, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_gyro_integrate():
    rng = np.random.default_rng(0)
    deltas = (1e-3 * rng.normal(size=(5000, 3))).astype(np.float32)
    R = np.asarray(jg.rot3_ypr(jnp.float32(0.3), jnp.float32(-0.2),
                               jnp.float32(1.1)))
    jcfg = je.GyroConfig(offset_matrix=jnp.asarray(R), latitude=0.7106,
                         sensor_rate=250.0)
    j = np.asarray(je.gyro_integrate(jnp.asarray(deltas), jcfg))
    t = te.gyro_integrate(torch.as_tensor(deltas),
                          gyro_config_from_reference(_np(jcfg), "cpu")).numpy()
    np.testing.assert_allclose(t, j, atol=2e-6)


def _jax_kalman_config(use_gyro=False, dt=None):
    kc = load_kalman_config()._replace(use_gyro=use_gyro)
    if dt is not None:
        A = np.array(kc.A_imu)
        A[0, 6] = A[1, 7] = A[3, 9] = A[4, 10] = dt
        kc = kc._replace(dt_imu=dt, A_imu=jnp.asarray(A), imu_offset=0.0)
    return kc


def test_kalman_config_default_is_the_yaml():
    ref = load_kalman_config()
    got = te.KalmanConfig.default("cpu")
    for name in te.KalmanConfig._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        else:
            assert a == b, name
    assert got.dvl_max_velocity == 0.5  # the yaml's, not the class default


@pytest.mark.parametrize("use_gyro", [False, True])
def test_kalman_scan_random_stream(use_gyro):
    rng = np.random.default_rng(1)
    types = rng.choice(3, size=700).astype(np.int32)
    types[:2] = [2, 1]  # corrections before the first IMU event
    if use_gyro:
        # a FOG event after each IMU event, as a merged bag interleaves them.
        # Two gyro corrections with no prediction between would cancel
        # P[11, 11] (R_gyro is 1e-8) down to its last bits in both packages
        types = np.concatenate([[t, 3] if t == 0 else [t] for t in types])
        types = types.astype(np.int32)
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
    jcfg = _jax_kalman_config(use_gyro)
    state, jp = je.kalman_scan(jnp.asarray(types), jnp.asarray(z), jcfg)
    x, P, tp = te.kalman_scan(types, torch.as_tensor(z),
                              kalman_config_from_reference(_np(jcfg), "cpu"))
    np.testing.assert_allclose(x.numpy(), np.asarray(state.x), atol=1e-5)
    np.testing.assert_allclose(P.numpy(), np.asarray(state.P), atol=1e-7)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    assert np.abs(np.asarray(jp)[:, :2]).max() > 0.1


def _full_params(jdims):
    return jcore.SlamParams.default(jdims)._replace(
        keyframe_translation=jnp.float32(3.0))


def _jax_dims():
    from sonar_slam_tpu.cloud import ICPConfig

    return jcore.SlamDims(max_keyframes=128, max_points=256,
                          target_capacity=1024, icp=ICPConfig())


def jax_full_frontends(bag) -> dict:
    """The JAX front ends' odometry at the pings and keyframe pings on
    ``bag``, as the JAX replay computes them (steps 1-3) at the full
    configuration: ``dr_gyro`` with DR-basis aggregation (the configuration
    asks for the basis integrals) and ``kalman`` with the default
    configuration adapted to the bag's IMU rate."""
    params = _full_params(_jax_dims())
    out = {}
    for frontend in ("dr_gyro", "kalman"):
        if frontend == "kalman":
            dt = float(np.median(np.diff(bag.imu_time)))
            tick_time, poses3 = jpipe._kalman_odometry(
                bag, _jax_kalman_config(dt=dt))
        else:
            gcfg = je.GyroConfig(offset_matrix=jnp.eye(3, dtype=jnp.float32),
                                 latitude=0.0, sensor_rate=50.0, roll0=0.0)
            ypr = je.gyro_integrate(jnp.asarray(bag.gyro_delta), gcfg)
            streams = jds.SensorStreams(
                imu_time=bag.imu_time, imu_rpy=bag.imu_rpy,
                dvl_time=bag.dvl_time, dvl_vel=bag.dvl_vel,
                depth_time=bag.depth_time, depth=bag.depth,
                gyro_time=bag.gyro_time, gyro_yaw=np.asarray(ypr[:, 0]))
            bundle = jds.build_dr_ticks(streams)
            tick_time = bundle.tick_time
            poses3, _ = je.dead_reckoning_with_basis_scan(
                bundle.ticks, je.DRConfig(roll_offset=0.0, use_gyro=True))
        tick_idx, sync_ok = jds.match_pings_to_ticks(bag.ping_time, tick_time)
        ping3 = np.asarray(poses3)[tick_idx]
        candidate = sync_ok
        kf = jcore.select_keyframes(jnp.asarray(bag.ping_time),
                                    jg.pose3_to_pose2(jnp.asarray(ping3)),
                                    jnp.asarray(candidate), params)
        out[f"{frontend}_ping_pose3"] = ping3
        out[f"{frontend}_keyframe_ping_idx"] = np.nonzero(np.asarray(kf))[0]
    return out


def port_full_frontends(bag, device="cpu") -> dict:
    """The port's counterpart of ``jax_full_frontends`` (the odometry of the
    port's ``replay`` at the pings, and its keyframe gate)."""
    params = params_from_reference(_np(_full_params(_jax_dims())), device)
    out = {}
    for frontend in ("dr_gyro", "kalman"):
        tick_time, poses3, _ = tpipe.odometry(bag, device, frontend, basis=True)
        tick_idx, sync_ok = match_pings_to_ticks(bag.ping_time, tick_time)
        ping3 = poses3[torch.as_tensor(tick_idx, device=device)]
        kf = tcore.select_keyframes(
            torch.as_tensor(bag.ping_time, device=device), pose3_to_pose2(ping3),
            torch.as_tensor(sync_ok, device=device), params)
        out[f"{frontend}_ping_pose3"] = ping3.cpu().numpy()
        out[f"{frontend}_keyframe_ping_idx"] = np.nonzero(kf.cpu().numpy())[0]
    return out


@pytest.fixture(scope="module")
def tiny_full_bag():
    return jsim.simulate_bag(jsim.SimConfig(**{**FULL_SIM, **TINY}))


def test_golden_streams_are_the_full_configuration(tiny_full_bag, monkeypatch):
    # the streams are drawn before any ping is rendered: skip the 512 x 256
    # rendering and compare the full configuration's streams
    monkeypatch.setattr(tsim, "render_ping",
                        lambda *a, **k: np.zeros((1, 1), np.float32))
    full = tsim.simulate_bag(tsim.SimConfig(**FULL_SIM))
    for name in STREAMS:
        np.testing.assert_array_equal(getattr(tiny_full_bag, name),
                                      getattr(full, name), err_msg=name)
    assert len(full.ping_time) == 2398


def test_golden_matches_jax(tiny_full_bag):
    ref = np.load(GOLDEN)
    new = jax_full_frontends(tiny_full_bag)
    assert sorted(ref.files) == sorted(new)
    for name in new:  # indices exactly, odometry to float32 rounding
        if name.endswith("keyframe_ping_idx"):
            np.testing.assert_array_equal(new[name], ref[name], err_msg=name)
        else:
            np.testing.assert_allclose(new[name], ref[name], atol=1e-5,
                                       err_msg=name)


def test_port_full_frontends_match_golden(tiny_full_bag):
    ref = np.load(GOLDEN)
    got = port_full_frontends(tiny_full_bag)
    for frontend in ("dr_gyro", "kalman"):
        np.testing.assert_array_equal(got[f"{frontend}_keyframe_ping_idx"],
                                      ref[f"{frontend}_keyframe_ping_idx"])
        a, b = got[f"{frontend}_ping_pose3"], ref[f"{frontend}_ping_pose3"]
        np.testing.assert_allclose(a[:, :3], b[:, :3], atol=ODO_POS_ATOL)
        np.testing.assert_allclose(a[:, 3:], b[:, 3:], atol=ODO_ANG_ATOL)


def test_kalman_refuses_dr_basis_aggregation(tiny_full_bag):
    from sonar_slam_torch.slam import FeatureConfig, SlamDims, SlamParams

    dims = SlamDims(max_keyframes=128, aggregate_with_dr_basis=True)
    with pytest.raises(ValueError, match="aggregate_with_dr_basis"):
        tpipe.replay(tiny_full_bag, FeatureConfig(), SlamParams.default(dims, "cpu"),
                     dims, "cpu", frontend="kalman")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    bag = jsim.simulate_bag(jsim.SimConfig(**{**FULL_SIM, **TINY}))
    np.savez_compressed(GOLDEN, **jax_full_frontends(bag))
    print("wrote", GOLDEN)


# ----------------------------------------------------------------------
# whole replays on a small bag (tests/test_frontends.py's configuration),
# shared by tests/test_torch_replay_{dr_gyro,kalman,kalman_gyro,dual}.py
# ----------------------------------------------------------------------

SMALL_SIM = dict(duration=60.0, speed=0.5, sonar_rate=1.0, num_ranges=128,
                 num_bearings=64, loop_radius=10.0, imu_rate=20.0,
                 gyro_rate=20.0)
DUAL_SIM = dict(duration=50.0, speed=0.5, sonar_rate=1.0, num_ranges=128,
                num_bearings=64, loop_radius=10.0, imu_rate=20.0,
                vertical_sonar=True, seafloor_depth=4.0,
                vertical_aperture_deg=60.0)


def small_dims():
    from sonar_slam_tpu.cloud import ICPConfig

    return jcore.SlamDims(
        max_keyframes=16, max_points=96, target_capacity=256,
        nssm_cov_samples=8, ssm_sobol=32, nssm_sobol=64, max_loops=8,
        gn_iters=3, icp=ICPConfig(min_diff_rot=1e-3, min_diff_trans=1e-2))


def small_params(jdims):
    return jcore.SlamParams.default(jdims)._replace(
        keyframe_translation=jnp.float32(2.0),
        ssm_min_points=jnp.asarray(15, jnp.int32),
        nssm_min_points=jnp.asarray(15, jnp.int32),
        fuse_odometry=jnp.asarray(True),
        odom_sigmas=jnp.asarray([0.05, 0.05, 0.01], jnp.float32),
        icp_odom_sigmas=jnp.asarray([0.3, 0.3, 0.03], jnp.float32))


def small_replays(sim=SMALL_SIM, kalman_gyro=False, **kw):
    """The same small bag replayed by both packages on the CPU with the
    replay options ``kw``: (bag, jdims, jparams, JAX result, port result)."""
    from sonar_slam_tpu.slam.frontend import FeatureConfig as JFC

    from sonar_slam_torch.convert import (dims_from_reference,
                                          feature_config_from_reference)

    jdims = small_dims()
    jparams = small_params(jdims)
    jfc = JFC(max_points=96)
    bag = jsim.simulate_bag(jsim.SimConfig(**sim))
    jkw, tkw = dict(kw), dict(kw)
    if kalman_gyro:
        dt = float(np.median(np.diff(bag.imu_time)))
        jkc = _jax_kalman_config(use_gyro=True, dt=dt)
        jkw["kalman_config"] = jkc
        tkw["kalman_config"] = kalman_config_from_reference(_np(jkc), "cpu")
    jres = jpipe.replay(bag, jfc, jparams, jdims, **jkw)
    tres = tpipe.replay(tsim.simulate_bag(tsim.SimConfig(**sim)),
                        feature_config_from_reference(jfc),
                        params_from_reference(_np(jparams), "cpu"),
                        dims_from_reference(jdims), "cpu", **tkw)
    return bag, jdims, jparams, jres, tres


def jax_scan_on_port_inputs(tres, jdims, jparams):
    """The JAX scan fed the port's keyframe inputs (odometry, clouds)."""
    nk, tc = tres.num_keyframes, tres.carry
    frames = jcore.KeyframeInput(
        time=jnp.asarray(tc.times.numpy()),
        dr_pose3=jnp.asarray(tc.dr_poses3.numpy()),
        points=jnp.asarray(tc.points.numpy()),
        pmask=jnp.asarray(tc.pmasks.numpy()),
        valid=jnp.arange(jdims.max_keyframes) < nk,
        conf=jnp.asarray(tc.pconf.numpy()))
    jc, _ = jcore.slam_scan(frames, jparams, jdims, None)
    return jc


def port_scan_on_jax_inputs(jres, jdims, jparams):
    """The port's scan fed the JAX replay's keyframe inputs."""
    jc = jres.carry
    frames = tcore.KeyframeInput(
        time=torch.as_tensor(np.asarray(jc.times)),
        dr_pose3=torch.as_tensor(np.asarray(jc.dr_poses3)),
        points=torch.as_tensor(np.asarray(jc.points)),
        pmask=torch.as_tensor(np.asarray(jc.pmasks)),
        valid=torch.arange(jdims.max_keyframes) < jres.num_keyframes,
        conf=torch.as_tensor(np.asarray(jc.pconf)))
    from sonar_slam_torch.convert import dims_from_reference

    carry, _ = tcore.slam_scan(frames, params_from_reference(_np(jparams), "cpu"),
                               dims_from_reference(jdims))
    return carry


def check_small_replay(replays, odo_atol, scan_atol, own_atol,
                       scan_on="port"):
    """Keyframes, loop count and clouds equal; odometry at the ticks within
    ``odo_atol``; the trajectory within ``own_atol`` of the JAX replay's
    own. With ``scan_on="port"`` the port's trajectory lies within
    ``scan_atol`` of the JAX scan fed the port's keyframe inputs (with the
    same loop log); with ``scan_on="jax"`` the port's scan fed the JAX
    replay's keyframe inputs lies within ``scan_atol`` of the JAX
    trajectory. Returns the two gaps."""
    bag, jdims, jparams, jres, tres = replays
    np.testing.assert_array_equal(tres.keyframe_ping_idx, jres.keyframe_ping_idx)
    assert tres.carry.num_loops == int(jres.carry.num_loops)
    a, b = tres.dr_poses_at_ticks, np.asarray(jres.dr_poses_at_ticks)
    np.testing.assert_allclose(a, b, atol=odo_atol)
    np.testing.assert_array_equal(tres.carry.pmasks.numpy(),
                                  np.asarray(jres.carry.pmasks))
    nk = tres.num_keyframes
    if scan_on == "port":
        scan = jax_scan_on_port_inputs(tres, jdims, jparams)
        ref, other = tres.carry, scan
    else:
        scan = port_scan_on_jax_inputs(jres, jdims, jparams)
        ref, other = jres.carry, scan
    nl = int(scan.num_loops)
    assert int(ref.num_loops) == nl
    np.testing.assert_array_equal(np.asarray(ref.loops_j)[:nl],
                                  np.asarray(other.loops_j)[:nl])
    scan_gap = float(np.abs(np.asarray(ref.poses)[:nk]
                            - np.asarray(other.poses)[:nk]).max())
    own_gap = float(np.abs(tres.trajectory - jres.trajectory).max())
    assert scan_gap <= scan_atol, scan_gap
    assert own_gap <= own_atol, own_gap
    truth = bag.true_pose_at_ping[tres.keyframe_ping_idx]
    assert tpipe.ate_rmse(tres.trajectory, truth) < 3.0
    return scan_gap, own_gap
