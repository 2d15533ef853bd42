"""The SLAM core and the whole replay slice: the port against the JAX package.

* ``keyframe_step``: both packages start from the same carry (the JAX carry
  after k keyframes, converted) and process keyframe k; the port's carry
  must match the JAX carry after k+1 keyframes. The dimensions switch on
  every branch bench.py's full configuration takes (DR-basis aggregation,
  DVL-scale estimation, NSSM re-initialization, windowed targets, pair
  refinement) at small capacities. Tolerance 1e-4 m / rad on poses: GN,
  ICP and the MCD run in float32 with sums in other orders.
* The whole slice at bench.py --small with refinement off: keyframe pings
  and loop count equal, trajectory within 1e-4 m (measured 1.5e-5 m). The
  JAX result must also match tests/golden/small_norefine_traj.npz, which
  chip_smoke.py compares the card against. The file also holds the JAX
  scan's result on the port's dead-reckoning poses, the other outcome of
  the survey's ill-conditioned first loop. The card's own dead reckoning
  (x and y scanned as rows, 1.9e-6 m from the CPU's) is a third input:
  tests/golden/small_norefine_traj_port_dr_rows.npz holds the JAX scan fed
  those card poses, with the poses; chip_smoke.py accepts it or the JAX
  result. Run as a script this file rewrites it from the hex dump that
  chip_smoke.py's phase 7 logs (the same poses; see the end of the file).
"""

import dataclasses
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
from sonar_slam_tpu.cloud import ICPConfig as JICP
from sonar_slam_tpu.slam.frontend import FeatureConfig as JFC
from sonar_slam_tpu.slam.frontend import FeatureExtractor as JFX

import sonar_slam_torch.io.simulate as tsim
import sonar_slam_torch.pipeline as tpipe
import sonar_slam_torch.slam.core as tcore
from sonar_slam_torch.convert import (
    carry_from_reference,
    dims_from_reference,
    feature_config_from_reference,
    params_from_reference,
)

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "small_norefine_traj.npz")
GOLDEN_ROWS = os.path.join(os.path.dirname(__file__), "golden",
                           "small_norefine_traj_port_dr_rows.npz")

SMALL_SIM = dict(duration=90.0, speed=0.5, sonar_rate=1.0, num_ranges=192,
                 num_bearings=96, loop_radius=10.0, imu_rate=20.0, seed=0)
ICP_PROD = dict(max_iterations=12, min_diff_rot=1e-3, min_diff_trans=1e-2,
                point_to_line=True, outlier_max_dist=0.5)
SMALL_DIMS = dict(max_keyframes=32, max_points=128, target_capacity=512,
                  nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=128,
                  max_loops=32, gn_iters=3, nssm_target_window=2,
                  nssm_pair_refine=True, pair_refine_max_dt=0.35,
                  pair_refine_max_dr=0.07, pair_refine_min_inliers=25,
                  refine_iters=0)


def _small_params(dims, **over):
    p = jcore.SlamParams.default(dims)._replace(
        keyframe_translation=jnp.float32(2.0),
        ssm_min_points=jnp.asarray(20, jnp.int32),
        nssm_min_points=jnp.asarray(20, jnp.int32),
        fuse_odometry=jnp.asarray(True), use_best_start_tf=jnp.asarray(True),
        nssm_every=jnp.asarray(1, jnp.int32),
        odom_sigmas=jnp.asarray([0.05, 0.05, 0.01], jnp.float32),
        icp_odom_sigmas=jnp.asarray([0.3, 0.3, 0.1], jnp.float32))
    return p._replace(**over)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def bag():
    return jsim.simulate_bag(jsim.SimConfig(**SMALL_SIM))


@pytest.fixture(scope="module")
def frames(bag):
    """JAX keyframe inputs of the small bag (the first 16 keyframes) and the
    DR basis at those keyframes."""
    jt = jds.build_dr_ticks(jds.SensorStreams(
        imu_time=bag.imu_time, imu_rpy=bag.imu_rpy, dvl_time=bag.dvl_time,
        dvl_vel=bag.dvl_vel, depth_time=bag.depth_time, depth=bag.depth))
    dr3, basis = je.dead_reckoning_with_basis_scan(
        jt.ticks, je.DRConfig(roll_offset=0.0))
    idx, ok = jds.match_pings_to_ticks(bag.ping_time, jt.tick_time)
    dims = jcore.SlamDims(icp=JICP(**ICP_PROD), **SMALL_DIMS)
    mask = np.asarray(jcore.select_keyframes(
        jnp.asarray(bag.ping_time), jg.pose3_to_pose2(dr3[idx]),
        jnp.asarray(ok), _small_params(dims)))
    sel = np.nonzero(mask)[0][:16]
    fx = JFX(JFC(max_points=128), bag.geometry)
    pts, pm, conf = fx.extract_batch_conf(jnp.asarray(bag.ping_images[sel]))
    return dict(time=np.asarray(bag.ping_time[sel], np.float32),
                dr_pose3=np.asarray(dr3[idx][sel]), points=np.asarray(pts),
                pmask=np.asarray(pm), conf=np.asarray(conf),
                basis=np.asarray(basis[idx][sel]))


def _step_dims():
    return jcore.SlamDims(
        icp=JICP(**ICP_PROD), **dict(
            SMALL_DIMS, max_keyframes=16, nssm_reinit_after_select=True,
            aggregate_with_dr=True, aggregate_with_dr_basis=True,
            estimate_dvl_scale=True))


@pytest.fixture(scope="module")
def reference_carries(frames):
    """The JAX carry after k valid keyframes for every k (one compiled scan,
    run with the valid mask cut at k)."""
    dims = _step_dims()
    params = _small_params(dims)
    out = {}
    for k in (1, 2, 9, 10, 11, 12):
        valid = np.arange(16) < k
        fr = jcore.KeyframeInput(
            time=jnp.asarray(frames["time"]), dr_pose3=jnp.asarray(frames["dr_pose3"]),
            points=jnp.asarray(frames["points"]),
            pmask=jnp.asarray(frames["pmask"] & valid[:, None]),
            valid=jnp.asarray(valid), conf=jnp.asarray(frames["conf"]))
        carry, outs = jcore.slam_scan_padded(fr, params, dims,
                                             jnp.asarray(frames["basis"]))
        out[k] = (_np(carry), _np(outs))
    return out


@pytest.mark.parametrize("k", [1, 9, 10, 11])
def test_keyframe_step_from_converted_carry(frames, reference_carries, k):
    jdims = _step_dims()
    jparams = _small_params(jdims)
    dims = dims_from_reference(jdims)
    params = params_from_reference(_np(jparams), "cpu")
    carry = carry_from_reference(reference_carries[k][0], "cpu")
    frame = tcore.KeyframeInput(
        time=torch.as_tensor(frames["time"][k]),
        dr_pose3=torch.as_tensor(frames["dr_pose3"][k]),
        points=torch.as_tensor(frames["points"][k]),
        pmask=torch.as_tensor(frames["pmask"][k]), valid=True,
        conf=torch.as_tensor(frames["conf"][k]))
    new, out = tcore.keyframe_step(carry, frame, params, dims)
    ref, ref_out = reference_carries[k + 1]
    assert bool(out.loop_added) == (k >= 9)  # steps 9-11 insert PCM loops
    assert new.num_kf == int(ref.num_kf) == k + 1
    assert new.num_loops == int(ref.num_loops)
    assert new.q_head == int(ref.q_head)
    for name in ("ssm_status", "nssm_status", "nssm_target", "loop_added",
                 "ssm_overlap", "nssm_overlap"):
        assert int(getattr(out, name)) == int(getattr(ref_out, name)[k]), name
    np.testing.assert_array_equal(new.ssm_slot.numpy(), ref.ssm_slot)
    np.testing.assert_array_equal(new.loops_i.numpy(), ref.loops_i)
    np.testing.assert_array_equal(new.loops_slot.numpy(), ref.loops_slot)
    np.testing.assert_array_equal(new.q_inserted.numpy(), ref.q_inserted)
    assert int(new.graph.num_factors) == int(ref.graph.num_factors)
    np.testing.assert_allclose(new.poses.numpy(), ref.poses, atol=1e-4)
    np.testing.assert_allclose(new.graph.log_scale.numpy(), ref.graph.log_scale,
                               atol=1e-5)
    np.testing.assert_allclose(new.covs.numpy(), ref.covs, rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(new.loops_tf.numpy(), ref.loops_tf, atol=1e-4)


@pytest.fixture(scope="module")
def small_replays(bag):
    """The small configuration replayed by both packages on the CPU."""
    jdims = jcore.SlamDims(icp=JICP(**ICP_PROD), **SMALL_DIMS)
    jparams = _small_params(jdims)
    jfc = JFC(max_points=128, corroborate=False)
    jres = jpipe.replay(bag, jfc, jparams, jdims)
    tbag = tsim.simulate_bag(tsim.SimConfig(**SMALL_SIM))
    tres = tpipe.replay(tbag, feature_config_from_reference(jfc),
                        params_from_reference(_np(jparams), "cpu"),
                        dims_from_reference(jdims), "cpu")
    return jdims, jparams, jfc, jres, tres


def test_replay_small_config_matches_jax(bag, small_replays):
    jdims, jparams, jfc, jres, tres = small_replays
    # chip_smoke.py holds the card to this stored JAX result (no JAX there)
    gold = np.load(GOLDEN)
    np.testing.assert_array_equal(gold["keyframe_ping_idx"], jres.keyframe_ping_idx)
    assert int(gold["num_loops"]) == int(jres.carry.num_loops)
    np.testing.assert_allclose(gold["trajectory"], jres.trajectory, atol=5e-4)

    np.testing.assert_array_equal(tres.keyframe_ping_idx, jres.keyframe_ping_idx)
    assert tres.carry.num_loops == int(jres.carry.num_loops) > 0
    np.testing.assert_allclose(tres.trajectory, jres.trajectory, atol=1e-4)
    np.testing.assert_allclose(tres.dense_trajectory, jres.dense_trajectory,
                               atol=1e-4)
    truth = bag.true_pose_at_ping[jres.keyframe_ping_idx]
    assert abs(tpipe.ate_rmse(tres.trajectory, truth)
               - jpipe.ate_rmse(jres.trajectory, truth)) < 1e-4


def test_jax_scan_on_port_odometry_matches_golden(bag, small_replays):
    """The small survey's first loop (keyframe 8 against keyframe 0) is
    ill-conditioned: the JAX scan fed the port's dead-reckoning poses, which
    differ from its own by at most 1.7e-5 m at the keyframes, ends up to
    0.17 m from its own result.
    chip_smoke.py accepts the card's trajectory within 1e-3 m of either JAX
    result; this pins the second one (``trajectory_port_dr``)."""
    jdims, jparams, jfc, jres, tres = small_replays
    nk = tres.num_keyframes
    # the JAX keyframe inputs as its carry holds them (zeros past nk)
    jc = jres.carry
    frames = jcore.KeyframeInput(
        time=jc.times, dr_pose3=jnp.asarray(tres.carry.dr_poses3.numpy()),
        points=jc.points, pmask=jc.pmasks,
        valid=jnp.arange(jdims.max_keyframes) < nk, conf=jc.pconf)
    carry, _ = jcore.slam_scan(frames, jparams, jdims, None)
    gold = np.load(GOLDEN)
    assert int(carry.num_loops) == int(gold["num_loops_port_dr"])
    np.testing.assert_allclose(gold["trajectory_port_dr"],
                               np.asarray(carry.poses)[:nk], atol=5e-4)


def jax_scan_on_odometry(jres, jdims, jparams, dr_poses3):
    """The JAX scan on the JAX package's own keyframe clouds and other
    dead-reckoning poses at the keyframe slots (K, 6): (keyframe_ping_idx,
    trajectory, num_loops)."""
    nk = jres.num_keyframes
    jc = jres.carry
    frames = jcore.KeyframeInput(
        time=jc.times, dr_pose3=jnp.asarray(dr_poses3), points=jc.points,
        pmask=jc.pmasks, valid=jnp.arange(jdims.max_keyframes) < nk,
        conf=jc.pconf)
    carry, _ = jcore.slam_scan(frames, jparams, jdims, None)
    return dict(keyframe_ping_idx=np.asarray(jres.keyframe_ping_idx),
                trajectory=np.asarray(carry.poses)[:nk],
                num_loops=int(carry.num_loops))


def test_jax_scan_on_card_odometry_matches_rows_golden(small_replays):
    """The rows golden's poses are the port's dead reckoning of this survey
    (within 1e-5 m of the CPU's), and the JAX scan on them reproduces it."""
    jdims, jparams, jfc, jres, tres = small_replays
    gold = np.load(GOLDEN_ROWS)
    np.testing.assert_allclose(gold["dr_poses3"], tres.carry.dr_poses3.numpy(),
                               rtol=0, atol=1e-5)
    got = jax_scan_on_odometry(jres, jdims, jparams, gold["dr_poses3"])
    np.testing.assert_array_equal(gold["keyframe_ping_idx"],
                                  got["keyframe_ping_idx"])
    assert int(gold["num_loops"]) == got["num_loops"]
    np.testing.assert_allclose(gold["trajectory"], got["trajectory"], atol=5e-4)


def test_unported_options_raise(bag):
    tbag = tsim.simulate_bag(tsim.SimConfig(**dict(SMALL_SIM, duration=5.0)))
    dims = tcore.SlamDims()
    params = tcore.SlamParams.default(dataclasses.replace(dims, ssm_sobol=8,
                                                          nssm_sobol=8), "cpu")
    fc = tpipe.FeatureConfig()
    # the front ends run; what the JAX replay refuses, the port refuses too
    for kw in (dict(frontend="kalman"), dict(frontend="dr_gyro")):
        res = tpipe.replay(tbag, fc, params, dims, "cpu", **kw)
        assert np.isfinite(res.trajectory).all() and res.num_keyframes >= 1
    for kw, match in ((dict(use_vertical=True), "no vertical sonar"),
                      (dict(frontend="imu"), "unknown front end")):
        with pytest.raises(ValueError, match=match):
            tpipe.replay(tbag, fc, params, dims, "cpu", **kw)
    basis = dataclasses.replace(dims, aggregate_with_dr_basis=True)
    with pytest.raises(ValueError, match="aggregate_with_dr_basis"):
        tpipe.replay(tbag, fc, params, basis, "cpu", frontend="kalman")
    # loop refinement converts with every refine_* option; only the TPU
    # scan's chunk size is dropped
    assert dims_from_reference(jcore.SlamDims(scan_chunk=4)) == dims
    on = dict(refine_iters=2, refine_sweep=True, refine_chain=True,
              refine_final_sweep=True, refine_scale_from_chain=True,
              refine_scale_basis=True, refine_incremental=True,
              refine_sweep_topk=2, refine_sweep_budget=7,
              refine_target_window=3, refine_scale_anchor_sigma=(0.01, 0.02))
    assert dims_from_reference(jcore.SlamDims(scan_chunk=4, **on)) == (
        dataclasses.replace(dims, **on))


if __name__ == "__main__":
    # Rewrite tests/golden/small_norefine_traj_port_dr_rows.npz from a log
    # of chip_smoke.py (its phase 7 line "... float32 little-endian hex:
    # <hex>", the card's dead-reckoning poses at the keyframe slots, which
    # phase 6 shares): the JAX scan on its own clouds and those poses.
    #   PYTHONPATH=.:tests JAX_PLATFORMS=cpu \
    #       python tests/test_torch_slam.py chip_smoke.log
    import re
    import sys

    with open(sys.argv[1]) as f:
        found = re.findall(r"\(32, 6\) float32 little-endian hex: ([0-9a-f]+)",
                           f.read())
    card_dr = np.frombuffer(bytes.fromhex(found[-1]), "<f4").reshape(32, 6)
    jdims = jcore.SlamDims(icp=JICP(**ICP_PROD), **SMALL_DIMS)
    jparams = _small_params(jdims)
    jres = jpipe.replay(jsim.simulate_bag(jsim.SimConfig(**SMALL_SIM)),
                        JFC(max_points=128, corroborate=False), jparams, jdims)
    out = jax_scan_on_odometry(jres, jdims, jparams, card_dr)
    np.savez(GOLDEN_ROWS, dr_poses3=card_dr, **out)
    print(f"wrote {GOLDEN_ROWS}: {out['num_loops']} loops")
