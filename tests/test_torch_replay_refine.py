"""The slice with loop refinement on: bench.py --small with refinement, the
configuration of tests/golden/small_traj.npz (tests/test_golden.py), replayed
by both packages on the CPU, then bench.py's scoring of it.

* Keyframe pings, the loop log (endpoints and count) equal; trajectory
  within 1e-4 m (measured 7.6e-6 m: float32 ICP and Gauss-Newton with sums
  in other orders). The JAX result must match the golden file as
  tests/test_golden.py holds it, because chip_smoke.py holds the card to
  that file.
* The survey's first loop is ill-conditioned (tests/test_torch_slam.py):
  the card, whose dead reckoning sums in another order, logs 8 loops and
  ends 0.080 m from the JAX result. The JAX package fed the port's
  dead-reckoning poses (1.7e-5 m from its own) is another reference;
  tests/golden/small_traj_port_dr.npz holds it, and
  ``test_jax_refine_on_port_odometry_matches_golden`` pins it. The card's
  own dead reckoning (x and y scanned as rows) lies 1.9e-6 m from the CPU's
  and moves the result again: tests/golden/small_traj_port_dr_rows.npz
  holds the JAX package fed those card poses, with the poses, and
  chip_smoke.py accepts it or small_traj.npz. Run as a script this file
  rewrites it from the hex dump that chip_smoke.py's phase 7 logs (see the
  end of the file); ``test_jax_refine_on_card_odometry_matches_rows_golden``
  checks that its poses are the port's dead reckoning of this survey
  (within 1e-5 m of the CPU's) and that JAX reproduces its result.
* ``pipeline.loop_metrics`` on the port's carry against bench.py's
  ``loop_metrics`` on the JAX carry: the same counts, precision and recall,
  and loop errors within 0.01 cm (their last rounded digit).
* bench.py's mapping stage (``pipeline.occupancy_map``) against the JAX
  package's mapping functions on the JAX carry, and ``map_metrics`` on both.
  The grids may differ only in cells that a pose 1e-4 m away moves across a
  cell boundary; the metrics must agree to their rounding.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
import sonar_slam_tpu.io.simulate as jsim
import sonar_slam_tpu.mapping as jmap
import sonar_slam_tpu.pipeline as jpipe
import sonar_slam_tpu.slam.core as jcore
import sonar_slam_tpu.slam.refine as jref
from sonar_slam_tpu.cloud import ICPConfig as JICP
from sonar_slam_tpu.slam.frontend import FeatureConfig as JFC

import sonar_slam_torch.io.simulate as tsim
import sonar_slam_torch.mapping as tmap
import sonar_slam_torch.pipeline as tpipe
from sonar_slam_torch.convert import (
    dims_from_reference,
    feature_config_from_reference,
    params_from_reference,
)

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "small_traj.npz")
GOLDEN_PORT_DR = os.path.join(os.path.dirname(__file__), "golden",
                              "small_traj_port_dr.npz")
GOLDEN_ROWS = os.path.join(os.path.dirname(__file__), "golden",
                           "small_traj_port_dr_rows.npz")
SIM = dict(duration=90.0, speed=0.5, sonar_rate=1.0, num_ranges=192,
           num_bearings=96, loop_radius=10.0, imu_rate=20.0)


def golden_config():
    """tests/test_golden.py's configuration (bench.py --small, refinement
    on), in the JAX package's types."""
    dims = jcore.SlamDims(
        max_keyframes=32, max_points=128, target_capacity=512,
        nssm_min_st_sep=8, nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=128,
        max_loops=32, gn_iters=3,
        icp=JICP(max_iterations=12, min_diff_rot=1e-3, min_diff_trans=1e-2,
                 point_to_line=True, outlier_max_dist=0.5),
        nssm_target_window=2, nssm_pair_refine=True, pair_refine_max_dt=0.35,
        pair_refine_max_dr=0.07, pair_refine_min_inliers=25,
        refine_iters=2, refine_sweep=True, refine_chain=True)
    params = jcore.SlamParams.default(dims)._replace(
        keyframe_translation=jnp.float32(2.0),
        keyframe_duration=jnp.float32(1.0),
        ssm_min_points=jnp.asarray(20, jnp.int32),
        nssm_min_points=jnp.asarray(20, jnp.int32),
        fuse_odometry=jnp.asarray(True), use_best_start_tf=jnp.asarray(True),
        odom_sigmas=jnp.asarray([0.05, 0.05, 0.01], jnp.float32),
        icp_odom_sigmas=jnp.asarray([0.3, 0.3, 0.1], jnp.float32))
    return dims, params, JFC(max_points=128)


@pytest.fixture(scope="module")
def replays():
    jdims, jparams, jfc = golden_config()
    bag = jsim.simulate_bag(jsim.SimConfig(**SIM))
    jres = jpipe.replay(bag, jfc, jparams, jdims)
    tbag = tsim.simulate_bag(tsim.SimConfig(**SIM))
    tres = tpipe.replay(
        tbag, feature_config_from_reference(jfc),
        params_from_reference(jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
        dims_from_reference(jdims), "cpu")
    truth = bag.true_pose_at_ping[jres.keyframe_ping_idx]
    return dict(bag=bag, tbag=tbag, jdims=jdims, jres=jres, tres=tres, truth=truth)


def jax_refined_on_odometry(jres, jdims, dr_poses3):
    """The JAX scan and refinement on the JAX package's own clouds and other
    dead-reckoning poses at the keyframe slots (K, 6): (keyframe_ping_idx,
    trajectory, num_loops)."""
    _, jparams, _ = golden_config()
    nk = jres.num_keyframes
    jc = jres.carry
    frames = jcore.KeyframeInput(
        time=jc.times, dr_pose3=jnp.asarray(dr_poses3),
        points=jc.points, pmask=jc.pmasks,
        valid=jnp.arange(jdims.max_keyframes) < nk, conf=jc.pconf)
    carry, _ = jcore.slam_scan(frames, jparams, jdims, None)
    carry = jref.refine_loops(carry, jparams, jref.RefineParams.default(),
                              jdims, None, None)
    return dict(keyframe_ping_idx=np.asarray(jres.keyframe_ping_idx),
                trajectory=np.asarray(carry.poses)[:nk],
                num_loops=int(carry.num_loops))


def jax_refined_on_port_odometry(replays):
    """The JAX scan and refinement on the JAX package's own clouds and the
    port's dead-reckoning poses."""
    assert replays["tres"].num_keyframes == replays["jres"].num_keyframes
    return jax_refined_on_odometry(replays["jres"], replays["jdims"],
                                   replays["tres"].carry.dr_poses3.numpy())


def test_jax_refine_on_port_odometry_matches_golden(replays):
    got = jax_refined_on_port_odometry(replays)
    gold = np.load(GOLDEN_PORT_DR)
    np.testing.assert_array_equal(gold["keyframe_ping_idx"],
                                  got["keyframe_ping_idx"])
    assert int(gold["num_loops"]) == got["num_loops"]
    np.testing.assert_allclose(gold["trajectory"], got["trajectory"], atol=5e-4)


def test_jax_refine_on_card_odometry_matches_rows_golden(replays):
    gold = np.load(GOLDEN_ROWS)
    card_dr = gold["dr_poses3"]
    np.testing.assert_allclose(card_dr, replays["tres"].carry.dr_poses3.numpy(),
                               rtol=0, atol=1e-5)
    got = jax_refined_on_odometry(replays["jres"], replays["jdims"], card_dr)
    np.testing.assert_array_equal(gold["keyframe_ping_idx"],
                                  got["keyframe_ping_idx"])
    assert int(gold["num_loops"]) == got["num_loops"]
    np.testing.assert_allclose(gold["trajectory"], got["trajectory"], atol=5e-4)


def test_refined_replay_matches_jax(replays):
    jres, tres = replays["jres"], replays["tres"]
    gold = np.load(GOLDEN)
    np.testing.assert_array_equal(jres.keyframe_ping_idx, gold["keyframe_ping_idx"])
    assert int(jres.carry.num_loops) == int(gold["num_loops"])
    np.testing.assert_allclose(jres.trajectory, gold["trajectory"], atol=5e-4)

    np.testing.assert_array_equal(tres.keyframe_ping_idx, jres.keyframe_ping_idx)
    nl = int(jres.carry.num_loops)
    assert tres.carry.num_loops == nl > 0
    np.testing.assert_array_equal(tres.carry.loops_i[:nl].numpy(),
                                  np.asarray(jres.carry.loops_i)[:nl])
    np.testing.assert_array_equal(tres.carry.loops_j[:nl].numpy(),
                                  np.asarray(jres.carry.loops_j)[:nl])
    np.testing.assert_allclose(tres.trajectory, jres.trajectory, atol=1e-4)
    np.testing.assert_allclose(tres.dense_trajectory, jres.dense_trajectory,
                               atol=1e-4)
    assert set(tres.stage_s) == {"dr_gate", "features", "slam_scan", "refine"}


def test_loop_metrics_match_bench(replays):
    jdims, truth = replays["jdims"], replays["truth"]
    kw = dict(min_st_sep=jdims.nssm_min_st_sep,
              prox_radius=0.5 * jdims.max_range)
    want = bench.loop_metrics(replays["jres"].carry, truth, **kw)
    got = tpipe.loop_metrics(replays["tres"].carry, truth, **kw)
    assert got.keys() == want.keys()
    for k in ("precision", "recall", "opportunities", "loops"):
        assert got[k] == want[k], k
    for k in ("loop_err_median_cm", "loop_err_p90_cm"):
        assert abs(got[k] - want[k]) <= 0.011, k
    assert got["loops"] > 0 and got["precision"] > 0.5


def test_mapping_stage_matches_jax(replays):
    bag, jres, tres = replays["bag"], replays["jres"], replays["tres"]
    jdims, truth = replays["jdims"], replays["truth"]
    K = jdims.max_keyframes
    occ, cfg = tpipe.occupancy_map(tres.carry, replays["tbag"].geometry, K)
    occ = occ.numpy()

    jcfg = dataclasses.replace(jmap.MappingConfig(), max_keyframes=K)
    model = jmap.SubmapModel(jcfg, bag.geometry)
    jc = jres.carry
    valid = jnp.arange(K) < jc.num_kf
    lo = jax.vmap(lambda p, m: jmap.build_submap_logodds(p, m, model))(
        jc.points, jc.pmasks)
    st = jmap.mapping_init(jcfg, model)._replace(
        kf_logodds=lo, kf_poses=jc.poses, kf_valid=valid, num_kf=jc.num_kf)
    st = st._replace(grid=jmap.render_global_logodds(st, model))
    jocc = np.asarray(jmap.occupancy_grid_method1(st, model))

    assert occ.dtype == np.int8 and occ.shape == jocc.shape
    differ = occ != jocc
    assert differ.sum() <= 1e-3 * (jocc != 50).sum()
    nk = tres.num_keyframes
    kw = dict(max_range=jdims.max_range, half_aperture=jdims.half_aperture)
    want = jmap.map_metrics(jocc, jcfg, bag.world_points, truth,
                            jres.trajectory, **kw)
    got = tmap.map_metrics(occ, cfg, bag.world_points, truth,
                           tres.trajectory[:nk], **kw)
    assert got["observed_truth_points"] == want["observed_truth_points"]
    assert abs(got["occupied_cells"] - want["occupied_cells"]) <= differ.sum()
    for k in ("precision", "recall"):
        assert abs(got[k] - want[k]) <= 0.002, k
    assert abs(got["chamfer_cm"] - want["chamfer_cm"]) <= 0.2
    assert got["precision"] > 0.5 and got["recall"] > 0.3


if __name__ == "__main__":
    # Rewrite tests/golden/small_traj_port_dr_rows.npz from a log of
    # chip_smoke.py (its phase 7 line "... float32 little-endian hex: <hex>",
    # the card's dead-reckoning poses at the keyframe slots): the JAX
    # package's refined small replay on its own clouds and those poses, on
    # the CPU.
    #   PYTHONPATH=.:tests JAX_PLATFORMS=cpu \
    #       python tests/test_torch_replay_refine.py chip_smoke.log
    import re
    import sys

    with open(sys.argv[1]) as f:
        found = re.findall(r"\(32, 6\) float32 little-endian hex: ([0-9a-f]+)",
                           f.read())
    card_dr = np.frombuffer(bytes.fromhex(found[-1]), "<f4").reshape(32, 6)
    jdims, jparams, jfc = golden_config()
    jres = jpipe.replay(jsim.simulate_bag(jsim.SimConfig(**SIM)), jfc, jparams,
                        jdims)
    out = jax_refined_on_odometry(jres, jdims, card_dr)
    np.savez(GOLDEN_ROWS, dr_poses3=card_dr, **out)
    print(f"wrote {GOLDEN_ROWS}: {out['num_loops']} loops, keyframes "
          f"{out['keyframe_ping_idx'].tolist()}")
