"""The slice with the order-statistic detector: bench.py --small with
refinement off (tests/test_torch_slam.py's configuration) and
``FeatureConfig(alg="OS", rank=10, corroborate=True)``, the front end of
chip_smoke.py's full OS path, replayed by both packages on the CPU.

The JAX extractor's CPU path and the port's plain version both select the
exact k-th smallest training cell, so the detections are equal: the same
keyframes and feature masks, and feature points within 1e-4 m.

The scan is held to the JAX scan fed the port's keyframe inputs: the same
loop log and a trajectory within 5e-4 m (float32 ICP and Gauss-Newton with
sums in other orders; measured 1.3e-4 m). The JAX replay on its own dead
reckoning, which differs from the port's by up to 1.7e-5 m (the cumulative
sum gap of ROADMAP queue 3), logs one loop more on this survey (keyframe 18
against 8) and ends 0.033 m away: the small survey's loops are
ill-conditioned, as tests/test_torch_slam.py records for its first loop.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.io.simulate as jsim
import sonar_slam_tpu.pipeline as jpipe
import sonar_slam_tpu.slam.core as jcore
from sonar_slam_tpu.cloud import ICPConfig as JICP
from sonar_slam_tpu.slam.frontend import FeatureConfig as JFC

import sonar_slam_torch.io.simulate as tsim
import sonar_slam_torch.pipeline as tpipe
from sonar_slam_torch.convert import (
    dims_from_reference,
    feature_config_from_reference,
    params_from_reference,
)
from test_torch_slam import ICP_PROD, SMALL_DIMS, SMALL_SIM, _small_params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def replays():
    jdims = jcore.SlamDims(icp=JICP(**ICP_PROD), **SMALL_DIMS)
    jparams = _small_params(jdims)
    jfc = JFC(max_points=128, alg="OS", rank=10, corroborate=True)
    bag = jsim.simulate_bag(jsim.SimConfig(**SMALL_SIM))
    jres = jpipe.replay(bag, jfc, jparams, jdims)
    tres = tpipe.replay(
        tsim.simulate_bag(tsim.SimConfig(**SMALL_SIM)),
        feature_config_from_reference(jfc),
        params_from_reference(jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
        dims_from_reference(jdims), "cpu")
    return bag, jdims, jparams, jres, tres


def test_os_features_match_jax(replays):
    _, _, _, jres, tres = replays
    np.testing.assert_array_equal(tres.keyframe_ping_idx, jres.keyframe_ping_idx)
    np.testing.assert_array_equal(tres.carry.pmasks.numpy(),
                                  np.asarray(jres.carry.pmasks))
    np.testing.assert_array_equal(tres.carry.pconf.numpy(),
                                  np.asarray(jres.carry.pconf))
    np.testing.assert_allclose(tres.carry.points.numpy(),
                               np.asarray(jres.carry.points), atol=1e-4)
    assert tres.carry.pmasks.sum() > 20 * tres.num_keyframes


def test_os_scan_matches_jax(replays):
    bag, jdims, jparams, jres, tres = replays
    nk, tc = tres.num_keyframes, tres.carry
    frames = jcore.KeyframeInput(
        time=jnp.asarray(tc.times.numpy()), dr_pose3=jnp.asarray(tc.dr_poses3.numpy()),
        points=jnp.asarray(tc.points.numpy()), pmask=jnp.asarray(tc.pmasks.numpy()),
        valid=jnp.arange(jdims.max_keyframes) < nk, conf=jnp.asarray(tc.pconf.numpy()))
    jc, _ = jcore.slam_scan(frames, jparams, jdims, None)
    nl = int(jc.num_loops)
    assert tc.num_loops == nl > 0
    np.testing.assert_array_equal(tc.loops_i[:nl].numpy(), np.asarray(jc.loops_i)[:nl])
    np.testing.assert_array_equal(tc.loops_j[:nl].numpy(), np.asarray(jc.loops_j)[:nl])
    np.testing.assert_allclose(tres.trajectory, np.asarray(jc.poses)[:nk], atol=5e-4)
    truth = bag.true_pose_at_ping[jres.keyframe_ping_idx]
    assert tpipe.ate_rmse(tres.trajectory, truth) < 0.5
