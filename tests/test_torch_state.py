"""Checkpoints of the port's state (``io/state.py``).

* ``load_checkpoint`` checks every leaf's shape and dtype against the
  template and restores Python scalars as Python scalars; a
  ``MappingState`` round-trips as a ``SlamCarry`` does.
* Resume: ``keyframe_step`` over the first k keyframes of a small survey,
  the carry saved and loaded, then the rest, equals the uninterrupted loop
  bit for bit (every tensor and counter of the carry).
* A carry saved by the JAX package's ``save_checkpoint`` loads into the
  port's carry (``load_reference_checkpoint``): every leaf lands in its
  field, equal to the JAX leaf.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.io.state as jstate
import sonar_slam_tpu.slam.core as jcore
from sonar_slam_torch.cloud import ICPConfig
from sonar_slam_torch.convert import dims_from_reference
from sonar_slam_torch.io.dataset import match_pings_to_ticks
from sonar_slam_torch.io.simulate import SimConfig, simulate_bag
from sonar_slam_torch.io.state import (
    load_checkpoint,
    load_reference_checkpoint,
    save_checkpoint,
)
from sonar_slam_torch.geometry import pose3_to_pose2
from sonar_slam_torch.mapping import (
    MappingConfig,
    SubmapModel,
    add_keyframe,
    mapping_init,
)
from sonar_slam_torch.pipeline import odometry
from sonar_slam_torch.slam import (
    FeatureConfig,
    FeatureExtractor,
    KeyframeInput,
    SlamDims,
    SlamParams,
    keyframe_step,
    select_keyframes,
    slam_init,
)
from sonar_slam_torch.slam.sonar import SonarGeometry

torch.set_num_threads(1)
DIMS = SlamDims(max_keyframes=16, max_points=128, target_capacity=512,
                nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=128,
                max_loops=32, gn_iters=3, nssm_target_window=2,
                nssm_pair_refine=True, pair_refine_max_dt=0.35,
                pair_refine_max_dr=0.07, pair_refine_min_inliers=25,
                icp=ICPConfig(max_iterations=12, min_diff_rot=1e-3,
                              min_diff_trans=1e-2, point_to_line=True,
                              outlier_max_dist=0.5))


def _params():
    return SlamParams.default(DIMS, "cpu")._replace(
        keyframe_translation=2.0, ssm_min_points=20, nssm_min_points=20,
        fuse_odometry=True, use_best_start_tf=True,
        odom_sigmas=torch.tensor([0.05, 0.05, 0.01]),
        icp_odom_sigmas=torch.tensor([0.3, 0.3, 0.1]))


def _assert_trees_equal(a, b, path=""):
    assert type(a) is type(b), path
    if hasattr(a, "_fields"):
        for name in a._fields:
            _assert_trees_equal(getattr(a, name), getattr(b, name),
                                f"{path}.{name}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def frames():
    """The first 12 keyframe inputs of bench.py's small survey, as the
    port's replay builds them."""
    bag = simulate_bag(SimConfig(duration=90.0, speed=0.5, sonar_rate=1.0,
                                 num_ranges=192, num_bearings=96,
                                 loop_radius=10.0, imu_rate=20.0, seed=0))
    tick_time, dr3, _ = odometry(bag, "cpu")
    idx, ok = match_pings_to_ticks(bag.ping_time, tick_time)
    ping_dr3 = dr3[torch.as_tensor(idx)]
    times = torch.as_tensor(np.asarray(bag.ping_time, np.float32))
    mask = select_keyframes(times, pose3_to_pose2(ping_dr3),
                            torch.as_tensor(ok), _params())
    sel = torch.nonzero(mask)[:12, 0]
    fx = FeatureExtractor(FeatureConfig(max_points=128), bag.geometry, "cpu")
    pts, pm, conf = fx.extract_batch_conf(
        torch.as_tensor(bag.ping_images)[sel])
    return [KeyframeInput(time=times[i], dr_pose3=ping_dr3[i], points=pts[k],
                          pmask=pm[k], valid=True, conf=conf[k])
            for k, i in enumerate(sel.tolist())]


def test_resume_from_checkpoint_is_bit_identical(frames, tmp_path):
    params = _params()
    carry = slam_init(DIMS, "cpu")
    for f in frames:
        carry, _ = keyframe_step(carry, f, params, DIMS)
    assert carry.num_loops > 0  # the loop search ran and inserted loops

    k = 9
    part = slam_init(DIMS, "cpu")
    for f in frames[:k]:
        part, _ = keyframe_step(part, f, params, DIMS)
    path = str(tmp_path / "carry.npz")
    save_checkpoint(path, part)
    resumed = load_checkpoint(path, slam_init(DIMS, "cpu"))
    _assert_trees_equal(resumed, part)
    for f in frames[k:]:
        resumed, _ = keyframe_step(resumed, f, params, DIMS)
    _assert_trees_equal(resumed, carry)


def test_load_checkpoint_checks_shape_and_dtype(tmp_path):
    path = str(tmp_path / "carry.npz")
    save_checkpoint(path, slam_init(DIMS, "cpu"))
    with pytest.raises(ValueError, match="shape|template"):
        load_checkpoint(path, slam_init(dataclasses.replace(
            DIMS, max_keyframes=8), "cpu"))
    wrong = slam_init(DIMS, "cpu")
    save_checkpoint(path, wrong._replace(poses=wrong.poses.double()))
    with pytest.raises(ValueError, match="float64"):
        load_checkpoint(path, slam_init(DIMS, "cpu"))
    save_checkpoint(path, wrong._replace(num_kf=2.5))
    with pytest.raises(ValueError, match="num_kf"):
        load_checkpoint(path, slam_init(DIMS, "cpu"))


def test_mapping_state_roundtrip(tmp_path):
    geom = SonarGeometry.make(num_ranges=128, num_bearings=64, max_range=20.0)
    cfg = MappingConfig(x0=-40.0, y0=-40.0, width=80.0, height=80.0,
                        resolution=0.5, outlier_filter_min_points=1,
                        max_keyframes=8)
    model = SubmapModel(cfg, geom, "cpu")
    pts = torch.zeros((64, 2))
    pts[:40, 0] = 10.0
    pts[:40, 1] = torch.linspace(-4, 4, 40)
    m = torch.arange(64) < 40
    st = add_keyframe(mapping_init(cfg, model), 2, [1.0, 0.5, 0.1], pts, m,
                      model)
    path = str(tmp_path / "map.npz")
    save_checkpoint(path, st)
    back = load_checkpoint(path, mapping_init(cfg, model))
    assert back.num_kf == 3
    _assert_trees_equal(back, st)


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    jdims = jcore.SlamDims(max_keyframes=8, max_points=16, target_capacity=32,
                           max_loops=4, pcm_queue_slots=3)
    jcarry = jcore.slam_init(jdims)
    # a distinct value in every leaf, so a leaf in the wrong field shows
    rng = np.random.default_rng(0)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.bool_:
            return jnp.asarray(rng.random(x.shape) < 0.5)
        if x.dtype.kind in "iu":
            return jnp.asarray(rng.integers(0, 7, x.shape).astype(x.dtype))
        return jnp.asarray(rng.normal(size=x.shape).astype(x.dtype))

    jcarry = jax.tree_util.tree_map(fill, jcarry)
    path = str(tmp_path / "jax_carry.npz")
    jstate.save_checkpoint(path, jcarry)

    carry = load_reference_checkpoint(path, "cpu")
    want = slam_init(dims_from_reference(jdims), "cpu")
    for name in want._fields:
        got, ref, tmpl = getattr(carry, name), getattr(jcarry, name), getattr(want, name)
        pairs = (zip(got, ref, tmpl) if name == "graph" else [(got, ref, tmpl)])
        for g, r, t in pairs:
            r = np.asarray(r)
            if isinstance(t, torch.Tensor):
                assert g.dtype == t.dtype and g.shape == t.shape, name
                np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
            else:
                assert g == int(r), name
    # the converted carry saves and loads through the port's own checkpoints
    save_checkpoint(str(tmp_path / "port.npz"), carry)
    _assert_trees_equal(load_checkpoint(str(tmp_path / "port.npz"), want), carry)
