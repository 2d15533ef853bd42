"""``parallel.multi_robot_scan`` as one lane-batched scan, each robot a lane
with its own keyframe stream (``slam/lanes.py``), and the batched Sobol
searches of ``propose_interrobot_loops``, on the CPU.

* (a) Three robots in one field of 400 scatterers (``_robot_frames``: two
  laps of four keyframes around a 3 m circle, robot r starting at phase
  r pi / 3 with its own sensor noise) of 8, 7 and 6 keyframes, the third's
  valid slots (0, 1, 3, 4, 5, 7) not a prefix; every robot closes loops.
  Against the JAX package's ``multi_robot_scan`` on a 3-device CPU mesh:
  poses within 1e-4 m / rad (the tolerance of tests/test_torch_slam.py),
  the same keyframe and loop counts and loop keys. Against
  ``multi_robot_scan_loop`` (each robot's lone ``slam_scan``): every leaf
  of the carries and the outputs bit for bit (floats, counts, statuses,
  slots and flags alike; at these dims no op rounds a lane in the batch
  otherwise than alone on the CPU, as ``tests/test_torch_sweep_lanes.py``
  found for the sweep). At phase pi / 6, robot 1's scan match at keyframe
  1 sits on ICP's trim boundary: the JAX scan's own poses move 1.96e-4 m
  when the odometry moves 1e-6 m, so no 1e-4 comparison can hold there; at
  r pi / 3 they move at most 1.9e-6 m (``PYTHONPATH=.:tests python
  tests/test_torch_multi_robot_lanes.py`` prints this probe).
* (b) The same robots with point-to-line ICP: every leaf bit for bit with
  the loop.
* (c) A robot lane is the same alone and first in a batch of another
  order, bit for bit; and with DR-relative aggregation, DVL-scale
  estimation and each robot's own basis integrals (``slam_scan_lanes``'
  ``dr_basis`` (B, K, 2, 2), which ``multi_robot_scan`` does not pass),
  each robot against its lone ``slam_scan`` given its basis: counts,
  statuses, slots and flags equal, poses within 1e-6 m / rad and other
  floats within 1e-4 relative (robot 0's poses part by 2.4e-7 at three
  lanes and not at one, as a shared stream's lanes do with a basis: the
  CPU's vectorized ops round by position, ``tests/test_torch_sweep_lanes.py``).
* (d) ``propose_interrobot_loops`` on the 3 x 3 world of
  ``tests/test_torch_multi_robot.py::test_propose_interrobot_loops_3x3``:
  bit for bit with ``propose_interrobot_loops_loop``; the same ``ok`` and
  overlaps as the JAX package's vmap, transforms within 1e-4 where ``ok``.
* (e) ``cli.lane_bits --robots 2 --cpu`` on the demo's basin at 34 s
  (8 and 7 keyframes: the last step runs robot 0 alone, with its loop
  search): every lane-batched call compared with its lone call, and
  nothing parts.

About 90 s on one core, most of it the JAX package compiling.
"""

import dataclasses
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sonar_slam_tpu.cloud import ICPConfig as JICP
from sonar_slam_tpu.geometry import se2_compose as j_compose
from sonar_slam_tpu.geometry import se2_inverse as j_inverse
from sonar_slam_tpu.geometry import se2_transform_points as j_transform
from sonar_slam_tpu.parallel import make_config_mesh
from sonar_slam_tpu.parallel import multi_robot as jmr
from sonar_slam_tpu.slam import KeyframeInput as JKI
from sonar_slam_tpu.slam import SlamDims as JDims
from sonar_slam_tpu.slam import SlamParams as JParams
from sonar_slam_tpu.slam.scan_matching import sobol_unit_samples

from sonar_slam_torch.cli import lane_bits
from sonar_slam_torch.cloud import ICPConfig
from sonar_slam_torch.convert import (
    dims_from_reference,
    params_from_reference,
    summary_from_reference,
)
from sonar_slam_torch.parallel import multi_robot as tmr
from sonar_slam_torch.slam import KeyframeInput

torch.set_num_threads(1)

JDIMS = JDims(
    max_keyframes=8, max_points=32, target_capacity=64,
    nssm_min_st_sep=4, nssm_source_frames=2, ssm_target_frames=2,
    nssm_cov_samples=8, ssm_sobol=16, nssm_sobol=16, max_loops=3,
    gn_iters=2, pcm_queue_slots=3, icp=JICP(max_iterations=6),
)
JDIMS_P2L = dataclasses.replace(
    JDIMS, icp=JDIMS.icp._replace(point_to_line=True))
VALID = ([1] * 8, [1] * 7 + [0], [1, 1, 0, 1, 1, 1, 0, 1])


def _robot_frames(robot, valid, phase=None, K=8, N=32):
    """Robot ``robot``'s keyframe stream in a field of 400 scatterers (the
    field of tests/test_torch_sweep_lanes.py's ``_world_frames``): two laps
    of four keyframes around a 3 m circle from ``phase`` (r pi / 3), each
    keyframe holding its N nearest scatterers within 14 m and 120 degrees
    of its heading with 5 cm of the robot's own noise; dead reckoning
    overstates x by 2 % and drifts 0.01 rad a keyframe. ``valid`` (K,)."""
    scatterers = np.random.default_rng(5).uniform(
        -20, 20, size=(400, 2)).astype(np.float32)
    noise = np.random.default_rng(100 + robot)
    phase = robot * np.pi / 3 if phase is None else phase
    ang = phase + np.arange(K) * (np.pi / 2)
    truth = np.stack([3.0 * np.sin(ang), 3.0 * (1 - np.cos(ang)), ang], -1)
    pts = np.zeros((K, N, 2), np.float32)
    pmask = np.zeros((K, N), bool)
    for k in range(K):
        c, s = np.cos(truth[k, 2]), np.sin(truth[k, 2])
        d = scatterers - truth[k, :2]
        local = np.stack([c * d[:, 0] + s * d[:, 1],
                          -s * d[:, 0] + c * d[:, 1]], -1)
        rng_ = np.linalg.norm(local, axis=1)
        seen = np.nonzero((rng_ < 14.0) & (np.abs(np.arctan2(
            local[:, 1], local[:, 0])) < np.radians(120)))[0]
        seen = seen[np.argsort(rng_[seen])][:N]
        pts[k, :len(seen)] = local[seen] + noise.normal(0, 0.05, (len(seen), 2))
        pmask[k, :len(seen)] = True
    dr = np.zeros((K, 6), np.float32)
    dr[:, 0] = truth[:, 0] * 1.02
    dr[:, 1] = truth[:, 1]
    dr[:, 5] = truth[:, 2] + np.arange(K) * 0.01
    valid = np.asarray(valid, bool)
    return dict(time=(np.arange(K) * 2.0).astype(np.float32), dr_pose3=dr,
                points=pts, pmask=pmask & valid[:, None], valid=valid)


def _stacked(robots=(0, 1, 2), **kw):
    fs = [_robot_frames(r, VALID[r], **kw) for r in robots]
    return {k: np.stack([f[k] for f in fs]) for k in fs[0]}


def _jax_params(jdims):
    return JParams.default(jdims)._replace(
        keyframe_translation=jnp.float32(1.0),
        ssm_min_points=jnp.asarray(5, jnp.int32),
        nssm_min_points=jnp.asarray(5, jnp.int32))


def _port_params(jdims):
    return params_from_reference(jax.tree.map(np.asarray, _jax_params(jdims)),
                                 "cpu")


def _port_frames(st):
    return KeyframeInput(**{k: torch.as_tensor(v) for k, v in st.items()})


def _jax_scan(st, jdims, robots=3):
    return jmr.multi_robot_scan(JKI(**{k: jnp.asarray(v) for k, v in st.items()}),
                                _jax_params(jdims), jdims,
                                make_config_mesh(robots, axis="robot"))


def _lane(tree, i):
    return type(tree)(*(_lane(x, i) if isinstance(x, tuple) else
                        None if x is None else x[i] for x in tree))


def _assert_equal(a, b, path):
    """Equal structure, every leaf equal bit for bit with its dtype."""
    if isinstance(a, tuple):
        assert type(a) is type(b), path
        for name, x, y in zip(a._fields, a, b):
            _assert_equal(x, y, f"{path}.{name}")
    elif a is None or b is None:
        assert a is None and b is None, path
    else:
        x, y = torch.as_tensor(a), torch.as_tensor(b)
        assert x.dtype == y.dtype and torch.equal(x, y), path


def _assert_close(a, b, path):
    """Equal structure; integer and bool leaves equal; poses within 1e-6
    m / rad, other floats within 1e-4 relative."""
    if isinstance(a, tuple):
        assert type(a) is type(b), path
        for name, x, y in zip(a._fields, a, b):
            _assert_close(x, y, f"{path}.{name}")
    elif a is None or b is None:
        assert a is None and b is None, path
    else:
        x, y = torch.as_tensor(a), torch.as_tensor(b)
        assert x.dtype == y.dtype, path
        if not x.is_floating_point():
            assert torch.equal(x, y), path
        elif path.rsplit(".", 1)[-1] in ("poses", "pose"):
            torch.testing.assert_close(x, y, rtol=0.0, atol=1e-6, msg=path)
        else:
            torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-6, msg=path)


@pytest.fixture(scope="module")
def robots():
    st = _stacked()
    dims = dims_from_reference(JDIMS)
    p = _port_params(JDIMS)
    frames = _port_frames(st)
    return dict(st=st, dims=dims, params=p, frames=frames,
                batched=tmr.multi_robot_scan(frames, p, dims))


def test_robot_lanes_against_jax(robots):
    """(a) against the JAX package's shard_map over the robots."""
    jc, _ = _jax_scan(robots["st"], JDIMS)
    carry, outputs = robots["batched"]
    np.testing.assert_array_equal(carry.num_kf.numpy(), [8, 7, 6])
    np.testing.assert_array_equal(carry.num_kf.numpy(), np.asarray(jc.num_kf))
    np.testing.assert_array_equal(carry.num_loops.numpy(),
                                  np.asarray(jc.num_loops))
    assert (carry.num_loops.numpy() > 0).all()
    for name in ("loops_i", "loops_j"):
        np.testing.assert_array_equal(getattr(carry, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)
    np.testing.assert_allclose(carry.poses.numpy(), np.asarray(jc.poses),
                               atol=1e-4)
    # robot 2's outputs sit in its own valid slots, zeros in the others
    assert not outputs.pose[2, [2, 6]].any() and outputs.pose[2, 7].any()


def test_robot_lanes_against_the_loop(robots):
    """(a) against each robot's lone ``slam_scan``, every leaf."""
    loop = tmr.multi_robot_scan_loop(robots["frames"], robots["params"],
                                     robots["dims"])
    for tree, name in ((0, "carry"), (1, "outputs")):
        for r in range(3):
            _assert_equal(_lane(robots["batched"][tree], r), _lane(loop[tree], r),
                          f"robot {r} {name}")


def test_point_to_line_robot_lanes_against_the_loop(robots):
    """(b) with point-to-line ICP."""
    dims = dims_from_reference(JDIMS_P2L)
    p = _port_params(JDIMS_P2L)
    batched = tmr.multi_robot_scan(robots["frames"], p, dims)
    loop = tmr.multi_robot_scan_loop(robots["frames"], p, dims)
    assert int(batched[0].num_loops.sum()) > 0
    for tree in (0, 1):
        for r in range(3):
            _assert_equal(_lane(batched[tree], r), _lane(loop[tree], r),
                          f"robot {r}")


def test_robot_lane_independent_of_batch_and_index(robots):
    """(c): robot 2 alone, and first in the order (2, 0)."""
    st = robots["st"]
    alone = tmr.multi_robot_scan(
        _port_frames({k: v[2:] for k, v in st.items()}), robots["params"],
        robots["dims"])
    first = tmr.multi_robot_scan(
        _port_frames({k: v[[2, 0]] for k, v in st.items()}), robots["params"],
        robots["dims"])
    for tree in (0, 1):
        _assert_equal(_lane(alone[tree], 0), _lane(robots["batched"][tree], 2),
                      "alone")
        _assert_equal(_lane(first[tree], 0), _lane(robots["batched"][tree], 2),
                      "first")


def test_dr_basis_robot_lanes_against_lone_scans(robots):
    """(c): DR-basis aggregation with each robot's own basis, keyed by its
    keyframes: the dead-reckoned positions as the body-x integral, zero
    for body y."""
    from sonar_slam_torch.parallel import stack_params
    from sonar_slam_torch.slam import slam_scan
    from sonar_slam_torch.slam.lanes import slam_scan_lanes

    dims = dataclasses.replace(robots["dims"], aggregate_with_dr=True,
                               aggregate_with_dr_basis=True,
                               estimate_dvl_scale=True, nssm_target_window=2)
    st, p = robots["st"], robots["params"]
    basis = np.zeros((3, 8, 2, 2), np.float32)
    for r in range(3):
        keyed = st["dr_pose3"][r][st["valid"][r]]
        basis[r, :len(keyed), 0] = keyed[:, :2]
    basis = torch.as_tensor(basis)
    batched = slam_scan_lanes(robots["frames"], stack_params([p] * 3), dims,
                              basis)
    assert int(batched[0].num_loops.sum()) > 0
    for r in range(3):
        lone = slam_scan(_port_frames({k: v[r] for k, v in st.items()}), p,
                         dims, basis[r])
        for tree in (0, 1):
            _assert_close(_lane(batched[tree], r), lone[tree], f"robot {r}")


def _scene_summary(rng, world, poses, pose_error, robot, N=96):
    """tests/test_torch_multi_robot.py's candidate summaries: the points
    within 12 m of each keyframe at ``poses``, with 2 cm noise, padded to
    N; the summary pose is the true pose composed with ``pose_error``."""
    P = len(poses)
    pts = np.zeros((P, N, 2), np.float32)
    msk = np.zeros((P, N), bool)
    for i, p in enumerate(poses):
        local = np.asarray(j_transform(jnp.asarray(world),
                                       j_inverse(jnp.asarray(p))))
        near = local[np.linalg.norm(local, axis=1) < 12.0][:N]
        pts[i, :len(near)] = near + rng.normal(scale=0.02, size=near.shape)
        msk[i, :len(near)] = True
    est = np.stack([np.asarray(j_compose(jnp.asarray(p), jnp.asarray(pose_error)))
                    for p in poses]).astype(np.float32)
    return jmr.KeyframeSummary(
        robot_id=jnp.full((P,), robot, jnp.int32),
        key=jnp.arange(P, dtype=jnp.int32), pose=jnp.asarray(est),
        cov=jnp.tile(jnp.eye(3, dtype=jnp.float32)[None] * 0.01, (P, 1, 1)),
        points=jnp.asarray(pts), pmask=jnp.asarray(msk))


def test_batched_proposals_against_the_loop_and_jax():
    """(d) on the 3 x 3 world (a walled basin with two inner walls)."""
    rng = np.random.default_rng(5)
    segs = [((-10, -10), (10, -10)), ((10, -10), (10, 10)),
            ((10, 10), (-10, 10)), ((-10, 10), (-10, -10)),
            ((-4, -10), (-4, 2)), ((3, 4), (10, 4))]
    world = np.concatenate([
        np.linspace(a, b, int(np.hypot(b[0] - a[0], b[1] - a[1]) / 0.25))
        for a, b in segs]).astype(np.float32)
    own = _scene_summary(rng, world, np.array(
        [[0, -6, 0], [4, -6, 0.5], [6, 0, 1.5]], np.float32), [0, 0, 0], 0)
    other = _scene_summary(rng, world, np.array(
        [[0.6, -5.5, 0.1], [5, 1, 1.4], [-7, 7, -2.0]], np.float32),
        [0.4, -0.3, 0.05], 1)
    sobol = sobol_unit_samples(64)
    bounds = np.array([2.0, 2.0, 0.4], np.float32)
    kw = dict(point_noise=0.5, min_overlap=30)
    jicp = JICP(min_diff_rot=1e-3, min_diff_trans=1e-2, point_to_line=True,
                outlier_max_dist=0.75)
    jtf, jok, jov = jmr.propose_interrobot_loops(
        own, other, jnp.asarray(sobol), jnp.asarray(bounds), icp_config=jicp,
        **kw)
    args = (summary_from_reference(jax.tree.map(np.asarray, own), "cpu"),
            summary_from_reference(jax.tree.map(np.asarray, other), "cpu"),
            torch.as_tensor(sobol), torch.as_tensor(bounds))
    icp = ICPConfig(**jicp._asdict())
    batched = tmr.propose_interrobot_loops(*args, icp_config=icp, **kw)
    loop = tmr.propose_interrobot_loops_loop(*args, icp_config=icp, **kw)
    for x, y in zip(batched, loop):
        assert torch.equal(x, y)
    tf, ok, ov = batched
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    okn = ok.numpy()
    assert 0 < okn.sum() < okn.size
    np.testing.assert_allclose(tf.numpy()[okn], np.asarray(jtf)[okn], atol=1e-4)


def test_lane_bits_robots():
    """(e)."""
    out = lane_bits.main(["--cpu", "--robots", "2", "--check", "0,1",
                          "--duration", "34"])
    assert out["robots"] == 2 and out["lanes"] == 2
    assert out["steps_parted"] == {}
    calls = out["calls"]
    for name in ("global_initialize_lanes", "icp_pairs", "icp_multistart_lanes",
                 "optimize_with_marginal_lanes", "_assemble_normal_equations"):
        assert calls[name]["calls"] > 0, name
    for row in calls.values():
        assert row["first_step"] is None and row["0"][0] == row["1"][0] == 0


def _conditioning_probe():
    """(a)'s probe: each robot's largest JAX pose move when every keyframe's
    dead-reckoned x and y move by 1e-6 m, at phases r pi / 6 and r pi / 3."""
    for name, phase in (("r pi / 6", np.pi / 6), ("r pi / 3", np.pi / 3)):
        st = {k: np.stack([_robot_frames(r, VALID[r], phase=r * phase)[k]
                           for r in range(3)]) for k in _robot_frames(0, VALID[0])}
        base = np.asarray(_jax_scan(st, JDIMS)[0].poses)
        st["dr_pose3"] = st["dr_pose3"] + np.float32(1e-6) * (np.arange(6) < 2)
        moved = np.asarray(_jax_scan(st, JDIMS)[0].poses)
        print(f"phases {name}: JAX pose move per robot under a 1e-6 m odometry "
              f"move {np.abs(moved - base).reshape(3, -1).max(-1)}")


if __name__ == "__main__":
    # PYTHONPATH=.:tests python tests/test_torch_multi_robot_lanes.py
    jax.config.update("jax_platforms", "cpu")
    sys.exit(_conditioning_probe())
