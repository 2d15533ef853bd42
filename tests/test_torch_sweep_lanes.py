"""``parallel.sweep_scan``, the lane-batched scan of ``slam/lanes.py``: every
lane advances through each keyframe step together.

* (a) Against the JAX package's vmapped ``sweep_scan``, at
  ``tests/test_parallel.py``'s dimensions and keyframe stream, on lanes
  that differ in ``point_noise``, ``icp_odom_sigmas`` and
  ``ssm_max_rotation``: each lane's poses within 1e-4 m / rad of its JAX
  lane (the tolerance of tests/test_torch_slam.py), the same keyframe and
  loop counts. That stream's clouds are random, so no loop closes there
  (its ``nssm_cov_samples`` 4 is under the 5 converged starts a loop
  needs); the same is done on ``_world_frames``, with point-to-point ICP
  and with bench.py's production point-to-line ICP.
* (b) Against the plain version ``sweep_scan_loop`` (``slam_scan`` of each
  lane alone), lane by lane: on ``_world_frames`` (a world of scatterers
  seen twice around a small loop) with ``nssm_cov_samples`` 8, lanes that
  also differ in every flag and integer field (one lane inserts loops
  under ``min_pcm`` 2, another never with 99) and in ``conf_power``, and a
  ``max_loops`` of 3 that stops one lane's fourth loop only; and the same
  lanes with their ICP switched to point to line. There the multi-start
  loop search is ill-conditioned in the reference algorithm itself:
  under bench.py's production ICP lanes 4 and 6's lone scans lose a loop
  when every keyframe's odometry moves by 1e-6 m, and under this ICP lane
  6's finds an NSSM overlap of 8 or 9 points at keyframe 4
  (``PYTHONPATH=.:tests python tests/test_torch_sweep_lanes.py`` prints
  the probe). So lane 6 is held to its poses, keyframes and loops only,
  and the production ICP to the JAX lanes (a); the card holds every lane
  bit for bit (``tests/test_torch_sweep_lanes_cuda.py``).
* (c) A lane's result is the same alone (B = 1) and in a batch of 4, at two
  lane indices; (d) identical lanes give equal results.

On a CUDA card a lane is its lone scan bit for bit (``chip_smoke.py``
phase 13a; ``tests/test_torch_sweep_lanes_cuda.py``). On the CPU these ops
round a lane in a batch otherwise than alone, by its position among the
lanes, so (b), (c) and (d) hold poses within 1e-6 m / rad (every other
float within 1e-4 of itself: covariances, whitening factors, loop
measurements), with every count, status, index and flag equal
(``tests/test_torch_sweep_lanes_cuda.py`` holds the bits on a card):

* ATen's vectorized ``atan2``, ``sin`` and ``cos`` round a contiguous
  array's 32-element runs otherwise than its scalar tail, so an angle's
  rounding follows its position among the lanes (ICP's Procrustes angle,
  the angle wraps of ``se2_compose`` / ``se2_between`` / ``wrap_angle``);
* MKL's ``mm`` of a lone pose's transform and the batched ``bmm`` of the
  lanes' (``se2_transform_points``);
* ``pow`` of a tensor power against a lone call's float power, which
  torch takes in a special form for 2 (``conf_weight_lanes``).

(The normal equations are built one lane a call on the CPU and are exact.)
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sonar_slam_tpu.cloud import ICPConfig as JICP
from sonar_slam_tpu.parallel import sweep as jsweep
from sonar_slam_tpu.slam import KeyframeInput as JKI
from sonar_slam_tpu.slam import SlamDims as JDims
from sonar_slam_tpu.slam import SlamParams as JParams

from sonar_slam_torch.convert import dims_from_reference, params_from_reference
from sonar_slam_torch.parallel import stack_params, sweep_scan
from sonar_slam_torch.parallel.sweep import _cast, sweep_scan_loop
from sonar_slam_torch.slam import KeyframeInput, slam_scan

torch.set_num_threads(1)

JDIMS = JDims(
    max_keyframes=8, max_points=32, target_capacity=64,
    nssm_min_st_sep=4, nssm_source_frames=2, ssm_target_frames=2,
    nssm_cov_samples=4, ssm_sobol=16, nssm_sobol=16, max_loops=4,
    gn_iters=2, pcm_queue_slots=3, icp=JICP(max_iterations=6),
)
# the same with enough converged starts for a loop, and the capacity cut
# to 3 loops
JDIMS_LOOPS = dataclasses.replace(JDIMS, nssm_cov_samples=8, max_loops=3)
# the same with bench.py's production ICP (bench.py:209-211): point to line
JDIMS_P2L = dataclasses.replace(
    JDIMS_LOOPS, icp=JICP(max_iterations=12, min_diff_rot=1e-3,
                          min_diff_trans=1e-2, point_to_line=True,
                          outlier_max_dist=0.5))
# and with its own ICP switched to point to line: (b)'s lanes under the
# production ICP gain or lose loops when the odometry moves by 1e-6 m (the
# probe below), so no comparison within rounding holds there
JDIMS_LOOPS_P2L = dataclasses.replace(
    JDIMS_LOOPS, icp=JDIMS_LOOPS.icp._replace(point_to_line=True))


def _random_frames(n=6, seed=17):
    """tests/test_parallel.py's keyframe stream, from a fresh generator."""
    rng = np.random.default_rng(seed)
    K, N = JDIMS.max_keyframes, JDIMS.max_points
    pts = rng.uniform(0, 15, size=(K, N, 2)).astype(np.float32)
    dr = np.zeros((K, 6), np.float32)
    dr[:, 0] = np.arange(K) * 1.5
    valid = np.arange(K) < n
    return dict(time=(np.arange(K) * 2.0).astype(np.float32), dr_pose3=dr,
                points=pts, pmask=np.ones((K, N), bool) & valid[:, None],
                valid=valid)


def _world_frames(K=8, N=32, seed=5):
    """Two laps of four keyframes around a 3 m circle in a field of 400
    scatterers: each keyframe holds its N nearest within 14 m and 120
    degrees of its heading (5 cm noise), and dead reckoning overstates x by
    2 % and drifts 0.01 rad a keyframe; the second lap closes loops on the
    first."""
    r = np.random.default_rng(seed)
    scatterers = r.uniform(-20, 20, size=(400, 2)).astype(np.float32)
    ang = np.arange(K) * (np.pi / 2)
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
        pts[k, :len(seen)] = local[seen] + r.normal(0, 0.05, (len(seen), 2))
        pmask[k, :len(seen)] = True
    dr = np.zeros((K, 6), np.float32)
    dr[:, 0] = truth[:, 0] * 1.02
    dr[:, 1] = truth[:, 1]
    dr[:, 5] = truth[:, 2] + np.arange(K) * 0.01
    return dict(time=(np.arange(K) * 2.0).astype(np.float32), dr_pose3=dr,
                points=pts, pmask=pmask, valid=np.ones(K, bool))


def _jax_params(jdims):
    return JParams.default(jdims)._replace(
        keyframe_translation=jnp.float32(1.0),
        ssm_min_points=jnp.asarray(5, jnp.int32),
        nssm_min_points=jnp.asarray(5, jnp.int32),
    )


def _port(params):
    return params_from_reference(jax.tree.map(np.asarray, params), "cpu")


def _port_frames(f):
    return KeyframeInput(**{k: torch.as_tensor(v) for k, v in f.items()})


def _lane(tree, i):
    return type(tree)(*(_lane(x, i) if isinstance(x, tuple) else
                        None if x is None else x[i] for x in tree))


POSE_LEAVES = ("poses", "pose")


def _assert_lane_close(a, b, path="carry"):
    """Equal structure; integer and bool leaves (counts, statuses, slots,
    flags) equal; poses within 1e-6 m / rad and other floats within 1e-4
    relative (the CPU ops of the module docstring)."""
    if isinstance(a, tuple):
        assert type(a) is type(b), path
        for name, x, y in zip(a._fields, a, b):
            _assert_lane_close(x, y, f"{path}.{name}")
    elif a is None or b is None:
        assert a is None and b is None, path
    else:
        x, y = torch.as_tensor(a), torch.as_tensor(b)
        assert x.dtype == y.dtype, path
        if not x.is_floating_point():
            assert torch.equal(x, y), path
        elif path.rsplit(".", 1)[-1] in POSE_LEAVES:
            torch.testing.assert_close(x, y, rtol=0.0, atol=1e-6, msg=path)
        else:
            torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-6, msg=path)


def _vary(p, **field_values):
    """One lane per index of the value lists, each lane ``p`` with that
    index's overrides (a value of None keeps ``p``'s)."""
    n = len(next(iter(field_values.values())))
    return [p._replace(**{k: _cast(k, getattr(p, k), v[i])
                          for k, v in field_values.items() if v[i] is not None})
            for i in range(n)]


_JAX_LANES = dict(point_noise=[0.3, 0.5, 0.6, 0.4],
                  icp_sigma_scale=[0.5, 1.0, 2.0, 1.5],
                  ssm_max_rotation=np.radians([20.0, 30.0, 45.0, 60.0]))


@pytest.mark.parametrize("inputs", ["test_parallel", "world", "world_p2l"])
def test_sweep_against_jax(inputs):
    """(a): the batched sweep against the JAX package's vmap, lane by lane
    (``world_p2l``: with point-to-line ICP)."""
    jdims, f = {"test_parallel": (JDIMS, _random_frames()),
                "world": (JDIMS_LOOPS, _world_frames()),
                "world_p2l": (JDIMS_P2L, _world_frames())}[inputs]
    base = _jax_params(jdims)
    jlanes = [base._replace(point_noise=jnp.float32(n),
                            icp_odom_sigmas=base.icp_odom_sigmas * jnp.float32(s),
                            ssm_max_rotation=jnp.float32(r))
              for n, s, r in zip(*_JAX_LANES.values())]
    jcarry, _ = jsweep.sweep_scan(JKI(**{k: jnp.asarray(v) for k, v in f.items()}),
                                  jsweep.stack_params(jlanes), jdims)
    carry, _ = sweep_scan(_port_frames(f), stack_params([_port(p) for p in jlanes]),
                          dims_from_reference(jdims))
    np.testing.assert_array_equal(carry.num_kf.numpy(), np.asarray(jcarry.num_kf))
    np.testing.assert_array_equal(carry.num_loops.numpy(),
                                  np.asarray(jcarry.num_loops))
    np.testing.assert_allclose(carry.poses.numpy(), np.asarray(jcarry.poses),
                               atol=1e-4)
    if inputs != "test_parallel":
        assert int(carry.num_loops.sum()) > 0


def _loop_lanes(p):
    """(b)'s eight lanes over ``p``."""
    return _vary(
        p,
        use_best_start_tf=[None, None, None, True, None, None, None, None],
        use_censi_cov=[None, None, None, True, None, None, None, None],
        fuse_odometry=[None, None, None, None, True, None, None, None],
        robust_ssm=[None, None, None, None, True, None, None, None],
        nssm_every=[None, None, 2, None, None, None, None, None],
        min_pcm=[None, 99, None, None, None, 1, None, None],
        pcm_queue_size=[None, None, None, None, None, 1, None, 2],
        point_noise=[None, None, None, None, None, None, 0.4, None],
        ssm_max_rotation=[None, None, None, None, None, None, 0.3, None],
        icp_odom_sigmas=[None] * 7 + [p.icp_odom_sigmas * 1.5],
        conf_power=[None, None, 2.0, None, None, None, 0.25, None],
    )


def _loop_case(jdims):
    """(b)'s lanes on ``_world_frames`` at ``jdims``: the batched sweep and
    its plain version."""
    dims = dims_from_reference(jdims)
    lanes = _loop_lanes(_port(_jax_params(jdims)))
    frames = _port_frames(_world_frames())
    stacked = stack_params(lanes)
    return dict(dims=dims, lanes=lanes, frames=frames, stacked=stacked,
                batched=sweep_scan(frames, stacked, dims),
                loop=sweep_scan_loop(frames, stacked, dims))


@pytest.fixture(scope="module")
def loop_case():
    return _loop_case(JDIMS_LOOPS)


def _against_the_loop(case, looping: int, unstable=()):
    """(b): every leaf of every lane, carry and outputs (see the module
    docstring for the tolerances); lane ``looping`` closes loops, lane 1
    (``min_pcm`` 99) none. A lane in ``unstable``, whose lone scan's
    integer outputs move when the odometry moves by 1e-6 (the probe below),
    keeps its poses, keyframes and loops."""
    (carry, outputs), (lcarry, loutputs) = case["batched"], case["loop"]
    for i in range(len(case["lanes"])):
        if i in unstable:
            _assert_lane_close(_lane(carry, i).poses, _lane(lcarry, i).poses,
                               f"lane {i} carry.poses")
            for name in ("num_kf", "num_loops"):
                assert torch.equal(getattr(carry, name)[i],
                                   getattr(lcarry, name)[i]), (i, name)
            continue
        _assert_lane_close(_lane(carry, i), _lane(lcarry, i), f"lane {i} carry")
        _assert_lane_close(_lane(outputs, i), _lane(loutputs, i),
                           f"lane {i} outputs")
    loops = carry.num_loops.tolist()
    assert loops[looping] > 0 and loops[1] == 0
    assert bool(outputs.loop_added[looping].any())
    assert not bool(outputs.loop_added[1].any())


def test_sweep_against_the_loop_lane_by_lane(loop_case):
    _against_the_loop(loop_case, 0)  # min_pcm 2 against 99


def test_point_to_line_sweep_against_the_loop_lane_by_lane():
    """(b) with the point-to-line ICP: lane 4 (fused odometry, robust SSM)
    closes loops; lane 6's lone scan finds an NSSM overlap of 8 or 9 points
    at keyframe 4 as the odometry moves by 1e-6 (the probe below)."""
    _against_the_loop(_loop_case(JDIMS_LOOPS_P2L), 4, unstable=(6,))


def test_capacity_gate_in_one_lane(loop_case):
    """(b): ``max_loops`` 3 stops lane 5's fourth loop; the other lanes are
    as at a capacity they never reach."""
    dims = loop_case["dims"]
    wide = dataclasses.replace(dims, max_loops=36)
    carry, _ = sweep_scan(loop_case["frames"], loop_case["stacked"], wide)
    loops, capped = carry.num_loops.tolist(), loop_case["batched"][0].num_loops.tolist()
    assert [i for i in range(len(loops)) if loops[i] != capped[i]] == [5]
    assert capped[5] == dims.max_loops < loops[5]


def test_lane_independent_of_batch_and_index(loop_case):
    """(c): lane 4 (fused odometry, robust SSM) alone, and at indices 0 and 3
    of a batch of 4 among other lanes: the same result (see the module
    docstring for the tolerances)."""
    lanes, frames, dims = loop_case["lanes"], loop_case["frames"], loop_case["dims"]
    alone = sweep_scan(frames, stack_params([lanes[4]]), dims)
    first = sweep_scan(frames, stack_params([lanes[4], lanes[0], lanes[5], lanes[7]]),
                       dims)
    last = sweep_scan(frames, stack_params([lanes[0], lanes[5], lanes[7], lanes[4]]),
                      dims)
    for tree in (0, 1):
        _assert_lane_close(_lane(first[tree], 0), _lane(alone[tree], 0))
        _assert_lane_close(_lane(last[tree], 3), _lane(alone[tree], 0))
    _assert_lane_close(_lane(loop_case["batched"][0], 4), _lane(alone[0], 0))


def test_identical_lanes_equal(loop_case):
    """(d): three copies of lane 0 give equal results (see the module
    docstring for the tolerances)."""
    lane0 = loop_case["lanes"][0]
    carry, outputs = sweep_scan(loop_case["frames"], stack_params([lane0] * 3),
                                loop_case["dims"])
    assert int(carry.num_loops[0]) > 0
    for i in (1, 2):
        _assert_lane_close(_lane(carry, i), _lane(carry, 0))
        _assert_lane_close(_lane(outputs, i), _lane(outputs, 0))


def _conditioning_probe():
    """Each of (b)'s lanes scanned alone with every keyframe's odometry
    but the first moved by 0, +1e-6, -1e-6 and +2e-6 (m in x and y, rad in
    yaw): its loops and NSSM overlaps under each ICP."""
    moves = (0.0, 1e-6, -1e-6, 2e-6)
    for name, jdims in (("default", JDIMS_LOOPS),
                        ("point_to_line", JDIMS_LOOPS_P2L),
                        ("production point_to_line", JDIMS_P2L)):
        dims = dims_from_reference(jdims)
        lanes = _loop_lanes(_port(_jax_params(jdims)))
        f = _world_frames()
        rows = []
        for lane in lanes:
            row = []
            for m in moves:
                g = dict(f, dr_pose3=f["dr_pose3"].copy())
                g["dr_pose3"][1:, [0, 1, 5]] += np.float32(m)
                carry, out = slam_scan(_port_frames(g), lane, dims)
                row.append((int(carry.num_loops), out.nssm_overlap.tolist()))
            rows.append(row)
        print(f"{name} ICP: each lane's (loops, NSSM overlaps) with the "
              f"odometry moved by {moves} m or rad:")
        for i, row in enumerate(rows):
            print(f"  lane {i}: {row}")


if __name__ == "__main__":
    # PYTHONPATH=.:tests python tests/test_torch_sweep_lanes.py
    jax.config.update("jax_platforms", "cpu")
    _conditioning_probe()
