"""The node-level API of the port against the JAX package's on the CPU.

Same seeded numpy inputs into both packages; tolerances:

* ``dead_reckoning_step`` one tick a call: both packages add in stream
  order in float32, so the steps lie within 1e-5 m of the JAX steps and of
  JAX's ``dead_reckoning_scan`` (the scan's body is the step); depth and
  attitude equal to float32 rounding (1e-6). Against the port's own
  ``dead_reckoning_scan`` (cumulative sums in another order) within the
  scan's accepted 2e-4 m, with the same keyframes from ``select_keyframes``.
  ``prepare_imu_euler`` within 1e-6 rad.
* ``kalman_init``: the same fields, shapes, dtypes and zeros.
* ``Smoother``: the cases of tests/test_graph.py driven through both
  packages, estimates within 1e-5 (1e-4 m where a loop pulls 4 m of
  drift), marginal covariances within 1e-6, and each case's own assertion.
* ``max_clique_host``: the JAX function's clique, whose size equals
  ``max_clique_mask``'s.
* ``density_filter``: masks equal, on clouds with tied distances (points
  on an integer grid).
* ``voxel_downsample_with_keys``: keys and mask equal, centroids within
  1e-6 m.
* ``se2_matrix`` / ``se2_from_matrix``: within 1e-6.
* ``slam_scan_padded``: ``slam_scan`` equal to it bit for bit on
  tests/test_refine.py's synthetic 16-slot corridor (12 valid slots, an
  interior invalid slot and a padded tail), and the padded scan within
  1e-4 m of the JAX package's with the same loops.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.cloud as jcl
import sonar_slam_tpu.estimators as je
import sonar_slam_tpu.geometry as jg
import sonar_slam_tpu.graph as jgr
import sonar_slam_tpu.io.dataset as jds
import sonar_slam_tpu.io.simulate as jsim
import sonar_slam_tpu.slam.core as jcore
import sonar_slam_torch.cloud as tcl
import sonar_slam_torch.estimators as te
import sonar_slam_torch.geometry as tg
import sonar_slam_torch.graph as tgr
import sonar_slam_torch.io.simulate as tsim
import sonar_slam_torch.slam.core as tcore
from sonar_slam_torch.convert import (
    dims_from_reference,
    dr_config_from_reference,
    params_from_reference,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
STEP_ATOL_M = 1e-5
SCAN_ATOL_M = 2e-4


# ---- dead reckoning, one tick a call ----


@pytest.fixture(scope="module")
def ticks():
    """A 120 s survey's DR ticks with invalid ticks and over-speed glitches,
    one of them before initialization (tests/test_torch_estimators.py's
    stream, shorter)."""
    bag = jsim.simulate_bag(jsim.SimConfig(
        duration=120.0, speed=0.5, sonar_rate=1.0, num_ranges=32,
        num_bearings=16, loop_radius=10.0, imu_rate=20.0, dvl_rate=10.0))
    jt = jds.build_dr_ticks(jds.SensorStreams(
        imu_time=bag.imu_time, imu_rpy=bag.imu_rpy, dvl_time=bag.dvl_time,
        dvl_vel=bag.dvl_vel, depth_time=bag.depth_time, depth=bag.depth)).ticks
    arrs = {k: np.array(v) for k, v in jt._asdict().items()}
    rng = np.random.default_rng(0)
    T = len(arrs["time"])
    arrs["valid"][:3] = False
    arrs["valid"][rng.choice(T, 20, replace=False)] = False
    over = rng.choice(np.arange(10, T), 15, replace=False)
    arrs["vel"][over, 0] = 1.7
    arrs["vel"][over[:3] + 1, 0] = 1.8  # runs of two: the error timer grows
    arrs["vel"][3, 0] = 2.0  # over-speed before initialization: dropped
    arrs["gyro_yaw"] = (np.cumsum(0.02 * rng.normal(size=T))
                        .astype(np.float32))
    return arrs


def _jax_steps(arrs, cfg):
    step = jax.jit(lambda s, t: je.dead_reckoning_step(s, t, cfg))
    state, out = je.dead_reckoning_init(), []
    cols = [jnp.asarray(arrs[k]) for k in je.DRTicks._fields]
    for i in range(len(arrs["time"])):
        state, pose = step(state, tuple(c[i] for c in cols))
        out.append(pose)
    return state, np.asarray(jnp.stack(out))


def _port_steps(arrs, cfg):
    cols = [torch.as_tensor(arrs[k]) for k in te.DRTicks._fields]
    state, out = te.dead_reckoning_init(CPU), []
    for i in range(len(arrs["time"])):
        state, pose = te.dead_reckoning_step(state, tuple(c[i] for c in cols),
                                             cfg)
        out.append(pose)
    return state, torch.stack(out).numpy()


@pytest.mark.parametrize("use_gyro", [False, True])
def test_dead_reckoning_step_matches_jax(ticks, use_gyro):
    jcfg = je.DRConfig(use_gyro=use_gyro)
    jstate, jsteps = _jax_steps(ticks, jcfg)
    _, jscan = je.dead_reckoning_scan(
        je.DRTicks(**{k: jnp.asarray(v) for k, v in ticks.items()}), jcfg)
    tstate, tsteps = _port_steps(ticks, dr_config_from_reference(jcfg))
    for ref in (jsteps, np.asarray(jscan)):
        np.testing.assert_allclose(tsteps[:, :2], ref[:, :2], atol=STEP_ATOL_M)
        np.testing.assert_allclose(tsteps[:, 2:], ref[:, 2:], atol=1e-6)
    for name in te.DRState._fields:
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   atol=STEP_ATOL_M, err_msg=name)
    assert float(jstate.error_timer) == 0.0 or bool(jstate.initialized)
    # the tick dropped before initialization emits the zero pose
    assert not tsteps[3].any()


def test_dead_reckoning_step_matches_the_port_scan(ticks):
    cfg = te.DRConfig()
    _, steps = _port_steps(ticks, cfg)
    scan = te.dead_reckoning_scan(
        te.DRTicks(**{k: torch.as_tensor(v) for k, v in ticks.items()}), cfg)
    gap = np.abs(steps[:, :2] - scan.numpy()[:, :2]).max()
    assert 0.0 < gap <= SCAN_ATOL_M
    np.testing.assert_allclose(steps[:, 2:], scan.numpy()[:, 2:], atol=1e-6)

    jdims = jcore.SlamDims(max_keyframes=8, ssm_sobol=8, nssm_sobol=8)
    params = params_from_reference(
        {k: np.asarray(v) for k, v in jcore.SlamParams.default(jdims)._replace(
            keyframe_translation=jnp.float32(2.0))._asdict().items()}, "cpu")
    times = torch.as_tensor(ticks["time"])
    cand = torch.as_tensor(ticks["valid"] & (np.arange(len(times)) % 2 == 0))
    masks = [tcore.select_keyframes(times, tg.pose3_to_pose2(torch.as_tensor(p)),
                                    cand, params) for p in (steps, scan)]
    assert int(masks[0].sum()) > 5
    assert torch.equal(masks[0], masks[1])


def test_dead_reckoning_step_on_the_full_survey():
    """chip_smoke.py phase 15a's check on the CPU: bench.py's 480 s survey
    (its streams do not depend on the image size, so rendered at 64 x 32)
    one tick a call against the scan, within its limits, and the same 73
    keyframes from ``replay``'s gate."""
    import chip_smoke

    sim, _, params_on, _ = chip_smoke.full_config(seed=0)
    node = chip_smoke.dr_node_inputs(tsim.simulate_bag(
        dataclasses.replace(sim, num_ranges=64, num_bearings=32)))
    cfg = te.DRConfig(roll_offset=0.0)
    steps, took = chip_smoke.step_dead_reckoning(node[0], cfg, CPU)
    scan = te.dead_reckoning_scan(node[0], cfg).numpy()
    assert len(took) == len(scan) > 2000
    assert np.abs(steps[:, :2] - scan[:, :2]).max() <= chip_smoke.DR_STEP_ATOL_M
    assert np.abs(steps[:, 2:] - scan[:, 2:]).max() <= chip_smoke.DR_STEP_ZRPY_ATOL
    kf = [chip_smoke.dr_node_keyframes(p, node, params_on(CPU))
          for p in (steps, scan)]
    np.testing.assert_array_equal(kf[0], kf[1])
    assert len(kf[0]) == chip_smoke.FULL_KEYFRAMES


def test_error_timer_runs_over_a_glitch():
    """Two over-speed ticks after a good one: the timer sums their dt, the
    pose moves on the last good velocity; a good tick resets the timer."""
    cfg = te.DRConfig(roll_offset=0.0)
    jcfg = je.DRConfig(roll_offset=0.0)
    arrs = {"time": np.arange(5, dtype=np.float32) * 0.5,
            "vel": np.array([[0.4, 0, 0], [0.4, 0, 0], [1.5, 0, 0],
                             [1.6, 0, 0], [0.2, 0, 0]], np.float32),
            "euler": np.zeros((5, 3), np.float32),
            "gyro_yaw": np.zeros(5, np.float32),
            "depth": np.full(5, 3.0, np.float32),
            "valid": np.ones(5, bool)}
    timers = []
    cols = [torch.as_tensor(arrs[k]) for k in te.DRTicks._fields]
    state = te.dead_reckoning_init(CPU)
    for i in range(5):
        state, pose = te.dead_reckoning_step(state, tuple(c[i] for c in cols), cfg)
        timers.append(float(state.error_timer))
    assert timers == [0.0, 0.0, 0.5, 1.0, 0.0]
    _, jposes = _jax_steps(arrs, jcfg)
    np.testing.assert_allclose(pose.numpy(), jposes[-1], atol=STEP_ATOL_M)
    assert float(pose[0]) == pytest.approx(0.4 * 1.5 + 0.5 * 0.6 * 0.5, abs=1e-6)


def test_prepare_imu_euler_matches_jax():
    rng = np.random.default_rng(5)
    rpy = rng.uniform(-np.pi, np.pi, size=(64, 3)).astype(np.float32)
    rpy[:, 1] *= 0.45  # pitch within +-pi/2
    mount = np.array([-np.pi / 2, 0.0, 0.0], np.float32)
    got = te.prepare_imu_euler(torch.as_tensor(rpy), torch.as_tensor(mount))
    want = je.prepare_imu_euler(jnp.asarray(rpy), jnp.asarray(mount))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---- the Kalman filter's state ----


def test_kalman_init_matches_jax():
    got, want = te.kalman_init(CPU), je.kalman_init()
    assert te.KalmanState._fields == je.KalmanState._fields
    for name in te.KalmanState._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# ---- the ISAM2-shaped smoother ----

CFG = jgr.GraphConfig(max_poses=16, max_factors=64, gn_iters=8)


def _smoothers(cfg=CFG):
    return jgr.Smoother(cfg), tgr.Smoother(cfg, CPU)


def _both_do(pair, name, *args, **kw):
    for s in pair:
        getattr(s, name)(*args, **kw)


def _updated(pair, atol=1e-5):
    want = np.asarray(pair[0].update())
    got = pair[1].update().numpy()
    np.testing.assert_allclose(got, want, atol=atol)
    return got


def test_smoother_prior_only():
    pair = _smoothers()
    _both_do(pair, "add_prior", [1.0, 2.0, 0.3], [0.1, 0.1, 0.01])
    _both_do(pair, "insert", 0, [0.0, 0.0, 0.0])
    np.testing.assert_allclose(_updated(pair)[0], [1.0, 2.0, 0.3], atol=1e-5)
    np.testing.assert_array_equal(pair[1].estimate(0).numpy(),
                                  pair[1].estimate().numpy()[0])


def test_smoother_perfect_odometry_chain():
    rng = np.random.default_rng(11)
    pair = _smoothers()
    _both_do(pair, "add_prior", [0, 0, 0], [0.1, 0.1, 0.01])
    _both_do(pair, "insert", 0, [0, 0, 0])
    truth = [np.zeros(3, np.float32)]
    for k, d in enumerate([[1.0, 0.0, 0.1], [1.0, 0.2, -0.05], [0.5, -0.1, 0.3]]):
        truth.append(np.asarray(jg.se2_compose(jnp.asarray(truth[-1]),
                                               jnp.asarray(d, jnp.float32))))
        _both_do(pair, "add_odometry", k, k + 1, d, [0.2, 0.2, 0.02])
        _both_do(pair, "insert", k + 1,
                 (truth[-1] + rng.normal(scale=0.05, size=3)).astype(np.float32))
    poses = _updated(pair)
    np.testing.assert_allclose(poses[:4], np.stack(truth), atol=1e-4)


def test_smoother_loop_closure_corrects_drift():
    rng = np.random.default_rng(11)
    pair = _smoothers()
    _both_do(pair, "add_prior", [0, 0, 0], [0.01, 0.01, 0.001])
    _both_do(pair, "insert", 0, [0, 0, 0])
    step = np.array([2.0, 0.0, np.pi / 2], np.float32)
    truth, guess = [np.zeros(3, np.float32)], [np.zeros(3, np.float32)]
    for k in range(4):
        truth.append(np.asarray(jg.se2_compose(jnp.asarray(truth[-1]),
                                               jnp.asarray(step))))
        noisy = step + rng.normal(scale=[0.1, 0.1, 0.03], size=3).astype(np.float32)
        _both_do(pair, "add_odometry", k, k + 1, noisy, [0.2, 0.2, 0.05])
        guess.append(np.asarray(jg.se2_compose(jnp.asarray(guess[-1]),
                                               jnp.asarray(noisy))))
        _both_do(pair, "insert", k + 1, guess[-1])
    drift = np.linalg.norm(guess[4][:2] - truth[4][:2])
    z = np.asarray(jg.se2_between(jnp.asarray(truth[0]), jnp.asarray(truth[4])))
    _both_do(pair, "add_odometry", 0, 4, z, [0.01, 0.01, 0.001])
    poses = _updated(pair, atol=1e-4)
    err = np.linalg.norm(poses[4][:2] - truth[4][:2])
    assert err < 0.02 and err < drift


def test_smoother_loop_with_full_covariance():
    """``add_between_cov`` (the loop factors' form) and a robust loop."""
    pair = _smoothers()
    _both_do(pair, "add_prior", [0, 0, 0], [0.01, 0.01, 0.001])
    _both_do(pair, "insert", 0, [0, 0, 0])
    for k in range(3):
        _both_do(pair, "add_odometry", k, k + 1, [1.0, 0.05, 0.02], [0.1, 0.1, 0.01])
        _both_do(pair, "insert", k + 1, [k + 1.0, 0.0, 0.0])
    cov = np.array([[0.02, 0.005, 0.0], [0.005, 0.03, 0.001],
                    [0.0, 0.001, 0.002]], np.float32)
    _both_do(pair, "add_between_cov", 0, 3, [3.1, 0.2, 0.05], cov)
    _both_do(pair, "add_between_cov", 1, 3, [1.5, 1.0, 0.3], cov, robust=True)
    _updated(pair)
    for k in (0, 3):
        np.testing.assert_allclose(pair[1].marginal_covariance(k).numpy(),
                                   np.asarray(pair[0].marginal_covariance(k)),
                                   atol=1e-6)


def test_smoother_marginal_covariance_grows_along_chain():
    pair = _smoothers()
    _both_do(pair, "add_prior", [0, 0, 0], [0.1, 0.1, 0.01])
    _both_do(pair, "insert", 0, [0, 0, 0])
    for k in range(3):
        _both_do(pair, "add_odometry", k, k + 1, [1.0, 0.0, 0.0], [0.2, 0.2, 0.02])
        _both_do(pair, "insert", k + 1, [k + 1.0, 0.0, 0.0])
    _updated(pair)
    c0, c3 = (pair[1].marginal_covariance(k).numpy() for k in (0, 3))
    for k, c in ((0, c0), (3, c3)):
        np.testing.assert_allclose(c, np.asarray(pair[0].marginal_covariance(k)),
                                   atol=1e-6)
    np.testing.assert_allclose(c0, np.diag([0.01, 0.01, 1e-4]), atol=1e-5)
    assert np.linalg.det(c3) > np.linalg.det(c0)
    np.testing.assert_allclose(c3[0, 0], 0.01 + 3 * 0.04, rtol=0.05)


def test_smoother_robust_factor_downweights_outlier():
    def final_error(robust):
        pair = _smoothers()
        _both_do(pair, "add_prior", [0, 0, 0], [0.01, 0.01, 0.001])
        _both_do(pair, "insert", 0, [0, 0, 0])
        for k in range(3):
            _both_do(pair, "add_odometry", k, k + 1, [1.0, 0.0, 0.0],
                     [0.1, 0.1, 0.01])
            _both_do(pair, "insert", k + 1, [k + 1.0, 0.0, 0.0])
        _both_do(pair, "add_odometry", 0, 3, [0.0, 5.0, 1.0], [0.1, 0.1, 0.01],
                 robust=robust)
        return np.linalg.norm(_updated(pair, atol=1e-4)[3] - [3.0, 0.0, 0.0])

    assert final_error(True) < final_error(False)


def test_smoother_survives_nan_factor():
    pair = _smoothers()
    _both_do(pair, "add_prior", [0, 0, 0], [0.1, 0.1, 0.01])
    _both_do(pair, "insert", 0, [0, 0, 0])
    _both_do(pair, "add_odometry", 0, 1, [1.0, 0.0, 0.0], [0.2, 0.2, 0.02])
    _both_do(pair, "insert", 1, [1.0, 0.0, 0.0])
    _both_do(pair, "add_odometry", 1, 2, [np.nan, 0.0, 0.0], [0.2, 0.2, 0.02])
    _both_do(pair, "insert", 2, [2.0, 0.0, 0.0])
    poses = _updated(pair)
    assert np.isfinite(poses).all()
    np.testing.assert_allclose(poses[1], [1.0, 0.0, 0.0], atol=1e-5)


@pytest.mark.parametrize("clamp", [(3, 0.01, 0.002, 1e-5), (64, 0.5, 0.1, 1e-7)])
def test_smoother_step_clamp(clamp):
    iters, ct, cr, tol = clamp
    cfg = CFG._replace(gn_iters=iters, step_clamp_t=ct, step_clamp_r=cr,
                       convergence_tol=tol)
    pair = _smoothers(cfg)
    _both_do(pair, "add_prior", [0, 0, 0], [0.1, 0.1, 0.01])
    _both_do(pair, "insert", 0, [0, 0, 0])
    _both_do(pair, "add_odometry", 0, 1, [1.0, 0.0, 0.0], [0.05, 0.05, 0.01])
    _both_do(pair, "insert", 1, [6.0, 3.0, 0.5] if iters > 3 else [6.0, 0.0, 0.0])
    poses = _updated(pair)
    if iters > 3:  # enough sweeps: the clamp keeps the fixed point
        np.testing.assert_allclose(poses[1], [1.0, 0.0, 0.0], atol=1e-4)
    else:  # each sweep moves a pose at most step_clamp_t
        assert np.linalg.norm(poses[1, :2] - [6.0, 0.0]) <= ct * iters + 1e-6


# ---- PCM's host clique search ----


@pytest.mark.parametrize("seed", range(4))
def test_max_clique_host_matches_jax(seed):
    rng = np.random.default_rng(seed)
    Q = 7
    adj = np.triu(rng.uniform(size=(Q, Q)) > 0.4, 1)
    adj = adj | adj.T
    graph = {i: {j for j in range(Q) if adj[i, j]} for i in range(Q)}
    got = tgr.max_clique_host(graph)
    assert got == jgr.max_clique_host(graph)
    _, size = tgr.max_clique_mask(torch.as_tensor(adj), torch.ones(Q, dtype=torch.bool), 1)
    assert int(size) == len(got)
    assert all(b in graph[a] for a in got for b in got if a != b)
    assert tgr.max_clique_host({}) == []


# ---- cloud filters and keyed downsampling ----


@pytest.mark.parametrize("knn,lo,hi", [(4, 0.5, 3.0), (6, 0.0, 1.2), (3, 0.3, 0.9)])
def test_density_filter_matches_jax_with_ties(knn, lo, hi):
    rng = np.random.default_rng(knn)
    # an integer grid with gaps and a dense clump: many tied distances
    grid = np.stack(np.meshgrid(np.arange(8), np.arange(6)), -1).reshape(-1, 2)
    pts = np.concatenate([grid, 0.5 * grid[:12] + 20.0]).astype(np.float32)
    mask = rng.uniform(size=len(pts)) > 0.15
    got = tcl.density_filter(torch.as_tensor(pts), torch.as_tensor(mask), knn, lo, hi)
    want = jcl.density_filter(jnp.asarray(pts), jnp.asarray(mask), knn, lo, hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < int(mask.sum())


@pytest.mark.parametrize("max_out", [16, 64])
def test_voxel_downsample_with_keys_matches_jax(max_out):
    rng = np.random.default_rng(max_out)
    N = 300
    pts = rng.uniform(-1.0, 11.0, size=(N, 2)).astype(np.float32)
    pts[:40] = 3.3  # one crowded cell
    mask = rng.uniform(size=N) > 0.2
    keys = rng.integers(0, 50, size=N).astype(np.int32)
    spec = dict(x0=0.0, y0=0.0, resolution=1.0, nx=10, ny=10)
    tc, tk, tm = tcl.voxel_downsample_with_keys(
        torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(keys),
        tcl.VoxelGridSpec(**spec), max_out)
    jc, jk, jm = jcl.voxel_downsample_with_keys(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(keys),
        jcl.VoxelGridSpec(**spec), max_out)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tk.dtype == torch.int32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    plain, plain_mask = tcl.voxel_downsample(
        torch.as_tensor(pts), torch.as_tensor(mask), tcl.VoxelGridSpec(**spec),
        max_out)
    assert torch.equal(plain_mask, tm) and torch.equal(plain, tc)


# ---- SE(2) homogeneous matrices ----


def test_se2_matrix_round_trip_matches_jax():
    rng = np.random.default_rng(2)
    p = rng.uniform(-3.0, 3.0, size=(5, 4, 3)).astype(np.float32)
    T = tg.se2_matrix(torch.as_tensor(p))
    np.testing.assert_allclose(T.numpy(), np.asarray(jg.se2_matrix(jnp.asarray(p))),
                               atol=1e-6)
    back = tg.se2_from_matrix(T)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(jg.se2_from_matrix(jnp.asarray(T.numpy()))),
                               atol=1e-6)
    np.testing.assert_allclose(back.numpy(), p, atol=1e-6)


# ---- the padded SLAM scan ----


def test_slam_scan_matches_padded_scan():
    from test_refine import K, N, _dims, _frame_cloud, _params

    jdims = _dims(refine_iters=0)
    rng = np.random.default_rng(3)
    truth = np.zeros((K, 3), np.float32)
    truth[:, 0] = np.arange(K) * 1.2
    pts = np.zeros((K, N, 2), np.float32)
    msk = np.zeros((K, N), bool)
    for k in range(K):
        pts[k], msk[k] = _frame_cloud(rng, truth[k], offset=0.04 * k)
    pose3 = np.zeros((K, 6), np.float32)
    pose3[:, 0] = truth[:, 0]
    valid = np.ones(K, bool)
    valid[5] = False  # an interior hole
    valid[K - 3:] = False  # a padded tail
    jparams = _params(jdims)._replace(keyframe_duration=jnp.float32(0.5))
    frames = tcore.KeyframeInput(
        time=torch.arange(K, dtype=torch.float32) * 2.0,
        dr_pose3=torch.as_tensor(pose3), points=torch.as_tensor(pts),
        pmask=torch.as_tensor(msk & valid[:, None]), valid=torch.as_tensor(valid))
    dims = dims_from_reference(jdims)
    params = params_from_reference(jax.tree_util.tree_map(np.asarray, jparams),
                                   "cpu")
    c_pad, o_pad = tcore.slam_scan_padded(frames, params, dims)
    c_new, o_new = tcore.slam_scan(frames, params, dims)

    def leaves(tree):
        if isinstance(tree, torch.Tensor) or tree is None or np.isscalar(tree):
            return [tree]
        return [x for sub in tree for x in leaves(sub)]

    for a, b in zip(leaves(c_pad), leaves(c_new)):
        assert type(a) is type(b)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    for name, a, b in zip(o_pad._fields, o_pad, o_new):
        assert torch.equal(a, b), name
        assert not a[torch.as_tensor(~valid)].any(), name
    assert c_pad.num_kf == int(valid.sum()) == 12

    jframes = jcore.KeyframeInput(
        time=jnp.arange(K, dtype=jnp.float32) * 2.0, dr_pose3=jnp.asarray(pose3),
        points=jnp.asarray(pts), pmask=jnp.asarray(msk & valid[:, None]),
        valid=jnp.asarray(valid))
    jc, _ = jcore.slam_scan_padded(jframes, jparams, jdims)
    assert c_pad.num_kf == int(jc.num_kf) and c_pad.num_loops == int(jc.num_loops)
    np.testing.assert_allclose(c_pad.poses.numpy(), np.asarray(jc.poses), atol=1e-4)
