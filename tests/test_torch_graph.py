"""Factor graph and PCM: the port against the JAX package.

The port assembles the normal equations as A^T A of one stacked Jacobian
(from ``torch.func.jacfwd``) instead of scatter-adds, and solves with the
same Jacobi-scaled Cholesky; poses agree to 2e-5 m / rad and marginal
covariances to 1e-3 relative (1e-6 absolute on entries ~0.1) after a few
Gauss-Newton sweeps in float32.
A NaN factor makes the Cholesky fail in both; both recover by escalating
the damping (tests/test_graph.py::test_optimize_survives_nan_factor pins it
for JAX).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.graph as jgr
from sonar_slam_tpu.graph.factor_graph import optimize_with_marginal as j_owm
import sonar_slam_torch.graph as tgr

torch.set_num_threads(1)


def _build(mod, cfg, steps, loops, nan_factor=False, device=None):
    T = (lambda x: jnp.asarray(np.asarray(x, np.float32))) if mod is jgr else (
        lambda x: torch.as_tensor(np.asarray(x, np.float32)))
    g = mod.graph_init(cfg) if mod is jgr else mod.graph_init(cfg, "cpu")
    g = mod.add_prior(g, T([0.0, 0.0, 0.0]), mod.sigmas_to_sqrt_info(
        T([0.1, 0.1, 0.01])))
    pose = np.zeros(3, np.float32)
    for k, (z, noisy) in enumerate(steps, start=1):
        sq = mod.sigmas_to_sqrt_info(T([0.2, 0.2, 0.02]))
        g = mod.add_between(g, k - 1, k, T(z), sq, robust=bool(k % 3 == 0),
                            scaled=bool(k % 2 == 0))
        c, s = np.cos(pose[2]), np.sin(pose[2])
        pose = pose + np.array([c * noisy[0] - s * noisy[1],
                                s * noisy[0] + c * noisy[1], noisy[2]], np.float32)
        g = mod.set_pose_estimate(g, k, T(pose))
    for i, j, z, cov in loops:
        sq = mod.cov_to_sqrt_info(T(cov))
        if nan_factor:
            sq = sq * np.float32("nan")
            nan_factor = False
        g = mod.add_between(g, i, j, T(z), sq)
    return g


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    steps = []
    for _ in range(9):
        z = np.array([1.0, 0.1, 0.35], np.float32)
        steps.append((z, z + rng.normal(scale=[0.05, 0.05, 0.02]).astype(np.float32)))
    cov = np.diag([0.01, 0.02, 0.001]).astype(np.float32)
    cov[0, 1] = cov[1, 0] = 0.004
    loops = [(0, 8, np.array([1.2, 5.1, 2.8], np.float32), cov),
             (2, 9, np.array([2.0, 3.0, 2.45], np.float32), cov)]
    return steps, loops


@pytest.mark.parametrize("estimate_scale", [False, True])
def test_optimize_with_marginal(problem, estimate_scale):
    steps, loops = problem
    kw = dict(max_poses=12, max_factors=16, gn_iters=4,
              estimate_scale=estimate_scale, scale_prior_sigma=(0.05, 0.01))
    jg = _build(jgr, jgr.GraphConfig(**kw), steps, loops)
    tg = _build(tgr, tgr.GraphConfig(**kw), steps, loops)
    js, jcov = j_owm(jg, 9, jgr.GraphConfig(**kw))
    ts, tcov = tgr.optimize_with_marginal(tg, 9, tgr.GraphConfig(**kw))
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses), atol=2e-5)
    np.testing.assert_allclose(ts.log_scale.numpy(), np.asarray(js.log_scale),
                               atol=2e-6)
    np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), rtol=1e-3, atol=1e-6)
    assert int(ts.num_factors) == int(js.num_factors) == 11


def test_optimize_survives_nan_factor(problem):
    steps, loops = problem
    kw = dict(max_poses=12, max_factors=16, gn_iters=4)
    jg = _build(jgr, jgr.GraphConfig(**kw), steps, loops, nan_factor=True)
    tg = _build(tgr, tgr.GraphConfig(**kw), steps, loops, nan_factor=True)
    js = jgr.optimize(jg, jgr.GraphConfig(**kw))
    ts = tgr.optimize(tg, tgr.GraphConfig(**kw))
    assert np.isfinite(ts.poses.numpy()).all()
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses), atol=2e-5)


def test_cov_to_sqrt_info_and_not_pd():
    cov = np.array([[0.02, 0.005, 0.0], [0.005, 0.03, 0.001],
                    [0.0, 0.001, 0.002]], np.float32)
    np.testing.assert_allclose(
        tgr.cov_to_sqrt_info(torch.as_tensor(cov)).numpy(),
        np.asarray(jgr.cov_to_sqrt_info(jnp.asarray(cov))), rtol=1e-4)
    bad = np.diag([1.0, -2.0, 1.0]).astype(np.float32)
    assert np.isnan(np.asarray(jgr.cov_to_sqrt_info(jnp.asarray(bad)))).any()
    assert torch.isnan(tgr.cov_to_sqrt_info(torch.as_tensor(bad))).any()


def test_add_between_disabled_is_noop(problem):
    steps, loops = problem
    cfg = tgr.GraphConfig(max_poses=12, max_factors=16)
    g = _build(tgr, cfg, steps, loops)
    g2 = tgr.add_between(g, 1, 2, torch.ones(3), torch.eye(3),
                         enabled=torch.tensor(False))
    for a, b in zip(g, g2):
        assert torch.equal(a, b)


def test_pcm_select():
    rng = np.random.default_rng(3)
    Q = 6
    tp = rng.normal(size=(Q, 3)).astype(np.float32)
    sp = rng.normal(size=(Q, 3)).astype(np.float32)
    import sonar_slam_tpu.geometry as jgeo

    tf = np.asarray(jgeo.se2_between(jnp.asarray(tp), jnp.asarray(sp)))
    tf = tf + rng.normal(scale=0.01, size=tf.shape).astype(np.float32)
    tf[4] += [1.0, -0.5, 0.3]  # inconsistent with the rest
    covs = np.tile(np.diag([0.01, 0.01, 0.001]).astype(np.float32), (Q, 1, 1))
    valid = np.array([True, True, True, True, True, False])
    for min_pcm in (2, 5):
        jm, js = jgr.pcm_select(*[jnp.asarray(x) for x in (sp, tp, tf, covs, valid)],
                                min_pcm)
        tm, ts = tgr.pcm_select(*[torch.as_tensor(x) for x in (sp, tp, tf, covs, valid)],
                                min_pcm)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert int(ts) == int(js)


def test_marginal_covariance_of_several_keys(problem):
    steps, loops = problem
    kw = dict(max_poses=12, max_factors=16, gn_iters=4, estimate_scale=True,
              scale_prior_sigma=(0.05, 0.01))
    jg = _build(jgr, jgr.GraphConfig(**kw), steps, loops)
    tg = _build(tgr, tgr.GraphConfig(**kw), steps, loops)
    keys = [0, 4, 9]
    got = tgr.marginal_covariance(tg, torch.tensor(keys), tgr.GraphConfig(**kw))
    assert got.shape == (3, 3, 3)
    for k, c in zip(keys, got):
        want = np.asarray(jgr.marginal_covariance(jg, k, jgr.GraphConfig(**kw)))
        np.testing.assert_allclose(c.numpy(), want, rtol=1e-3, atol=1e-6)
    one = tgr.marginal_covariance(tg, 4, tgr.GraphConfig(**kw))
    np.testing.assert_array_equal(one.numpy(), got[1].numpy())


@pytest.mark.parametrize("estimate_scale", [False, True])
def test_optimize_batch_matches_vmapped_optimize(problem, estimate_scale):
    """A batch of graphs whose Gauss-Newton loops stop after different
    numbers of sweeps, against the JAX package's vmap of ``optimize``."""
    import jax

    steps, loops = problem
    kw = dict(max_poses=12, max_factors=16, gn_iters=5,
              estimate_scale=estimate_scale, scale_prior_sigma=(0.05, 0.01))
    rng = np.random.default_rng(1)
    jgs, tgs = [], []
    for b in range(3):
        st = [(z, noisy + rng.normal(scale=0.02 * b, size=3).astype(np.float32))
              for z, noisy in steps]
        jgs.append(_build(jgr, jgr.GraphConfig(**kw), st, loops))
        tgs.append(_build(tgr, tgr.GraphConfig(**kw), st, loops))
    jb = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jgs)
    js = jax.vmap(lambda g: jgr.optimize(g, jgr.GraphConfig(**kw)))(jb)
    tb = tgr.GraphState(*[torch.stack(x) for x in zip(*tgs)])
    ts = tgr.optimize_batch(tb, tgr.GraphConfig(**kw))
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses), atol=2e-5)
    np.testing.assert_allclose(ts.log_scale.numpy(), np.asarray(js.log_scale),
                               atol=2e-6)
    for b in range(3):  # each lane as the unbatched optimize gives it
        one = tgr.optimize(tgs[b], tgr.GraphConfig(**kw))
        np.testing.assert_allclose(ts.poses[b].numpy(), one.poses.numpy(),
                                   atol=2e-6)


def _assert_cov_blocks(got, want):
    """Each 3x3 block within 1e-4 of its largest entry: the cross terms are
    1e-3 to 1e-2 of the diagonal and carry the float32 solve's rounding
    (measured 5.4e-5)."""
    scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-4 * scale)


def test_services(problem):
    """predict_slam_update and query_pose_uncertainty on a carry holding the
    test graph, against the JAX services."""
    import jax

    import sonar_slam_tpu.slam.core as jcore
    from sonar_slam_tpu.cloud import ICPConfig
    from sonar_slam_tpu.slam.services import (
        predict_slam_update as j_predict, query_pose_uncertainty as j_query)
    from sonar_slam_torch.convert import carry_from_reference, dims_from_reference
    from sonar_slam_torch.slam.services import (
        predict_slam_update, query_pose_uncertainty)

    steps, loops = problem
    jdims = jcore.SlamDims(max_keyframes=14, max_loops=4, gn_iters=4,
                           icp=ICPConfig())
    jg = _build(jgr, jdims.graph_config(), steps, loops)
    jg = jgr.optimize(jg, jdims.graph_config())
    jcarry = jcore.slam_init(jdims)._replace(graph=jg, poses=jg.poses,
                                             num_kf=jnp.asarray(10, jnp.int32))
    carry = carry_from_reference(jax.tree_util.tree_map(np.asarray, jcarry), "cpu")
    dims = dims_from_reference(jdims)
    odom = np.asarray([[[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]],
                       [[1.0, 0.0, 0.5], [1.0, 0.0, 0.5]],
                       [[0.5, 0.2, -0.3], [0.8, -0.1, 0.1]]], np.float32)
    sig = np.asarray([0.2, 0.2, 0.02], np.float32)
    jpred, jcov = j_predict(jcarry, jdims, jnp.asarray(odom), jnp.asarray(sig))
    pred, cov = predict_slam_update(carry, dims, torch.as_tensor(odom),
                                    torch.as_tensor(sig))
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=2e-5)
    _assert_cov_blocks(cov.numpy(), np.asarray(jcov))
    keys = np.asarray([0, 5, 9])
    got = query_pose_uncertainty(carry, dims, torch.as_tensor(keys))
    _assert_cov_blocks(got.numpy(), np.asarray(j_query(jcarry, jdims,
                                                       jnp.asarray(keys))))
    assert np.trace(cov[0].numpy()) > np.trace(got[-1].numpy())
