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
