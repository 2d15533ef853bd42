"""Scan-matching parity: Sobol global initialization, the robust multi-start
covariance, and the covariance helpers.

Pinned differences between JAX and torch:
* ``jnp.argsort`` is stable and the costs are small integers, so ties are
  the rule; the port sorts with ``stable=True`` and must give the same guess
  order exactly;
* the guess scatter drops out-of-range slots (``mode="drop"``); the port
  masks them first (here 129 samples compact into 6 guesses);
* a Cholesky of a matrix that is not positive definite returns NaN in JAX,
  which the log-det maps to +inf; the port fills NaN the same way.
Poses agree to 1e-5 (float32 trigonometry); counts and masks exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.slam.scan_matching as jsm
import sonar_slam_torch.slam.scan_matching as tsm

torch.set_num_threads(1)


def _t(*a):
    return [torch.as_tensor(np.asarray(x)) for x in a]


def _j(*a):
    return [jnp.asarray(x) for x in a]


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, 150)
    tgt = np.stack([9 * np.cos(t) + 0.6 * np.sin(4 * t), 6 * np.sin(t)], -1)
    tgt = (tgt + 0.03 * rng.normal(size=tgt.shape)).astype(np.float32)
    src = (tgt[::2] + 0.05 * rng.normal(size=(75, 2))).astype(np.float32)
    return (src, rng.uniform(size=75) < 0.9, tgt, rng.uniform(size=150) < 0.9)


def test_global_initialize_ties_and_drop(clouds):
    src, smask, tgt, tmask = clouds
    unit = jsm.sobol_unit_samples(128)
    np.testing.assert_array_equal(tsm.sobol_unit_samples(128), unit)
    sp = np.array([0.2, -0.1, 0.03], np.float32)
    tp = np.array([0.0, 0.1, -0.02], np.float32)
    bounds = np.array([0.5, 0.5, 0.1], np.float32)
    jr = jsm.global_initialize(*_j(src, smask, tgt, tmask, sp, tp, bounds, unit),
                               point_noise=0.5, num_guesses=6)
    tr = tsm.global_initialize(*_t(src, smask, tgt, tmask, sp, tp, bounds, unit),
                               point_noise=0.5, num_guesses=6)
    jcost, _ = jsm.match_count_costs(*_j(src, smask, tgt, tmask, sp, tp),
                                     jnp.zeros((3, 3)), 0.5)
    tcost, _ = tsm.match_count_costs(*_t(src, smask, tgt, tmask, sp, tp),
                                     torch.zeros((3, 3)), 0.5)
    np.testing.assert_array_equal(tcost.numpy(), np.asarray(jcost))
    np.testing.assert_array_equal(tr.guess_mask.numpy(), np.asarray(jr.guess_mask))
    np.testing.assert_allclose(tr.guess_poses.numpy(), np.asarray(jr.guess_poses),
                               atol=1e-5)
    np.testing.assert_allclose(tr.best_delta.numpy(), np.asarray(jr.best_delta),
                               atol=1e-6)
    assert float(tr.best_cost) == float(jr.best_cost)
    np.testing.assert_allclose(tr.guesses_vs(torch.as_tensor(tp)).numpy(),
                               np.asarray(jr.guesses_vs(jnp.asarray(tp))), atol=1e-5)


def test_estimate_pose_covariance():
    rng = np.random.default_rng(1)
    samples = (np.array([1.0, -0.5, 0.1])
               + rng.normal(scale=[0.02, 0.03, 0.005], size=(12, 3)))
    samples[[2, 7]] += [0.8, -0.6, 0.2]  # outliers the MCD must reject
    samples = samples.astype(np.float32)
    mask = np.ones(12, bool)
    mask[[5, 11]] = False
    jmu, jcov, jn = jsm.estimate_pose_covariance(*_j(samples, mask))
    tmu, tcov, tn = tsm.estimate_pose_covariance(*_t(samples, mask))
    assert int(tn) == int(jn)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=1e-6)
    np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), rtol=1e-4, atol=1e-9)


def test_covariance_helpers_and_nan_cholesky():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 3)).astype(np.float32)
    cov = (a @ a.T * 0.01).astype(np.float32)
    pose = np.array([1.0, 2.0, 0.7], np.float32)
    np.testing.assert_allclose(
        tsm.localize_covariance(*_t(cov, pose)).numpy(),
        np.asarray(jsm.localize_covariance(*_j(cov, pose))), rtol=1e-5, atol=1e-8)
    for sig in ([0.3, 0.3, 0.1], [0.001, 0.001, 0.001]):
        s = np.asarray(sig, np.float32)
        jc, jf = jsm.apply_covariance_floor(*_j(cov, s))
        tc, tf = tsm.apply_covariance_floor(*_t(cov, s))
        assert bool(tf) == bool(jf)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    not_pd = np.diag([1.0, -1.0, 1.0]).astype(np.float32)
    assert np.isinf(float(jsm._logdet_psd_3x3(jnp.asarray(not_pd))))
    assert np.isinf(float(tsm._logdet_psd_3x3(torch.as_tensor(not_pd))))
    assert torch.isnan(tsm.cholesky_nan(torch.as_tensor(not_pd))).all()
    np.testing.assert_allclose(
        float(tsm._logdet_psd_3x3(torch.as_tensor(cov))),
        float(jsm._logdet_psd_3x3(jnp.asarray(cov))), rtol=1e-5)
