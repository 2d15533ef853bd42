"""Component-level parity of the port against the installable reference
libraries: the port's counterpart of tests/test_parity.py's
``TestGaussNewtonConventions``, ``TestShgoParity`` and
``TestMinCovDetParity``, run against the port's own functions on the same
inputs with the same tolerances.

* The Gauss-Newton smoother (``graph.factor_graph``) against GTSAM's Pose2
  conventions, pinned in closed form: at zero headings the problem is
  linear, so its optimum and marginal are computable by hand.
* ``slam.scan_matching.global_initialize`` against ``scipy.optimize.shgo``
  over the same Sobol box and overlap cost (the reference's scan-match
  initialization).
* ``slam.scan_matching.estimate_pose_covariance`` against
  ``sklearn.covariance.MinCovDet`` (the reference's multi-start ICP
  covariance).

The card's machine has no sklearn; these tests run on the CPU and carry no
``cuda`` marker.
"""

import numpy as np
import torch

from sonar_slam_torch.graph.factor_graph import (
    GraphConfig,
    add_between,
    add_prior,
    graph_init,
    marginal_covariance,
    optimize,
    set_pose_estimate,
    sigmas_to_sqrt_info,
)
from sonar_slam_torch.slam.scan_matching import (
    estimate_pose_covariance,
    global_initialize,
    sobol_unit_samples,
)

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _make_clouds(seed=0, n=96, true_delta=(0.6, -0.4, 0.12)):
    """Target cloud + source cloud observed from a pose offset by
    ``true_delta`` from the identity-aligned pose (tests/test_parity.py's
    scene: two walls and a blob)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 8, n // 3)
    w1 = np.stack([t, 0.15 * np.sin(1.7 * t)], -1) + [4.0, -3.0]
    w2 = np.stack([0.2 * np.sin(2.1 * t), t], -1) + [10.0, -2.0]
    th = np.linspace(0, 2 * np.pi, n - 2 * (n // 3))
    blob = np.stack([6 + 0.8 * np.cos(th), 2 + 0.8 * np.sin(th)], -1)
    target = np.concatenate([w1, w2, blob]).astype(np.float32)
    d = np.asarray(true_delta, np.float32)
    c, s = np.cos(d[2]), np.sin(d[2])
    R = np.array([[c, -s], [s, c]], np.float32)
    source = (target - d[:2]) @ R + rng.normal(
        scale=0.01, size=target.shape).astype(np.float32)
    return source, target, d


def _count_cost(pose, source, target, noise):
    """The reference's overlap cost, continuous form (slam.py:536-568)."""
    c, s = np.cos(pose[2]), np.sin(pose[2])
    moved = source @ np.array([[c, s], [-s, c]]) + pose[:2]
    d2 = ((moved[:, None, :] - target[None]) ** 2).sum(-1)
    return -float((d2.min(1) <= noise**2).sum())


def _global_initialize(source, target, bounds, samples, noise, guesses):
    return global_initialize(
        _t(source), torch.ones(len(source), dtype=torch.bool), _t(target),
        torch.ones(len(target), dtype=torch.bool), torch.zeros(3),
        torch.zeros(3), _t(bounds), _t(sobol_unit_samples(samples)), noise,
        guesses)


class TestGaussNewtonConventions:
    """Closed-form pins of the Gauss-Newton smoother against GTSAM's
    documented Pose2 conventions (BetweenFactor error = Logmap(z^-1 *
    x_i^-1 x_j), diagonal sigma whitening): at zero headings the SE(2)
    problem is exactly linear, so the optimum and marginals any correct
    implementation must reach are computable by hand."""

    def _graph(self):
        cfg = GraphConfig(max_poses=3, max_factors=8, gn_iters=10)
        g = graph_init(cfg, "cpu")
        g = add_prior(g, _t([0.0, 0.0, 0.0]),
                      sigmas_to_sqrt_info(_t([0.1, 0.1, 0.05])))
        for k, x in enumerate([0.0, 1.0, 2.0]):
            g = set_pose_estimate(g, k, _t([x, 0.0, 0.0]))
        sq = sigmas_to_sqrt_info(_t([0.1, 0.1, 0.05]))
        g = add_between(g, 0, 1, _t([1.0, 0.0, 0.0]), sq)
        g = add_between(g, 1, 2, _t([1.0, 0.0, 0.0]), sq)
        # conflicting loop: 0->2 measured 0.3 m longer than the chain
        g = add_between(g, 0, 2, _t([2.3, 0.0, 0.0]), sq)
        return g, cfg

    def test_optimum_matches_hand_solved_linear_system(self):
        """min a^2 + (b-a-1)^2 + (c-b-1)^2 + (c-a-2.3)^2 has its unique
        optimum at a=0, b=1.1, c=2.2."""
        g, cfg = self._graph()
        g = optimize(g, cfg)
        np.testing.assert_allclose(
            g.poses[:3].numpy(),
            [[0.0, 0.0, 0.0], [1.1, 0.0, 0.0], [2.2, 0.0, 0.0]], atol=2e-4)

    def test_marginal_covariance_matches_hand_inverted_information(self):
        """The x-axis information for (x0, x1, x2) is w*[[3,-1,-1],
        [-1,2,-1],[-1,-1,2]] with w = 1/0.1^2; hand inversion gives
        Cov(x2,x2) = 5/(3w) = 1/60, the value GTSAM's marginalCovariance
        returns here."""
        g, cfg = self._graph()
        g = optimize(g, cfg)
        cov = marginal_covariance(g, 2, cfg).numpy()
        np.testing.assert_allclose(cov[0, 0], 1.0 / 60.0, rtol=1e-3)
        np.testing.assert_allclose(cov, cov.T, atol=1e-8)
        assert np.all(np.linalg.eigvalsh(cov) > 0)


class TestShgoParity:
    def test_matches_scipy_shgo_optimum(self):
        from scipy.optimize import shgo

        source, target, true_delta = _make_clouds()
        noise = 0.35
        bounds = np.array([1.0, 1.0, 0.3])
        ret = shgo(
            lambda p: _count_cost(p, source, target, noise),
            bounds=[(-b, b) for b in bounds],
            n=128, iters=2, sampling_method="sobol",
            minimizer_kwargs={"options": {"ftol": 1e-2}},
        )
        gi = _global_initialize(source, target, bounds, 256, noise, 8)
        ours = gi.best_delta.numpy()
        # both land in the true basin; shgo polishes a piecewise-constant
        # cost, so agreement is bounded by the Sobol sample spacing
        assert np.linalg.norm(ours[:2] - true_delta[:2]) < noise
        assert abs(ours[2] - true_delta[2]) < 0.15
        assert np.linalg.norm(ret.x[:2] - true_delta[:2]) < noise
        # the same predicate: our best sample is no worse than scipy's
        # optimum, up to one point of overlap
        assert float(gi.best_cost) <= _count_cost(ret.x, source, target,
                                                  noise) + 1.0

    def test_guess_list_matches_reference_ordering(self):
        """Guess list = cost-sorted eps-deduped samples: best-first and
        pairwise-distinct."""
        source, target, _ = _make_clouds(seed=3)
        gi = _global_initialize(source, target, [1.0, 1.0, 0.3], 128, 0.35, 6)
        guesses = gi.guess_poses.numpy()[gi.guess_mask.numpy()]
        costs = [_count_cost(g, source, target, 0.35) for g in guesses]
        assert costs[0] == min(costs)
        for i in range(len(guesses)):
            for j in range(i + 1, len(guesses)):
                assert np.linalg.norm(guesses[i] - guesses[j]) >= 0.01


class TestMinCovDetParity:
    def _samples(self, seed=0, n_in=24, n_out=6):
        rng = np.random.default_rng(seed)
        mean = np.array([0.5, -0.3, 0.1])
        cov = np.diag([0.02, 0.03, 0.005]) ** 2
        inliers = rng.multivariate_normal(mean, cov, size=n_in)
        outliers = rng.multivariate_normal(
            mean + [1.5, -1.0, 0.6], np.eye(3) * 0.04, size=n_out)
        return np.concatenate([inliers, outliers]).astype(np.float32), mean

    def test_matches_sklearn_mincovdet(self):
        from sklearn.covariance import MinCovDet

        samples, _ = self._samples()
        mcd = MinCovDet(support_fraction=0.8, random_state=0).fit(samples)
        mu, cov, _ = estimate_pose_covariance(
            _t(samples), torch.ones(len(samples), dtype=torch.bool))
        mu, cov = mu.numpy(), cov.numpy()
        np.testing.assert_allclose(mu, mcd.location_, atol=0.02)
        # against the scatter of sklearn's own support set (its consistency
        # and reweighting factors are a documented divergence)
        emp = np.cov(samples[mcd.support_].T, bias=True)
        scale = np.trace(cov) / np.trace(emp)
        assert 0.5 < scale < 2.0

        def corr(m):
            d = np.sqrt(np.diag(m))
            return m / np.outer(d, d)

        np.testing.assert_allclose(corr(cov), corr(emp), atol=0.35)

    def test_outlier_rejection_matches(self):
        """Both exclude the planted outliers from the support."""
        from sklearn.covariance import MinCovDet

        samples, true_mean = self._samples(seed=7)
        contaminated_mean = samples.mean(0)
        mcd = MinCovDet(support_fraction=0.8, random_state=0).fit(samples)
        mu, _, _ = estimate_pose_covariance(
            _t(samples), torch.ones(len(samples), dtype=torch.bool))
        mu = mu.numpy()
        for est in (mu, mcd.location_):
            assert np.linalg.norm(est - true_mean) < 0.05
            assert (np.linalg.norm(est - true_mean)
                    < 0.25 * np.linalg.norm(contaminated_mean - true_mean))
        np.testing.assert_allclose(mu, mcd.location_, atol=0.02)
