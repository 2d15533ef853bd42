"""Parity of sonar_slam_torch.geometry with sonar_slam_tpu.geometry.

Same float32 inputs (numpy, seeded) through both; tolerance 2e-6 absolute on
unit-scale poses: the two libraries' float32 sin/cos/atan2 differ by a few
ulps, and nothing else differs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.geometry as jg
import sonar_slam_torch.geometry as tg

torch.set_num_threads(1)
ATOL = 2e-6


def _poses(rng, n):
    p = rng.normal(size=(n, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-np.pi, np.pi, size=n)
    return p


def _both(name, *args):
    j = np.asarray(getattr(jg, name)(*[jnp.asarray(a) for a in args]))
    t = getattr(tg, name)(*[torch.as_tensor(a) for a in args]).numpy()
    return j, t


@pytest.mark.parametrize("name", ["se2_compose", "se2_between"])
def test_binary_ops(name):
    rng = np.random.default_rng(0)
    a, b = _poses(rng, 32), _poses(rng, 32)
    j, t = _both(name, a, b)
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("name", ["se2_inverse", "se2_logmap", "se2_expmap",
                                  "wrap_angle"])
def test_unary_ops(name):
    rng = np.random.default_rng(1)
    x = _poses(rng, 64)
    x[:4, 2] = [0.0, 1e-12, -3e-11, np.pi]  # small-angle branch and the seam
    if name == "wrap_angle":
        x = (x * 7.0)[:, 2]
    j, t = _both(name, x)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_retract_and_transform_points():
    rng = np.random.default_rng(2)
    base, xi = _poses(rng, 16), (0.1 * rng.normal(size=(16, 3))).astype(np.float32)
    j, t = _both("se2_retract", base, xi)
    np.testing.assert_allclose(t, j, atol=ATOL)
    pts = (20.0 * rng.normal(size=(16, 50, 2))).astype(np.float32)
    j, t = _both("se2_transform_points", pts, base)
    np.testing.assert_allclose(t, j, atol=2e-5)  # 20 m-scale coordinates


def test_pose3_make_and_project():
    rng = np.random.default_rng(3)
    t3 = rng.normal(size=(8, 3)).astype(np.float32)
    rpy = (3.0 * rng.normal(size=(8, 3))).astype(np.float32)
    j, t = _both("pose3_make", t3, rpy)
    np.testing.assert_array_equal(t, j)
    j, t = _both("pose3_to_pose2", j)
    np.testing.assert_allclose(t, j, atol=ATOL)
