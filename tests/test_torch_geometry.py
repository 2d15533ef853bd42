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
import sonar_slam_tpu.geometry.se3 as jse3
import sonar_slam_torch.geometry as tg

torch.set_num_threads(1)
ATOL = 2e-6


def _poses(rng, n):
    p = rng.normal(size=(n, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-np.pi, np.pi, size=n)
    return p


def _both(name, *args):
    jf = getattr(jg, name) if hasattr(jg, name) else getattr(jse3, name)
    j = np.asarray(jf(*[jnp.asarray(a) for a in args]))
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


def _poses3(rng, n):
    p = rng.normal(size=(n, 6)).astype(np.float32)
    p[:, :3] *= 10.0
    p[:, 3] = rng.uniform(-np.pi, np.pi, size=n)
    p[:, 4] = rng.uniform(-1.2, 1.2, size=n)  # away from gimbal lock
    p[:, 5] = rng.uniform(-np.pi, np.pi, size=n)
    return p


@pytest.mark.parametrize("name", ["pose3_compose", "pose3_between"])
def test_pose3_binary_ops(name):
    rng = np.random.default_rng(4)
    a, b = _poses3(rng, 32), _poses3(rng, 32)
    j, t = _both(name, a, b)
    np.testing.assert_allclose(t, j, atol=2e-5)  # 10 m-scale translations


@pytest.mark.parametrize("name", ["pose3_inverse", "pose3_rotmat"])
def test_pose3_unary_ops(name):
    rng = np.random.default_rng(5)
    j, t = _both(name, _poses3(rng, 32).reshape(4, 8, 6))
    np.testing.assert_allclose(t, j, atol=2e-5)


def test_rot3_ops():
    rng = np.random.default_rng(6)
    p = _poses3(rng, 24)
    ypr = (p[:, 5], p[:, 4], p[:, 3])
    jR, tR = _both("rot3_ypr", *ypr)
    np.testing.assert_allclose(tR, jR, atol=ATOL)
    j, t = _both("rot3_to_ypr", jR)
    np.testing.assert_allclose(t, j, atol=ATOL)
    j, t = _both("rot3_compose", jR, jR[::-1].copy())
    np.testing.assert_allclose(t, j, atol=ATOL)
    j, t = _both("rot3_inverse", jR)
    np.testing.assert_array_equal(t, j)


def test_pose2_to_pose3_and_transform_points():
    rng = np.random.default_rng(7)
    p2 = _poses(rng, 8)
    j = np.asarray(jg.pose2_to_pose3(jnp.asarray(p2), z=1.5, roll=0.25))
    t = tg.pose2_to_pose3(torch.as_tensor(p2), z=1.5, roll=0.25).numpy()
    np.testing.assert_array_equal(t, j)
    pts = (20.0 * rng.normal(size=(8, 30, 3))).astype(np.float32)
    j, t = _both("pose3_transform_points", pts, _poses3(rng, 8))
    np.testing.assert_allclose(t, j, atol=4e-5)  # 20 m-scale coordinates
