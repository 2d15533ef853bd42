"""The port's visualization helpers (``utils/viz.py``, Agg backend): the
cases of ``tests/test_viz.py``, and the feature overlay's Cartesian images
against the JAX package's."""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import matplotlib.pyplot as plt
import torch

from sonar_slam_torch.mapping import MappingConfig
from sonar_slam_torch.slam.sonar import SonarGeometry
from sonar_slam_torch.utils.viz import (
    feature_overlay,
    plot_constraints,
    plot_cov_ellipse,
    plot_occupancy,
    plot_trajectory,
)

rng = np.random.default_rng(3)


def test_trajectory_and_constraints(tmp_path):
    fig, ax = plt.subplots()
    poses = np.cumsum(rng.normal(size=(20, 3)), axis=0)
    plot_trajectory(poses, ax=ax)
    plot_trajectory(torch.as_tensor(poses) + 1, ax=ax, color_by_index=False,
                    color="orange")
    plot_constraints(poses, loops_i=[2, 5], loops_j=[15, 18], ax=ax)
    plot_cov_ellipse(poses[3], np.diag([0.5, 0.2, 0.1]), ax=ax, color="blue")
    fig.savefig(tmp_path / "traj.png")
    plt.close(fig)
    assert (tmp_path / "traj.png").exists()


def test_occupancy_render(tmp_path):
    cfg = MappingConfig(x0=-10, y0=-10, width=20, height=20, resolution=0.5)
    grid = np.full((cfg.rows, cfg.cols), -1, np.int8)
    grid[10:20, 10:20] = 90
    grid[5:10, 5:10] = 0
    fig, ax = plt.subplots()
    plot_occupancy(grid, cfg, ax=ax)
    fig.savefig(tmp_path / "occ.png")
    plt.close(fig)
    assert (tmp_path / "occ.png").exists()


def test_feature_overlay(tmp_path):
    from sonar_slam_tpu.slam.sonar import SonarGeometry as JGeometry
    from sonar_slam_tpu.utils.viz import feature_overlay as jax_overlay

    geom = SonarGeometry.make(num_ranges=64, num_bearings=32, max_range=10.0)
    img = rng.exponential(10.0, size=(64, 32)).astype(np.float32)
    det = np.zeros((64, 32), bool)
    det[30, 16] = True
    fig, ax = plt.subplots()
    feature_overlay(img, det, geom, ax=ax)
    fig.savefig(tmp_path / "overlay.png")
    assert (tmp_path / "overlay.png").exists()
    fig2, ax2 = plt.subplots()
    jax_overlay(img, det, JGeometry.make(num_ranges=64, num_bearings=32,
                                         max_range=10.0), ax=ax2)
    np.testing.assert_array_equal(ax.images[0].get_array(),
                                  ax2.images[0].get_array())
    np.testing.assert_array_equal(ax.collections[0].get_offsets(),
                                  ax2.collections[0].get_offsets())
    assert len(ax.collections[0].get_offsets()) > 0
    plt.close(fig)
    plt.close(fig2)
