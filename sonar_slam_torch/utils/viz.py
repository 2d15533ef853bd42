"""Visualization helpers (matplotlib; no ROS markers).

Counterpart of ``sonar_slam_tpu/utils/viz.py`` (the reference's
``utils/visualization.py``): colored trajectories, covariance ellipses,
constraint line sets (green sequential / red loops), occupancy-grid rendering
and the sonar feature overlay. Every function draws onto a supplied (or the
current) matplotlib axes and imports matplotlib only when called; inputs may
be numpy arrays or CPU tensors.
"""

from __future__ import annotations

import numpy as np


def plot_trajectory(poses, ax=None, color_by_index=True, label=None, **kw):
    """2-D trajectory colored along its length (ros_colorline analog)."""
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    poses = np.asarray(poses)
    if color_by_index and len(poses) > 1:
        sc = ax.scatter(
            poses[:, 0], poses[:, 1], c=np.arange(len(poses)), s=4,
            cmap=kw.pop("cmap", "viridis"),
        )
        ax.plot(poses[:, 0], poses[:, 1], lw=0.5, alpha=0.5,
                color="gray", label=label)
        return sc
    return ax.plot(poses[:, 0], poses[:, 1], label=label, **kw)


def plot_cov_ellipse(pose, cov, ax=None, nstd=3.0, **kw):
    """n-sigma covariance ellipse at pose (`visualization.py:60-102`)."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Ellipse

    ax = ax or plt.gca()
    cov2 = np.asarray(cov)[:2, :2]
    vals, vecs = np.linalg.eigh(cov2)
    angle = np.degrees(np.arctan2(vecs[1, -1], vecs[0, -1]))
    w, h = 2 * nstd * np.sqrt(np.maximum(vals, 0))
    e = Ellipse(xy=np.asarray(pose)[:2], width=w, height=h, angle=angle,
                fill=False, **kw)
    ax.add_patch(e)
    return e


def plot_constraints(poses, loops_i=None, loops_j=None, ax=None):
    """Sequential constraints green, loop closures red
    (`visualization.py:136-165`)."""
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    poses = np.asarray(poses)
    for k in range(1, len(poses)):
        ax.plot(poses[k - 1 : k + 1, 0], poses[k - 1 : k + 1, 1],
                color="green", lw=1.0)
    if loops_i is not None:
        for i, j in zip(np.asarray(loops_i), np.asarray(loops_j)):
            if i < len(poses) and j < len(poses):
                ax.plot([poses[i, 0], poses[j, 0]], [poses[i, 1], poses[j, 1]],
                        color="red", lw=1.2)


def plot_occupancy(grid, config, ax=None, **kw):
    """Render an occupancy grid (int8 -1/0..100) in world coordinates."""
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    g = np.asarray(grid, np.float32)
    g = np.ma.masked_where(g < 0, g)
    extent = [config.x0, config.x0 + config.width,
              config.y0, config.y0 + config.height]
    return ax.imshow(g, origin="lower", extent=extent,
                     cmap=kw.pop("cmap", "gray_r"), vmin=0, vmax=100, **kw)


def feature_overlay(polar_img, detections, geometry, ax=None):
    """Cartesian sonar image with detections overlaid (the feature-image
    topic, `feature_extraction.py:226-228`)."""
    import matplotlib.pyplot as plt

    import torch

    from ..slam.sonar import remap_polar_to_cart

    ax = ax or plt.gca()
    ri, ci, valid = geometry.cart_gather_indices()
    img = remap_polar_to_cart(torch.as_tensor(np.asarray(polar_img)), ri, ci,
                              valid).numpy()
    det = remap_polar_to_cart(
        torch.as_tensor(np.asarray(detections).astype(np.float32)), ri, ci,
        valid).numpy()
    ax.imshow(img, cmap="inferno")
    ys, xs = np.nonzero(det > 0.5)
    ax.scatter(xs, ys, s=2, c="cyan")
    return ax
