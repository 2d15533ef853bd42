"""Parity of sonar_slam_torch.cloud with sonar_slam_tpu.cloud.

Inputs are seeded numpy clouds at the sonar's scale (tens of metres).
Tolerances: integer outputs (indices, counts, masks, kept cells) exact;
coordinates 1e-5 m (float32 sums in another order); ICP poses 1e-4 (a
dozen iterations of 3x3 solves on those sums).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.cloud as jc
from sonar_slam_tpu.cloud.icp import censi_covariance as j_censi
import sonar_slam_torch.cloud as tc

torch.set_num_threads(1)


def _cloud(rng, n, scale=10.0, pmask=0.8):
    pts = (scale * rng.normal(size=(n, 2))).astype(np.float32)
    mask = rng.uniform(size=n) < pmask
    return pts, mask


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_nn_match_and_overlap():
    rng = np.random.default_rng(0)
    ref, rmask = _cloud(rng, 200)
    q, qmask = _cloud(rng, 150)
    ji, jd = jc.nn_match(*_j(ref, rmask, q, qmask), 1.5)
    ti, td = tc.nn_match(*_t(ref, rmask, q, qmask), 1.5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    assert int(tc.count_overlap(*_t(q, qmask, ref, rmask), 0.5)) == int(
        jc.count_overlap(*_j(q, qmask, ref, rmask), 0.5))


def test_remove_outlier_batched():
    rng = np.random.default_rng(1)
    pts = (3.0 * rng.normal(size=(4, 128, 2))).astype(np.float32)
    mask = rng.uniform(size=(4, 128)) < 0.9
    tm = tc.remove_outlier(*_t(pts, mask), 1.0, 5).numpy()
    for b in range(4):
        jm = np.asarray(jc.remove_outlier(*_j(pts[b], mask[b]), 1.0, 5))
        np.testing.assert_array_equal(tm[b], jm)


def test_voxel_downsample_top_k_ties():
    """More occupied cells than the capacity, all with equal small counts:
    ``lax.top_k`` keeps the lowest cell ids, and so must the port."""
    spec_kw = dict(x0=-10.0, y0=-10.0, resolution=0.5, nx=41, ny=41)
    rng = np.random.default_rng(2)
    cells = rng.choice(41 * 41, size=150, replace=False)
    cx, cy = cells % 41, cells // 41
    base = np.stack([-10.0 + 0.5 * cx + 0.25, -10.0 + 0.5 * cy + 0.25], -1)
    pts = np.concatenate([base, base + 0.01, base[:20] - 0.01]).astype(np.float32)
    mask = np.ones(len(pts), bool)
    conf = rng.uniform(1, 5, len(pts)).astype(np.float32)
    jp, jm, jcf = jc.voxel_downsample_with_conf(
        *_j(pts, mask, conf), jc.VoxelGridSpec(**spec_kw), 64)
    tp, tm, tcf = tc.voxel_downsample_with_conf(
        *_t(pts, mask, conf), tc.VoxelGridSpec(**spec_kw), 64)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(tcf.numpy(), np.asarray(jcf), rtol=1e-6)
    jp2, jm2 = jc.voxel_downsample(*_j(pts, mask), jc.VoxelGridSpec(**spec_kw), 64)
    tp2, tm2 = tc.voxel_downsample(*_t(pts, mask), tc.VoxelGridSpec(**spec_kw), 64)
    np.testing.assert_allclose(tp2.numpy(), np.asarray(jp2), atol=1e-5)


def test_estimate_normals():
    rng = np.random.default_rng(3)
    t = np.linspace(0, 20, 120)
    pts = np.stack([t, 0.3 * np.sin(t)], -1) + 0.02 * rng.normal(size=(120, 2))
    pts = pts.astype(np.float32)
    mask = rng.uniform(size=120) < 0.9
    jn = np.asarray(jc.estimate_normals(*_j(pts, mask), 8, 2.0))
    tn = tc.estimate_normals(*_t(pts, mask), 8, 2.0).numpy()
    np.testing.assert_allclose(tn, jn, atol=1e-4)


def _scene(rng, n=160):
    t = np.linspace(0, 2 * np.pi, n)
    tgt = np.stack([8 * np.cos(t) + 0.5 * np.sin(5 * t), 5 * np.sin(t)], -1)
    tgt = (tgt + 0.02 * rng.normal(size=tgt.shape)).astype(np.float32)
    true = np.array([0.3, -0.2, 0.05], np.float32)
    c, s = np.cos(true[2]), np.sin(true[2])
    src = (tgt - true[:2]) @ np.array([[c, -s], [s, c]])  # inverse transform
    src = (src + 0.02 * rng.normal(size=src.shape)).astype(np.float32)
    return src, np.ones(n, bool), tgt, rng.uniform(size=n) < 0.95


@pytest.mark.parametrize("cfg", [
    dict(max_iterations=12, min_diff_rot=1e-3, min_diff_trans=1e-2,
         point_to_line=True, outlier_max_dist=0.5),
    dict(max_iterations=20, outlier_dist_decay=0.7, outlier_min_dist=0.3),
    dict(),
])
def test_icp_multistart_and_weights(cfg):
    rng = np.random.default_rng(4)
    src, smask, tgt, tmask = _scene(rng)
    guesses = np.array([[0, 0, 0], [0.4, -0.1, 0.1], [1.5, 1.0, -0.3],
                        [0.2, -0.3, 0.0]], np.float32)
    gmask = np.array([True, True, True, False])
    sw = rng.uniform(0.2, 1.0, len(src)).astype(np.float32)
    tw = rng.uniform(0.2, 1.0, len(tgt)).astype(np.float32)
    jres = jc.icp_multistart(*_j(src, smask, tgt, tmask, guesses, gmask),
                             jc.ICPConfig(**cfg), *_j(sw, tw))
    tres = tc.icp_multistart(*_t(src, smask, tgt, tmask, guesses, gmask),
                             tc.ICPConfig(**cfg), *_t(sw, tw))
    for name in ("ok", "converged", "iterations", "inliers"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)), err_msg=name)
    np.testing.assert_allclose(tres.pose.numpy(), np.asarray(jres.pose), atol=1e-4)
    np.testing.assert_allclose(tres.info.numpy(), np.asarray(jres.info),
                               rtol=1e-4, atol=1e-3)
    jcov = np.asarray(j_censi(jres.info[0], jres.mse[0], jres.pose[0]))
    tcov = tc.censi_covariance(tres.info[0], tres.mse[0], tres.pose[0]).numpy()
    np.testing.assert_allclose(tcov, jcov, rtol=1e-3, atol=1e-9)


def test_icp_single_start_starved():
    rng = np.random.default_rng(5)
    src, smask, tgt, tmask = _scene(rng)
    smask[:] = False  # no source points: never enough matches
    g = np.zeros(3, np.float32)
    jres = jc.icp(*_j(src, smask, tgt, tmask, g))
    tres = tc.icp(*_t(src, smask, tgt, tmask, g))
    assert bool(tres.ok) == bool(jres.ok) is False
    assert int(tres.iterations) == int(jres.iterations)
