"""Dual-sonar fusion: every function of sonar_slam_torch.slam.dual_sonar
against the JAX package's on the same inputs.

The vertical frames are a small simulated dual-sonar survey's, detected by
the JAX package's strict-edge SOCA with the intensity gate; the horizontal
clouds and the poses are seeded numpy draws.

* Geometry, bins, centroids and masks are the same float32 arithmetic on
  the same inputs: the masks and weights equal, coordinates within 2e-6 m.
* The scatter-adds add the kept samples in their order in both packages
  (``index_put_(accumulate=True)`` and XLA's scatter on the CPU): the grid
  within 1e-5 relative.
* ``fuse_frames_global`` end to end: within 2e-5 m (transforms of 30 m-scale
  coordinates through float32 matmuls in the two libraries).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.io.simulate as jsim
import sonar_slam_tpu.slam.dual_sonar as jd
from sonar_slam_tpu.kernels.cfar import cfar_soca2
from sonar_slam_tpu.kernels.cfar_factors import threshold_factor_soca

import sonar_slam_torch.slam.dual_sonar as td
from sonar_slam_torch.slam.sonar import SonarGeometry

torch.set_num_threads(1)
ATOL = 2e-6


@pytest.fixture(scope="module")
def frames():
    """Vertical frames (F, R, C) with their JAX detections, seeded clouds
    (F, N, 2) with masks, poses (F, 3) and both packages' geometries."""
    bag = jsim.simulate_bag(jsim.SimConfig(
        duration=12.0, speed=0.5, sonar_rate=1.0, num_ranges=96,
        num_bearings=64, loop_radius=10.0, imu_rate=20.0, vertical_sonar=True,
        seafloor_depth=4.0, vertical_aperture_deg=60.0))
    v = np.asarray(bag.vertical_images, np.float32)
    tau = threshold_factor_soca(40, 0.1)
    det = np.stack([np.asarray(cfar_soca2(jnp.asarray(im), 20, 5, tau)[0]
                               & (jnp.asarray(im) > 65.0)) for im in v])
    F = v.shape[0]
    rng = np.random.default_rng(0)
    pts = rng.uniform([0.5, -12.0], [30.0, 12.0], size=(F, 80, 2)).astype(np.float32)
    pts[:, :20, 1] *= 0.02  # a share of the points in the vertical fan's strip
    mask = rng.uniform(size=(F, 80)) < 0.8
    poses = np.stack([np.linspace(0, 6, F), np.linspace(0, 2, F),
                      np.linspace(0, 1.0, F)], -1).astype(np.float32)
    jg = bag.vertical_geometry
    tg = SonarGeometry(num_ranges=jg.num_ranges, num_bearings=jg.num_bearings,
                       range_resolution=jg.range_resolution,
                       bearings=jg.bearings, model=jg.model,
                       vertical_aperture=jg.vertical_aperture)
    assert det.sum() > 100
    return v, det, pts, mask, poses, jg, tg


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_vertical_cell_xz(frames):
    *_, jg, tg = frames
    np.testing.assert_array_equal(td.vertical_cell_xz(tg, "cpu").numpy(),
                                  np.asarray(jd.vertical_cell_xz(jg)))


@pytest.mark.parametrize("num_bins,min_count", [(64, 2), (40, 1)])
def test_elevation_profile_and_fuse(frames, num_bins, min_count):
    v, det, pts, mask, poses, jg, tg = frames
    tz, tok = td.elevation_profile(_t(det), tg, num_bins, jg.max_range, min_count)
    for f in range(det.shape[0]):
        jz, jok = jd.elevation_profile(jnp.asarray(det[f]), jg, num_bins,
                                       jg.max_range, min_count)
        np.testing.assert_array_equal(tok[f].numpy(), np.asarray(jok))
        np.testing.assert_allclose(tz[f].numpy(), np.asarray(jz), atol=ATOL)
        jp, jm = jd.fuse_vertical(jnp.asarray(pts[f]), jnp.asarray(mask[f]),
                                  jz, jok, jg.max_range)
        tp, tm = td.fuse_vertical(_t(pts[f]), _t(mask[f]), tz[f], tok[f],
                                  jg.max_range)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tok.any()


def test_fuse_frames(frames):
    v, det, pts, mask, poses, jg, tg = frames
    jp, jm = jd.fuse_frames(jnp.asarray(pts), jnp.asarray(mask),
                            jnp.asarray(det), jg)
    tp, tm = td.fuse_frames(_t(pts), _t(mask), _t(det), tg)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (np.asarray(jp)[..., 2] != 0).any()


def test_beam_floor_samples(frames):
    v, det, pts, mask, poses, jg, tg = frames
    txz, tw = td.beam_floor_samples(_t(v), _t(det), tg)
    for f in range(v.shape[0]):
        jxz, jw = jd.beam_floor_samples(jnp.asarray(v[f]), jnp.asarray(det[f]), jg)
        np.testing.assert_array_equal(tw[f].numpy(), np.asarray(jw))
        np.testing.assert_allclose(txz[f].numpy(), np.asarray(jxz), atol=ATOL)
    assert (tw > 0).sum() > v.shape[0]


def _spec(mod):
    return mod.ElevationSpec(x0=-20.0, y0=-15.0, resolution=0.5, nx=70, ny=60)


def test_accumulate_and_lift(frames):
    rng = np.random.default_rng(1)
    xy = rng.uniform(-25, 25, size=(3000, 2)).astype(np.float32)
    xy[:500] = np.round(xy[:500])  # samples on cell borders
    z = rng.normal(4.0, 0.5, size=3000).astype(np.float32)
    w = rng.uniform(0, 200, size=3000).astype(np.float32)
    w[rng.uniform(size=3000) < 0.3] = 0.0
    jgrid = jd.accumulate_elevation(jnp.asarray(xy), jnp.asarray(z),
                                    jnp.asarray(w), _spec(jd))
    tgrid = td.accumulate_elevation(_t(xy), _t(z), _t(w), _spec(td))
    np.testing.assert_allclose(tgrid.w.numpy(), np.asarray(jgrid.w), rtol=1e-5)
    np.testing.assert_allclose(tgrid.z.numpy(), np.asarray(jgrid.z), rtol=1e-5,
                               atol=1e-5)
    q = rng.uniform(-25, 25, size=(2000, 2)).astype(np.float32)
    jz, jok = jd.lift_from_grid(jnp.asarray(q), jgrid, _spec(jd))
    tz, tok = td.lift_from_grid(_t(q), tgrid, _spec(td))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-5)
    assert 0.2 < tok.float().mean() < 1.0


def test_fuse_frames_global(frames):
    v, det, pts, mask, poses, jg, tg = frames
    spec = dict(x0=-30.0, y0=-30.0, resolution=0.5, nx=120, ny=120)
    j = jd.fuse_frames_global(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(v),
                              jnp.asarray(det), jnp.asarray(poses), jg,
                              jd.ElevationSpec(**spec))
    t = td.fuse_frames_global(_t(pts), _t(mask), _t(v), _t(det), _t(poses), tg,
                              td.ElevationSpec(**spec))
    for name, a, b in zip(("points3d", "mask", "floor3d", "floor_w"), t[:4], j[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   err_msg=name)
    np.testing.assert_allclose(t[4].w.numpy(), np.asarray(j[4].w), rtol=1e-5)
    np.testing.assert_allclose(t[4].z.numpy(), np.asarray(j[4].z), rtol=1e-5,
                               atol=1e-5)
    assert (np.asarray(j[0])[..., 2] != 0).sum() > 10
