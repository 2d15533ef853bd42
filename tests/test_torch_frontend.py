"""Feature front end parity: FeatureExtractor, the static voxel binner with
its top-k tie order, sub-bin refinement, and the corroboration gate.

The JAX extractor runs its XLA path here (``use_pallas="never"``), whose
CFAR sums by prefix differences; the port adds rows one by one. On these
simulated pings no pixel lies within rounding of its threshold, so the
detections, the kept voxels and their counts are equal; the voxel
centroids agree to 1e-4 m (float32 sums over up to ~1000 cells in another
order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.io.simulate as jsim
import sonar_slam_tpu.slam.frontend as jfe
import sonar_slam_torch.slam.frontend as tfe
import sonar_slam_torch.slam.sonar as tsonar
from sonar_slam_torch.kernels.cfar_cuda import cfar_detect, cfar_os_plain

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pings():
    bag = jsim.simulate_bag(jsim.SimConfig(
        duration=12.0, speed=0.5, sonar_rate=1.0, num_ranges=128,
        num_bearings=64, loop_radius=8.0, imu_rate=20.0, seed=1))
    return bag.ping_images[3:8], bag.geometry


@pytest.mark.parametrize("cfg", [
    dict(max_points=96),
    dict(max_points=64, cfar_edge="strict", alg="GOCA", min_voxel_hits=2),
    dict(max_points=64, alg="OS", subbin=False),
    dict(max_points=96, alg="OS", rank=10),
])
def test_extract_batch_conf(pings, cfg):
    imgs, geom = pings
    tgeom = tsonar.SonarGeometry.make(num_ranges=geom.num_ranges,
                                      num_bearings=geom.num_bearings,
                                      max_range=geom.max_range)
    jx = jfe.FeatureExtractor(jfe.FeatureConfig(**cfg), geom, use_pallas="never")
    tx = tfe.FeatureExtractor(tfe.FeatureConfig(**cfg), tgeom, "cpu")
    tx.slice_frames = 2  # exercise the slicing
    jp, jm, jc = (np.asarray(a) for a in jx.extract_batch_conf(jnp.asarray(imgs)))
    tp, tm, tc = (a.numpy() for a in tx.extract_batch_conf(torch.as_tensor(imgs)))
    assert tx._binner.dropped_cells == jx._binner.dropped_cells
    np.testing.assert_array_equal(
        tx.detections(torch.as_tensor(imgs)).numpy(),
        np.stack([np.asarray(jx.detections(jnp.asarray(im))) for im in imgs]))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    assert tm.sum() > 20


def test_subbin_xy(pings):
    imgs, geom = pings
    tgeom = tsonar.SonarGeometry.make(num_ranges=geom.num_ranges,
                                      num_bearings=geom.num_bearings,
                                      max_range=geom.max_range)
    jx = jfe.FeatureExtractor(jfe.FeatureConfig(), geom, use_pallas="never")
    tx = tfe.FeatureExtractor(tfe.FeatureConfig(), tgeom, "cpu")
    j = np.asarray(jx._subbin_xy(jnp.asarray(imgs[0])))
    t = tx.subbin_xy(torch.as_tensor(imgs[:1]))[0].numpy()
    np.testing.assert_allclose(t, j, atol=2e-6)


@pytest.mark.parametrize("both", [False, True])
def test_corroborate(both):
    rng = np.random.default_rng(7)
    K, N = 3, 40
    pts = (8.0 * rng.normal(size=(K, N, 2))).astype(np.float32)
    masks = rng.uniform(size=(K, N)) < 0.9
    pose = rng.normal(scale=[2.0, 2.0, 0.5], size=(K, 3)).astype(np.float32)
    nbs = []
    for s in (0.05, -0.05):
        npose = pose + np.float32(s)
        c, sn = np.cos(-s), np.sin(-s)
        npts = (pts + 0.1 * rng.normal(size=pts.shape)).astype(np.float32)
        nbs.append((npts, rng.uniform(size=(K, N)) < 0.8, npose.astype(np.float32)))
    j = np.asarray(jfe.corroborate(
        jnp.asarray(pts), jnp.asarray(masks), jnp.asarray(pose),
        [tuple(jnp.asarray(a) for a in nb) for nb in nbs], 0.3, both))
    t = tfe.corroborate(
        torch.as_tensor(pts), torch.as_tensor(masks), torch.as_tensor(pose),
        [tuple(torch.as_tensor(a) for a in nb) for nb in nbs], 0.3, both).numpy()
    np.testing.assert_array_equal(t, j)
    assert 0 < t.sum() < masks.sum()


def test_os_on_cuda_is_not_ported(pings, monkeypatch):
    """OS now goes through ``cfar_detect`` like the sum variants (the entry
    point that launches the OS kernel on a CUDA tensor), with the rank and
    the fused gate, and the extractor no longer refuses it."""
    imgs, geom = pings
    tgeom = tsonar.SonarGeometry.make(num_ranges=geom.num_ranges,
                                      num_bearings=geom.num_bearings,
                                      max_range=geom.max_range)
    cfg = tfe.FeatureConfig(alg="OS", rank=10, threshold=65)
    tx = tfe.FeatureExtractor(cfg, tgeom, "cpu")
    calls = []

    def spy(*args, **kw):
        calls.append((args[4], kw["rank"], kw["intensity_threshold"]))
        return cfar_detect(*args, **kw)

    monkeypatch.setattr(tfe, "cfar_detect", spy)
    x = torch.as_tensor(imgs)
    det = tx.detections(x)
    assert calls == [("OS", 10, 65)]
    want, _ = cfar_os_plain(x, cfg.ntc // 2, cfg.ngc // 2, 10, tx.tau, 65,
                            cfg.cfar_edge)
    assert torch.equal(det, want) and bool(det.any())
