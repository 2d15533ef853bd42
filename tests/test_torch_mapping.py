"""Occupancy mapping and the map metrics: the port against the JAX package.

Inputs: a short simulated survey, the JAX package's feature clouds of a few
pings and the true poses at those pings, through bench.py's mapping stage
(every submap, the full repaint, the method-1 export) in both packages.

* Submap log-odds within 1e-5: the Gaussian inflation is a convolution whose
  sums run in another order (XLA's convolution against PyTorch's).
* The dedup and the int8 occupancy grid are equal: the port multiplies by
  the float32 reciprocal of each constant divisor, as XLA on the CPU
  evaluates the JAX version's divisions, and adds the repaint in input
  order, as XLA's scatter-add does. The world-cell ids are equal but at
  points on a rounding boundary (see ``test_world_cells_and_dedup``).
* ``map_metrics`` on the two grids is equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.io.simulate as jsim
import sonar_slam_tpu.mapping as jmap
import sonar_slam_tpu.mapping.occupancy as jocc
import sonar_slam_tpu.slam.frontend as jfe
import sonar_slam_torch.mapping as tmap
import sonar_slam_torch.mapping.occupancy as tocc
import sonar_slam_torch.slam.sonar as tsonar

torch.set_num_threads(1)
K = 8


@pytest.fixture(scope="module")
def survey():
    bag = jsim.simulate_bag(jsim.SimConfig(
        duration=24.0, speed=0.5, sonar_rate=1.0, num_ranges=192,
        num_bearings=96, loop_radius=10.0, imu_rate=20.0, seed=2))
    sel = np.arange(2, 2 + 3 * K, 3)
    fx = jfe.FeatureExtractor(jfe.FeatureConfig(max_points=128), bag.geometry,
                              use_pallas="never")
    pts, masks = (np.asarray(a) for a in fx.extract_batch(
        jnp.asarray(bag.ping_images[sel])))
    poses = bag.true_pose_at_ping[sel].astype(np.float32)
    geom = bag.geometry
    tgeom = tsonar.SonarGeometry.make(num_ranges=geom.num_ranges,
                                      num_bearings=geom.num_bearings,
                                      max_range=geom.max_range)
    cfg = dataclasses.replace(jmap.MappingConfig(), max_keyframes=K)
    tcfg = dataclasses.replace(tmap.MappingConfig(), max_keyframes=K)
    return dict(bag=bag, pts=pts, masks=masks, poses=poses,
                jmodel=jmap.SubmapModel(cfg, geom),
                tmodel=tmap.SubmapModel(tcfg, tgeom, "cpu"), cfg=cfg, tcfg=tcfg)


def _jax_stage(s, valid):
    m = s["jmodel"]
    lo = jax.vmap(lambda p, k: jmap.build_submap_logodds(p, k, m))(
        jnp.asarray(s["pts"]), jnp.asarray(s["masks"]))
    st = jmap.mapping_init(s["cfg"], m)._replace(
        kf_logodds=lo, kf_poses=jnp.asarray(s["poses"]),
        kf_valid=jnp.asarray(valid), num_kf=jnp.asarray(int(valid.sum())))
    grid = jmap.render_global_logodds(st, m)
    occ = jmap.occupancy_grid_method1(st._replace(grid=grid), m)
    return np.asarray(lo), np.asarray(grid), np.asarray(occ)


def _port_stage(s, valid):
    m = s["tmodel"]
    lo = tmap.build_submap_logodds(torch.as_tensor(s["pts"]),
                                   torch.as_tensor(s["masks"]), m)
    st = tmap.mapping_init(s["tcfg"], m)._replace(
        kf_logodds=lo, kf_poses=torch.as_tensor(s["poses"]),
        kf_valid=torch.as_tensor(valid), num_kf=int(valid.sum()))
    grid = tmap.render_global_logodds(st, m)
    occ = tmap.occupancy_grid_method1(st._replace(grid=grid), m)
    return lo.numpy(), grid.numpy(), occ.numpy()


def test_submap_model_tables(survey):
    j, t = survey["jmodel"], survey["tmodel"]
    assert (j.r_skip, j.c_skip, j.shape, j.hr, j.hc) == (
        t.r_skip, t.c_skip, t.shape, t.hr, t.hc)
    np.testing.assert_array_equal(t.sonar_xy.numpy(), np.asarray(j.sonar_xy))
    np.testing.assert_array_equal(t.kernel_r.numpy(), np.asarray(j.kernel_r))
    assert t.peak == j.peak


@pytest.mark.parametrize("filter_outliers", [True, False])
def test_submap_logodds(survey, filter_outliers):
    jm, tm = survey["jmodel"], survey["tmodel"]
    j = np.asarray(jax.vmap(lambda p, k: jmap.build_submap_logodds(
        p, k, jm, filter_outliers))(jnp.asarray(survey["pts"]),
                                    jnp.asarray(survey["masks"])))
    t = tmap.build_submap_logodds(torch.as_tensor(survey["pts"]),
                                  torch.as_tensor(survey["masks"]), tm,
                                  filter_outliers).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)
    # hit, miss and unknown cells all occur
    assert (t > 0.5).any() and (t < -0.5).any() and (np.abs(t) < 1e-6).any()


def test_empty_frame_is_all_miss(survey):
    tm = survey["tmodel"]
    lo = tmap.build_submap_logodds(torch.zeros((2, 16, 2)),
                                   torch.zeros((2, 16), dtype=torch.bool), tm)
    np.testing.assert_allclose(lo.numpy(), np.log(0.3 / 0.7), atol=1e-6)


def test_world_cells_and_dedup(survey):
    """Cell ids equal to the JAX package's, but at polar cells whose world
    coordinate lies on a rounding boundary (within 1e-3 of a cell of x.5):
    XLA fuses the transform with the cell arithmetic and rounds such a
    point either way (measured: 2 of 147,456 here)."""
    jm, tm = survey["jmodel"], survey["tmodel"]
    poses = survey["poses"]
    valid = np.arange(K) % 3 != 1
    tr, tc, tin = tocc._world_cells(tm, torch.as_tensor(poses))
    tu, tv = (a.numpy() for a in tocc._world_coords(tm, torch.as_tensor(poses)))
    tkeep = tocc._dedup_first(tr * tm.config.cols + tc,
                              tin & torch.as_tensor(valid)[:, None]).numpy()
    mismatched = 0
    for k in range(K):
        jr, jc, jin = (np.asarray(a) for a in jocc._world_cells(
            jm, jnp.asarray(poses[k])))
        for port, ref, coord in ((tr[k].numpy(), jr, tu[k]),
                                 (tc[k].numpy(), jc, tv[k])):
            off = port != ref
            assert (np.abs(port - ref)[off] == 1).all()
            assert (np.abs(np.abs(coord - np.floor(coord)) - 0.5)[off]
                    < 1e-3).all()
            mismatched += int(off.sum())
        # the dedup on the JAX package's own ids
        jkeep = np.asarray(jocc._dedup_first(
            jnp.asarray(jr * jm.config.cols + jc), jnp.asarray(jin & valid[k])))
        tk = tocc._dedup_first(torch.as_tensor(jr * jm.config.cols + jc)[None],
                               torch.as_tensor(jin & valid[k])[None])[0]
        np.testing.assert_array_equal(tk.numpy(), jkeep)
        if valid[k]:
            assert 0 < tkeep[k].sum() < tin[k].sum()
    assert mismatched <= 1e-4 * tr.numel()


@pytest.mark.parametrize("drop", [False, True])
def test_mapping_stage_matches_jax(survey, drop):
    valid = np.ones(K, bool)
    if drop:
        valid[[1, 5]] = False
    jlo, jgrid, jocc_ = _jax_stage(survey, valid)
    tlo, tgrid, tocc_ = _port_stage(survey, valid)
    np.testing.assert_allclose(tlo, jlo, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tgrid, jgrid, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tocc_, jocc_)
    assert tocc_.dtype == np.int8 and (tocc_ > 55).sum() > 100


def test_map_metrics_match(survey):
    valid = np.ones(K, bool)
    _, _, jo = _jax_stage(survey, valid)
    _, _, to = _port_stage(survey, valid)
    bag, poses = survey["bag"], survey["poses"]
    est = poses + np.float32([0.3, -0.2, 0.01])  # a shifted estimate
    kw = dict(max_range=bag.geometry.max_range,
              half_aperture=float(bag.geometry.bearings[-1]))
    jm = jmap.map_metrics(jo, survey["cfg"], bag.world_points, poses, est, **kw)
    tm = tmap.map_metrics(to, survey["tcfg"], bag.world_points, poses, est, **kw)
    assert tm == jm
    assert tm["precision"] > 0.5 and tm["recall"] > 0.1
