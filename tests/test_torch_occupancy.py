"""The rest of mapping: the port against the JAX package.

The cases of ``tests/test_mapping.py`` (lines 63-200) on the port, each also
held to the JAX package's result on the same inputs:

* ``add_keyframe``'s grid within 1e-6 of the JAX grid (the submap's
  inflation is a convolution whose sums run in another order: within 1e-6
  of the JAX log-odds), the world cells equal (both divide exactly, as XLA
  does op by op), so the int8 exports are equal;
* a grid built up keyframe by keyframe against a full repaint: within 1e-4
  on the wall case, as in the JAX package (the repaint divides by the
  reciprocal, as XLA does under ``jit``, so a cell on a rounding boundary
  can move in both packages alike; ``test_incremental_cells_match_jax``);
* method 2, the intensity grid, the service with a frame subset and a
  coarser resolution, ``grow`` and ``save_submaps``: equal to the JAX
  results.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.mapping as jmap
from sonar_slam_tpu.slam.sonar import SonarGeometry as JGeometry
from sonar_slam_torch.mapping import (
    MappingConfig,
    SubmapModel,
    add_keyframe,
    get_occupancy_map,
    grow,
    intensity_grid,
    mapping_init,
    occupancy_grid_method1,
    occupancy_grid_method2,
    render_global_logodds,
    save_submaps,
    submap_intensity,
    update_poses,
)
from sonar_slam_torch.slam.sonar import SonarGeometry

torch.set_num_threads(1)
CFG = MappingConfig(x0=-40.0, y0=-40.0, width=80.0, height=80.0,
                    resolution=0.5, outlier_filter_min_points=1, max_keyframes=8)
JCFG = jmap.MappingConfig(**dataclasses.asdict(CFG))
GEOM = SonarGeometry.make(num_ranges=128, num_bearings=64, max_range=20.0)
JGEOM = JGeometry.make(num_ranges=128, num_bearings=64, max_range=20.0)
R0 = int(round((0.0 - CFG.y0) / CFG.resolution))


def col(x):
    return int(round((x - CFG.x0) / CFG.resolution))


@pytest.fixture(scope="module")
def models():
    return SubmapModel(CFG, GEOM, "cpu"), jmap.SubmapModel(JCFG, JGEOM)


def wall_points(x=10.0, n=40, cap=64):
    ys = np.linspace(-4, 4, n)
    pts = np.zeros((cap, 2), np.float32)
    pts[:n] = np.stack([np.full(n, x), ys], -1)
    m = np.zeros(cap, bool)
    m[:n] = True
    return pts, m


def both(poses, model, jmodel, pts=None, m=None):
    """The same keyframes added in both packages: (port state, JAX state)."""
    if pts is None:
        pts, m = wall_points()
    st, jst = mapping_init(CFG, model), jmap.mapping_init(JCFG, jmodel)
    for k, p in enumerate(poses):
        p = np.asarray(p, np.float32)
        st = add_keyframe(st, k, p, torch.as_tensor(pts), torch.as_tensor(m),
                          model)
        jst = jmap.add_keyframe(jst, k, jnp.asarray(p), jnp.asarray(pts),
                                jnp.asarray(m), jmodel)
    return st, jst


def close_to_jax(st, jst, atol=1e-6):
    np.testing.assert_allclose(st.kf_logodds.numpy(), np.asarray(jst.kf_logodds),
                               atol=atol)
    np.testing.assert_array_equal(st.kf_poses.numpy(), np.asarray(jst.kf_poses))
    np.testing.assert_array_equal(st.kf_valid.numpy(), np.asarray(jst.kf_valid))
    assert st.num_kf == int(jst.num_kf)
    np.testing.assert_allclose(st.grid.numpy(), np.asarray(jst.grid), atol=atol)


def test_add_keyframe_updates_grid(models):
    model, jmodel = models
    st, jst = both([np.zeros(3)], model, jmodel)
    grid = st.grid.numpy()
    c = col(10.0)
    assert grid[R0, c - 1:c + 2].max() > 0.2
    c_free = col(5.0)
    assert grid[R0, c_free] < 0
    occ = occupancy_grid_method1(st, model).numpy()
    assert occ[R0, c - 1:c + 2].max() > 50
    assert occ[R0, c_free] < 50
    close_to_jax(st, jst)
    np.testing.assert_array_equal(occ, np.asarray(jmap.occupancy_grid_method1(
        jst, jmodel)))


def test_incremental_matches_full_render(models):
    model, jmodel = models
    poses = [[0.0, 0.0, 0.0], [2.0, 1.0, 0.3], [4.0, 2.0, 0.6]]
    st, jst = both(poses, model, jmodel)
    full = render_global_logodds(st, model).numpy()
    np.testing.assert_allclose(st.grid.numpy(), full, atol=1e-4)
    close_to_jax(st, jst)
    np.testing.assert_allclose(
        full, np.asarray(jmap.render_global_logodds(jst, jmodel)), atol=1e-6)


def test_incremental_cells_match_jax(models):
    """Random poses and clouds: the incremental grid's cells equal the JAX
    package's (a cell differs by a whole log-odds value if a point lands on
    the other side of a rounding boundary), and where the JAX package's own
    incremental and full grids part, the port's part the same way."""
    model, jmodel = models
    rng = np.random.default_rng(5)
    pts = rng.uniform(-15, 15, (64, 2)).astype(np.float32)
    pts[:, 0] = np.abs(pts[:, 0]) + 2.0
    m = rng.random(64) < 0.8
    poses = np.concatenate([rng.uniform(-5, 5, (8, 2)),
                            rng.uniform(-np.pi, np.pi, (8, 1))], 1)
    st, jst = both(poses.astype(np.float32), model, jmodel, pts, m)
    close_to_jax(st, jst)
    full, jfull = (render_global_logodds(st, model).numpy(),
                   np.asarray(jmap.render_global_logodds(jst, jmodel)))
    np.testing.assert_allclose(full, jfull, atol=1e-6)
    np.testing.assert_array_equal(np.abs(st.grid.numpy() - full) > 1e-3,
                                  np.abs(np.asarray(jst.grid) - jfull) > 1e-3)


def test_update_poses_repaints(models):
    model, jmodel = models
    st, jst = both([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], model, jmodel)
    new = np.asarray([[0.0, 0.0, 0.0], [4.0, 0.0, 0.0]] + [[0, 0, 0]] * 6,
                     np.float32)
    st2 = update_poses(st, torch.as_tensor(new), model)
    c_new = col(14.0)
    assert st2.grid.numpy()[R0, c_new - 1:c_new + 2].max() > 0.2
    close_to_jax(st2, jmap.update_poses(jst, jnp.asarray(new), jmodel))
    small = np.asarray([[0.1, 0.0, 0.0], [1.05, 0.0, 0.0]] + [[0, 0, 0]] * 6,
                       np.float32)
    st3 = update_poses(st, small, model)
    np.testing.assert_allclose(st3.grid.numpy(), st.grid.numpy(), atol=1e-4)
    close_to_jax(st3, jmap.update_poses(jst, jnp.asarray(small), jmodel))


def test_occupancy_method2(models):
    model, jmodel = models
    st, jst = both([np.zeros(3)], model, jmodel)
    pts, m = wall_points()
    occ = occupancy_grid_method2(st, model, torch.as_tensor(pts),
                                 torch.as_tensor(m)).numpy()
    assert occ[R0, col(10.0)] == 100
    assert occ[R0, col(5.0)] == 0
    assert occ[2, 2] == -1
    np.testing.assert_array_equal(occ, np.asarray(jmap.occupancy_grid_method2(
        jst, jmodel, jnp.asarray(pts), jnp.asarray(m))))


def test_grow(models):
    model, jmodel = models
    st, jst = both([np.zeros(3)], model, jmodel)
    new_cfg, new_st = grow(CFG, st, pad_m=10.0)
    assert new_cfg.rows == CFG.rows + 2 * 20
    assert new_cfg.x0 == CFG.x0 - 10.0
    c = col(10.0)
    np.testing.assert_allclose(st.grid.numpy()[R0, c],
                               new_st.grid.numpy()[R0 + 20, c + 20])
    jcfg, jnew = jmap.grow(JCFG, jst, pad_m=10.0)
    assert dataclasses.asdict(new_cfg) == dataclasses.asdict(jcfg)
    np.testing.assert_allclose(new_st.grid.numpy(), np.asarray(jnew.grid),
                               atol=1e-6)


def test_intensity_grid(models):
    model, jmodel = models
    st, jst = both([np.zeros(3)], model, jmodel)
    img = np.full((GEOM.num_ranges, GEOM.num_bearings), 128.0, np.float32)
    inten = submap_intensity(torch.as_tensor(img), model)
    kf_int = torch.zeros((CFG.max_keyframes, inten.shape[0]))
    kf_int[0] = inten
    grid = intensity_grid(st, model, kf_int).numpy()
    assert grid[R0, col(10.0)] == 50
    assert grid[2, 2] == -1
    # speckled pings over several keyframes, against the JAX grid
    rng = np.random.default_rng(1)
    poses = [[0.0, 0.0, 0.0], [1.0, 0.5, 0.2], [2.0, -0.5, -0.3]]
    st, jst = both(poses, model, jmodel)
    imgs = rng.exponential(40.0, (3, GEOM.num_ranges, GEOM.num_bearings)).astype(
        np.float32)
    kf_int = torch.zeros((CFG.max_keyframes, inten.shape[0]))
    jkf = np.zeros((CFG.max_keyframes, inten.shape[0]), np.float32)
    for k in range(3):
        kf_int[k] = submap_intensity(torch.as_tensor(imgs[k]), model)
        jkf[k] = np.asarray(jmap.submap_intensity(jnp.asarray(imgs[k]), jmodel))
    np.testing.assert_array_equal(kf_int.numpy(), jkf)
    np.testing.assert_array_equal(
        intensity_grid(st, model, kf_int).numpy(),
        np.asarray(jmap.intensity_grid(jst, jmodel, jnp.asarray(jkf))))


def test_get_occupancy_map_service(models):
    model, jmodel = models
    st, jst = both([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0]], model, jmodel)
    frames = np.asarray([True] + [False] * (CFG.max_keyframes - 1))
    occ, res = get_occupancy_map(st, model, frames=torch.as_tensor(frames))
    assert res == CFG.resolution
    c0, c1 = col(10.0), col(13.0)
    assert occ.numpy()[R0, c0 - 1:c0 + 2].max() > 50
    assert occ.numpy()[R0, c1 - 1:c1 + 2].max() <= 50
    jocc, _ = jmap.get_occupancy_map(jst, jmodel, frames=jnp.asarray(frames))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    for r in (1.0, 0.7):
        occ2, res2 = get_occupancy_map(st, model, resolution=r)
        assert res2 == r
        jocc2, _ = jmap.get_occupancy_map(jst, jmodel, resolution=r)
        np.testing.assert_array_equal(occ2.numpy(), np.asarray(jocc2))
    assert get_occupancy_map(st, model, resolution=1.0)[0].shape[0] == CFG.rows // 2
    pts, m = wall_points()
    occ3, _ = get_occupancy_map(st, model, method=2, points=torch.as_tensor(pts),
                                pmask=torch.as_tensor(m), resolution=1.0)
    jocc3, _ = jmap.get_occupancy_map(jst, jmodel, method=2, points=jnp.asarray(pts),
                                      pmask=jnp.asarray(m), resolution=1.0)
    np.testing.assert_array_equal(occ3.numpy(), np.asarray(jocc3))


def test_save_submaps_roundtrip(models, tmp_path):
    model, jmodel = models
    st, jst = both([[0.0, 0.0, 0.0], [3.0, 1.0, 0.1]], model, jmodel)
    path = str(tmp_path / "step-1-submaps.npz")
    save_submaps(path, CFG, st, model)
    d = np.load(path)
    assert d["poses"].shape == (2, 3)
    np.testing.assert_allclose(d["poses"][1], [3.0, 1.0, 0.1], atol=1e-6)
    assert d["logodds"].shape == (2, model.sonar_xy.shape[0])
    np.testing.assert_allclose(d["logodds"][0], st.kf_logodds[0].numpy())
    assert d["cell_xy"].shape == (model.sonar_xy.shape[0], 2)
    np.testing.assert_allclose(
        d["map_size"], [CFG.x0, CFG.y0, CFG.width, CFG.height, CFG.resolution])
    jpath = str(tmp_path / "jax-submaps.npz")
    jmap.save_submaps(jpath, JCFG, jst, jmodel)
    j = np.load(jpath)
    assert sorted(j.files) == sorted(d.files)
    for k in ("poses", "cell_xy", "map_size"):
        np.testing.assert_array_equal(d[k], j[k])
    np.testing.assert_allclose(d["logodds"], j["logodds"], atol=1e-6)
