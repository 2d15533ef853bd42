"""bench.py's dual-sonar lane (bench.py:792-953) and its JAX golden file.

tests/golden/dual_lane.npz holds the JAX package's ``replay(use_vertical=True,
refine_params=RefineParams.default())`` of the lane's configuration
(``dual_lane_config``, bench.py:818-860: a 90 s survey at 1 Hz, 192 x 96
horizontal and 192 x 48 vertical pings, 32 keyframe slots, refinement on),
which chip_smoke.py holds the card to: the keyframe pings, the loop count,
the trajectory, the vertical detection masks of the 32 keyframe slots
(packed bits), the fusion stage's inputs (clouds, masks, poses) and outputs
(fused clouds, floor samples, elevation grid) and the lane's ``dual_sonar``
numbers as bench.py computes them.

* ``test_golden_matches_jax`` recomputes the file with the JAX package.
* ``test_port_fusion_on_golden_inputs``: the port's ``fuse_frames_global``
  on the golden's inputs gives its outputs within 2e-5 (measured 1e-6).
  chip_smoke.py makes the same check on the card.
* ``test_port_scores_golden_like_bench``: the port's ``dual_sonar_metrics``
  on the JAX result gives the golden's numbers, which the JAX package's
  functions compute as bench.py does (``bench_dual_metrics``). bench.py's own
  CPU lane (``python bench.py --cpu --small``) printed the same 0.0409 m,
  938 points and 520 cells.
* ``test_port_lane_on_cpu``: the port's whole lane on the CPU gives the
  JAX keyframes and loop count, and a z RMSE within 5e-3 m of the JAX
  result's.

Regenerate the golden file with ``python tests/test_torch_dual_lane.py``.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.io.simulate as jsim
import sonar_slam_tpu.pipeline as jpipe
import sonar_slam_tpu.slam.core as jcore
from sonar_slam_tpu.cloud import ICPConfig as JICP
from sonar_slam_tpu.kernels.cfar import cfar_soca2
from sonar_slam_tpu.kernels.cfar_factors import threshold_factor_soca
from sonar_slam_tpu.slam.frontend import FeatureConfig as JFC
from sonar_slam_tpu.slam.refine import RefineParams as JRP

import sonar_slam_torch.io.simulate as tsim
import sonar_slam_torch.pipeline as tpipe
import sonar_slam_torch.slam.dual_sonar as td
from sonar_slam_torch.convert import (
    dims_from_reference,
    feature_config_from_reference,
    params_from_reference,
    refine_params_from_reference,
)

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "dual_lane.npz")
DUAL_SIM = dict(duration=90.0, speed=0.5, sonar_rate=1.0, num_ranges=192,
                num_bearings=96, loop_radius=10.0, imu_rate=20.0,
                vertical_sonar=True, seed=0)
Z_RMSE_BAND_M = 5e-3


def dual_lane_config():
    """bench.py's dual lane in the JAX package's types (bench.py:818-844):
    (SimConfig, SlamDims, SlamParams, FeatureConfig)."""
    icp = JICP(max_iterations=12, min_diff_rot=1e-3, min_diff_trans=1e-2,
               point_to_line=True, outlier_max_dist=0.5)
    dims = jcore.SlamDims(
        max_keyframes=32, max_points=128, target_capacity=512,
        nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=128, max_loops=32,
        gn_iters=3, icp=icp, nssm_target_window=2, nssm_pair_refine=True,
        pair_refine_max_dt=0.35, pair_refine_max_dr=0.07,
        pair_refine_min_inliers=25, refine_iters=2, refine_sweep=True,
        refine_chain=True)
    params = jcore.SlamParams.default(dims)._replace(
        keyframe_translation=jnp.float32(2.0),
        ssm_min_points=jnp.asarray(20, jnp.int32),
        nssm_min_points=jnp.asarray(20, jnp.int32),
        fuse_odometry=jnp.asarray(True),
        use_best_start_tf=jnp.asarray(True),
        odom_sigmas=jnp.asarray([0.05, 0.05, 0.01], jnp.float32),
        icp_odom_sigmas=jnp.asarray([0.3, 0.3, 0.03], jnp.float32))
    return jsim.SimConfig(**DUAL_SIM), dims, params, JFC(max_points=128)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_dual_lane() -> dict:
    sim, dims, params, fc = dual_lane_config()
    bag = jsim.simulate_bag(sim)
    res = jpipe.replay(bag, fc, params, dims, use_vertical=True,
                       refine_params=JRP.default())
    K = dims.max_keyframes
    kf = res.keyframe_ping_idx
    sel = np.concatenate([kf, np.zeros(K - len(kf), np.int64)])
    tau = threshold_factor_soca(fc.ntc, fc.pfa)
    vdet = np.stack([
        np.asarray(cfar_soca2(jnp.asarray(im), fc.ntc // 2, fc.ngc // 2, tau)[0]
                   & (jnp.asarray(im) > fc.threshold))
        for im in np.asarray(bag.vertical_images[sel], np.float32)])
    c = res.carry
    out = dict(
        keyframe_ping_idx=kf, num_loops=np.int64(c.num_loops),
        trajectory=res.trajectory, vdet_bits=np.packbits(vdet),
        vdet_shape=np.asarray(vdet.shape), points=np.asarray(c.points),
        pmasks=np.asarray(c.pmasks), poses=np.asarray(c.poses),
        points3d=res.points3d, points3d_mask=res.points3d_mask,
        floor_points3d=res.floor_points3d, floor_weights=res.floor_weights,
        elevation_z=res.elevation_z, elevation_w=res.elevation_w,
        elevation_spec=np.asarray(res.elevation_spec, np.float64))
    out.update({k: np.asarray(v) for k, v in bench_dual_metrics(res, bag, sim).items()})
    return out


def bench_dual_metrics(res, bag, sim) -> dict:
    """bench.py's ``dual_sonar`` accuracy keys (bench.py:917-949) with the
    JAX package's functions, unrounded."""
    from sonar_slam_tpu.geometry import se2_transform_points
    from sonar_slam_tpu.mapping.metrics import _umeyama_se2

    nk = res.num_keyframes
    truth = bag.true_pose_at_ping[res.keyframe_ping_idx[:nk]]
    align = _umeyama_se2(np.asarray(res.carry.poses[:nk, :2]), truth[:, :2])
    poses = np.asarray(res.carry.poses)
    pts3, p3mask = res.points3d, res.points3d_mask
    floor3, floor_w = res.floor_points3d, res.floor_weights
    zerrs = []
    for k in range(nk):
        pose_k = jnp.asarray(poses[k])
        m = p3mask[k] & (np.abs(pts3[k][:, 2]) > 0.1)
        if m.any():
            g = np.asarray(se2_transform_points(jnp.asarray(pts3[k][m, :2]), pose_k))
            zerrs.append(pts3[k][m, 2] - jsim.seafloor_z(sim, *align(g).T))
        fm = floor_w[k] > 0
        if fm.any():
            g = np.asarray(se2_transform_points(jnp.asarray(floor3[k][fm, :2]), pose_k))
            zerrs.append(floor3[k][fm, 2] - jsim.seafloor_z(sim, *align(g).T))
    zerr = np.concatenate(zerrs) if zerrs else np.full(1, np.inf)
    return {"z_rmse_m": float(np.sqrt(np.mean(zerr**2))),
            "z_points": int(sum(len(z) for z in zerrs)),
            "elevation_cells": int((np.asarray(res.elevation_w) > 0).sum())}


def golden_vdet(ref):
    shape = tuple(ref["vdet_shape"])
    return np.unpackbits(ref["vdet_bits"])[: int(np.prod(shape))].reshape(
        shape).astype(bool)


def golden_spec(ref):
    x0, y0, res, nx, ny = ref["elevation_spec"]
    return td.ElevationSpec(x0=float(x0), y0=float(y0), resolution=float(res),
                            nx=int(nx), ny=int(ny))


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_golden_matches_jax(golden):
    """Indices, counts and masks exactly; floats to the JAX CPU run's own
    float32 rounding (the trajectory as tests/test_torch_slam.py holds its
    golden)."""
    new = jax_dual_lane()
    assert sorted(golden.files) == sorted(new)
    for name, v in new.items():
        ref = golden[name]
        if name in ("trajectory", "poses"):
            np.testing.assert_allclose(v, ref, atol=5e-4, err_msg=name)
        elif name in ("z_points", "elevation_cells"):
            assert abs(int(v) - int(ref)) <= 2, name
        elif name == "z_rmse_m":
            assert abs(float(v) - float(ref)) <= 1e-4
        elif v.dtype.kind == "f":
            np.testing.assert_allclose(v, ref, rtol=1e-4, atol=1e-3, err_msg=name)
        else:
            np.testing.assert_array_equal(v, ref, err_msg=name)


def test_port_fusion_on_golden_inputs(golden):
    sim, dims, _, _ = dual_lane_config()
    bag = tsim.simulate_bag(tsim.SimConfig(**DUAL_SIM))
    kf = golden["keyframe_ping_idx"]
    sel = np.concatenate([kf, np.zeros(dims.max_keyframes - len(kf), np.int64)])
    out = td.fuse_frames_global(
        torch.as_tensor(golden["points"]), torch.as_tensor(golden["pmasks"]),
        torch.as_tensor(bag.vertical_images[sel], dtype=torch.float32),
        torch.as_tensor(golden_vdet(golden)), torch.as_tensor(golden["poses"]),
        bag.vertical_geometry, golden_spec(golden))
    got = (*out[:4], out[4].z, out[4].w)
    names = ("points3d", "points3d_mask", "floor_points3d", "floor_weights",
             "elevation_z", "elevation_w")
    for name, a in zip(names, got):
        np.testing.assert_allclose(a.numpy(), golden[name], rtol=1e-5,
                                   atol=2e-5, err_msg=name)


def test_port_scores_golden_like_bench(golden):
    sim = tsim.SimConfig(**DUAL_SIM)
    bag = tsim.simulate_bag(sim)
    res = tpipe.ReplayResult(
        trajectory=golden["trajectory"], covs=None, dr_trajectory=None,
        keyframe_times=None, keyframe_ping_idx=golden["keyframe_ping_idx"],
        num_keyframes=len(golden["trajectory"]), outputs=None, carry=None,
        dr_poses_at_ticks=None, dense_trajectory=None, stage_s={},
        points3d=golden["points3d"], points3d_mask=golden["points3d_mask"],
        floor_points3d=golden["floor_points3d"],
        floor_weights=golden["floor_weights"],
        elevation_w=golden["elevation_w"])
    m = tpipe.dual_sonar_metrics(res, bag, sim)
    assert m["z_points"] == int(golden["z_points"]) > 500
    assert m["elevation_cells"] == int(golden["elevation_cells"])
    assert m["z_rmse_m"] == pytest.approx(float(golden["z_rmse_m"]), abs=1e-7)


def test_port_lane_on_cpu(golden):
    jsim_cfg, jdims, jparams, jfc = dual_lane_config()
    sim = tsim.SimConfig(**DUAL_SIM)
    bag = tsim.simulate_bag(sim)
    res = tpipe.replay(
        bag, feature_config_from_reference(jfc),
        params_from_reference(_np(jparams), "cpu"), dims_from_reference(jdims),
        "cpu", use_vertical=True,
        refine_params=refine_params_from_reference(_np(JRP.default()), "cpu"))
    np.testing.assert_array_equal(res.keyframe_ping_idx, golden["keyframe_ping_idx"])
    assert res.carry.num_loops == int(golden["num_loops"])
    m = tpipe.dual_sonar_metrics(res, bag, sim)
    assert abs(m["z_rmse_m"] - float(golden["z_rmse_m"])) <= Z_RMSE_BAND_M
    assert m["z_points"] > 500


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(GOLDEN, **jax_dual_lane())
    print("wrote", GOLDEN)
