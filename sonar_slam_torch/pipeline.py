"""End-to-end offline replay of a sensor bag on one device.

Counterpart of ``sonar_slam_tpu/pipeline.py::replay``:

1. the odometry front end, on the device: dead reckoning over the
   synchronized ticks (``"dr"``, with the DVL basis integrals when the
   configuration asks for them), the same with the FOG yaw (``"dr_gyro"``),
   or the 12-state Kalman filter over the merged sensor events
   (``"kalman"``);
2. the keyframe gate (a host loop over the pings);
3. CFAR feature extraction of the keyframe pings, and with the temporal
   corroboration gate of both neighbours of each (three batched CFAR
   launches on a CUDA device);
4. ``slam_scan`` over the keyframes;
5. ``refine_loops`` when ``dims.refine_iters > 0``;
6. the dense trajectory: every ping's odometry delta composed onto its
   latest keyframe's optimized pose;
7. with ``use_vertical``, dual-sonar fusion: one strict-edge SOCA launch
   over the keyframes' vertical pings, then the global elevation grid and
   the lifted 3-D clouds (``slam/dual_sonar.py``).

Stages 1-2, 3, 4, 5 and 7 are the ``CodeTimer`` spans ``dr_gate``,
``features``, ``slam_scan``, ``refine`` and ``dual`` (the first four end in
a device sync), whose seconds fill ``ReplayResult.stage_s``.

``occupancy_map`` is bench.py's mapping stage on the result's carry, and
``loop_metrics`` / ``ate_rmse`` / ``ate_heading_deg`` / ``dual_sonar_metrics``
score a replay against the simulator's truth. The JAX package's ``mesh`` option (sharding the
refinement lanes over devices) has no counterpart on one card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .estimators import (
    EVENT_DEPTH,
    EVENT_DVL,
    EVENT_GYRO,
    EVENT_IMU,
    DRConfig,
    GyroConfig,
    KalmanConfig,
    dead_reckoning_scan,
    dead_reckoning_with_basis_scan,
    gyro_integrate,
    kalman_scan,
)
from .geometry import pose3_to_pose2, se2_between, se2_compose, se2_transform_points
from .io.dataset import SensorStreams, build_dr_ticks, match_pings_to_ticks
from .io.simulate import SyntheticBag, seafloor_z
from .kernels.cfar_cuda import cfar_detect
from .kernels.cfar_factors import threshold_factor_soca
from .mapping import (
    MappingConfig,
    SubmapModel,
    build_submap_logodds,
    mapping_init,
    occupancy_grid_method1,
    render_global_logodds,
)
from .mapping.metrics import _umeyama_se2
from .precision import pin_fp32
from .slam.core import KeyframeInput, SlamDims, SlamParams, select_keyframes, slam_scan
from .slam.frontend import FeatureConfig, FeatureExtractor, corroborate
from .slam.dual_sonar import ElevationSpec, fuse_frames_global
from .slam.refine import RefineParams, check_mesh_dims, refine_loops
from .utils.timing import CodeTimer, host_read, to_device


class ReplayResult(NamedTuple):
    trajectory: np.ndarray  # (K', 3) optimized keyframe poses
    covs: np.ndarray  # (K', 3, 3)
    dr_trajectory: np.ndarray  # (K', 3) odometry poses at keyframes
    keyframe_times: np.ndarray  # (K',)
    keyframe_ping_idx: np.ndarray  # (K',) ping index of each keyframe
    num_keyframes: int
    outputs: object  # StepOutputs stacked over the K slots (tensors)
    carry: object  # final SlamCarry
    dr_poses_at_ticks: np.ndarray  # (T, 6) full-rate odometry
    dense_trajectory: np.ndarray  # (Ts, 3) SLAM pose at every ping
    stage_s: dict  # host-clock seconds per stage, each ended by a device sync
    # dual sonar (use_vertical): the fused clouds, the per-beam floor samples
    # as 3-D points (local frames) and the global elevation grid
    points3d: np.ndarray | None = None  # (K', N, 3)
    points3d_mask: np.ndarray | None = None
    floor_points3d: np.ndarray | None = None  # (K', Cv, 3)
    floor_weights: np.ndarray | None = None  # (K', Cv)
    elevation_z: np.ndarray | None = None  # (H, W)
    elevation_w: np.ndarray | None = None  # (H, W)
    elevation_spec: object | None = None  # ElevationSpec


def kalman_events(bag: SyntheticBag, use_gyro: bool):
    """The bag's merged, time-sorted sensor event stream on the host:
    (times (T,), types (T,) int32, z (T, 3) float32), the FOG's events
    among them when ``use_gyro`` and the bag has a gyro."""
    times = [bag.imu_time, bag.dvl_time, bag.depth_time]
    types = [np.full(len(bag.imu_time), EVENT_IMU, np.int32),
             np.full(len(bag.dvl_time), EVENT_DVL, np.int32),
             np.full(len(bag.depth_time), EVENT_DEPTH, np.int32)]
    zeros = np.zeros_like(bag.depth)
    zs = [bag.imu_rpy, bag.dvl_vel, np.stack([bag.depth, zeros, zeros], -1)]
    if use_gyro and bag.gyro_time is not None:
        # FOG delta-yaw corrections; the simulator's gyro frame is already
        # sonar-aligned (identity offset)
        times.append(bag.gyro_time)
        types.append(np.full(len(bag.gyro_time), EVENT_GYRO, np.int32))
        zg = np.zeros((len(bag.gyro_time), 3), np.float32)
        zg[:, 0] = bag.gyro_delta[:, 0]
        zs.append(zg)
    times = np.concatenate(times)
    types = np.concatenate(types)
    z = np.concatenate(zs).astype(np.float32)
    order = np.argsort(times, kind="stable")
    return times[order], types[order], z[order]


def _kalman_odometry(bag: SyntheticBag, kalman_config: KalmanConfig, device):
    """The merged sensor event stream through the Kalman filter: (times
    (T,), poses3 (T, 6)) at the IMU events, where the filter publishes."""
    times, types, z = kalman_events(bag, kalman_config.use_gyro)
    _, _, poses = kalman_scan(types, to_device(z, device), kalman_config)
    imu = np.nonzero(types == EVENT_IMU)[0]
    return times[imu], poses[to_device(imu, device)]


def default_kalman_config(imu_time: np.ndarray, device) -> KalmanConfig:
    """``KalmanConfig.default`` with no IMU offset, its IMU period and
    transition set from the bag's median IMU period (the position integrates
    ``v * dt_imu`` at each IMU event)."""
    cfg = KalmanConfig.default(device)._replace(imu_offset=0.0)
    dt = float(np.median(np.diff(imu_time)))
    A = cfg.A_imu.clone()
    for ij in ((0, 6), (1, 7), (3, 9), (4, 10)):
        # a host value written into a device tensor: a copy that waits
        host_read(A.__setitem__, ij, dt)
    return cfg._replace(dt_imu=dt, A_imu=A)


def odometry(bag: SyntheticBag, device, frontend: str = "dr",
             dr_config: DRConfig = DRConfig(roll_offset=0.0),
             gyro_config: GyroConfig | None = None,
             kalman_config: KalmanConfig | None = None, basis: bool = False):
    """The odometry front end of ``replay``: (tick times (T,) on the host,
    pose3 at the ticks (T, 6), DVL basis integrals (T, 2, 2) or None). The
    dead-reckoning front ends tick at the DVL samples and give the basis
    integrals when ``basis``; the Kalman filter ticks at the IMU events and
    gives none."""
    if frontend not in ("dr", "dr_gyro", "kalman"):
        raise ValueError(f"unknown front end {frontend!r}")
    pin_fp32()
    if frontend == "kalman":
        if kalman_config is None:
            kalman_config = default_kalman_config(bag.imu_time, device)
        return (*_kalman_odometry(bag, kalman_config, device), None)
    gyro_time = gyro_yaw = None
    if frontend == "dr_gyro":
        if gyro_config is None:
            gyro_config = GyroConfig(offset_matrix=torch.eye(3, device=device),
                                     latitude=0.0, sensor_rate=50.0, roll0=0.0)
        ypr = gyro_integrate(torch.as_tensor(bag.gyro_delta, device=device),
                             gyro_config)
        gyro_yaw = ypr[:, 0].cpu().numpy()
        gyro_time = bag.gyro_time
        dr_config = dr_config._replace(use_gyro=True)
    streams = SensorStreams(
        imu_time=bag.imu_time, imu_rpy=bag.imu_rpy, dvl_time=bag.dvl_time,
        dvl_vel=bag.dvl_vel, depth_time=bag.depth_time, depth=bag.depth,
        gyro_time=gyro_time, gyro_yaw=gyro_yaw)
    bundle = build_dr_ticks(streams, device)
    if basis:
        poses3, tick_basis = dead_reckoning_with_basis_scan(bundle.ticks,
                                                            dr_config)
        return bundle.tick_time, poses3, tick_basis
    return bundle.tick_time, dead_reckoning_scan(bundle.ticks, dr_config), None


def replay(
    bag: SyntheticBag,
    feature_config: FeatureConfig,
    params: SlamParams,
    dims: SlamDims,
    device,
    dr_config: DRConfig = DRConfig(roll_offset=0.0),
    frontend: str = "dr",
    gyro_config: GyroConfig | None = None,
    kalman_config: KalmanConfig | None = None,
    use_vertical: bool = False,
    refine_params: RefineParams | None = None,
    mesh=None,
) -> ReplayResult:
    """Replay ``bag`` on ``device`` (a torch device or its name).

    ``frontend`` is ``"dr"``, ``"dr_gyro"`` or ``"kalman"``. ``dr_gyro``
    defaults to an identity mount, latitude 0, a 50 Hz gyro and roll0 0;
    ``kalman`` to ``default_kalman_config`` and refuses DR-basis aggregation,
    whose basis integrals only dead reckoning gives. ``refine_params``
    defaults to ``RefineParams.default``. ``mesh`` (``parallel.mesh.Mesh``,
    called on every rank with its device) shards the refinement's
    registration fan-outs over the ranks (``refine_loops``); everything
    before runs replicated on every rank."""
    if use_vertical and bag.vertical_images is None:
        raise ValueError("bag has no vertical sonar stream")
    if mesh is not None:
        check_mesh_dims(dims, mesh.size)
    pin_fp32()
    dev = torch.device(device)
    stage_s = {}
    with CodeTimer("dr_gate", silent=True, sync=dev) as span:
        # 1) the odometry front end
        tick_time, dr_poses3, tick_basis = odometry(
            bag, dev, frontend, dr_config, gyro_config, kalman_config,
            basis=((dims.refine_scale_basis and dims.estimate_dvl_scale)
                   or dims.aggregate_with_dr_basis))
        if dims.aggregate_with_dr_basis and tick_basis is None:
            raise ValueError(
                "aggregate_with_dr_basis requires a DR frontend (the basis "
                "integrals come from dead_reckoning_with_basis_scan)")

        # 2) pair pings with odometry, keyframe gate
        tick_idx, sync_ok = match_pings_to_ticks(bag.ping_time, tick_time)
        tick_idx_t = torch.as_tensor(tick_idx, device=dev)
        ping_dr3 = dr_poses3[tick_idx_t]
        ping_dr2 = pose3_to_pose2(ping_dr3)
        n_pings = len(bag.ping_time)
        ping_time = torch.as_tensor(np.asarray(bag.ping_time, np.float32),
                                    device=dev)
        candidate = sync_ok & (np.arange(n_pings) % feature_config.skip == 0)
        kf_mask = select_keyframes(ping_time, ping_dr2,
                                   torch.as_tensor(candidate, device=dev), params)
        kf_idx = np.nonzero(kf_mask.cpu().numpy())[0]
        K = dims.max_keyframes
        if len(kf_idx) > K:
            raise ValueError(
                f"{len(kf_idx)} keyframes exceed capacity {K}; raise "
                "SlamDims.max_keyframes or loosen keyframe gates")
        valid = np.zeros(K, bool)
        valid[: len(kf_idx)] = True
        sel = np.concatenate([kf_idx, np.zeros(K - len(kf_idx), np.int64)])
    stage_s["dr_gate"] = span.took

    # 3) features of the keyframe pings (and of their neighbours)
    with CodeTimer("features", silent=True, sync=dev) as span:
        images = torch.as_tensor(bag.ping_images, device=dev)
        extractor = FeatureExtractor(feature_config, bag.geometry, dev)
        sel_t = torch.as_tensor(sel, device=dev)
        pts, masks, conf = extractor.extract_batch_conf(images[sel_t])
        if feature_config.corroborate:
            neighbors = []
            for nb in (np.clip(sel - 1, 0, n_pings - 1),
                       np.clip(sel + 1, 0, n_pings - 1)):
                nb_t = torch.as_tensor(nb, device=dev)
                npts, nmask, _ = extractor.extract_batch_conf(images[nb_t])
                neighbors.append((npts, nmask, ping_dr2[nb_t]))
            masks = corroborate(pts, masks, ping_dr2[sel_t], neighbors,
                                feature_config.corroborate_rho,
                                feature_config.corroborate_both)
        valid_t = torch.as_tensor(valid, device=dev)
        masks = masks & valid_t[:, None]
    stage_s["features"] = span.took

    # 4) the SLAM scan
    with CodeTimer("slam_scan", silent=True, sync=dev) as span:
        frames = KeyframeInput(time=ping_time[sel_t], dr_pose3=ping_dr3[sel_t],
                               points=pts, pmask=masks, valid=valid_t, conf=conf)
        kf_basis = tick_basis[tick_idx_t][sel_t] if tick_basis is not None else None
        carry, outputs = slam_scan(frames, params, dims, kf_basis)
    stage_s["slam_scan"] = span.took

    # 5) post-convergence loop refinement
    if dims.refine_iters > 0:
        with CodeTimer("refine", silent=True, sync=dev) as span:
            rp = (refine_params if refine_params is not None
                  else RefineParams.default(dev))
            carry = refine_loops(carry, params, rp, dims, kf_basis, mesh=mesh)
        stage_s["refine"] = span.took

    # 6) full-rate pose at every ping
    nk = carry.num_kf
    kf_of_ping = np.clip(
        np.searchsorted(kf_idx, np.arange(n_pings), side="right") - 1,
        0, max(nk - 1, 0))
    base = torch.as_tensor(kf_of_ping, device=dev)
    dense = se2_compose(carry.poses[base],
                        se2_between(carry.dr_poses[base], ping_dr2))

    def host(x):
        return x.detach().cpu().numpy()

    # 7) dual sonar: vertical detections of the keyframes, then the fusion
    fused = {}
    if use_vertical:
        with CodeTimer("dual", silent=True) as span:
            vimgs = torch.as_tensor(bag.vertical_images[sel], dtype=torch.float32,
                                    device=dev)
            # the JAX package detects the vertical fan with cfar_soca2, whose
            # edge is strict: rows within ntc/2 + ngc/2 of a border never detect
            vdet = cfar_detect(
                vimgs, feature_config.ntc // 2, feature_config.ngc // 2,
                threshold_factor_soca(feature_config.ntc, feature_config.pfa),
                "SOCA", intensity_threshold=feature_config.threshold, edge="strict")
            # the elevation grid spans the survey area (trajectory +- max range)
            half = float(dims.max_range) * (1.0 + dims.aggregation_extent)
            res = 0.5
            n = int(np.ceil(2 * half / res))
            espec = ElevationSpec(x0=-half, y0=-half, resolution=res, nx=n, ny=n)
            p3, p3m, floor3, fw, egrid = fuse_frames_global(
                carry.points, carry.pmasks, vimgs, vdet, carry.poses,
                bag.vertical_geometry, espec)
            fused = dict(points3d=host(p3), points3d_mask=host(p3m),
                         floor_points3d=host(floor3), floor_weights=host(fw),
                         elevation_z=host(egrid.z), elevation_w=host(egrid.w),
                         elevation_spec=espec)
        stage_s["dual"] = span.took

    return ReplayResult(
        trajectory=host(carry.poses[:nk]), covs=host(carry.covs[:nk]),
        dr_trajectory=host(carry.dr_poses[:nk]),
        keyframe_times=host(carry.times[:nk]), keyframe_ping_idx=kf_idx,
        num_keyframes=nk, outputs=outputs, carry=carry,
        dr_poses_at_ticks=host(dr_poses3), dense_trajectory=host(dense),
        stage_s=stage_s, **fused,
    )


def occupancy_map(carry, geometry, max_keyframes: int):
    """bench.py's mapping stage on a replay's carry: every keyframe's submap
    log-odds, the full repaint through the current poses and the method-1
    int8 export. Returns (occupancy (H, W) int8 tensor, MappingConfig)."""
    config = dataclasses.replace(MappingConfig(), max_keyframes=max_keyframes)
    model = SubmapModel(config, geometry, carry.poses.device)
    valid = torch.arange(max_keyframes, device=carry.poses.device) < carry.num_kf
    state = mapping_init(config, model)._replace(
        kf_logodds=build_submap_logodds(carry.points, carry.pmasks, model),
        kf_poses=carry.poses, kf_valid=valid, num_kf=carry.num_kf)
    state = state._replace(grid=render_global_logodds(state, model))
    return occupancy_grid_method1(state, model), config


def loop_metrics(carry, truth_kf: np.ndarray, min_st_sep: int,
                 prox_radius: float, correct_tol: float = 0.30) -> dict:
    """Loop-closure precision and recall against the simulator's truth
    (bench.py's ``loop_metrics`` on the port's carry): a loop is correct when
    its measured translation is within ``correct_tol`` of the true relative
    pose; recall counts the source keyframes with a revisit opportunity (a
    keyframe ``min_st_sep`` older within ``prox_radius``) that have a correct
    loop."""
    nk = carry.num_kf
    nl = min(carry.num_loops, carry.loops_i.shape[0])
    li = carry.loops_i[:nl].cpu().numpy()
    lj = carry.loops_j[:nl].cpu().numpy()
    ltf = carry.loops_tf[:nl].cpu().numpy()
    truth32 = torch.as_tensor(np.asarray(truth_kf, np.float32))
    errs = np.asarray([
        float(np.linalg.norm(z[:2] - se2_between(truth32[a], truth32[b]).numpy()[:2]))
        for a, b, z in zip(li, lj, ltf)])
    correct = errs < correct_tol if nl else np.zeros(0, bool)

    xy = truth_kf[:nk, :2]
    d = np.linalg.norm(xy[:, None, :] - xy[None, :, :], axis=-1)
    i_idx = np.arange(nk)
    opp = ((i_idx[None, :] - i_idx[:, None]) >= min_st_sep) & (d < prox_radius)
    opp_j = opp.any(axis=0)
    det_j = np.zeros(nk, bool)
    det_j[lj[(lj < nk) & correct]] = True
    n_opp = int(opp_j.sum())
    return {
        "precision": round(float(correct.mean()), 3) if nl else None,
        "recall": round(float((det_j & opp_j).sum() / max(n_opp, 1)), 3),
        "opportunities": n_opp,
        "loops": nl,
        "loop_err_median_cm": round(float(np.median(errs)) * 100, 2)
        if nl else None,
        "loop_err_p90_cm": round(float(np.percentile(errs, 90)) * 100, 2)
        if nl else None,
    }


def _umeyama_rotation(est: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Best SE(2) alignment rotation est -> truth over the common prefix."""
    n = min(len(est), len(truth))
    a, b = est[:n, :2], truth[:n, :2]
    A, B = a - a.mean(0), b - b.mean(0)
    U, _, Vt = np.linalg.svd(A.T @ B)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    return Vt.T @ np.diag([1, d]) @ U.T


def ate_rmse(est: np.ndarray, truth: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error (RMSE over xy, metres) after SE(2)
    alignment."""
    n = min(len(est), len(truth))
    a, b = est[:n, :2], truth[:n, :2]
    if align and len(a) >= 2:
        R = _umeyama_rotation(est, truth)
        a = (R @ (a - a.mean(0)).T).T + b.mean(0)
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


def ate_heading_deg(est: np.ndarray, truth: np.ndarray,
                    align: bool = True) -> float:
    """Heading RMSE (degrees) after the same alignment as ``ate_rmse``."""
    dth = est[:, 2] - truth[: len(est), 2]
    if align and len(est) >= 2:
        R = _umeyama_rotation(est, truth)
        dth = dth + np.arctan2(R[1, 0], R[0, 0])
    dth = np.arctan2(np.sin(dth), np.cos(dth))
    return float(np.degrees(np.sqrt(np.mean(dth**2))))


def dual_sonar_metrics(res: ReplayResult, bag: SyntheticBag, sim) -> dict:
    """bench.py's ``dual_sonar`` accuracy keys for a ``use_vertical`` replay
    of a simulated bag (``sim`` its ``SimConfig``): the fused heights of the
    lifted horizontal points (|z| > 0.1 m) and of the per-beam floor samples
    against the simulator's seafloor, sampled in the truth frame through the
    SE(2) alignment of the keyframe trajectory. Returns ``z_rmse_m``,
    ``z_points`` and ``elevation_cells`` (unrounded)."""
    nk = res.num_keyframes
    truth = bag.true_pose_at_ping[res.keyframe_ping_idx[:nk]]
    align = _umeyama_se2(res.trajectory[:, :2], truth[:, :2])
    poses = torch.as_tensor(np.array(res.trajectory, np.float32))
    zerrs = []
    for k in range(nk):
        for pts, m in ((res.points3d[k], res.points3d_mask[k]
                        & (np.abs(res.points3d[k][:, 2]) > 0.1)),
                       (res.floor_points3d[k], res.floor_weights[k] > 0)):
            if m.any():
                g = se2_transform_points(torch.as_tensor(pts[m, :2]),
                                         poses[k]).numpy()
                zerrs.append(pts[m, 2] - seafloor_z(sim, *align(g).T))
    zerr = np.concatenate(zerrs) if zerrs else np.full(1, np.inf)
    return {"z_rmse_m": float(np.sqrt(np.mean(zerr**2))),
            "z_points": int(sum(len(z) for z in zerrs)),
            "elevation_cells": int((res.elevation_w > 0).sum())}
