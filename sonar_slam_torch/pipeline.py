"""End-to-end offline replay of a sensor bag on one device.

Counterpart of ``sonar_slam_tpu/pipeline.py::replay`` for the dead-reckoning
front end:

1. dead reckoning over the synchronized ticks (with the DVL basis integrals
   when the configuration asks for them), on the device;
2. the keyframe gate (a host loop over the pings);
3. CFAR feature extraction of the keyframe pings, and with the temporal
   corroboration gate of both neighbours of each (three batched CFAR
   launches on a CUDA device);
4. ``slam_scan`` over the keyframes;
5. ``refine_loops`` when ``dims.refine_iters > 0``;
6. the dense trajectory: every ping's DR delta composed onto its latest
   keyframe's optimized pose.

``occupancy_map`` is bench.py's mapping stage on the result's carry, and
``loop_metrics`` / ``ate_rmse`` / ``ate_heading_deg`` score a replay against
the simulator's truth. Options that are not ported yet (the Kalman and gyro
front ends, dual sonar) raise ``NotImplementedError`` naming the option.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from .estimators import DRConfig, dead_reckoning_scan, dead_reckoning_with_basis_scan
from .geometry import pose3_to_pose2, se2_between, se2_compose
from .io.dataset import SensorStreams, build_dr_ticks, match_pings_to_ticks
from .io.simulate import SyntheticBag
from .mapping import (
    MappingConfig,
    SubmapModel,
    build_submap_logodds,
    mapping_init,
    occupancy_grid_method1,
    render_global_logodds,
)
from .precision import pin_fp32
from .slam.core import KeyframeInput, SlamDims, SlamParams, select_keyframes, slam_scan
from .slam.frontend import FeatureConfig, FeatureExtractor, corroborate
from .slam.refine import RefineParams, refine_loops


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


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def replay(
    bag: SyntheticBag,
    feature_config: FeatureConfig,
    params: SlamParams,
    dims: SlamDims,
    device,
    dr_config: DRConfig = DRConfig(roll_offset=0.0),
    frontend: str = "dr",
    use_vertical: bool = False,
    refine_params: RefineParams | None = None,
) -> ReplayResult:
    """Replay ``bag`` on ``device`` (a torch device or its name).
    ``refine_params`` defaults to ``RefineParams.default``."""
    if frontend != "dr":
        raise NotImplementedError(
            f"replay(frontend={frontend!r}): only the 'dr' front end is ported")
    if use_vertical:
        raise NotImplementedError("replay(use_vertical=True): dual sonar is "
                                  "not ported")
    pin_fp32()
    dev = torch.device(device)
    stage_s = {}
    t0 = time.perf_counter()

    # 1) dead reckoning over synchronized ticks
    streams = SensorStreams(
        imu_time=bag.imu_time, imu_rpy=bag.imu_rpy, dvl_time=bag.dvl_time,
        dvl_vel=bag.dvl_vel, depth_time=bag.depth_time, depth=bag.depth)
    bundle = build_dr_ticks(streams, dev)
    tick_basis = None
    if ((dims.refine_scale_basis and dims.estimate_dvl_scale)
            or dims.aggregate_with_dr_basis):
        dr_poses3, tick_basis = dead_reckoning_with_basis_scan(bundle.ticks,
                                                               dr_config)
    else:
        dr_poses3 = dead_reckoning_scan(bundle.ticks, dr_config)

    # 2) pair pings with odometry, keyframe gate
    tick_idx, sync_ok = match_pings_to_ticks(bag.ping_time, bundle.tick_time)
    tick_idx_t = torch.as_tensor(tick_idx, device=dev)
    ping_dr3 = dr_poses3[tick_idx_t]
    ping_dr2 = pose3_to_pose2(ping_dr3)
    n_pings = len(bag.ping_time)
    ping_time = torch.as_tensor(np.asarray(bag.ping_time, np.float32), device=dev)
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
    _sync(dev)
    stage_s["dr_gate"] = time.perf_counter() - t0

    # 3) features of the keyframe pings (and of their neighbours)
    t0 = time.perf_counter()
    images = torch.as_tensor(bag.ping_images, device=dev)
    extractor = FeatureExtractor(feature_config, bag.geometry, dev)
    sel_t = torch.as_tensor(sel, device=dev)
    pts, masks, conf = extractor.extract_batch_conf(images[sel_t])
    if feature_config.corroborate:
        neighbors = []
        for nb in (np.clip(sel - 1, 0, n_pings - 1), np.clip(sel + 1, 0, n_pings - 1)):
            nb_t = torch.as_tensor(nb, device=dev)
            npts, nmask, _ = extractor.extract_batch_conf(images[nb_t])
            neighbors.append((npts, nmask, ping_dr2[nb_t]))
        masks = corroborate(pts, masks, ping_dr2[sel_t], neighbors,
                            feature_config.corroborate_rho,
                            feature_config.corroborate_both)
    valid_t = torch.as_tensor(valid, device=dev)
    masks = masks & valid_t[:, None]
    _sync(dev)
    stage_s["features"] = time.perf_counter() - t0

    # 4) the SLAM scan
    t0 = time.perf_counter()
    frames = KeyframeInput(time=ping_time[sel_t], dr_pose3=ping_dr3[sel_t],
                           points=pts, pmask=masks, valid=valid_t, conf=conf)
    kf_basis = tick_basis[tick_idx_t][sel_t] if tick_basis is not None else None
    carry, outputs = slam_scan(frames, params, dims, kf_basis)
    _sync(dev)
    stage_s["slam_scan"] = time.perf_counter() - t0

    # 5) post-convergence loop refinement
    if dims.refine_iters > 0:
        t0 = time.perf_counter()
        rp = refine_params if refine_params is not None else RefineParams.default(dev)
        carry = refine_loops(carry, params, rp, dims, kf_basis)
        _sync(dev)
        stage_s["refine"] = time.perf_counter() - t0

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

    return ReplayResult(
        trajectory=host(carry.poses[:nk]), covs=host(carry.covs[:nk]),
        dr_trajectory=host(carry.dr_poses[:nk]),
        keyframe_times=host(carry.times[:nk]), keyframe_ping_idx=kf_idx,
        num_keyframes=nk, outputs=outputs, carry=carry,
        dr_poses_at_ticks=host(dr_poses3), dense_trajectory=host(dense),
        stage_s=stage_s,
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
