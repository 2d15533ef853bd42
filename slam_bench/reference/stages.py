"""The stages of an offline replay and of the live nodes on the reference's
modules (the order and arithmetic of the port's ``pipeline.replay`` as the
benchmark was written), each callable on inputs handed in from outside, so
the check can follow the program stage by stage."""

from __future__ import annotations

import dataclasses
import importlib
import types

import numpy as np
import torch

from .estimators import DRTicks, dead_reckoning_init, dead_reckoning_step
from .geometry import pose3_to_pose2
from .io import SensorStreams, build_dr_ticks, match_pings_to_ticks
from .mapping import (
    MappingConfig,
    SubmapModel,
    build_submap_logodds,
    mapping_init,
    occupancy_grid_method1,
    render_global_logodds,
)
from .slam import (
    FeatureExtractor,
    KeyframeInput,
    corroborate,
    keyframe_step,
    refine_loops,
    select_keyframes,
    slam_init,
    slam_scan,
)
from .slam.core import _init_carry


def host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def dr_bundle(bag, dev):
    return build_dr_ticks(SensorStreams(
        imu_time=bag.imu_time, imu_rpy=bag.imu_rpy, dvl_time=bag.dvl_time,
        dvl_vel=bag.dvl_vel, depth_time=bag.depth_time, depth=bag.depth), dev)


def odometry(bag, dims, dr_config, dev, frontend: str):
    """The odometry at the ticks: (tick times, poses3 (T, 6), basis
    (T, 2, 2) or None), as ``pipeline.odometry`` gives them for
    ``frontend``, whose reference is ``odometry/<frontend>.py``."""
    fe = importlib.import_module(f"{__package__}.odometry.{frontend}")
    return fe.odometry(bag, dims, dr_config, dev)


def ping_pairing(bag, tick_time, skip: int):
    tick_idx, ok = match_pings_to_ticks(bag.ping_time, tick_time)
    n = len(bag.ping_time)
    return tick_idx, ok & (np.arange(n) % skip == 0)


def gate(bag, dr_poses3, tick_idx, candidate, params, dev):
    """The replay's keyframe gate on ``dr_poses3`` at the ticks."""
    ping_dr2 = pose3_to_pose2(dr_poses3[torch.as_tensor(tick_idx, device=dev)])
    ping_time = torch.as_tensor(np.asarray(bag.ping_time, np.float32),
                                device=dev)
    mask = select_keyframes(ping_time, ping_dr2,
                            torch.as_tensor(candidate, device=dev), params)
    return np.nonzero(mask.cpu().numpy())[0], ping_dr2


def features(bag, kf_idx, ping_dr2, fc, K, dev):
    """The replay's features of the keyframe pings ``kf_idx`` (padded to K
    slots with ping 0), with the corroboration gate on ``ping_dr2``."""
    n = len(bag.ping_time)
    sel = np.concatenate([kf_idx, np.zeros(K - len(kf_idx), np.int64)])
    images = torch.as_tensor(bag.ping_images, device=dev)
    ext = FeatureExtractor(fc, bag.geometry, dev)
    sel_t = torch.as_tensor(sel, device=dev)
    pts, masks, conf = ext.extract_batch_conf(images[sel_t])
    if fc.corroborate:
        nbs = []
        for nb in (np.clip(sel - 1, 0, n - 1), np.clip(sel + 1, 0, n - 1)):
            nb_t = torch.as_tensor(nb, device=dev)
            npts, nmask, _ = ext.extract_batch_conf(images[nb_t])
            nbs.append((npts, nmask, ping_dr2[nb_t]))
        masks = corroborate(pts, masks, ping_dr2[sel_t], nbs,
                            fc.corroborate_rho, fc.corroborate_both)
    valid = torch.as_tensor(np.arange(K) < len(kf_idx), device=dev)
    return pts, masks & valid[:, None], conf


def keyframe_inputs(bag, kf_idx, tick_idx, dr_poses3, basis, pts, masks,
                    conf, K, dev):
    sel = np.concatenate([kf_idx, np.zeros(K - len(kf_idx), np.int64)])
    sel_t = torch.as_tensor(sel, device=dev)
    ping_time = torch.as_tensor(np.asarray(bag.ping_time, np.float32),
                                device=dev)
    tick_t = torch.as_tensor(tick_idx, device=dev)
    valid = torch.as_tensor(np.arange(K) < len(kf_idx), device=dev)
    frames = KeyframeInput(time=ping_time[sel_t],
                           dr_pose3=dr_poses3[tick_t][sel_t], points=pts,
                           pmask=masks, valid=valid, conf=conf)
    kf_basis = basis[tick_t][sel_t] if basis is not None else None
    return frames, kf_basis


def occupancy(points, pmasks, poses, num_kf: int, geometry, K: int, dev):
    """The replay's mapping stage: ``pipeline.occupancy_map``."""
    config = dataclasses.replace(MappingConfig(), max_keyframes=K)
    model = SubmapModel(config, geometry, dev)
    valid = torch.arange(K, device=dev) < num_kf
    state = mapping_init(config, model)._replace(
        kf_logodds=build_submap_logodds(points, pmasks, model),
        kf_poses=poses, kf_valid=valid, num_kf=num_kf)
    state = state._replace(grid=render_global_logodds(state, model))
    return occupancy_grid_method1(state, model)


def keyframe_basis(basis, kf_idx, tick_idx, K: int, dev):
    """The DVL basis integrals at the keyframe pings (padded to K slots
    with ping 0), or None."""
    if basis is None:
        return None
    sel = np.concatenate([kf_idx, np.zeros(K - len(kf_idx), np.int64)])
    return basis[torch.as_tensor(tick_idx, device=dev)][
        torch.as_tensor(sel, device=dev)]


def init_carry(dims, kf_basis, dev):
    """The carry a replay's scan starts from."""
    return _init_carry(dims, kf_basis, dev)


def replay(bag, built, dev, frontend: str) -> dict:
    """A whole offline replay and its map on the reference (the control
    runs this): the odometry at the ticks, the keyframe pings, the final
    carry and the map."""
    b = built
    K = b.dims.max_keyframes
    tick_time, dr3, basis = odometry(bag, b.dims, b.dr, dev, frontend)
    tick_idx, cand = ping_pairing(bag, tick_time, b.features.skip)
    kf_idx, ping_dr2 = gate(bag, dr3, tick_idx, cand, b.params, dev)
    pts, masks, conf = features(bag, kf_idx, ping_dr2, b.features, K, dev)
    frames, kf_basis = keyframe_inputs(bag, kf_idx, tick_idx, dr3, basis, pts,
                                       masks, conf, K, dev)
    carry, _ = slam_scan(frames, b.params, b.dims, kf_basis)
    if b.dims.refine_iters > 0:
        carry = refine_loops(carry, b.params, b.refine_params, b.dims,
                             kf_basis)
    grid = occupancy(carry.points, carry.pmasks, carry.poses, carry.num_kf,
                     bag.geometry, K, dev)
    return dict(dr_ticks=host(dr3), kf_idx=kf_idx, carry=carry,
                grid=host(grid))


def modules():
    """The reference's entry points in the shape the online nodes take."""
    return types.SimpleNamespace(
        dead_reckoning_init=dead_reckoning_init,
        dead_reckoning_step=dead_reckoning_step, slam_init=slam_init,
        keyframe_step=keyframe_step, select_keyframes=select_keyframes,
        KeyframeInput=KeyframeInput, FeatureExtractor=FeatureExtractor,
        corroborate=corroborate, pose3_to_pose2=pose3_to_pose2)


def dr_steps(ticks: DRTicks, dr_config, dev) -> np.ndarray:
    """The DR node's poses at every tick, one ``dead_reckoning_step`` a
    tick: (T, 6)."""
    cols = tuple(c.to(dev) for c in ticks)
    state = dead_reckoning_init(dev)
    out = []
    for i in range(cols[0].shape[0]):
        state, pose = dead_reckoning_step(state, tuple(c[i] for c in cols),
                                          dr_config)
        out.append(pose)
    return host(torch.stack(out))


def live_gate(ping_time, tick_idx, candidate, tick_poses, params) -> list:
    """The live gate, one ping at a time against the newest keyframe, on the
    host (as the live node gates): the keyframe pings."""
    true_ = torch.ones(2, dtype=torch.bool)
    kf, last = [], None
    for p in range(len(ping_time)):
        if not candidate[p]:
            continue
        if last is not None:
            pr = torch.as_tensor(tick_poses[tick_idx[[last, p]]])
            if not bool(select_keyframes(
                    torch.as_tensor(ping_time[[last, p]]),
                    pose3_to_pose2(pr), true_, params)[1]):
                continue
        last = p
        kf.append(p)
    return kf


def keyframe_features(extractor, images, dr3, fc, dev):
    """The feature node on one keyframe: its ping and both neighbours
    (``images`` (3, R, C), their DR poses ``dr3`` (3, 6)): points, the
    corroborated mask and the confidences of the middle ping."""
    imgs = torch.as_tensor(images).to(dev)
    pts, masks, conf = extractor.extract_batch_conf(imgs)
    dr2 = pose3_to_pose2(torch.as_tensor(dr3).to(dev))
    mask = masks[1:2]
    if fc.corroborate:
        mask = corroborate(pts[1:2], masks[1:2], dr2[1:2],
                           [(pts[0:1], masks[0:1], dr2[0:1]),
                            (pts[2:3], masks[2:3], dr2[2:3])],
                           fc.corroborate_rho, fc.corroborate_both)
    return host(pts[1]), host(mask[0]), host(conf[1])


def carry(carry_host: dict, dev):
    """A carry handed in as host arrays, on ``dev``."""
    from .graph import GraphState
    from .slam import SlamCarry

    def t(v):
        return torch.as_tensor(v).to(dev) if isinstance(v, np.ndarray) else v

    fields = dict(carry_host)
    fields["graph"] = GraphState(**{k: t(v) for k, v in fields["graph"].items()})
    return SlamCarry(**{k: (v if k == "graph" else t(v))
                        for k, v in fields.items()})


def step(carry_host: dict, frame_host: dict, built, dev):
    """One ``keyframe_step`` from a carry and a frame handed in as host
    arrays: the carry after it."""
    frame = KeyframeInput(**{
        k: torch.as_tensor(v).to(dev) if isinstance(v, np.ndarray) else v
        for k, v in frame_host.items()})
    after, _ = keyframe_step(carry(carry_host, dev), frame, built.params,
                             built.dims)
    return after
